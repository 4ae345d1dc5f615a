"""Training checkpoints: step-numbered directories, keep-N pruning, atomic
writes, "latest" resume.

Counterpart of ``gmdx/train/checkpoint.py`` in the port's own format (the
card's machine has no orbax): ``<output_dir>/checkpoint_<step>/`` holds

    state.safetensors   every tensor of the state (``gmdx_torch.io.params``),
                        each in its own dtype (bfloat16 stays bfloat16)
    state.json          the state's format tag, the scalars (global step,
                        each optimizer's count and accumulator phase, the
                        EMA step) and a digest of the tensors' bits

for each kind of training state: Stage 2 (the UNet's trainable parameters,
their AdamW moments, the accumulator, the EMA shadow), Stage 1 (the LoRA
factors and ``conv_out`` with the generator's optimizer state, the
discriminator's parameters with its own, its spectral-norm buffers, the
EMA shadow) and ControlNet (as Stage 2, over the ControlNet's parameters).
A restore into a state of another kind raises, naming both tags. So
``resolve_resume_step`` resolves ``latest``, a path or a step exactly as
the JAX package does. A save writes into a hidden temporary directory and
renames it into place, so a kill mid-write leaves no directory that a
resume could take; ``max_to_keep`` prunes the oldest after each save. With
``async_checkpointing`` a save returns once the state is copied to the host
(the optimizer updates the parameters in place, so the copy cannot wait)
and the disk write runs on a thread; ``wait_until_finished`` drains it.
The copy from the card goes through one pinned host buffer that the
manager keeps for its later saves (the size of the state). A restore checks
the digest of what it loaded against the saved one.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
from typing import Any

import torch

from gmdx_torch.io.params import load_file, save_file
from gmdx_torch.train.optim import MultiSteps

_PREFIX = "checkpoint_"
_TENSORS, _META = "state.safetensors", "state.json"


def tensor_digest(tensors: dict[str, torch.Tensor]) -> str:
    """A digest of the tensors' bits, computed where they live (one copy of
    two int64 sums a tensor to the host): equal bits, equal digest; a bit
    flipped or a value moved changes it."""
    sums = []
    for key in sorted(tensors):
        flat = tensors[key].detach().reshape(-1)
        bits = flat.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                          8: torch.int64}[flat.element_size()]).to(torch.int64)
        weight = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
        sums.append(torch.stack([bits.sum(), (bits * weight).sum()]))
    h = hashlib.sha256(json.dumps(sorted(tensors)).encode())
    if sums:
        h.update(torch.stack(sums).cpu().numpy().tobytes())
    return h.hexdigest()[:32]


def _adam(opt):
    return opt.opt if isinstance(opt, MultiSteps) else opt


def _optimizer_tensors(prefix: str, names: list[str], opt) -> dict:
    """The tensors of one optimizer, keyed ``<prefix><role>/<name>``: its
    parameters, moments and, under accumulation, the accumulator."""
    adam = _adam(opt)
    if len(names) != len(adam.params):
        raise ValueError(f"the optimizer holds {len(adam.params)} tensors, the model "
                         f"{len(names)} trainable parameters")
    groups = {"params": adam.params, "mu": adam.mu, "nu": adam.nu}
    if isinstance(opt, MultiSteps):
        groups["acc"] = opt.acc
    return {f"{prefix}{g}/{n}": t for g, ts in groups.items() for n, t in zip(names, ts)}


# Each kind of training state, its checkpoint's format tag.
FORMATS = {
    "Stage2State": "gmdx_torch.stage2.v1",
    "Stage1State": "gmdx_torch.stage1.v1",
    "ControlNetState": "gmdx_torch.controlnet.v1",
}


def _describe(state):
    """(format tag, tensors, scalars, [(key prefix, optimizer)]) of a
    Stage-2 or ControlNet state (one module's trainable parameters under
    one optimizer, and the EMA) or a Stage-1 state (the trainables, keyed
    by LoRA name and ``conv_out``, under the generator's optimizer, the
    discriminator's parameters under its own and its spectral-norm
    buffers, and the EMA of the trainables)."""
    kind = type(state).__name__
    if kind not in FORMATS:
        raise TypeError(f"no checkpoint layout for {kind}")
    tensors = {}
    if kind == "Stage1State":
        from gmdx_torch.train.stage1 import trainable_names

        names = trainable_names(state.trainables)
        disc = state.discriminator
        groups = [("gen_", names, state.optimizer),
                  ("disc_", [n for n, _ in disc.named_parameters()], state.disc_optimizer)]
        tensors.update({f"disc_buffers/{n}": b for n, b in disc.named_buffers()})
    else:
        module = state.unet if kind == "Stage2State" else state.controlnet
        names = [n for n, p in module.named_parameters() if p.requires_grad]
        groups = [("", names, state.optimizer)]
    scalars = {"step": state.step,
               "ema_step": None if state.ema is None else state.ema.step}
    for prefix, group_names, opt in groups:
        tensors.update(_optimizer_tensors(prefix, group_names, opt))
        scalars[f"{prefix}count"] = _adam(opt).count
        scalars[f"{prefix}mini_step"] = opt.mini_step if isinstance(opt, MultiSteps) else None
    if state.ema is not None:
        tensors.update({f"ema/{n}": t for n, t in zip(names, state.ema.shadow)})
    return FORMATS[kind], tensors, scalars, [(prefix, opt) for prefix, _, opt in groups]


def state_tensors(state) -> tuple[dict[str, torch.Tensor], dict[str, Any]]:
    """A training state's tensors (live references, keyed by role and name)
    and scalars: a Stage-2, Stage-1 or ControlNet state."""
    return _describe(state)[1:3]


class CheckpointManager:
    """Saves and restores ``checkpoint_<step>`` directories under
    ``output_dir``."""

    def __init__(self, output_dir: str, *, max_to_keep: int | None = None,
                 async_checkpointing: bool = False):
        self.directory = os.path.abspath(output_dir)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.async_checkpointing = async_checkpointing
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._staging: dict[str, torch.Tensor] = {}

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"{_PREFIX}{step}")

    def all_steps(self) -> list[int]:
        """The steps of the finished checkpoints, ascending."""
        steps = []
        for name in os.listdir(self.directory):
            m = re.fullmatch(r"checkpoint_?(\d+)", name)
            if m and os.path.isfile(os.path.join(self.directory, name, _META)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def _write(self, step: int, host: dict[str, torch.Tensor], meta: dict) -> None:
        final = self.path(step)
        tmp = os.path.join(self.directory, f".{_PREFIX}{step}.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        save_file(host, os.path.join(tmp, _TENSORS))
        with open(os.path.join(tmp, _META), "w") as f:
            json.dump(meta, f, indent=2)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self.path(old), ignore_errors=True)

    def _to_host(self, tensors: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Host copies of ``tensors``, finished when this returns: from the
        card into views of one pinned buffer (kept: its last write has
        ended before a save reaches here), else clones."""
        if not any(t.is_cuda for t in tensors.values()):
            return {k: t.detach().clone() for k, t in tensors.items()}
        layout = {k: (t.shape, t.dtype) for k, t in tensors.items()}
        if {k: (v.shape, v.dtype) for k, v in self._staging.items()} != layout:
            self._staging = {}  # the old buffer goes before the new one is taken
            sizes = {k: -(-t.numel() * t.element_size() // 64) * 64 for k, t in tensors.items()}
            flat = torch.empty(sum(sizes.values()), dtype=torch.uint8, pin_memory=True)
            offset = 0
            for k, t in tensors.items():
                n = t.numel() * t.element_size()
                self._staging[k] = flat[offset:offset + n].view(t.dtype).view(t.shape)
                offset += sizes[k]
        for k, t in tensors.items():
            self._staging[k].copy_(t.detach(), non_blocking=True)
        torch.cuda.synchronize()
        return self._staging

    def _run(self, *args) -> None:
        try:
            self._write(*args)
        except BaseException as e:  # noqa: BLE001 -- raised by wait_until_finished
            self._error = e

    def save(self, step: int, tensors: dict[str, torch.Tensor], scalars: dict,
             *, fmt: str, wait: bool = True) -> None:
        """Copy ``tensors`` to the host, then write them under the format
        tag ``fmt`` (on a thread when the manager is asynchronous and
        ``wait`` is False)."""
        self.wait_until_finished()
        meta = {"format": fmt, "global_step": int(step), "scalars": scalars,
                "digest": tensor_digest(tensors)}
        host = self._to_host(tensors)
        if self.async_checkpointing and not wait:
            self._thread = threading.Thread(target=self._run, args=(step, host, meta))
            self._thread.start()
        else:
            self._write(step, host, meta)

    def wait_until_finished(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, step: int, into: dict[str, torch.Tensor], *, fmt: str) -> dict:
        """Copy the saved tensors into ``into`` (same keys, shapes and
        dtypes, in place); returns the metadata. Raises if the checkpoint's
        format tag is not ``fmt`` (another kind of state), or if the bits
        read differ from the bits saved."""
        path = self.path(step)
        with open(os.path.join(path, _META)) as f:
            meta = json.load(f)
        if meta.get("format") != fmt:
            raise ValueError(f"{path}: a {meta.get('format')!r} checkpoint; the run restores "
                             f"a {fmt!r} state")
        saved = load_file(os.path.join(path, _TENSORS),
                          pin_memory=any(t.is_cuda for t in into.values()))
        if set(saved) != set(into):
            raise ValueError(f"{path}: holds {len(saved)} tensors, the run {len(into)}; "
                             f"missing {sorted(set(into) - set(saved))[:5]}, extra "
                             f"{sorted(set(saved) - set(into))[:5]} (another model, or another "
                             f"--use_ema / --gradient_accumulation_steps?)")
        with torch.no_grad():
            for k, t in into.items():
                src = saved[k] if isinstance(saved[k], torch.Tensor) else torch.from_numpy(saved[k])
                if src.shape != t.shape or src.dtype != t.dtype:
                    raise ValueError(f"{path}: {k} is {src.dtype} {tuple(src.shape)}, the run's "
                                     f"{t.dtype} {tuple(t.shape)} (another --use_8bit_adam?)")
                t.copy_(src, non_blocking=True)
        if any(t.is_cuda for t in into.values()):
            torch.cuda.synchronize()  # the pinned buffer goes when this returns
        if tensor_digest(into) != meta["digest"]:
            raise ValueError(f"{path}: the restored tensors' digest differs from the saved one")
        return meta


def make_manager(output_dir: str, *, max_to_keep: int | None = None,
                 async_checkpointing: bool = False) -> CheckpointManager:
    return CheckpointManager(output_dir, max_to_keep=max_to_keep,
                             async_checkpointing=async_checkpointing)


def save_state(manager: CheckpointManager, step: int, state, *, wait: bool = True) -> str:
    """Checkpoint a Stage-2, Stage-1 or ControlNet state at ``step`` (the
    global step: optimizer updates) under its kind's format tag; returns
    the digest of the saved tensors."""
    fmt, tensors, scalars, _ = _describe(state)
    manager.save(step, tensors, scalars, fmt=fmt, wait=wait)
    return tensor_digest(tensors)


def restore_state(manager: CheckpointManager, step: int, state):
    """Load checkpoint ``step`` into ``state`` in place (the state the run
    built: its parameters, moments, accumulators, spectral-norm buffers and
    EMA shadow are overwritten) and return it. A checkpoint of another kind
    of state raises, naming both format tags."""
    fmt, tensors, _, optimizers = _describe(state)
    scalars = manager.restore(step, tensors, fmt=fmt)["scalars"]
    state.step = scalars["step"]
    for prefix, opt in optimizers:
        _adam(opt).count = scalars[f"{prefix}count"]
        if isinstance(opt, MultiSteps):
            opt.mini_step = scalars[f"{prefix}mini_step"]
    if state.ema is not None:
        state.ema.step = scalars["ema_step"]
    return state


def resolve_resume_step(output_dir: str, resume_from: str | None) -> int | None:
    """Map ``--resume_from_checkpoint {latest|path|step}`` to a step number,
    or None when there is nothing to resume (the reference then warns and
    starts afresh)."""
    if resume_from is None:
        return None
    if resume_from != "latest":
        m = re.search(r"checkpoint[-_](\d+)$", resume_from.rstrip("/"))
        if m:
            return int(m.group(1))
        if resume_from.isdigit():
            return int(resume_from)
        return None
    if not os.path.isdir(output_dir):
        return None
    steps = []
    for name in os.listdir(output_dir):
        m = re.fullmatch(r"checkpoint_?(\d+)", name)
        if m:
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


__all__ = [
    "CheckpointManager",
    "make_manager",
    "save_state",
    "restore_state",
    "resolve_resume_step",
    "state_tensors",
    "tensor_digest",
    "FORMATS",
]
