"""Training checkpoints: step-numbered directories, keep-N pruning, atomic
writes, "latest" resume.

Counterpart of ``gmdx/train/checkpoint.py`` in the port's own format (the
card's machine has no orbax): ``<output_dir>/checkpoint_<step>/`` holds

    state.safetensors   every tensor of the state (``gmdx_torch.io.params``),
                        each in its own dtype (bfloat16 stays bfloat16)
    state.json          the scalars (global step, the optimizer's count,
                        the accumulator's phase, the EMA step) and a digest
                        of the tensors' bits

so ``resolve_resume_step`` resolves ``latest``, a path or a step exactly as
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
FORMAT = "gmdx_torch.stage2.v1"


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


def state_tensors(state) -> tuple[dict[str, torch.Tensor], dict[str, Any]]:
    """A Stage-2 state's tensors (live references, keyed by role and the
    parameter's name) and scalars."""
    named = [n for n, p in state.unet.named_parameters() if p.requires_grad]
    opt = state.optimizer
    adam = opt.opt if isinstance(opt, MultiSteps) else opt
    if len(named) != len(adam.params):
        raise ValueError(f"the optimizer holds {len(adam.params)} tensors, the UNet "
                         f"{len(named)} trainable parameters")
    tensors = {}
    groups = {"params": adam.params, "mu": adam.mu, "nu": adam.nu}
    if isinstance(opt, MultiSteps):
        groups["acc"] = opt.acc
    if state.ema is not None:
        groups["ema"] = state.ema.shadow
    for group, ts in groups.items():
        tensors.update({f"{group}/{n}": t for n, t in zip(named, ts)})
    scalars = {"step": state.step, "count": adam.count,
               "mini_step": opt.mini_step if isinstance(opt, MultiSteps) else None,
               "ema_step": None if state.ema is None else state.ema.step}
    return tensors, scalars


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
             *, wait: bool = True) -> None:
        """Copy ``tensors`` to the host, then write them (on a thread when
        the manager is asynchronous and ``wait`` is False)."""
        self.wait_until_finished()
        meta = {"format": FORMAT, "global_step": int(step), "scalars": scalars,
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

    def restore(self, step: int, into: dict[str, torch.Tensor]) -> dict:
        """Copy the saved tensors into ``into`` (same keys, shapes and
        dtypes, in place); returns the metadata. Raises if the bits read
        differ from the bits saved."""
        path = self.path(step)
        with open(os.path.join(path, _META)) as f:
            meta = json.load(f)
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
    """Checkpoint a Stage-2 state at ``step`` (the global step: optimizer
    updates); returns the digest of the saved tensors."""
    tensors, scalars = state_tensors(state)
    manager.save(step, tensors, scalars, wait=wait)
    return tensor_digest(tensors)


def restore_state(manager: CheckpointManager, step: int, state):
    """Load checkpoint ``step`` into ``state`` in place (the state the run
    built: its parameters, moments, accumulator and EMA shadow are
    overwritten) and return it."""
    tensors, _ = state_tensors(state)
    meta = manager.restore(step, tensors)
    scalars = meta["scalars"]
    opt = state.optimizer
    adam = opt.opt if isinstance(opt, MultiSteps) else opt
    state.step = scalars["step"]
    adam.count = scalars["count"]
    if isinstance(opt, MultiSteps):
        opt.mini_step = scalars["mini_step"]
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
]
