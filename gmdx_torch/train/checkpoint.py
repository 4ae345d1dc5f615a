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

Across ranks the format is the one-process format, whatever the world
size and strategy: a save gathers the sharded parts of the state (zero1's
moments; fsdp's master parameters and EMA too) to rank 0 bucket by bucket,
rank 0 alone writes (under ``async_checkpointing`` only its disk write
goes to the thread) and prunes, and the digest is summed over every rank's
part; a restore reads the file on every rank and gives each its part. A
checkpoint written at one world size under one strategy resumes at
another. An accumulator (gradient accumulation) is saved as its mean over
the ranks.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import re
import shutil
import threading
from typing import Any

import torch

from gmdx_torch.dist.mesh import Sharded, all_reduce_mean_list
from gmdx_torch.dist.tp import gather_slices, tp_slice
from gmdx_torch.dist.multihost import barrier, is_initialized, rank
from gmdx_torch.io.params import load_file, save_file
from gmdx_torch.train.optim import MultiSteps, data_parallel, model_params

_PREFIX = "checkpoint_"
_TENSORS, _META = "state.safetensors", "state.json"


def _digest_sums(t: torch.Tensor, start: int = 0) -> torch.Tensor:
    """The two int64 sums of the digest over ``t``'s elements, the first
    of which is element ``start`` of its key's tensor."""
    flat = t.detach().reshape(-1)
    bits = flat.view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                      8: torch.int64}[flat.element_size()]).to(torch.int64)
    weight = torch.arange(start, start + bits.numel(), device=bits.device) % 65521 + 1
    return torch.stack([bits.sum(), (bits * weight).sum()])


def _digest(keys, sums: list[torch.Tensor]) -> str:
    h = hashlib.sha256(json.dumps(sorted(keys)).encode())
    if sums:
        h.update(torch.stack(sums).cpu().numpy().tobytes())
    return h.hexdigest()[:32]


def tensor_digest(tensors: dict[str, torch.Tensor]) -> str:
    """A digest of the tensors' bits, computed where they live (one copy of
    two int64 sums a tensor to the host): equal bits, equal digest; a bit
    flipped or a value moved changes it."""
    return _digest(tensors, [_digest_sums(tensors[k]) for k in sorted(tensors)])


@dataclasses.dataclass
class Sliced:
    """A list of tensors of which this rank holds tensor parallelism's
    slices, in the order of :class:`~gmdx_torch.dist.DataParallel` ``dp``'s
    names (checkpoints gather them over the model group)."""

    dp: object
    tensors: list


@dataclasses.dataclass
class _Slice:
    """This rank's tensor-parallel slice ``view`` of ``key``'s tensor of
    ``shape`` (the whole of it where the rule replicates) over the model
    axis ``ctx``."""

    view: torch.Tensor
    key: str
    shape: tuple
    ctx: object

    @property
    def dtype(self) -> torch.dtype:
        return self.view.dtype

    def full(self) -> torch.Tensor:
        """The whole tensor, gathered (a collective of the model group)."""
        return gather_slices(self.key, self.view, self.shape, self.ctx)


@dataclasses.dataclass
class _Part:
    """Elements ``[a, b)`` of a key's flattened tensor (of ``shape`` and
    ``dtype``) held by this rank in ``view`` (None: none of it)."""

    view: torch.Tensor | None
    a: int
    b: int
    shape: tuple
    dtype: torch.dtype


def _targets(groups) -> dict:
    """Key -> full tensor (replicated), :class:`_Part` (sharded) or
    :class:`_Slice` (tensor-parallel)."""
    out = {}
    for prefix, names, value in groups:
        if isinstance(value, Sliced):
            dp = value.dp
            for name, key, t, shape in zip(names, dp.names, value.tensors, dp.full_shapes):
                out[f"{prefix}{name}"] = _Slice(t, key, shape, dp.layout_ctx)
        elif isinstance(value, Sharded):
            dp = value.dp
            own = {i: (a, b, s) for i, a, b, s in dp.own}
            for i, name in enumerate(names):
                a, b, s = own.get(i, (0, 0, 0))
                view = value.flat[s:s + b - a] if i in own else None
                out[f"{prefix}{name}"] = _Part(view, a, b, tuple(dp.tensors[i].shape),
                                               value.flat.dtype)
        else:
            out.update({f"{prefix}{n}": t for n, t in zip(names, value)})
    return out


def _spec(t) -> tuple:
    """(shape, dtype) of a tensor or of the whole of a :class:`_Part`'s."""
    return (tuple(t.shape), t.dtype)


def _is_cuda(t) -> bool:
    v = t.view if isinstance(t, (_Part, _Slice)) else t
    return v is not None and v.is_cuda


def _dist_digest(targets: dict) -> str:
    """:func:`tensor_digest` of the whole state, summed over the ranks'
    parts (replicated tensors counted on rank 0): a collective."""
    device = next((t.view if isinstance(t, (_Part, _Slice)) else t).device
                  for t in targets.values() if not isinstance(t, _Part) or t.view is not None)
    zero = torch.zeros(2, dtype=torch.int64, device=device)
    sums = []
    for k in sorted(targets):
        t = targets[k]
        if isinstance(t, _Slice):
            full = t.full()
            sums.append(_digest_sums(full) if rank() == 0 else zero)
        elif isinstance(t, _Part):
            sums.append(_digest_sums(t.view, t.a) if t.view is not None and t.b > t.a else zero)
        else:
            sums.append(_digest_sums(t) if rank() == 0 else zero)
    total = torch.stack(sums)
    torch.distributed.all_reduce(total)
    return _digest(targets, list(total.unbind()))


def _adam(opt):
    return opt.opt if isinstance(opt, MultiSteps) else opt


def _optimizer_groups(prefix: str, names: list[str], opt, mean_acc: bool = False) -> list:
    """The tensors of one optimizer as (key prefix, names, full tensors or
    :class:`~gmdx_torch.dist.Sharded`), keyed ``<prefix><role>/<name>``:
    its parameters, moments and, under accumulation, the accumulator."""
    adam = _adam(opt)
    params = model_params(adam)
    if len(names) != len(params):
        raise ValueError(f"the optimizer holds {len(params)} tensors, the model "
                         f"{len(names)} trainable parameters")
    dp = data_parallel(adam)
    if dp is not None and dp.layout_ctx is not None:  # tp / sp
        groups = [(f"{prefix}{role}/", names, tensors)
                  for role, tensors in (("params", params), ("mu", adam.mu), ("nu", adam.nu))]
        if isinstance(opt, MultiSteps):
            # Saved as the one process's accumulator: the data axis's mean
            # (under sp of the model group's summed shares).
            groups.append((f"{prefix}acc/", names, dp.reduce(list(opt.acc)) if mean_acc
                           else opt.acc))
        return [(p, n, Sliced(dp, t)) if dp.sliced is not None else (p, n, t)
                for p, n, t in groups]
    groups = [
        (f"{prefix}params/", names, Sharded(dp, dp.master) if dp is not None
         and dp.master is not None else params),
        (f"{prefix}mu/", names, Sharded(dp, adam.mu_flat) if dp is not None and dp.sharded
         else adam.mu),
        (f"{prefix}nu/", names, Sharded(dp, adam.nu_flat) if dp is not None and dp.sharded
         else adam.nu),
    ]
    if isinstance(opt, MultiSteps):
        groups.append((f"{prefix}acc/", names, all_reduce_mean_list(opt.acc) if mean_acc
                       else opt.acc))
    return groups


# Each kind of training state, its checkpoint's format tag.
FORMATS = {
    "Stage2State": "gmdx_torch.stage2.v1",
    "Stage1State": "gmdx_torch.stage1.v1",
    "ControlNetState": "gmdx_torch.controlnet.v1",
}


def _describe(state, mean_acc: bool = False):
    """(format tag, groups, scalars, [(key prefix, optimizer)]) of a
    Stage-2 or ControlNet state (one module's trainable parameters under
    one optimizer, and the EMA) or a Stage-1 state (the trainables, keyed
    by LoRA name and ``conv_out``, under the generator's optimizer, the
    discriminator's parameters under its own and its spectral-norm
    buffers, and the EMA of the trainables); a group is (key prefix,
    names, full tensors or this rank's shard); ``mean_acc`` takes the
    accumulators' mean over the ranks (what a save keeps)."""
    kind = type(state).__name__
    if kind not in FORMATS:
        raise TypeError(f"no checkpoint layout for {kind}")
    groups = []
    if kind == "Stage1State":
        from gmdx_torch.train.stage1 import trainable_names

        names = trainable_names(state.trainables)
        disc = state.discriminator
        opts = [("gen_", names, state.optimizer),
                ("disc_", [n for n, _ in disc.named_parameters()], state.disc_optimizer)]
        buffers = list(disc.named_buffers())
        groups.append(("disc_buffers/", [n for n, _ in buffers], [b for _, b in buffers]))
    else:
        module = state.unet if kind == "Stage2State" else state.controlnet
        names = [n for n, p in module.named_parameters() if p.requires_grad]
        opts = [("", names, state.optimizer)]
    scalars = {"step": state.step,
               "ema_step": None if state.ema is None else state.ema.step}
    for prefix, group_names, opt in opts:
        groups.extend(_optimizer_groups(prefix, group_names, opt, mean_acc))
        scalars[f"{prefix}count"] = _adam(opt).count
        scalars[f"{prefix}mini_step"] = opt.mini_step if isinstance(opt, MultiSteps) else None
    if state.ema is not None:
        dp = data_parallel(_adam(opts[0][2]))
        groups.append(("ema/", names, Sharded(state.ema.dp, state.ema.flat)
                       if state.ema.dp is not None
                       else Sliced(dp, state.ema.shadow) if dp is not None and dp.sliced is not None
                       else state.ema.shadow))
    return FORMATS[kind], groups, scalars, [(prefix, opt) for prefix, _, opt in opts]


def state_tensors(state) -> tuple[dict[str, torch.Tensor], dict[str, Any]]:
    """A training state's tensors (keyed by role and name; live references,
    or full copies of the sharded ones, gathered from every rank: call it
    on every rank) and scalars: a Stage-2, Stage-1 or ControlNet state."""
    _, groups, scalars, _ = _describe(state)
    tensors = {}
    for prefix, names, value in groups:
        full = (value.dp.full(value.flat) if isinstance(value, Sharded)
                else value.dp.whole(value.tensors) if isinstance(value, Sliced) else value)
        tensors.update({f"{prefix}{n}": t for n, t in zip(names, full)})
    return tensors, scalars


def state_digest(state) -> str:
    """:func:`tensor_digest` of the state's tensors, equal at any world
    size (across ranks a collective: call it on every rank)."""
    targets = _targets(_describe(state)[1])
    return _dist_digest(targets) if is_initialized() else tensor_digest(targets)


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

    def _host_buffers(self, specs: dict[str, tuple], pinned: bool) -> dict[str, torch.Tensor]:
        """Host tensors of ``specs`` (key -> (shape, dtype)): views of one
        pinned buffer, kept for later saves of the same layout (its last
        write has ended before a save reaches here), else new tensors."""
        if not pinned:
            return {k: torch.empty(shape, dtype=dtype) for k, (shape, dtype) in specs.items()}
        if {k: _spec(v) for k, v in self._staging.items()} != specs:
            self._staging = {}  # the old buffer goes before the new one is taken
            sizes = {k: -(-math.prod(shape) * dtype.itemsize // 64) * 64
                     for k, (shape, dtype) in specs.items()}
            flat = torch.empty(sum(sizes.values()), dtype=torch.uint8, pin_memory=True)
            offset = 0
            for k, (shape, dtype) in specs.items():
                n = math.prod(shape) * dtype.itemsize
                self._staging[k] = flat[offset:offset + n].view(dtype).view(shape)
                offset += sizes[k]
        return self._staging

    def _to_host(self, tensors: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Host copies of ``tensors``, finished when this returns: from the
        card into the pinned buffers, else clones."""
        if not any(t.is_cuda for t in tensors.values()):
            return {k: t.detach().clone() for k, t in tensors.items()}
        staging = self._host_buffers({k: _spec(t) for k, t in tensors.items()}, pinned=True)
        for k, t in tensors.items():
            staging[k].copy_(t.detach(), non_blocking=True)
        torch.cuda.synchronize()
        return staging

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
        self._dispatch(step, self._to_host(tensors), meta, wait)

    def _dispatch(self, step: int, host: dict, meta: dict, wait: bool) -> None:
        if self.async_checkpointing and not wait:
            self._thread = threading.Thread(target=self._run, args=(step, host, meta))
            self._thread.start()
        else:
            self._write(step, host, meta)

    def save_groups(self, step: int, groups: list, scalars: dict, *, fmt: str,
                    wait: bool = True) -> str:
        """The save of a state spread over the ranks (a collective: every
        rank calls it): the sharded groups gathered to rank 0 bucket by
        bucket, the digest summed over the ranks, the one-process format
        written by rank 0 (its disk write on a thread when asynchronous
        and ``wait`` is False; otherwise the ranks wait for it). Returns
        the digest."""
        self.wait_until_finished()
        targets = _targets(groups)
        digest = _dist_digest(targets)
        main = rank() == 0
        cuda = any(_is_cuda(t) for t in targets.values())
        host = None
        if main:
            host = self._host_buffers({k: _spec(t) for k, t in targets.items()}, pinned=cuda)
        for prefix, names, value in groups:
            dests = [host[f"{prefix}{n}"] for n in names] if main else None
            if isinstance(value, Sharded):
                _gather_shards(value, dests)
            elif isinstance(value, Sliced):
                for i, t in enumerate(value.dp.whole(value.tensors)):
                    if main:
                        dests[i].copy_(t.detach(), non_blocking=True)
            elif main:
                for d, t in zip(dests, value):
                    d.copy_(t.detach(), non_blocking=True)
        if cuda:
            torch.cuda.synchronize()
        if main:
            meta = {"format": fmt, "global_step": int(step), "scalars": scalars,
                    "digest": digest}
            self._dispatch(step, host, meta, wait)
        if not (self.async_checkpointing and not wait):
            barrier("gmdx_checkpoint")
        return digest

    def wait_until_finished(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, step: int, into: dict, *, fmt: str) -> dict:
        """Copy the saved tensors into ``into`` (same keys, shapes and
        dtypes, in place; across ranks a value may be this rank's part of
        a key's tensor); returns the metadata. Raises if the checkpoint's
        format tag is not ``fmt`` (another kind of state), or if the bits
        read differ from the bits saved."""
        path = self.path(step)
        with open(os.path.join(path, _META)) as f:
            meta = json.load(f)
        if meta.get("format") != fmt:
            raise ValueError(f"{path}: a {meta.get('format')!r} checkpoint; the run restores "
                             f"a {fmt!r} state")
        cuda = any(_is_cuda(t) for t in into.values())
        saved = load_file(os.path.join(path, _TENSORS), pin_memory=cuda)
        if set(saved) != set(into):
            raise ValueError(f"{path}: holds {len(saved)} tensors, the run {len(into)}; "
                             f"missing {sorted(set(into) - set(saved))[:5]}, extra "
                             f"{sorted(set(saved) - set(into))[:5]} (another model, or another "
                             f"--use_ema / --gradient_accumulation_steps?)")
        with torch.no_grad():
            for k, t in into.items():
                src = saved[k] if isinstance(saved[k], torch.Tensor) else torch.from_numpy(saved[k])
                shape, dtype = _spec(t)
                if tuple(src.shape) != tuple(shape) or src.dtype != dtype:
                    raise ValueError(f"{path}: {k} is {src.dtype} {tuple(src.shape)}, the run's "
                                     f"{dtype} {tuple(shape)} (another --use_8bit_adam?)")
                if isinstance(t, _Slice):
                    t.view.copy_(tp_slice(t.key, src, t.ctx.rank, t.ctx.size),
                                 non_blocking=True)
                elif isinstance(t, _Part):
                    if t.view is not None:
                        t.view.copy_(src.reshape(-1)[t.a:t.b], non_blocking=True)
                else:
                    t.copy_(src, non_blocking=True)
        if cuda:
            torch.cuda.synchronize()  # the pinned buffer goes when this returns
        digest = _dist_digest(into) if is_initialized() else tensor_digest(into)
        if digest != meta["digest"]:
            raise ValueError(f"{path}: the restored tensors' digest differs from the saved one")
        return meta


def _gather_shards(value: Sharded, dests: list[torch.Tensor] | None) -> None:
    """Every rank's shard of ``value`` into the full host tensors ``dests``
    (rank 0's; None on the others), one bucket's all-gather at a time."""
    dp = value.dp
    for lo, hi in dp.layout.buckets():
        out = torch.empty(dp.world * (hi - lo), dtype=value.flat.dtype,
                          device=value.flat.device)
        torch.distributed.all_gather_into_tensor(out, value.flat[lo:hi])
        out = out.view(dp.world, hi - lo)
        if dests is None:
            continue
        for r in range(dp.world):
            for i, a, b, s in dp.layout.spans(r, lo, hi):
                dests[i].view(-1)[a:b].copy_(out[r, s - lo:s - lo + b - a], non_blocking=True)


def make_manager(output_dir: str, *, max_to_keep: int | None = None,
                 async_checkpointing: bool = False) -> CheckpointManager:
    return CheckpointManager(output_dir, max_to_keep=max_to_keep,
                             async_checkpointing=async_checkpointing)


def save_state(manager: CheckpointManager, step: int, state, *, wait: bool = True) -> str:
    """Checkpoint a Stage-2, Stage-1 or ControlNet state at ``step`` (the
    global step: optimizer updates) under its kind's format tag; returns
    the digest of the saved tensors. Across ranks every rank calls it."""
    if is_initialized():
        fmt, groups, scalars, _ = _describe(state, mean_acc=True)
        return manager.save_groups(step, groups, scalars, fmt=fmt, wait=wait)
    fmt, groups, scalars, _ = _describe(state)
    tensors = _targets(groups)
    manager.save(step, tensors, scalars, fmt=fmt, wait=wait)
    return tensor_digest(tensors)


def restore_state(manager: CheckpointManager, step: int, state):
    """Load checkpoint ``step`` into ``state`` in place (the state the run
    built: its parameters, moments, accumulators, spectral-norm buffers and
    EMA shadow, or this rank's shards of them, are overwritten) and return
    it. A checkpoint of another kind of state raises, naming both format
    tags."""
    fmt, groups, _, optimizers = _describe(state)
    scalars = manager.restore(step, _targets(groups), fmt=fmt)["scalars"]
    state.step = scalars["step"]
    for prefix, opt in optimizers:
        _adam(opt).count = scalars[f"{prefix}count"]
        if isinstance(opt, MultiSteps):
            opt.mini_step = scalars[f"{prefix}mini_step"]
            layout = getattr(data_parallel(_adam(opt)), "layout_ctx", None)
            if layout is not None and layout.mode == "sp" and layout.rank:
                # sp sums the model group's accumulators at the update: the
                # saved one lives on its first rank.
                for a in opt.acc:
                    a.zero_()
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
    "state_digest",
    "tensor_digest",
    "FORMATS",
]
