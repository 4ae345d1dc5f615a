"""Data-parallel training over the ranks of a process group.

Counterpart of ``gmdx/dist/mesh.py``. The JAX package annotates shardings
on a 1-D ``data`` mesh and lets XLA place the collectives; the port's train
steps are functional (their gradients come from ``torch.autograd.grad``,
so no ``DistributedDataParallel`` reducer ever sees them), and the
collectives are written out here, on bucketed flat buffers:

* ``ddp``: everything replicated; the gradients are all-reduced and
  averaged over the ranks.
* ``zero1``: the optimizer moments are sharded; the gradients are
  reduce-scattered, each rank updates its shard of the parameters and the
  parameters are all-gathered.
* ``fsdp``: the fp32 parameters and the EMA are sharded too; the full
  parameters are gathered for a step (:meth:`DataParallel.gathered`) and
  their storage freed after it.

A list of tensors is laid out as one flat range of ``world * chunk``
elements (:class:`ShardLayout`, the tail zero-padded); rank r owns
``[r * chunk, (r + 1) * chunk)``. AdamW and the EMA are elementwise, so
each rank steps its shard as a list of pieces (a piece: the part of one
tensor that falls in the shard) and the numbers are those of the
replicated update (under gradient accumulation a rank's accumulator of
local gradients stays whole: it is reduced once, at the update). The
module's own tensors stay separate allocations:
the kernels never see a view into a flat buffer, so their 16-byte
alignment needs hold. The data-parallel size is the world size; the
global batch is the per-rank batch times it, and a rank takes rows
``[r * B / N, (r + 1) * B / N)`` (:func:`shard_batch`). Random draws of a
step are made for the global batch's shape from a generator seeded alike
on every rank and sliced to the rank's rows (:func:`randn_rows`), so an
N-rank step is the 1-rank step on the global batch.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import itertools
import math
from typing import Sequence

import torch
import torch.distributed as dist

from gmdx_torch.dist.multihost import is_initialized, rank, world_size

STRATEGIES = ("ddp", "zero1", "fsdp")
# Tensor and spatial parallelism: a slice of their own (ROADMAP.md).
TP_SP_ITEM = "ROADMAP Queue 1 item 9"
BUCKET_BYTES = 128 << 20


def check_strategy(strategy: str) -> None:
    if strategy in ("tp", "sp"):
        raise NotImplementedError(
            f"--shard_strategy {strategy}: tensor and spatial parallelism are not in the "
            f"port yet ({TP_SP_ITEM}: `gmdx/dist/{{tp,tpctx}}.py` -> torch.distributed)")
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown shard strategy {strategy!r}")


def data_parallel_size() -> int:
    return world_size()


def batch_rows(local_rows: int) -> tuple[int, int] | None:
    """(first row, rows of the global batch) of this rank's slice of a
    global batch of ``local_rows`` a rank; None outside a process group."""
    n = world_size()
    return (rank() * local_rows, n * local_rows) if is_initialized() else None


def shard_batch(batch: dict, index: int | None = None, count: int | None = None) -> dict:
    """Rows ``[i * B / n, (i + 1) * B / n)`` of every leaf of a global
    batch (``index``, ``count`` default to this rank and the world size)."""
    i = rank() if index is None else index
    n = world_size() if count is None else count
    if n == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if v.shape[0] % n:
            raise ValueError(f"{n} ranks do not divide the global batch of {v.shape[0]} rows")
        local = v.shape[0] // n
        out[k] = v[i * local:(i + 1) * local]
    return out


def randn_rows(shape, generator: torch.Generator, rows: tuple[int, int] | None, *,
               device, dtype=torch.float32) -> torch.Tensor:
    """``torch.randn(shape)``; with ``rows = (start, total)``, rows
    ``[start, start + shape[0])`` of one draw for ``total`` rows."""
    if rows is None:
        return torch.randn(shape, generator=generator, device=device, dtype=dtype)
    start, total = rows
    full = torch.randn((total, *shape[1:]), generator=generator, device=device, dtype=dtype)
    return full[start:start + shape[0]]


def randint_rows(high: int, b: int, generator: torch.Generator,
                 rows: tuple[int, int] | None, *, device) -> torch.Tensor:
    """``torch.randint(0, high, (b,))``, sliced from a global draw as
    :func:`randn_rows`."""
    if rows is None:
        return torch.randint(0, high, (b,), generator=generator, device=device)
    start, total = rows
    return torch.randint(0, high, (total,), generator=generator, device=device)[start:start + b]


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the ranks (a new tensor; ``t`` itself in a
    single process)."""
    if world_size() == 1:
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out.div_(world_size())


def _runs(numels: Sequence[int], bucket: int) -> list[list[int]]:
    """Consecutive indices grouped into runs of at most ``bucket``
    elements (a longer tensor alone)."""
    runs, cur, size = [], [], 0
    for i, n in enumerate(numels):
        if cur and size + n > bucket:
            runs.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += n
    return runs + ([cur] if cur else [])


@torch.no_grad()
def all_reduce_mean_list(tensors: list, *, bucket_bytes: int = BUCKET_BYTES,
                         consume: bool = False) -> list[torch.Tensor]:
    """The mean over the ranks of each of ``tensors`` (new tensors, views
    into bucketed flat buffers; ``consume`` empties the list's entries as
    their bucket is packed, so their memory can go)."""
    if world_size() == 1:
        return list(tensors)
    n = world_size()
    out = [None] * len(tensors)
    esize = tensors[0].element_size() if tensors else 4
    for idx in _runs([t.numel() for t in tensors], max(1, bucket_bytes // esize)):
        shapes = [tensors[i].shape for i in idx]
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        if consume:
            for i in idx:
                tensors[i] = None
        dist.all_reduce(flat)
        flat.div_(n)
        for i, v, shape in zip(idx, flat.split([math.prod(sh) for sh in shapes]), shapes):
            out[i] = v.view(shape)
    return out


class ShardLayout:
    """Tensors of ``numels`` elements, one after another in a flat range
    split into ``world`` shards of ``chunk`` elements, walked in buckets of
    at most ``bucket`` elements of a shard."""

    def __init__(self, numels: Sequence[int], world: int, rank_: int, bucket: int):
        self.numels = [int(n) for n in numels]
        self.offsets = [0, *itertools.accumulate(self.numels)]
        self.total = self.offsets[-1]
        self.world, self.rank = world, rank_
        self.chunk = max(1, -(-self.total // world))
        self.bucket = max(1, min(bucket, self.chunk))

    def buckets(self) -> list[tuple[int, int]]:
        return [(lo, min(lo + self.bucket, self.chunk))
                for lo in range(0, self.chunk, self.bucket)]

    def spans(self, r: int, lo: int = 0, hi: int | None = None) -> list[tuple[int, int, int, int]]:
        """(i, a, b, s): elements ``[a, b)`` of tensor i lie at
        ``[s, s + b - a)`` of rank r's shard, for the part of the shard in
        ``[lo, hi)``."""
        hi = self.chunk if hi is None else hi
        start, end = r * self.chunk + lo, min(r * self.chunk + hi, self.total)
        out = []
        i = max(0, bisect.bisect_right(self.offsets, start) - 1)
        while i < len(self.numels) and self.offsets[i] < end:
            off = self.offsets[i]
            a, b = max(start, off) - off, min(end, off + self.numels[i]) - off
            if b > a:
                out.append((i, a, b, off + a - r * self.chunk))
            i += 1
        return out


@dataclasses.dataclass
class Sharded:
    """A list of tensors held as this rank's shard: the flat buffer of
    :class:`DataParallel` ``dp``'s layout (checkpoints gather it)."""

    dp: "DataParallel"
    flat: torch.Tensor


class DataParallel:
    """The collectives of one list of trainable tensors (the module's own,
    full ones) under ``strategy``: gradient reduction, the norm of a
    reduced gradient, the parameters' gather after an update (zero1) or
    around a step (fsdp), and full copies of shards."""

    def __init__(self, tensors: Sequence[torch.Tensor], strategy: str, *,
                 bucket_bytes: int = BUCKET_BYTES):
        check_strategy(strategy)
        self.tensors = list(tensors)
        dtypes = {t.dtype for t in self.tensors}
        if len(dtypes) != 1:
            raise ValueError(f"one dtype a parameter list, got {sorted(map(str, dtypes))}")
        self.dtype = dtypes.pop()
        self.device = self.tensors[0].device
        self.strategy = strategy
        self.world, self.rank = world_size(), rank()
        esize = self.tensors[0].element_size()
        self.layout = ShardLayout([t.numel() for t in self.tensors], self.world, self.rank,
                                  bucket_bytes // esize)
        self.sharded = strategy in ("zero1", "fsdp")
        self.own = self.layout.spans(self.rank)
        # The tensors whose last elements (on any rank) a bucket holds: a
        # gradient can go once that bucket is reduced.
        last = {}
        for k, (lo, hi) in enumerate(self.layout.buckets()):
            for r in range(self.world):
                for i, *_ in self.layout.spans(r, lo, hi):
                    last[i] = k
        self._done_after = [[i for i, k_ in last.items() if k_ == k]
                            for k in range(len(self.layout.buckets()))]
        self._gathered = 0
        self.master = None
        if strategy == "fsdp":
            self.master = self.shard_of(self.tensors)
            self.release()

    # --- layout -----------------------------------------------------------

    def new_shard(self, dtype: torch.dtype | None = None) -> torch.Tensor:
        return torch.zeros(self.layout.chunk, dtype=dtype or self.dtype, device=self.device)

    def pieces(self, flat: torch.Tensor) -> list[torch.Tensor]:
        """This rank's pieces, as views into its shard buffer ``flat``."""
        return [flat[s:s + b - a] for _, a, b, s in self.own]

    def piece_index(self) -> list[int]:
        """The tensor index of each of this rank's pieces."""
        return [i for i, *_ in self.own]

    def views(self, tensors: Sequence[torch.Tensor], r: int | None = None, lo: int = 0,
              hi: int | None = None) -> list[torch.Tensor]:
        """Views of the parts of full ``tensors`` that lie in rank r's
        shard (this rank's by default) within ``[lo, hi)``."""
        r = self.rank if r is None else r
        return [tensors[i].view(-1)[a:b] for i, a, b, _ in self.layout.spans(r, lo, hi)]

    def shard_of(self, tensors: Sequence[torch.Tensor], dtype=None) -> torch.Tensor:
        """A new shard buffer holding this rank's part of full ``tensors``."""
        flat = self.new_shard(dtype or tensors[0].dtype)
        with torch.no_grad():
            if self.own:
                torch._foreach_copy_(self.pieces(flat), self.views(tensors))
        return flat

    def _fill(self, out: torch.Tensor, tensors, r: int, lo: int, hi: int) -> None:
        """Rank r's shard of ``tensors`` over ``[lo, hi)`` into ``out``,
        zeros where the flat range has no tensor (the tail)."""
        parts = [tensors[i].reshape(-1)[a:b] for i, a, b, _ in self.layout.spans(r, lo, hi)]
        pad = (hi - lo) - sum(p.numel() for p in parts)
        if pad:
            parts.append(torch.zeros(pad, dtype=out.dtype, device=out.device))
        torch.cat(parts, out=out)

    # --- gradients --------------------------------------------------------

    @torch.no_grad()
    def reduce(self, grads: list) -> list[torch.Tensor]:
        """The mean over the ranks of local gradients ``grads`` (one per
        tensor; the list is emptied as buckets go, so their memory can):
        full tensors under ddp, this rank's pieces under zero1 and fsdp."""
        if not self.sharded:
            return all_reduce_mean_list(grads, bucket_bytes=self.layout.bucket
                                        * self.tensors[0].element_size(), consume=True)
        n = self.world
        shard = self.new_shard()
        for k, (lo, hi) in enumerate(self.layout.buckets()):
            # 1-D buffers: gloo takes the leading dimension as the ranks'.
            inp = torch.empty(n * (hi - lo), dtype=self.dtype, device=self.device)
            for r, row in enumerate(inp.view(n, hi - lo)):
                self._fill(row, grads, r, lo, hi)
            dist.reduce_scatter_tensor(shard[lo:hi], inp)
            for i in self._done_after[k]:
                grads[i] = None
        grads.clear()
        return self.pieces(shard.div_(n))

    @torch.no_grad()
    def sq_norms(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """Each tensor's squared gradient norm, from :meth:`reduce`'s
        output (summed over the ranks' pieces when sharded)."""
        norms = torch.stack(torch._foreach_norm([g.float() for g in grads])) ** 2
        if not self.sharded:
            return norms
        index = torch.tensor(self.piece_index(), device=self.device, dtype=torch.long)
        out = torch.zeros(len(self.tensors), device=self.device).index_add_(0, index, norms)
        dist.all_reduce(out)
        return out

    @torch.no_grad()
    def global_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global norm of a gradient in :meth:`reduce`'s form."""
        norms = torch.stack(torch._foreach_norm([g.float() for g in grads]))
        if not self.sharded:
            return torch.linalg.vector_norm(norms)
        sq = (norms**2).sum()
        dist.all_reduce(sq)
        return sq.sqrt()

    # --- parameters -------------------------------------------------------

    @torch.no_grad()
    def gather_into(self, tensors: Sequence[torch.Tensor], flat: torch.Tensor | None) -> None:
        """All ranks' shards into full ``tensors``: from the shard buffer
        ``flat``, else from the tensors' own part on each rank (zero1,
        after each rank updated its part in place)."""
        n = self.world
        for lo, hi in self.layout.buckets():
            if flat is None:
                inp = torch.empty(hi - lo, dtype=self.dtype, device=self.device)
                self._fill(inp, tensors, self.rank, lo, hi)
            else:
                inp = flat[lo:hi]
            out = torch.empty(n * (hi - lo), dtype=inp.dtype, device=self.device)
            dist.all_gather_into_tensor(out, inp)
            out = out.view(n, hi - lo)
            for r in range(n):
                spans = self.layout.spans(r, lo, hi)
                if spans:
                    src = out[r, :spans[-1][3] + spans[-1][2] - spans[-1][1] - lo]
                    torch._foreach_copy_([tensors[i].view(-1)[a:b] for i, a, b, _ in spans],
                                         list(src.split([b - a for _, a, b, _ in spans])))

    def after_update(self) -> None:
        """zero1: every rank's updated part of the parameters to all."""
        if self.strategy == "zero1":
            self.gather_into(self.tensors, None)

    def release(self) -> None:
        """fsdp: free the full parameters' storage (kept: the tensors)."""
        for t in self.tensors:
            if not t.untyped_storage().resizable():
                # Host memory a numpy array has seen (a file's bytes, a
                # save) stays fixed: the tensor takes storage of its own.
                t.data = torch.empty_like(t.data)
            t.untyped_storage().resize_(0)

    def materialize(self) -> None:
        """fsdp: the full parameters again, gathered from the master
        shards (a copy: each tensor's version moves, so caches keyed on it
        see new weights)."""
        for t in self.tensors:
            t.untyped_storage().resize_(t.numel() * t.element_size())
        self.gather_into(self.tensors, self.master)

    @contextlib.contextmanager
    def gathered(self):
        """The full parameters for the block (fsdp; always there otherwise);
        nested blocks gather once."""
        if self.strategy != "fsdp":
            yield
            return
        if self._gathered == 0:
            self.materialize()
        self._gathered += 1
        try:
            yield
        finally:
            self._gathered -= 1
            if self._gathered == 0:
                self.release()

    @torch.no_grad()
    def full(self, flat: torch.Tensor) -> list[torch.Tensor]:
        """Full tensors from a shard buffer, on every rank."""
        out = [torch.empty(t.shape, dtype=flat.dtype, device=self.device)
               for t in self.tensors]
        self.gather_into(out, flat)
        return out


def _adam(opt):
    return getattr(opt, "opt", opt)


# gmdx's state fields of each trainer's state, as (optimizer attribute, role).
_FIELDS = {
    "Stage2State": {"params": ("optimizer", "params"), "opt_state": ("optimizer", "moments"),
                    "ema": ("optimizer", "ema")},
    "ControlNetState": {"params": ("optimizer", "params"),
                        "opt_state": ("optimizer", "moments"), "ema": ("optimizer", "ema")},
    "Stage1State": {"trainables": ("optimizer", "params"),
                    "disc_params": ("disc_optimizer", "params"),
                    "opt_state": ("optimizer", "moments"),
                    "disc_opt_state": ("disc_optimizer", "moments"),
                    "ema": ("optimizer", "ema")},
}


def apply_shard_strategy(state, strategy: str, *, param_fields: Sequence[str],
                         opt_fields: Sequence[str], bucket_bytes: int = BUCKET_BYTES):
    """Distribute a train state over the ranks per ``--shard_strategy``,
    with gmdx's field lists of the trainer (Stage 2 and ControlNet:
    ``("params", "ema")``, ``("opt_state",)``; Stage 1: ``("trainables",
    "disc_params", "ema")``, ``("opt_state", "disc_opt_state")``). ddp
    replicates everything; zero1 shards ``opt_fields``; fsdp shards
    ``param_fields`` too. Each of the state's optimizers gets a
    :class:`DataParallel` of its parameters (in a group of one process
    too: its collectives then run on one rank). Outside a process group
    the state is returned as it is; tp and sp raise."""
    check_strategy(strategy)
    if not is_initialized():
        return state
    kind = type(state).__name__
    fields = _FIELDS[kind]
    unknown = (set(param_fields) | set(opt_fields)) - set(fields)
    if unknown:
        raise ValueError(f"{kind} has no field(s) {sorted(unknown)}")
    sharded = (set() if strategy == "ddp" else set(opt_fields)) | (
        set(param_fields) if strategy == "fsdp" else set())
    for attr in dict.fromkeys(a for a, _ in fields.values()):
        roles = {role for f, (a, role) in fields.items() if a == attr and f in sharded}
        if "params" in roles and "moments" not in roles:
            raise ValueError(f"{kind}.{attr}: sharded parameters need sharded moments")
        mode = "fsdp" if "params" in roles else "zero1" if "moments" in roles else "ddp"
        if "ema" in roles and mode != "fsdp":
            raise ValueError(f"{kind}: the EMA shards with the parameters (fsdp) only")
        adam = _adam(getattr(state, attr))
        dp = DataParallel(adam.params, mode, bucket_bytes=bucket_bytes)
        adam.distribute(dp)
        if "ema" in roles and state.ema is not None:
            state.ema.distribute(dp)
    return state


__all__ = [
    "STRATEGIES",
    "TP_SP_ITEM",
    "check_strategy",
    "data_parallel_size",
    "batch_rows",
    "shard_batch",
    "randn_rows",
    "randint_rows",
    "all_reduce_mean",
    "all_reduce_mean_list",
    "ShardLayout",
    "Sharded",
    "DataParallel",
    "apply_shard_strategy",
]
