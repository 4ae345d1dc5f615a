"""Data-parallel training over the ranks of a process group, and the
spatial split of an image's rows.

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

The spatial half (``spatial_sharding`` and ``shard_batch_spatial``'s
counterparts, for serving): an image's H rows split evenly over the ranks
(:func:`spatial_rows`, :func:`shard_rows`, :func:`gather_rows`); the rows
above and below a rank's slab come from its neighbours by one all-gather of
every rank's edge rows (:func:`halo_rows`, :func:`fill_halo`: gloo, which
runs two ranks on one card, has no send/recv for tensors on a card); random
draws are the whole image's, sliced (:func:`randn_spatial`). Under
autograd each collective's backward is its adjoint: a gathered image's
gradient is every rank's cotangent summed, then the rank's rows; a halo
row's goes back to the rank whose row it is.

The trainers' tp and sp (:func:`apply_shard_strategy` with the data x
model layout of ``tpctx.join_train_parallel``): tp slices the UNet's or
the ControlNet's parameters, moments and EMA by ``gmdx_torch.dist.tp``'s
rule (a Stage-1 state has no leaf the rule matches: the model axis holds
replicas, as in the JAX package), sp keeps them whole; either way
:class:`DataParallel` averages the gradient over the data axis alone (under
sp after summing each model group's rows' shares), and takes the norm of
the whole gradient. The spatial collectives are twice differentiable: each
backward is an autograd Function, the forward's transpose, whose own
backward is the forward (Stage 1's gradient penalty differentiates the
discriminator's input gradient).
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
# Tensor and spatial parallelism: a trainer's data x model grid.
MODEL_STRATEGIES = ("tp", "sp")
BUCKET_BYTES = 128 << 20


def check_group_size(strategy: str, size: int, n: int) -> None:
    """``gmdx/dist/mesh.py:make_train_mesh``'s check: a model group of
    ``size`` >= 2 ranks that divides the ``n`` ranks."""
    if size < 2 or n % size:
        raise ValueError(f"--shard_strategy {strategy} needs a group size >= 2 dividing the "
                         f"device count ({n}); got {size}")


def check_strategy(strategy: str) -> None:
    """Raise for a ``--shard_strategy`` other than the data-parallel ones
    (:data:`STRATEGIES`), which lay the ranks out as one flat group. tp /
    sp take a data x model grid (``tpctx.join_train_parallel``, whose group
    size :func:`check_group_size` checks)."""
    if strategy in MODEL_STRATEGIES:
        raise ValueError(f"--shard_strategy {strategy} lays the ranks out as a data x model "
                         f"grid (tpctx.join_train_parallel), not one flat group")
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown shard strategy {strategy!r}")


def data_parallel_size() -> int:
    return world_size()


def batch_rows(local_rows: int, layout=None) -> tuple[int, int] | None:
    """(first row, rows of the global batch) of this rank's slice of a
    global batch of ``local_rows`` a rank; None outside a process group.
    Under a data x model ``layout`` (``tpctx.join_train_parallel``) the
    batch splits over the data axis alone."""
    if layout is not None:
        return layout.data_rank * local_rows, layout.data_size * local_rows
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
               device, dtype=torch.float32, spatial=None) -> torch.Tensor:
    """``torch.randn(shape)``; with ``rows = (start, total)``, rows
    ``[start, start + shape[0])`` of one draw for ``total`` rows; with
    ``spatial = (ctx, h_dim)`` (spatial parallelism) ``shape`` is this
    rank's image rows, and the draw is the whole image's, sliced to them."""
    full = list(shape)
    if spatial is not None:
        full[spatial[1]] *= spatial[0].size
    if rows is not None:
        full[0] = rows[1]
    out = torch.randn(full, generator=generator, device=device, dtype=dtype)
    if rows is not None:
        out = out[rows[0]:rows[0] + shape[0]]
    return out if spatial is None else shard_rows(out, *spatial)


def randint_rows(high: int, b: int, generator: torch.Generator,
                 rows: tuple[int, int] | None, *, device) -> torch.Tensor:
    """``torch.randint(0, high, (b,))``, sliced from a global draw as
    :func:`randn_rows`."""
    if rows is None:
        return torch.randint(0, high, (b,), generator=generator, device=device)
    start, total = rows
    return torch.randint(0, high, (total,), generator=generator, device=device)[start:start + b]


# --- spatial parallelism: the image's rows over the ranks -----------------


def spatial_rows(h: int, rank_: int, n: int) -> tuple[int, int]:
    """Rows ``[start, stop)`` of an image of ``h`` rows that rank ``rank_``
    of ``n`` holds under spatial parallelism (the counterpart of
    ``spatial_sharding``'s H split). Rows that do not split evenly raise:
    the convs' halos and the stride-2 levels assume equal slices."""
    if h % n:
        raise ValueError(f"{h} image rows do not split evenly over {n} ranks")
    rows = h // n
    return rank_ * rows, (rank_ + 1) * rows


def shard_rows(x: torch.Tensor, ctx, h_dim: int = 2) -> torch.Tensor:
    """This rank's rows (along ``h_dim``; NCHW by default) of a whole image
    that every rank holds (``shard_batch_spatial``'s placement)."""
    start, stop = spatial_rows(x.shape[h_dim], ctx.rank, ctx.size)
    return x.narrow(h_dim, start, stop - start).contiguous()


def all_gather_stacked(t: torch.Tensor, ctx) -> torch.Tensor:
    """Every rank's ``t`` of ``ctx``'s group, stacked in rank order:
    (size, *t.shape), by one all-gather of flat buffers (gloo takes a
    tensor's leading dimension as the ranks')."""
    t = t.contiguous()
    out = torch.empty((ctx.size, t.numel()), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out.view(-1), t.view(-1), group=ctx.group)
    return out.view(ctx.size, *t.shape)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx):
        fctx.ctx = ctx
        y = x.contiguous().clone()
        dist.all_reduce(y, group=ctx.group)
        return y

    @staticmethod
    def backward(fctx, g):
        return _AllReduceSum.apply(g, fctx.ctx), None


def all_reduce_sum(x: torch.Tensor, ctx) -> torch.Tensor:
    """The sum of ``x`` over ``ctx``'s group, on every rank (a new tensor).
    Each rank uses the sum in its own way (its share of a loss), so the
    gradient of a rank's ``x`` is every rank's cotangent of the sum,
    summed: the same collective (``torch.distributed.nn.functional``'s
    ``all_reduce``), differentiable again."""
    return _AllReduceSum.apply(x, ctx)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, ctx, h_dim):
        fctx.ctx, fctx.h_dim = ctx, h_dim
        return torch.cat(list(all_gather_stacked(x, ctx).unbind(0)), dim=h_dim)

    @staticmethod
    def backward(fctx, g):
        return _RowsOfSum.apply(g, fctx.ctx, fctx.h_dim), None, None


class _RowsOfSum(torch.autograd.Function):
    """:class:`_GatherRows`' transpose: every rank's whole ``g`` summed (one
    all-reduce: gloo has no reduce-scatter for tensors on a card), then
    this rank's rows."""

    @staticmethod
    def forward(fctx, g, ctx, h_dim):
        fctx.ctx, fctx.h_dim = ctx, h_dim
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        rows = g.shape[h_dim] // ctx.size
        return g.narrow(h_dim, ctx.rank * rows, rows)

    @staticmethod
    def backward(fctx, gg):
        return _GatherRows.apply(gg, fctx.ctx, fctx.h_dim), None, None


def gather_rows(x: torch.Tensor, ctx, h_dim: int = 2) -> torch.Tensor:
    """The whole image, on every rank, from each rank's rows ``x`` (one
    all-gather: gloo has no gather for tensors on a card); any tensor split
    into equal slices along ``h_dim`` in rank order. Each rank uses the
    whole in its own way (its queries against every rank's keys), so the
    gradient of a rank's rows is every rank's cotangent of them: one
    all-reduce of the whole cotangent, then this rank's rows."""
    return _GatherRows.apply(x, ctx, h_dim)


def _exchange(up: torch.Tensor, down: torch.Tensor, ctx, h_dim: int = 1):
    """(the previous rank's ``down``, the next rank's ``up``), None at the
    image's top and bottom edge: one all-gather of every rank's rows ``up``
    (for the rank above) and ``down`` (for the rank below), stacked along
    H (``h_dim``; gloo has no send/recv for tensors on a card)."""
    rows = all_gather_stacked(torch.cat([up, down], dim=h_dim), ctx)
    k, m = up.shape[h_dim], down.shape[h_dim]
    prev = rows[ctx.rank - 1].narrow(h_dim, k, m) if ctx.rank > 0 else None
    nxt = rows[ctx.rank + 1].narrow(h_dim, 0, k) if ctx.rank < ctx.size - 1 else None
    return prev, nxt


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(fctx, x, top, bottom, ctx, h_dim):
        fctx.args = (top, bottom, ctx, h_dim)
        h = x.shape[h_dim]
        prev, nxt = _exchange(x.narrow(h_dim, 0, bottom), x.narrow(h_dim, h - top, top), ctx,
                              h_dim)

        def zeros(k):
            shape = list(x.shape)
            shape[h_dim] = k
            return x.new_zeros(shape)

        return torch.cat([zeros(top) if prev is None else prev, x,
                          zeros(bottom) if nxt is None else nxt], dim=h_dim)

    @staticmethod
    def backward(fctx, g):
        return (_HaloRowsT.apply(g, *fctx.args),) + (None,) * 4


class _HaloRowsT(torch.autograd.Function):
    """:class:`_HaloRows`' transpose: the halo rows' cotangents go back to
    the ranks whose rows they are, added to their edge rows."""

    @staticmethod
    def forward(fctx, g, top, bottom, ctx, h_dim):
        fctx.args = (top, bottom, ctx, h_dim)
        h = g.shape[h_dim] - top - bottom
        prev, nxt = _exchange(g.narrow(h_dim, 0, top), g.narrow(h_dim, top + h, bottom), ctx,
                              h_dim)
        dx = g.narrow(h_dim, top, h).clone()
        if prev is not None:  # the rank above read our first rows as its bottom halo
            dx.narrow(h_dim, 0, bottom).add_(prev)
        if nxt is not None:  # the rank below read our last rows as its top halo
            dx.narrow(h_dim, h - top, top).add_(nxt)
        return dx

    @staticmethod
    def backward(fctx, gg):
        return (_HaloRows.apply(gg, *fctx.args),) + (None,) * 4


def halo_rows(x: torch.Tensor, top: int, bottom: int, ctx, h_dim: int = 1) -> torch.Tensor:
    """Rows ``x`` (NHWC, H at ``h_dim`` 1; NCHW with ``h_dim`` 2) with
    ``top`` rows of the previous rank above and ``bottom`` rows of the next
    rank below (zeros past the image's edges): what a conv of this rank's
    output rows reads. The halo rows' gradient goes back to the ranks whose
    rows they are, added to their edge rows."""
    h = x.shape[h_dim]
    if top > h or bottom > h:
        raise ValueError(f"a halo of {max(top, bottom)} rows over {h} local rows")
    return _HaloRows.apply(x, top, bottom, ctx, h_dim)


class _FillHalo(torch.autograd.Function):
    @staticmethod
    def forward(fctx, xp, ctx):
        fctx.ctx = ctx
        fctx.mark_dirty(xp)
        h = xp.shape[1] - 2
        prev, nxt = _exchange(xp[:, 1:2], xp[:, h:h + 1], ctx)
        if prev is not None:
            xp[:, :1] = prev
        if nxt is not None:
            xp[:, h + 1:] = nxt
        return xp

    @staticmethod
    def backward(fctx, g):
        return _FillHaloT.apply(g, fctx.ctx), None


class _FillHaloT(torch.autograd.Function):
    """:class:`_FillHalo`' transpose: the border rows' cotangents go back to
    the neighbours whose edge rows they are."""

    @staticmethod
    def forward(fctx, g, ctx):
        fctx.ctx = ctx
        h = g.shape[1] - 2
        prev, nxt = _exchange(g[:, :1], g[:, h + 1:], ctx)
        dxp = g.clone()
        dxp[:, :1] = 0  # the border rows were replaced: none of xp's reaches the output
        dxp[:, h + 1:] = 0
        if prev is not None:
            dxp[:, 1:2] += prev
        if nxt is not None:
            dxp[:, h:h + 1] += nxt
        return dxp

    @staticmethod
    def backward(fctx, gg):
        return _FillHalo.apply(gg.clone(), fctx.ctx), None


def fill_halo(xp: torch.Tensor, ctx) -> torch.Tensor:
    """A 1-px padded NHWC slab ``xp`` (B, h + 2, W + 2, C) with its top and
    bottom border rows replaced, in place, by the neighbouring ranks' edge
    rows (left as zeros at the image's edges): the conv kernel's
    ``pre_padded`` input for this rank's rows. The cotangent of each border
    row goes back to the neighbour whose edge row it is, added to that
    row's."""
    return _FillHalo.apply(xp, ctx)


def randn_spatial(shape, generator: torch.Generator, ctx, h_dim: int, *, device,
                  dtype=torch.float32) -> torch.Tensor:
    """This rank's rows of one ``torch.randn`` draw for the whole image
    whose rank-local shape is ``shape``: every rank draws what one process
    would and keeps its rows, so a spatially split run samples the noise of
    an unsplit one."""
    return randn_rows(shape, generator, None, device=device, dtype=dtype,
                      spatial=(ctx, h_dim))


def spatial_batch(batch: dict, ctx) -> dict:
    """This rank's image rows of a batch of tensors or host arrays
    (``shard_batch_spatial``'s placement): every leaf of 4 dimensions or
    more (NCHW images, latents) split along H over ``ctx``'s group,
    contiguous; ids and embeddings whole."""
    def rows(v):
        start, stop = spatial_rows(v.shape[2], ctx.rank, ctx.size)
        part = v[:, :, start:stop]
        return part.contiguous() if isinstance(part, torch.Tensor) else part.copy()

    return {k: rows(v) if v.ndim >= 4 else v for k, v in batch.items()}


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
                         consume: bool = False, group=None,
                         sum_group=None) -> list[torch.Tensor]:
    """The mean over the ranks (of ``group``; None: all) of each of
    ``tensors`` (new tensors, views into bucketed flat buffers; ``consume``
    empties the list's entries as their bucket is packed, so their memory
    can go); with ``sum_group``, summed over that group's ranks first."""
    n = world_size() if group is None else dist.get_world_size(group)
    if n == 1 and sum_group is None:
        return list(tensors)
    out = [None] * len(tensors)
    esize = tensors[0].element_size() if tensors else 4
    for idx in _runs([t.numel() for t in tensors], max(1, bucket_bytes // esize)):
        shapes = [tensors[i].shape for i in idx]
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        if consume:
            for i in idx:
                tensors[i] = None
        if sum_group is not None:
            dist.all_reduce(flat, group=sum_group)
        if n > 1:
            dist.all_reduce(flat, group=group)
            flat.div_(n)
        for i, v, shape in zip(idx, flat.split([math.prod(sh) for sh in shapes]), shapes):
            out[i] = v.view(shape)
    return out


def layout_mean(tensors: list, layout=None, **kw) -> list[torch.Tensor]:
    """What one process would take of ``tensors`` (each rank's values of its
    part of the global batch): their mean over the ranks; under a data x
    model ``layout`` (``tpctx.join_train_parallel``) over its data axis,
    under sp each rank's rows' share summed over its model group first (tp's
    group holds replicas). New tensors where a collective ran, else
    ``tensors``' own; ``kw`` as :func:`all_reduce_mean_list`'s."""
    if layout is None:
        return all_reduce_mean_list(tensors, **kw)
    return all_reduce_mean_list(tensors, group=layout.data_group,
                                sum_group=layout.group if layout.mode == "sp" else None, **kw)


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
    around a step (fsdp), and full copies of shards.

    Under a data x model ``layout`` (``tpctx.join_train_parallel``; the
    strategy is then ddp over the data axis) the gradients' mean is taken
    over the data group alone. Under sp each rank's gradient is its rows'
    share, summed over the model group first. Under tp the tensors named
    ``names`` are this rank's slices of leaves of ``full_shapes`` where the
    slicing rule says so (``sliced``; None where it slices none): their
    norms are summed over the model group, and :meth:`whole` gathers them."""

    def __init__(self, tensors: Sequence[torch.Tensor], strategy: str, *,
                 bucket_bytes: int = BUCKET_BYTES, layout=None, names=None, full_shapes=None):
        check_strategy(strategy)
        if layout is not None and strategy != "ddp":
            raise ValueError(f"a data x model layout takes ddp over its data axis, not {strategy}")
        self.layout_ctx = layout
        self.names, self.full_shapes = names, full_shapes
        self.sliced = None
        if layout is not None and layout.mode == "tp" and names is not None:
            from gmdx_torch.dist.tp import is_sliced

            sliced = [is_sliced(n, sh, layout.size) for n, sh in zip(names, full_shapes)]
            self.sliced = sliced if any(sliced) else None
        self.tensors = list(tensors)
        dtypes = {t.dtype for t in self.tensors}
        if len(dtypes) != 1:
            raise ValueError(f"one dtype a parameter list, got {sorted(map(str, dtypes))}")
        self.dtype = dtypes.pop()
        self.device = self.tensors[0].device
        self.strategy = strategy
        self.world, self.rank = ((world_size(), rank()) if layout is None
                                 else (layout.data_size, layout.data_rank))
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
            return layout_mean(grads, self.layout_ctx, consume=True,
                               bucket_bytes=self.layout.bucket * self.tensors[0].element_size())
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
        if self.sliced is not None:  # a slice's share of its leaf's, summed over the slices
            mask = torch.tensor(self.sliced, device=norms.device)
            part = torch.where(mask, norms, 0.0)
            dist.all_reduce(part, group=self.layout_ctx.group)
            return torch.where(mask, part, norms)
        if not self.sharded:
            return norms
        index = torch.tensor(self.piece_index(), device=self.device, dtype=torch.long)
        out = torch.zeros(len(self.tensors), device=self.device).index_add_(0, index, norms)
        dist.all_reduce(out)
        return out

    @torch.no_grad()
    def global_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global norm of a gradient in :meth:`reduce`'s form."""
        if self.sliced is not None:
            return self.sq_norms(grads).sum().sqrt()
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
    def whole(self, tensors: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """The whole leaves of ``tensors`` (one per tensor, in this layout's
        order): tp's slices gathered over the model group, the rest as they
        are (a collective of the model group under tp)."""
        if self.sliced is None:
            return list(tensors)
        from gmdx_torch.dist.tp import gather_slices

        return [gather_slices(n, t, sh, self.layout_ctx)
                for n, t, sh in zip(self.names, tensors, self.full_shapes)]

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


def _model_parallel(state, strategy: str, layout, bucket_bytes: int):
    """tp / sp of a trainer's state over ``layout``'s data x model grid.
    tp: the UNet's (Stage 2) or the ControlNet's parameters, the
    optimizer's moments and accumulator and the EMA become this rank's
    slices (``dist.tp``'s rule, the JAX package's ``tp_shard_params``); a
    Stage-1 state holds no leaf the rule matches (gmdx keys its LoRA
    factors by path tuples, and the discriminator's convs have other
    names), so each rank of a model group holds the whole of it, a replica.
    sp: all stay whole. Each optimizer's gradient mean goes over the data
    axis (:class:`DataParallel`'s layout)."""
    kind = type(state).__name__
    if kind not in _FIELDS:
        raise TypeError(f"--shard_strategy {strategy}: no layout for a {kind}")
    if layout is None or layout.mode != strategy:
        raise ValueError(f"--shard_strategy {strategy} needs its data x model layout "
                         f"(tpctx.join_train_parallel)")
    if kind == "Stage1State":
        for opt in (state.optimizer, state.disc_optimizer):
            adam = _adam(opt)
            adam.distribute(DataParallel(adam.params, "ddp", bucket_bytes=bucket_bytes,
                                         layout=layout))
        return state
    module, opt = (state.unet if kind == "Stage2State" else state.controlnet), state.optimizer
    adam = _adam(opt)
    names = [n for n, p in module.named_parameters() if p.requires_grad]
    if len(names) != len(adam.params):
        raise ValueError(f"the optimizer holds {len(adam.params)} tensors, the module "
                         f"{len(names)} trainable parameters")
    shapes = [tuple(p.shape) for p in adam.params]
    if strategy == "tp":
        from gmdx_torch.dist.tp import tp_shard_module, tp_slice

        def cut(i, t):
            return tp_slice(names[i], t, layout.rank, layout.size)

        tp_shard_module(module, layout.rank, layout.size)
        own = dict(module.named_parameters())
        adam.reslice([own[n] for n in names], cut)
        if hasattr(opt, "acc"):
            opt.acc = [cut(i, a) for i, a in enumerate(opt.acc)]
        if state.ema is not None:
            state.ema.shadow = [cut(i, t) for i, t in enumerate(state.ema.shadow)]
    adam.distribute(DataParallel(adam.params, "ddp", bucket_bytes=bucket_bytes, layout=layout,
                                 names=names, full_shapes=shapes))
    return state


def apply_shard_strategy(state, strategy: str, *, param_fields: Sequence[str],
                         opt_fields: Sequence[str], bucket_bytes: int = BUCKET_BYTES,
                         layout=None):
    """Distribute a train state over the ranks per ``--shard_strategy``,
    with gmdx's field lists of the trainer (Stage 2 and ControlNet:
    ``("params", "ema")``, ``("opt_state",)``; Stage 1: ``("trainables",
    "disc_params", "ema")``, ``("opt_state", "disc_opt_state")``). ddp
    replicates everything; zero1 shards ``opt_fields``; fsdp shards
    ``param_fields`` too. Each of the state's optimizers gets a
    :class:`DataParallel` of its parameters (in a group of one process
    too: its collectives then run on one rank). Outside a process group
    the state is returned as it is. tp and sp take the data x model
    ``layout`` of ``tpctx.join_train_parallel`` (:func:`_model_parallel`)."""
    if strategy in MODEL_STRATEGIES:
        return _model_parallel(state, strategy, layout, bucket_bytes)
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
    "MODEL_STRATEGIES",
    "check_group_size",
    "check_strategy",
    "layout_mean",
    "data_parallel_size",
    "batch_rows",
    "shard_batch",
    "randn_rows",
    "randint_rows",
    "spatial_rows",
    "shard_rows",
    "all_gather_stacked",
    "all_reduce_sum",
    "gather_rows",
    "halo_rows",
    "fill_halo",
    "randn_spatial",
    "spatial_batch",
    "all_reduce_mean",
    "all_reduce_mean_list",
    "ShardLayout",
    "Sharded",
    "DataParallel",
    "apply_shard_strategy",
]
