"""The model-parallel context: which process group splits each layer, and how.

Counterpart of ``gmdx/dist/tpctx.py``. The JAX package carries a mesh whose
``model`` axis GSPMD partitions; the port carries the model axis's process
group, its size and this process's rank in it, and the mode:

* ``"tp"`` (tensor parallelism): the layers' weights are this rank's slices
  (``gmdx_torch.dist.tp``); attention runs head-parallel on the attention
  kernels and GroupNorm, the 3x3 conv and the GEGLU FF take library calls,
  as the JAX package's dispatch does under ``tp_kernel_context``
  (:func:`gmdx_torch.kernels.attention.tp_route`).
* ``"sp"`` (spatial parallelism): the weights are whole; every image-shaped
  activation is this rank's rows of the image (``gmdx_torch.dist.mesh``:
  :func:`~gmdx_torch.dist.mesh.spatial_rows`); the convs read their halo
  rows from the neighbouring ranks, attention gathers K and V, GroupNorm
  merges each rank's statistics.

The context is thread-local, as the JAX module's is (its
``tp_kernel_context``), and set with :func:`parallel_context` (serving:
one model group) or :func:`entered` (training's data x model grid,
:func:`join_train_parallel`, whose context also carries the data axis);
:func:`active` is None outside one. A model whose weights are slices raises
outside a ``"tp"`` context rather than compute with them. Under autograd
the layers' collectives are ``autograd.Function``s whose backward issues
the adjoint collective (``gmdx_torch.dist.tp``, ``gmdx_torch.dist.mesh``),
and a remat block's recompute enters the context it was called in.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch.distributed as dist

MODES = ("tp", "sp")


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    mode: str
    group: object  # the model axis's ProcessGroup (None: the default group)
    size: int
    rank: int
    # Training's data axis (:func:`join_train_parallel`): the ranks that hold
    # this rank's model index in every model group; a group of one in serving.
    data_group: object = None
    data_size: int = 1
    data_rank: int = 0


_state = threading.local()


def active() -> ParallelContext | None:
    """The innermost active context, or None."""
    return getattr(_state, "ctx", None)


def tp_active() -> ParallelContext | None:
    """The active context when it is tensor-parallel over more than one rank."""
    ctx = active()
    return ctx if ctx is not None and ctx.mode == "tp" and ctx.size > 1 else None


def sp_active() -> ParallelContext | None:
    """The active context when it is spatial-parallel over more than one rank."""
    ctx = active()
    return ctx if ctx is not None and ctx.mode == "sp" and ctx.size > 1 else None


@contextlib.contextmanager
def entered(ctx: ParallelContext | None):
    """The block inside ``ctx``. None: outside any context, also inside a
    layout's block: a module that the JAX package replicates over a tp
    layout (the ControlNet trainer's frozen UNet, which takes the
    ControlNet's residuals whole, after their row-parallel sums) runs whole
    on every rank, with the one-process routes."""
    prev = active()
    _state.ctx = ctx
    try:
        yield ctx
    finally:
        _state.ctx = prev


def parallel_context(mode: str, group=None):
    """Split the layers called in the block over ``group`` (the default
    process group when None) in ``mode`` ("tp" or "sp")."""
    if mode not in MODES:
        raise ValueError(f"parallel mode is one of {MODES}, got {mode!r}")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"a {mode} context needs a torch.distributed process group")
    return entered(ParallelContext(mode, group, dist.get_world_size(group),
                                   dist.get_rank(group)))


def join_model_parallel(tp_size: int = 1, sp_size: int = 1):
    """The inference CLIs' ``--tp_size``/``--sp_size``: ``(mode, group, rank
    in the group, size)`` for :func:`parallel_context` and the weight
    slices, or None for one process. Joins the process group from
    torchrun's environment (or uses the one already joined) and raises
    where the world does not fit, as the JAX scripts raise where the width
    does not divide the device count: TP needs a world that the width
    divides (groups of consecutive ranks; the groups beyond the first
    repeat its work, as the JAX package's replicated data axis does), SP a
    world of exactly the width (a rank cannot sit out of the split)."""
    if tp_size > 1 and sp_size > 1:
        raise ValueError("--tp_size and --sp_size are mutually exclusive")
    width = max(tp_size, sp_size)
    if width <= 1:
        return None
    from gmdx_torch.dist import multihost

    multihost.initialize()
    n, rank = multihost.world_size(), multihost.rank()
    if n % width:
        raise ValueError(f"--tp_size/--sp_size {width} does not divide the world size ({n}): "
                         f"run under torchrun --nproc_per_node with a multiple of it")
    if sp_size > 1:
        if n != width:
            raise ValueError(f"--sp_size {width} needs a world of exactly {width} ranks, got "
                             f"{n}: a rank cannot sit out of the spatial split")
        return "sp", None, rank, width
    group = None
    if n > width:  # every rank makes every group, in the same order
        groups = [dist.new_group(list(range(g, g + width))) for g in range(0, n, width)]
        group = groups[rank // width]
    return "tp", group, rank % width, width


def join_train_parallel(strategy: str, size: int) -> ParallelContext:
    """The trainers' ``--shard_strategy tp|sp`` with ``--tp_size``/
    ``--sp_size`` ``size``: the ranks as a data x model grid of
    ``(world / size, size)``, the model axis innermost (ranks r and r + 1
    share a model group, as the JAX package's ``make_train_mesh`` lays its
    mesh out), joined from torchrun's environment or the group already
    joined. Every rank makes every model group and every data group, in the
    same order. Returns this rank's context: its model group, size and
    index, and its data group, size and index."""
    if strategy not in MODES:
        raise ValueError(f"a train layout is one of {MODES}, got {strategy!r}")
    from gmdx_torch.dist import multihost
    from gmdx_torch.dist.mesh import check_group_size

    multihost.initialize()
    n, rank = multihost.world_size(), multihost.rank()
    check_group_size(strategy, size, n)
    models = [dist.new_group(list(range(g, g + size))) for g in range(0, n, size)]
    datas = [dist.new_group(list(range(m, n, size))) for m in range(size)]
    return ParallelContext(strategy, models[rank // size], size, rank % size,
                           datas[rank % size], n // size, rank // size)


__all__ = ["MODES", "ParallelContext", "active", "tp_active", "sp_active", "entered",
           "parallel_context", "join_model_parallel", "join_train_parallel"]
