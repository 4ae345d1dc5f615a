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
``tp_kernel_context``), and set with :func:`parallel_context`; :func:`active`
is None outside one. A model whose weights are slices raises
outside a ``"tp"`` context rather than compute with them.
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
def parallel_context(mode: str, group=None):
    """Split the layers called in the block over ``group`` (the default
    process group when None) in ``mode`` ("tp" or "sp")."""
    if mode not in MODES:
        raise ValueError(f"parallel mode is one of {MODES}, got {mode!r}")
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(f"a {mode} context needs a torch.distributed process group")
    prev = active()
    _state.ctx = ParallelContext(mode, group, dist.get_world_size(group), dist.get_rank(group))
    try:
        yield _state.ctx
    finally:
        _state.ctx = prev


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


__all__ = ["MODES", "ParallelContext", "active", "tp_active", "sp_active",
           "parallel_context", "join_model_parallel"]
