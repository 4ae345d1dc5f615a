"""Process-group utilities of multi-process training.

Counterpart of ``gmdx/dist/multihost.py`` on ``torch.distributed``: one
process a card, joined by :func:`initialize` from torchrun's environment
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``)
or from explicit arguments; ``nccl`` between cards and ``gloo`` on the CPU
unless ``backend=`` says otherwise. The group is made with a long timeout
(:data:`TIMEOUT`), so a rank that reaches its first collective minutes
after another (a cold kernel build, a latent cache built by rank 0) is
waited for rather than failed, as ``coordination_barrier`` does in the JAX
package. Every helper is a no-op in a process outside a group.
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os

import torch
import torch.distributed as dist

logger = logging.getLogger("gmdx_torch.dist")

# How long a collective (the barrier included) waits for the slowest rank.
TIMEOUT = datetime.timedelta(minutes=30)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def local_rank() -> int:
    """This process's index among the processes of its host: torchrun's
    ``LOCAL_RANK``, else the rank modulo the host's card count (two ranks
    on one card share it, as the one-card checks run them under gloo)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return rank() % max(1, n)


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, *, backend: str | None = None) -> bool:
    """Join the process group; returns whether it joined one. Explicit
    arguments (``host:port``, the process count, this process's rank) win;
    else torchrun's environment (``MASTER_ADDR`` / ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``, any size, one process included); without either it
    is a no-op returning False, and the run stays the plain one-process
    run. With a card, the process takes ``cuda:<local rank>`` as its
    current device. Safe to call twice."""
    if is_initialized():
        return True
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    if coordinator_address is None and num_processes is None and process_id is None:
        if "WORLD_SIZE" not in os.environ or "MASTER_PORT" not in os.environ:
            return False
        # env:// takes torchrun's store (its agent serves MASTER_PORT).
        dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
    else:
        if coordinator_address is None or num_processes is None or process_id is None:
            raise ValueError("initialize() takes all three of coordinator_address, "
                             "num_processes and process_id, or none")
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id, timeout=TIMEOUT)
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank())
    logger.info("torch.distributed: rank %d of %d over %s", rank(), world_size(), backend)
    return True


def device(requested: str | torch.device = "cuda") -> torch.device:
    """The device of this process: ``cuda:<local rank>`` for a card request
    in a process group, else ``requested``."""
    dev = torch.device(requested)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def is_main_process() -> bool:
    return rank() == 0


def barrier(name: str = "gmdx") -> None:
    """Block until every rank arrives (accelerate's ``wait_for_everyone``)."""
    del name  # the JAX package's barriers are named; a process group's are not
    if world_size() > 1:
        dist.barrier()


@contextlib.contextmanager
def main_process_first(name: str = "gmdx_mpf"):
    """Rank 0 runs the body before the others start theirs (the
    reference's dataset-preparation gate)."""
    if world_size() == 1:
        yield
        return
    if is_main_process():
        yield
        barrier(name)
    else:
        barrier(name)
        yield


def broadcast_from_main(obj):
    """Rank 0's ``obj`` (any picklable value: tensors come back on this
    rank's device) on every rank."""
    if world_size() == 1:
        return obj
    box = [obj if is_main_process() else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def shutdown() -> None:
    """Leave the process group (at the end of a trainer's run)."""
    if is_initialized():
        dist.destroy_process_group()


__all__ = [
    "TIMEOUT",
    "initialize",
    "is_initialized",
    "world_size",
    "rank",
    "local_rank",
    "device",
    "is_main_process",
    "barrier",
    "main_process_first",
    "broadcast_from_main",
    "shutdown",
]
