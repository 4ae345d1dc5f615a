"""The hop between two pipeline stages: a tensor from a rank to its peer.

Rank i of the first stage and rank i + half of the second form a two-rank
pair group (:func:`pair_groups`); the first sends (:func:`send`), the
second receives into a buffer of the known shape (:func:`recv`). The hop
is one ``broadcast`` over the pair, from the sender: a collective that
gloo carries for tensors on a card as well as on the CPU (gloo has no
send/recv for tensors on a card, and the one-card checks run two gloo
ranks on one card) and that NCCL carries between cards, so the same call
serves both; it sends each byte once. The sender issues it asynchronously
and keeps the work: under NCCL neither its host nor its stream waits for
the peer, under gloo its host does not. The receiver's call returns once
the tensor is there (gloo) or once its stream waits for it (NCCL).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def pair_groups(half: int) -> list:
    """The two-rank groups {i, i + half} for i < ``half``; every rank of
    the world makes every one, in the same order."""
    return [dist.new_group([i, i + half]) for i in range(half)]


def send(t: torch.Tensor, group, src: int):
    """Issue ``t`` (contiguous) from this rank, ``src`` (its global rank), to
    its peer in ``group``; returns the work, to be waited on before the
    sender leaves its loop."""
    return dist.broadcast(t.contiguous(), src=src, group=group, async_op=True)


def recv(shape, group, src: int, *, device, dtype=torch.float32) -> torch.Tensor:
    """The tensor of ``shape`` and ``dtype`` that ``src`` sends over ``group``."""
    out = torch.empty(tuple(shape), dtype=dtype, device=device)
    dist.broadcast(out, src=src, group=group)
    return out


__all__ = ["pair_groups", "send", "recv"]
