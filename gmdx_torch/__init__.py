"""gmdx_torch: the PyTorch/CUDA port of gmdx for NVIDIA Hopper (H100).

Mirrors ``gmdx``'s layout (kernels, models, schedulers, pipelines, ops, io).
It imports torch, numpy and the standard library only, never JAX or gmdx.
Entry points run on the card (``device="cuda"``) unless the caller asks for
the CPU; without a card they raise rather than fall back.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on: raises for CUDA without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gmdx_torch: CUDA requested but no card is available; "
            "pass device='cpu' to run the plain PyTorch versions"
        )
    return dev


def stream_seed(*keys: int) -> int:
    """A generator seed from non-negative integer keys, the counterpart of
    ``jax.random.fold_in``: a trainer seeds each batch's generator from
    (--seed, batch index), so that a resumed run draws what an
    uninterrupted one would."""
    import numpy as np

    return int(np.random.SeedSequence(list(keys)).generate_state(1, np.uint64)[0]
               & 0x7FFF_FFFF_FFFF_FFFF)


__all__ = ["resolve_device", "stream_seed"]
