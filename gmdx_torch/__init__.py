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


__all__ = ["resolve_device"]
