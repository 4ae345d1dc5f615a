"""VGG19 feature extractor of the Stage-1 perceptual loss.

Counterpart of ``gmdx/models/vgg.py``: configuration E, NCHW input in
[0, 1] with the ImageNet normalisation folded in, returning the five
post-ReLU stage maps before each max pool. Plain ``nn.Conv2d`` (torchvision
naming, ``features.<idx>``), as the JAX package uses ``nn.Conv``; the
parameters may be kept in another dtype than the activations (``dtype``)
and are cast at use.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# Channels per conv, "M" = 2x2 max pool.
VGG19_LAYOUT = (
    64, 64, "M",
    128, 128, "M",
    256, 256, 256, 256, "M",
    512, 512, 512, 512, "M",
    512, 512, 512, 512, "M",
)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


class VGG19Features(nn.Module):
    """(B, 3, H, W) in [0, 1] -> the five stage maps (NCHW) of the loss.
    ``features`` holds torchvision's indices (conv at 0, 2, 5, ...; ReLU and
    pool layers are parameter-free and not stored)."""

    def __init__(self, dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = dtype
        self.features = nn.ModuleDict()
        in_ch, idx = 3, 0
        for spec in VGG19_LAYOUT:
            if spec == "M":
                idx += 1
            else:
                self.features[str(idx)] = nn.Conv2d(in_ch, spec, 3, padding=1)
                in_ch = spec
                idx += 2

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        dt = self.compute_dtype or x.dtype
        mean = torch.as_tensor(IMAGENET_MEAN, device=x.device).view(1, 3, 1, 1)
        std = torch.as_tensor(IMAGENET_STD, device=x.device).view(1, 3, 1, 1)
        h = ((x.to(dt) - mean.to(dt)) / std.to(dt))
        feats = []
        convs = iter(self.features.values())
        for spec in VGG19_LAYOUT:
            if spec == "M":
                feats.append(h)
                h = F.max_pool2d(h, 2, 2)
            else:
                conv = next(convs)
                h = F.relu(F.conv2d(h, conv.weight.to(dt), conv.bias.to(dt), padding=1))
        return feats


def perceptual_loss(feats_a: Sequence[torch.Tensor], feats_b: Sequence[torch.Tensor]) -> torch.Tensor:
    """Mean over the stages of the fp32 MSE between the two pyramids."""
    total = 0.0
    for fa, fb in zip(feats_a, feats_b):
        total = total + torch.mean((fa.float() - fb.float()) ** 2)
    return total / len(feats_a)


def resize_for_vgg(x: torch.Tensor, resolution: int = 224, ctx=None) -> torch.Tensor:
    """(B, 3, H, W) -> (B, 3, resolution, resolution) by PyTorch's default
    ``F.interpolate`` rule, ``nearest`` with floor indexing: source index
    ``floor(i * in / out)`` (the JAX package's ``torch_nearest``), computed
    here as the JAX package computes it, in float64 on the host.

    Under spatial parallelism (``ctx``; ``x`` this rank's H rows of equal
    slices) every rank gets the whole resized image: each places the output
    rows whose source rows it holds (a contiguous run) and the group sums
    the placed images, whose gradient is every rank's cotangent summed
    (:func:`~gmdx_torch.dist.mesh.all_reduce_sum`), back to the rows read."""
    _, _, h, w = x.shape
    n = 1 if ctx is None else ctx.size
    ih = np.minimum((np.arange(resolution) * (h * n / resolution)).astype(np.int64), h * n - 1)
    iw = np.minimum((np.arange(resolution) * (w / resolution)).astype(np.int64), w - 1)
    iw = torch.as_tensor(iw, device=x.device)
    if ctx is None:
        return x.index_select(2, torch.as_tensor(ih, device=x.device)).index_select(3, iw)
    from gmdx_torch.dist.mesh import all_reduce_sum

    mine = np.flatnonzero((ih >= ctx.rank * h) & (ih < (ctx.rank + 1) * h))
    lo, hi = (int(mine[0]), int(mine[-1]) + 1) if mine.size else (0, 0)
    rows = torch.as_tensor(ih[lo:hi] - ctx.rank * h, device=x.device)
    part = x.index_select(2, rows).index_select(3, iw)
    return all_reduce_sum(F.pad(part, (0, 0, lo, resolution - hi)), ctx)


__all__ = ["VGG19Features", "VGG19_LAYOUT", "perceptual_loss", "resize_for_vgg"]
