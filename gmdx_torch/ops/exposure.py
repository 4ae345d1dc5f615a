"""Camera-exposure simulation: the augmentation of Stage-1 training.

Counterpart of ``gmdx/ops/exposure.py``. The chain is the same: an inverse
sigmoid camera curve ``((sigma * y) / (1 + sigma - y + 1e-8)) ** (1 / n)``
with n ~ N(0.65, 0.1) clipped to [0.4, 0.9] and sigma ~ N(0.6, 0.1) clipped
to [0.4, 0.8], uint16 discretisation (round half to even, as ``jnp.round``),
an exposure drawn from {0.1, 0.25, 0.5, 1, 4, 8, 16},
``clip(img * exposure, 0, 1) ** (1 / gamma)``, applied with probability
``prob``; one draw per call, shared by the batch.

An explicit CPU ``torch.Generator`` replaces the JAX key, and the gate, the
exposure level, n and sigma are drawn on the host as float32 values: the
chain on a batch on the card then forces no synchronisation, and a call the
gate skips launches nothing. Each call draws the same four numbers in the
same order whether or not the gate applies them.
"""

from __future__ import annotations

import numpy as np
import torch

EXPOSURE_LEVELS = np.array([0.1, 0.25, 0.5, 1.0, 4.0, 8.0, 16.0], dtype=np.float32)


def _f32(x) -> float:
    """``x`` rounded to float32, as a Python float (exact in float32)."""
    return float(np.float32(x))


def sample_camera_curve(generator: torch.Generator) -> tuple[float, float]:
    """Draw the (n, sigma) curve parameters, clipped normals, as float32
    values."""
    z = torch.randn(2, generator=generator, dtype=torch.float32)
    n = torch.clamp(0.65 + 0.1 * z[0], 0.4, 0.9)
    sigma = torch.clamp(0.6 + 0.1 * z[1], 0.4, 0.8)
    return float(n), float(sigma)


def apply_inv_sigmoid_curve(y: torch.Tensor, n: float, sigma: float) -> torch.Tensor:
    """The inverse sigmoid camera curve; ``1 / n`` is taken in float32, as
    the JAX package takes it."""
    inv_n = _f32(np.float32(1.0) / np.float32(n))
    sigma = _f32(sigma)
    return ((sigma * y) / ((1.0 + sigma) - y + 1e-8)) ** inv_n


def discretize_to_uint16(img: torch.Tensor) -> torch.Tensor:
    max_int = 2**16 - 1
    return torch.round(torch.clamp(img * max_int, 0, max_int)) / max_int


def hdr_to_ldr(img: torch.Tensor, exposure: float, gamma: float = 2.2) -> torch.Tensor:
    return torch.clamp(img * _f32(exposure), 0.0, 1.0) ** _f32(1.0 / gamma)


def random_exposure_adjust(
    generator: torch.Generator,
    imgs: torch.Tensor,
    *,
    gamma: float = 2.2,
    prob: float = 1.0,
) -> tuple[torch.Tensor, dict[str, float]]:
    """Apply the exposure chain to ``imgs`` (any shape, values in [0, 1])
    with one draw from the CPU ``generator`` shared by the batch.

    Returns ``(ldr_imgs, metadata)``: ``metadata`` holds the applied
    ``exposure`` / ``n`` / ``sigma`` as floats, the identity values 1, 1
    and 0 when the gate skips (and ``imgs`` itself is returned). The gate
    applies when a uniform draw ``u < prob`` (gmdx: ``<=``; they differ only
    at ``u = 0``)."""
    u = float(torch.rand((), generator=generator, dtype=torch.float32))
    level = int(torch.randint(0, len(EXPOSURE_LEVELS), (), generator=generator))
    n, sigma = sample_camera_curve(generator)
    if not u < prob:
        return imgs, {"exposure": 1.0, "n": 1.0, "sigma": 0.0}
    exposure = float(EXPOSURE_LEVELS[level])
    linear = discretize_to_uint16(apply_inv_sigmoid_curve(imgs, n, sigma))
    return hdr_to_ldr(linear, exposure, gamma), {"exposure": exposure, "n": n, "sigma": sigma}


class RandomExposureAdjust:
    """The class form: ``__call__(generator, imgs, return_metadata=False)``."""

    def __init__(self, gamma: float = 2.2, prob: float = 1.0):
        self.gamma = gamma
        self.prob = prob
        self.exposure_levels = EXPOSURE_LEVELS

    def __call__(self, generator: torch.Generator, imgs: torch.Tensor, *,
                 return_metadata: bool = False):
        out, meta = random_exposure_adjust(generator, imgs, gamma=self.gamma, prob=self.prob)
        return (out, meta) if return_metadata else out

    sample_camera_curve = staticmethod(sample_camera_curve)
    apply_inv_sigmoid_curve = staticmethod(apply_inv_sigmoid_curve)
    discretize_to_uint16 = staticmethod(discretize_to_uint16)

    def hdr_to_ldr(self, img: torch.Tensor, exposure: float) -> torch.Tensor:
        return hdr_to_ldr(img, exposure, gamma=self.gamma)

    def __repr__(self) -> str:
        return (f"{type(self).__name__}(gamma={self.gamma}, prob={self.prob}, "
                f"exposure_levels={self.exposure_levels.tolist()})")


__all__ = [
    "EXPOSURE_LEVELS",
    "sample_camera_curve",
    "apply_inv_sigmoid_curve",
    "discretize_to_uint16",
    "hdr_to_ldr",
    "random_exposure_adjust",
    "RandomExposureAdjust",
]
