"""Tone-mapping operators, elementwise.

Counterpart of ``gmdx/ops/tmo.py``: the peak rescale, the hard clip, the
mu-law curves (mu = 500 fixed, mu = 5000 on ``clip(x / 10)``, mu ~ U(500,
5000) drawn from an explicit ``torch.Generator``) and ITU-R BT.2446-0
Method A; :func:`choose_tmo` is the Stage-1 CLI's mapping from
``--bright_tmo`` / ``--tmo_2446a`` (``scripts/stage1/train_vqgan_lora.py:
142-160``).
"""

from __future__ import annotations

import math
from typing import Callable

import torch


def linear_scale_tmo(img: torch.Tensor, qmax: float) -> torch.Tensor:
    """Scale an HDR tensor back to [0, 1] by the peak ``qmax + 1``."""
    return img / (qmax + 1.0)


def hard_clip_tmo(hdr_img: torch.Tensor, qmax: float | None = None) -> torch.Tensor:
    """Clamp to [0, 1]; ``qmax`` is ignored (kept for the signature)."""
    del qmax
    return hdr_img.clamp(0.0, 1.0)


def fix_mulog_tmo(hdr_img: torch.Tensor, qmax: float) -> torch.Tensor:
    """mu-law curve with mu = 500 after the peak rescale, clamped."""
    x = hdr_img / (qmax + 1.0)
    mu = 500.0
    return (torch.log1p(mu * x) / math.log1p(mu)).clamp(0.0, 1.0)


def mulog_tmo(hdr_img: torch.Tensor) -> torch.Tensor:
    """mu = 5000 curve on ``clip(img / 10, 0, 1)``."""
    x = (hdr_img / 10.0).clamp(0.0, 1.0)
    mu = 5000.0
    return torch.log1p(mu * x) / math.log1p(mu)


def random_tmo(generator: torch.Generator, hdr_img: torch.Tensor, qmax: float) -> torch.Tensor:
    """mu-law curve with mu ~ U(500, 5000) drawn from ``generator`` (on the
    image's device), after the peak rescale, clamped."""
    x = hdr_img / (qmax + 1.0)
    u = torch.rand((), generator=generator, device=generator.device, dtype=torch.float32)
    mu = (500.0 + 4500.0 * u).to(device=x.device, dtype=x.dtype)
    return (torch.log1p(mu * x) / torch.log1p(mu)).clamp(0.0, 1.0)


# BT.2020 luminance weights.
_BT2020_Y = (0.2627, 0.6780, 0.0593)


def tmo_2446a(
    hdr_img: torch.Tensor,
    *,
    l_hdr: float = 1000.0,
    l_sdr: float = 100.0,
    alpha: float = 0.05,
    eps: float = 1e-6,
    channel_axis: int = 1,
) -> torch.Tensor:
    """ITU-R BT.2446-0 Method A HDR -> SDR tone mapping: crosstalk, BT.2020
    luminance, gamma and perceptual log at the HDR peak, the three-segment
    knee, the inverse at the SDR peak, a per-pixel gain, inverse crosstalk.
    Input is linear HDR with 1.0 = ``l_hdr`` nits; output linear SDR in
    [0, 1]."""
    x = hdr_img.clamp(min=0.0).movedim(channel_axis, -1)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    a = alpha
    rc = (1 - 2 * a) * r + a * (g + b)
    gc = (1 - 2 * a) * g + a * (r + b)
    bc = (1 - 2 * a) * b + a * (r + g)
    xc = torch.stack([rc, gc, bc], dim=-1)
    wy = _BT2020_Y
    y_hdr = (rc * wy[0] + gc * wy[1] + bc * wy[2]).clamp(0.0, 1.0)
    yp = y_hdr.clamp(eps, 1.0) ** (1.0 / 2.4)
    rho_h = 1.0 + 32.0 * (l_hdr / 10000.0) ** (1.0 / 2.4)
    ypp = torch.log1p((rho_h - 1.0) * yp) / math.log(rho_h)
    yc = torch.where(
        ypp <= 0.7399,
        1.0770 * ypp,
        torch.where(ypp < 0.9909, -1.1510 * ypp * ypp + 2.7811 * ypp - 0.6302,
                    0.5000 * ypp + 0.5000),
    )
    rho_s = 1.0 + 32.0 * (l_sdr / 10000.0) ** (1.0 / 2.4)
    y_sdr_p = torch.expm1(yc * math.log(rho_s)) / (rho_s - 1.0)
    y_sdr = y_sdr_p.clamp(0.0, 1.0) ** 2.4
    gain = y_sdr / y_hdr.clamp(min=eps)
    out = xc * gain[..., None]
    ro, go, bo = out[..., 0], out[..., 1], out[..., 2]
    d = 1.0 - 3.0 * a
    ri = ((1 - a) * ro - a * (go + bo)) / d
    gi = ((1 - a) * go - a * (ro + bo)) / d
    bi = ((1 - a) * bo - a * (ro + go)) / d
    out = torch.stack([ri, gi, bi], dim=-1).clamp(0.0, 1.0).to(hdr_img.dtype)
    return out.movedim(-1, channel_axis)


def choose_tmo(name: str, use_2446a: bool = False) -> Callable[..., torch.Tensor]:
    """The Stage-1 CLI's ``choose_tmo``: ``--bright_tmo`` names the training
    TMO (``fix_mulog``, ``hard_clip``, ``linear_scale``); ``--tmo_2446a``
    replaces it with BT.2446-A on the peak-normalised HDR."""
    if use_2446a:
        return lambda hdr, qmax: tmo_2446a(hdr / (qmax + 1.0))
    return {
        "fix_mulog": fix_mulog_tmo,
        "hard_clip": hard_clip_tmo,
        "linear_scale": linear_scale_tmo,
    }[name]


__all__ = [
    "linear_scale_tmo",
    "hard_clip_tmo",
    "fix_mulog_tmo",
    "mulog_tmo",
    "random_tmo",
    "tmo_2446a",
    "choose_tmo",
]
