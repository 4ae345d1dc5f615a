"""Eq. (1) HDR reconstruction from an SDR base layer and a gain map.

Counterpart of ``gmdx/ops/reconstruct.py``.
"""

from __future__ import annotations

import torch


def apply_gm_to_sdr(
    gm: torch.Tensor,
    sdr: torch.Tensor,
    qmax: float = 9.0,
    eps: float = 1.0 / 64.0,
    *,
    clip_output: bool = True,
) -> torch.Tensor:
    """``HDR = (clip(sdr, 0, 1)^2.2 + eps) * (1 + gm * qmax) - eps``.

    ``clip_output=True`` clamps to [0, qmax + 1] (the training op);
    ``False`` leaves the output unclamped (the experiments' .hdr export)."""
    hdr = (sdr.clamp(0.0, 1.0) ** 2.2 + eps) * (1.0 + gm * qmax) - eps
    if clip_output:
        hdr = hdr.clamp(0.0, qmax + 1.0)
    return hdr


__all__ = ["apply_gm_to_sdr"]
