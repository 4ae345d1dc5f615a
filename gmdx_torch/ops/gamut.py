"""BT.2020 -> BT.709 gamut compression.

Counterpart of ``gmdx/ops/gamut.py``: contract the channel axis with the 3x3
primaries conversion, then clamp to [0, 1]. The product runs in full fp32
(an elementwise sum of three scaled channels, never a TF32 matmul), as the
JAX package pins ``Precision.HIGHEST`` for it.
"""

from __future__ import annotations

import numpy as np
import torch

# Row-major BT.2020 -> BT.709 primaries conversion (out = M @ rgb).
BT2020_TO_BT709 = np.array(
    [
        [1.660491, -0.587641, -0.072850],
        [-0.124550, 1.132900, -0.008349],
        [-0.018151, -0.100579, 1.118730],
    ],
    dtype=np.float32,
)


def gamut_compress(tmo_hdr_img: torch.Tensor, *, channel_axis: int = 1) -> torch.Tensor:
    """Convert a tone-mapped image with a size-3 ``channel_axis`` (default 1,
    NCHW) from BT.2020 to BT.709 and clamp to [0, 1]."""
    x = tmo_hdr_img.movedim(channel_axis, 0)
    m = BT2020_TO_BT709.tolist()
    out = torch.stack([row[0] * x[0] + row[1] * x[1] + row[2] * x[2] for row in m])
    return out.movedim(0, channel_axis).clamp(0.0, 1.0)


__all__ = ["gamut_compress", "BT2020_TO_BT709"]
