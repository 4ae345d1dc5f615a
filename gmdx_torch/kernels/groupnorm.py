"""GroupNorm (+temb pre-add) (+SiLU) (+1-px padded output) over NHWC.

Counterpart of ``gmdx/kernels/groupnorm.py``: one function covers both
``fused_group_norm_silu`` (plain, optionally padded) and
``parity_gn_pad_silu`` (temb added before the statistics), without the
Winograd parity layout. Kernel: ``csrc/groupnorm.cu``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gmdx_torch.kernels import LAUNCHES, check_kernel_operands

_TARGET_BLOCKS = 528  # about four blocks per SM of the H100's 132


def group_norm_silu_plain(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    temb: torch.Tensor | None = None,
    *,
    num_groups: int = 32,
    eps: float = 1e-5,
    activate: bool = True,
    pad_output: bool = False,
) -> torch.Tensor:
    """Plain version: fp32 statistics (two-pass variance), result in x's
    dtype. ``temb`` is (B, C), added before the statistics."""
    b, h, w, c = x.shape
    xf = x.float()
    if temb is not None:
        xf = xf + temb.float()[:, None, None, :]
    xg = xf.reshape(b, h * w, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = xg.var(dim=(1, 3), unbiased=False, keepdim=True)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(b, h, w, c)
    y = y * scale.float() + bias.float()
    if activate:
        y = F.silu(y)
    y = y.to(x.dtype)
    if pad_output:
        y = F.pad(y, (0, 0, 1, 1, 1, 1))
    return y


def group_norm_silu(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    temb: torch.Tensor | None = None,
    *,
    num_groups: int = 32,
    eps: float = 1e-5,
    activate: bool = True,
    pad_output: bool = False,
) -> torch.Tensor:
    """GN(num_groups) over NHWC ``x`` (B, H, W, C) with affine ``scale``/
    ``bias`` (C,), optional ``temb`` (B, C) added before the statistics,
    optional SiLU, and with ``pad_output`` the 1-px zero-bordered result
    (B, H+2, W+2, C) that :func:`gmdx_torch.kernels.winograd.conv3x3` takes
    with ``pre_padded=True``."""
    if x.ndim != 4:
        raise ValueError(f"expected NHWC, got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    if not x.is_cuda:
        return group_norm_silu_plain(
            x, scale, bias, temb, num_groups=num_groups, eps=eps,
            activate=activate, pad_output=pad_output,
        )
    if c % 8 or c > 8192 or num_groups > 64:
        raise ValueError(f"group_norm_silu kernel: unsupported C={c}, G={num_groups}")
    if temb is not None and temb.shape != (b, c):
        raise ValueError(f"temb must be ({b}, {c}), got {tuple(temb.shape)}")
    stream = check_kernel_operands("group_norm_silu", x, scale, bias, temb)
    from gmdx_torch.kernels import _build

    pad = 1 if pad_output else 0
    out = torch.empty((b, h + 2 * pad, w + 2 * pad, c), dtype=x.dtype, device=x.device)
    chunks = c // 8
    rows = max(1, 512 // chunks)  # pixels a block walks in parallel
    splits = max(1, min(-(-_TARGET_BLOCKS // b), -(-(h * w) // rows)))
    partials = torch.empty((b, splits, num_groups, 2), dtype=torch.float32, device=x.device)
    _build.call(
        "groupnorm", x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        temb.data_ptr() if temb is not None else None, out.data_ptr(),
        partials.data_ptr(), b, h, w, c, num_groups, splits, float(eps),
        int(activate), pad, stream,
    )
    LAUNCHES["group_norm_silu"] += 1
    return out


__all__ = ["group_norm_silu", "group_norm_silu_plain"]
