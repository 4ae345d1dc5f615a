"""3x3 stride-1 SAME convolution + bias over NHWC.

Counterpart of ``gmdx/kernels/winograd.py:winograd_conv3x3``. The Hopper
kernel (``csrc/conv3x3.cu``) is an implicit GEMM, not a Winograd transform;
the source says why. Its weight operand is the (O, 9*C) repacking of the
OIHW conv weight made by :func:`pack_weight`, once per weight.

Under autograd the conv is :func:`conv3x3_direct`, ``F.conv2d`` in both
directions, as the JAX package's ``_wino_fwd`` takes the direct XLA conv for
training by default (``winograd.py:1028-1048``, ``GMDX_WINOGRAD_TRAIN=0``):
a computation the JAX package leaves outside Pallas.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gmdx_torch.kernels import LAUNCHES, check_kernel_operands


def pack_weight(weight: torch.Tensor) -> torch.Tensor:
    """OIHW (O, C, 3, 3) -> (O, 9*C) with k = (ky*3 + kx)*C + c."""
    o, c = weight.shape[:2]
    return weight.permute(0, 2, 3, 1).reshape(o, 9 * c).contiguous()


def conv3x3_plain(
    x: torch.Tensor, wpacked: torch.Tensor, bias: torch.Tensor, *,
    pre_padded: bool = False,
) -> torch.Tensor:
    """Plain version, the kernel's arithmetic in fp32: gather the nine taps
    into (pixels, 9*C) and multiply by the packed weight."""
    xp = x if pre_padded else F.pad(x, (0, 0, 1, 1, 1, 1))
    b, hp, wp, c = xp.shape
    h, w = hp - 2, wp - 2
    xf = xp.float()
    cols = torch.cat(
        [xf[:, ky:ky + h, kx:kx + w, :] for ky in range(3) for kx in range(3)], dim=-1
    )
    out = cols.reshape(b * h * w, 9 * c) @ wpacked.float().t() + bias.float()
    return out.reshape(b, h, w, -1).to(x.dtype)


def conv3x3(
    x: torch.Tensor, wpacked: torch.Tensor, bias: torch.Tensor, *,
    pre_padded: bool = False,
) -> torch.Tensor:
    """3x3 SAME conv of NHWC ``x`` (B, H, W, C), or of its 1-px zero-bordered
    form (B, H+2, W+2, C) with ``pre_padded``, by the packed weight
    (O, 9*C) plus ``bias`` (O,). Returns (B, H, W, O)."""
    if x.ndim != 4:
        raise ValueError(f"expected NHWC, got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if pre_padded:
        h, w = h - 2, w - 2
    o = wpacked.shape[0]
    if wpacked.shape != (o, 9 * c) or bias.shape != (o,):
        raise ValueError(f"weight {tuple(wpacked.shape)} does not match C={c}")
    if not x.is_cuda:
        return conv3x3_plain(x, wpacked, bias, pre_padded=pre_padded)
    if c % 8 or o % 8:
        raise ValueError(f"conv3x3 kernel needs C % 8 == O % 8 == 0, got {c}, {o}")
    stream = check_kernel_operands("conv3x3", x, wpacked, bias)
    from gmdx_torch.kernels import _build

    out = torch.empty((b, h, w, o), dtype=x.dtype, device=x.device)
    _build.call(
        "gmdx_conv3x3", x.data_ptr(), wpacked.data_ptr(), bias.data_ptr(),
        out.data_ptr(), b, h, w, c, o, int(pre_padded), stream,
    )
    LAUNCHES["conv3x3"] += 1
    return out


def conv3x3_direct(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *, pre_padded: bool = False,
) -> torch.Tensor:
    """The same conv by ``F.conv2d`` on a channels-last view, with the OIHW
    ``weight``: the differentiated route. A channels-last input gives a
    channels-last result, so the final ``contiguous`` copies nothing."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, padding=0 if pre_padded else 1)
    return y.permute(0, 2, 3, 1).contiguous()


__all__ = ["conv3x3", "conv3x3_plain", "conv3x3_direct", "pack_weight"]
