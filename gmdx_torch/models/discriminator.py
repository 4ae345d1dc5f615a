"""Paella-style conv GAN discriminator of Stage-1 adversarial training.

Counterpart of ``gmdx/models/discriminator.py``: ``depth`` spectral-norm 3x3
stride-2 convs with the channel ramp ``hidden // 2**max(d - 1 - i, 0)`` (``d =
max(depth - 3, 3)``, the first conv ``hidden // 2**d``), InstanceNorm without
affine (biased variance, eps 1e-5) and LeakyReLU(0.2) between them, a 1x1
head and a sigmoid. NCHW throughout. The JAX module's optional
conditioning vector has no caller in Stage 1 and is not ported.

Spectral norm is flax's ``nn.SpectralNorm``, not
``torch.nn.utils.spectral_norm``: the kernel is flattened HWIO-first to
(kh*kw*in, out); one power iteration from the stored ``u`` (1, out) runs on
every call, ``v = l2n(u W^T)``, ``u = l2n(v W)`` (``l2n(x) = x *
rsqrt(sum x^2 + 1e-12)``), both held constant for autograd; ``sigma = v W
u^T`` and the kernel used is ``W / sigma`` (``sigma`` 0 divides by 1). The
state (buffers ``u``, ``sigma``, fp32, as the JAX package's
``batch_stats``) is written only when the caller passes ``update_sn=True``.

Under spatial parallelism (``gmdx_torch.dist.tpctx``'s ``sp`` context, the
input this rank's rows of each image) each stride-2 conv reads one halo row
from the rank above (the output row ``j`` reads input rows ``2j - 1 ..
2j + 1``; zero padding at the image's top), so a rank's rows must stay even
through every halving; InstanceNorm sums each image's moments over the
group; the score map is this rank's rows. The power iteration reads the
weights alone, so every rank computes the same ``u`` and ``sigma``. Both
collectives are twice differentiable (Stage 1's gradient penalty).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from gmdx_torch.dist import tpctx
from gmdx_torch.dist.mesh import all_reduce_sum, halo_rows

_SN_EPS = 1e-12


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + _SN_EPS)


class SpectralNormConv2d(nn.Conv2d):
    """A 3x3 stride-2 conv (padding 1) with flax's spectral normalisation."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(in_ch, out_ch, 3, stride=2, padding=1)
        self.register_buffer("u", torch.randn(1, out_ch))
        self.register_buffer("sigma", torch.ones(()))

    def normalized_weight(self, update_sn: bool = False) -> torch.Tensor:
        """The kernel divided by its power-iteration sigma, in the weight's
        dtype; with ``update_sn`` the buffers take this call's u and sigma."""
        w = self.weight
        value = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0])  # (kh*kw*in, out)
        with torch.no_grad():
            v0 = _l2_normalize(self.u @ value.T)
            u0 = _l2_normalize(v0 @ value)
        sigma = (v0 @ value @ u0.T)[0, 0]
        if update_sn:
            with torch.no_grad():
                self.u.copy_(u0)
                self.sigma.copy_(sigma)
        return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))

    def forward(self, x: torch.Tensor, update_sn: bool = False) -> torch.Tensor:
        w = self.normalized_weight(update_sn).to(x.dtype)
        ctx = tpctx.sp_active()
        if ctx is None:
            return F.conv2d(x, w, self.bias.to(x.dtype), self.stride, self.padding)
        h = x.shape[2]
        if h % 2:
            raise ValueError(f"the discriminator's {h * ctx.size}-row level: {h} rows a rank "
                             f"do not halve over {ctx.size} ranks")
        return F.conv2d(halo_rows(x, 1, 0, ctx, h_dim=2), w, self.bias.to(x.dtype), self.stride,
                        (0, self.padding[1]))


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-sample, per-channel spatial normalisation, no affine, biased
    variance, statistics in fp32 (or the input's wider type); under spatial
    parallelism over the whole image (each moment's sum over the group's
    rows)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    ctx = tpctx.sp_active()
    if ctx is None:
        mean = xf.mean(dim=(2, 3), keepdim=True)
        var = ((xf - mean) ** 2).mean(dim=(2, 3), keepdim=True)
    else:
        n = x.shape[2] * x.shape[3] * ctx.size
        mean = all_reduce_sum(xf.sum(dim=(2, 3), keepdim=True), ctx) / n
        var = all_reduce_sum(((xf - mean) ** 2).sum(dim=(2, 3), keepdim=True), ctx) / n
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


class Discriminator(nn.Module):
    def __init__(self, in_channels: int = 3, hidden_channels: int = 512, depth: int = 6,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.compute_dtype = dtype
        self.depth, self.hidden_channels = depth, hidden_channels
        d = max(depth - 3, 3)
        chs = [hidden_channels // 2**d] + [
            hidden_channels // 2 ** max(d - 1 - i, 0) for i in range(depth - 1)
        ]
        self.convs = nn.ModuleList(
            SpectralNormConv2d(c_in, c_out) for c_in, c_out in zip([in_channels] + chs[:-1], chs)
        )
        self.shuffle = nn.Conv2d(chs[-1], 1, 1)

    def forward(self, x: torch.Tensor, *, update_sn: bool = False) -> torch.Tensor:
        """x (B, C, H, W) -> the sigmoid score map (B, 1, H', W'), fp32."""
        h = x.to(self.compute_dtype or x.dtype)
        for i, conv in enumerate(self.convs):
            h = conv(h, update_sn)
            if i > 0:
                h = instance_norm(h)
            h = F.leaky_relu(h, 0.2)
        h = F.conv2d(h, self.shuffle.weight.to(h.dtype), self.shuffle.bias.to(h.dtype))
        return torch.sigmoid(h.float())


__all__ = ["Discriminator", "SpectralNormConv2d", "instance_norm"]
