"""AutoencoderKL (SD-1.5 VAE), NHWC inside.

Counterpart of ``gmdx/models/vae.py``: ``VAEConfig``, the ``Encoder`` and
``Decoder``, ``AutoencoderKL.encode``/``decode`` and the
``DiagonalGaussianDistribution`` posterior, with the diffusers module tree
(``encoder.*``, ``quant_conv``, ``decoder.*``, ``post_quant_conv``). The mid
attention (one 512-wide head) is plain PyTorch at 512^2 (4096 tokens) and
the flash forward at 1024^2 (16384 tokens), by the JAX package's dispatch
rule. ``dtype`` is the compute dtype, as in the UNet.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from gmdx_torch.models.layers import (
    Downsample2D,
    GroupNorm,
    ResnetBlock2D,
    Upsample2D,
    VAEAttention,
    conv1x1_nhwc,
    conv2d_nhwc,
    remat_call,
)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    latent_channels: int = 4
    scaling_factor: float = 0.18215
    sample_size: int = 512
    # Gradient checkpointing of each resnet and the mid attention while
    # training, the UNet's granularity (``gmdx/models/vae.py:41-45``).
    remat: bool = False


SD15_VAE_CONFIG = VAEConfig()
TINY_VAE_CONFIG = VAEConfig(block_out_channels=(32, 64), sample_size=32)


class DiagonalGaussianDistribution:
    """Posterior N(mean, diag(std^2)) from concatenated (mean, logvar)
    moments along ``channel_axis``; logvar is clipped to [-30, 20]."""

    def __init__(self, moments: torch.Tensor, channel_axis: int = 1):
        self.mean, logvar = moments.chunk(2, dim=channel_axis)
        self.logvar = logvar.clamp(-30.0, 20.0)
        self.std = torch.exp(0.5 * self.logvar)

    def sample(self, generator: torch.Generator | None = None,
               rows: tuple[int, int] | None = None, spatial=None) -> torch.Tensor:
        """A draw; with ``rows = (start, total)`` (a rank's rows of a
        global batch) the noise is those rows of one draw for ``total``
        rows, and with ``spatial`` (a posterior of a rank's image rows) the
        whole image's draw, sliced, as ``gmdx_torch.dist.randn_rows`` makes
        it."""
        from gmdx_torch.dist.mesh import randn_rows

        eps = randn_rows(self.mean.shape, generator, rows, device=self.mean.device,
                         dtype=self.mean.dtype, spatial=spatial)
        return self.mean + self.std * eps

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        return 0.5 * torch.sum(
            self.mean**2 + torch.exp(self.logvar) - 1.0 - self.logvar,
            dim=tuple(range(1, self.mean.ndim)),
        )


class _VAEMidBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(ch, ch), ResnetBlock2D(ch, ch)])
        self.attentions = nn.ModuleList([VAEAttention(ch)])

    def forward(self, x: torch.Tensor, remat: bool = False) -> torch.Tensor:
        for m in (self.resnets[0], self.attentions[0], self.resnets[1]):
            x = remat_call(m, remat, x)
        return x


class _VAEUpBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, layers: int, add_upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch) for j in range(layers)]
        )
        if add_upsample:
            self.upsamplers = nn.ModuleList([Upsample2D(out_ch)])


class _VAEDownBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, layers: int, add_downsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch) for j in range(layers)]
        )
        if add_downsample:
            self.downsamplers = nn.ModuleList([Downsample2D(out_ch, asymmetric_pad=True)])


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.remat = cfg.remat
        chs = tuple(cfg.block_out_channels)
        self.conv_in = nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        in_ch = chs[0]
        for i, out_ch in enumerate(chs):
            self.down_blocks.append(
                _VAEDownBlock(in_ch, out_ch, cfg.layers_per_block, i < len(chs) - 1)
            )
            in_ch = out_ch
        self.mid_block = _VAEMidBlock(chs[-1])
        self.conv_norm_out = GroupNorm(chs[-1], 32, eps=1e-6)
        self.conv_out = nn.Conv2d(chs[-1], 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # NHWC in, NHWC moments out
        remat = self.remat and self.training
        h = conv2d_nhwc(x, self.conv_in)
        for block in self.down_blocks:
            for resnet in block.resnets:
                h = remat_call(resnet, remat, h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
        h = self.mid_block(h, remat)
        return conv2d_nhwc(self.conv_norm_out(h, activate=True), self.conv_out)


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        self.remat = cfg.remat
        rev = tuple(reversed(cfg.block_out_channels))
        n = len(rev)
        self.conv_in = nn.Conv2d(cfg.latent_channels, rev[0], 3, padding=1)
        self.mid_block = _VAEMidBlock(rev[0])
        self.up_blocks = nn.ModuleList()
        in_ch = rev[0]
        for i, out_ch in enumerate(rev):
            self.up_blocks.append(
                _VAEUpBlock(in_ch, out_ch, cfg.layers_per_block + 1, i < n - 1)
            )
            in_ch = out_ch
        self.conv_norm_out = GroupNorm(rev[-1], 32, eps=1e-6)
        self.conv_out = nn.Conv2d(rev[-1], cfg.out_channels, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:  # NHWC in, NHWC out
        remat = self.remat and self.training
        h = self.mid_block(conv2d_nhwc(z, self.conv_in), remat)
        for block in self.up_blocks:
            for resnet in block.resnets:
                h = remat_call(resnet, remat, h)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)
        return conv2d_nhwc(self.conv_norm_out(h, activate=True), self.conv_out)


class AutoencoderKL(nn.Module):
    """The KL VAE. The gain-map head's sigmoid, where one is wanted, belongs
    to the caller, as in the JAX package."""

    def __init__(self, config: VAEConfig = SD15_VAE_CONFIG, dtype: torch.dtype | None = None):
        super().__init__()
        self.config = config
        self.compute_dtype = dtype
        self.encoder = Encoder(config)
        self.quant_conv = nn.Conv2d(2 * config.latent_channels, 2 * config.latent_channels, 1)
        self.decoder = Decoder(config)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)

    def _dtype(self) -> torch.dtype:
        return self.compute_dtype or self.post_quant_conv.weight.dtype

    def encode(self, x: torch.Tensor) -> DiagonalGaussianDistribution:
        """x: (B, 3, H, W) -> the posterior over (B, 4, H/8, W/8), fp32."""
        h = x.permute(0, 2, 3, 1).to(self._dtype()).contiguous()
        moments = conv1x1_nhwc(self.encoder(h), self.quant_conv)
        return DiagonalGaussianDistribution(moments.float().permute(0, 3, 1, 2), channel_axis=1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z: (B, 4, h, w) -> image (B, 3, 8h, 8w), fp32."""
        h = z.permute(0, 2, 3, 1).to(self._dtype()).contiguous()
        img = self.decoder(conv1x1_nhwc(h, self.post_quant_conv))
        return img.float().permute(0, 3, 1, 2).contiguous()


__all__ = [
    "AutoencoderKL",
    "DiagonalGaussianDistribution",
    "Encoder",
    "Decoder",
    "VAEConfig",
    "SD15_VAE_CONFIG",
    "TINY_VAE_CONFIG",
]
