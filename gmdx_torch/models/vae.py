"""AutoencoderKL (SD-1.5 VAE) decoder, NHWC inside.

Counterpart of ``gmdx/models/vae.py``: ``VAEConfig``, the ``Decoder`` and
``AutoencoderKL.decode`` with the diffusers module tree (``decoder.*``,
``post_quant_conv``). The encoder and ``quant_conv`` come with the SDR->HDR
slice of the port; the dual text-to-HDR path only decodes.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from gmdx_torch.models.layers import (
    GroupNorm,
    ResnetBlock2D,
    Upsample2D,
    VAEAttention,
    conv1x1_nhwc,
    conv2d_nhwc,
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


SD15_VAE_CONFIG = VAEConfig()
TINY_VAE_CONFIG = VAEConfig(block_out_channels=(32, 64), sample_size=32)


class _VAEMidBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock2D(ch, ch), ResnetBlock2D(ch, ch)])
        self.attentions = nn.ModuleList([VAEAttention(ch)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.resnets[1](self.attentions[0](self.resnets[0](x)))


class _VAEUpBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, layers: int, add_upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch) for j in range(layers)]
        )
        if add_upsample:
            self.upsamplers = nn.ModuleList([Upsample2D(out_ch)])


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
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
        h = self.mid_block(conv2d_nhwc(z, self.conv_in))
        for block in self.up_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)
        return conv2d_nhwc(self.conv_norm_out(h, activate=True), self.conv_out)


class AutoencoderKL(nn.Module):
    """The KL VAE's decoding half. The gain-map head's sigmoid, where one is
    wanted, belongs to the caller, as in the JAX package."""

    def __init__(self, config: VAEConfig = SD15_VAE_CONFIG):
        super().__init__()
        self.config = config
        self.decoder = Decoder(config)
        self.post_quant_conv = nn.Conv2d(config.latent_channels, config.latent_channels, 1)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z: (B, 4, h, w) -> image (B, 3, 8h, 8w), fp32."""
        dtype = self.post_quant_conv.weight.dtype
        h = z.permute(0, 2, 3, 1).to(dtype).contiguous()
        img = self.decoder(conv1x1_nhwc(h, self.post_quant_conv))
        return img.float().permute(0, 3, 1, 2).contiguous()


__all__ = ["AutoencoderKL", "Decoder", "VAEConfig", "SD15_VAE_CONFIG", "TINY_VAE_CONFIG"]
