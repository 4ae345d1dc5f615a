"""ControlNet for the SD-1.5 UNet, NHWC inside.

Counterpart of ``gmdx/models/controlnet.py``: a trainable copy of the UNet's
encoder (conv_in, time embedding, down blocks, mid block) whose every skip
and mid state passes through a zero-initialized 1x1 conv and is added into
the frozen UNet's skips; the control image (the SDR frame for SDR->HDRTV
up-conversion) enters through a strided conv embedder that maps pixels to
the latent grid. The encoder copy is the UNet's own modules
(``_UNetEncoder``), so its resnets and attentions take the same kernels.
The embedder's convs and the 1x1 zero convs are plain PyTorch, as the JAX
package leaves them to XLA.

Module names follow diffusers' ``ControlNetModel`` (``controlnet_cond_embedding``,
``controlnet_down_blocks.{k}``, ``controlnet_mid_block``). The embedder's
layout does not: like gmdx it changes the channel count in the first conv of
each pair, where diffusers changes it in the strided conv, so a diffusers
ControlNet checkpoint does not load into it.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from gmdx_torch.models.layers import conv1x1_nhwc, conv2d_nhwc
from gmdx_torch.models.unet2d import (
    SD15_UNET_CONFIG,
    TINY_UNET_CONFIG,
    UNetConfig,
    _UNetEncoder,
)


@dataclasses.dataclass(frozen=True)
class ControlNetConfig:
    unet: UNetConfig = SD15_UNET_CONFIG
    conditioning_channels: int = 3
    conditioning_embedding_channels: Tuple[int, ...] = (16, 32, 96, 256)


SD15_CONTROLNET_CONFIG = ControlNetConfig()
# len(conditioning_embedding_channels) - 1 stride-2 stages must equal the
# image -> latent factor (8x for the SD VAE pipelines), so 4 entries.
TINY_CONTROLNET_CONFIG = ControlNetConfig(
    unet=TINY_UNET_CONFIG, conditioning_embedding_channels=(8, 16, 16, 32)
)


def _zero_conv(in_ch: int, out_ch: int, kernel: int) -> nn.Conv2d:
    conv = nn.Conv2d(in_ch, out_ch, kernel, padding=kernel // 2)
    nn.init.zeros_(conv.weight)
    nn.init.zeros_(conv.bias)
    return conv


class ConditioningEmbedding(nn.Module):
    """Full-resolution control image (NHWC) -> the latent grid: 3x3 convs
    with a stride-2 step per 2x factor, SiLU between, a zero-initialized
    output conv."""

    def __init__(self, out_channels: int, block_channels: Tuple[int, ...], in_channels: int = 3):
        super().__init__()
        self.conv_in = nn.Conv2d(in_channels, block_channels[0], 3, padding=1)
        blocks, prev = [], block_channels[0]
        for ch in block_channels[1:]:
            blocks += [nn.Conv2d(prev, ch, 3, padding=1), nn.Conv2d(ch, ch, 3, stride=2, padding=1)]
            prev = ch
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = _zero_conv(block_channels[-1], out_channels, 3)

    def forward(self, cond: torch.Tensor) -> torch.Tensor:
        h = F.silu(conv2d_nhwc(cond, self.conv_in))
        for conv in self.blocks:
            h = F.silu(conv2d_nhwc(h, conv))
        return conv2d_nhwc(h, self.conv_out)


class ControlNetModel(_UNetEncoder):
    def __init__(
        self, config: ControlNetConfig = SD15_CONTROLNET_CONFIG, dtype: torch.dtype | None = None
    ):
        super().__init__(config.unet, dtype)
        self.config = config
        chs = config.unet.block_out_channels
        self.controlnet_cond_embedding = ConditioningEmbedding(
            chs[0], config.conditioning_embedding_channels, config.conditioning_channels
        )
        self.controlnet_down_blocks = nn.ModuleList(
            [_zero_conv(c, c, 1) for c in self.skip_channels]
        )
        self.controlnet_mid_block = _zero_conv(chs[-1], chs[-1], 1)

    def forward(
        self,
        sample: torch.Tensor,
        timesteps: torch.Tensor | int,
        encoder_hidden_states: torch.Tensor,
        controlnet_cond: torch.Tensor,
        conditioning_scale: float = 1.0,
        channels_last: bool = False,
    ) -> tuple[tuple[torch.Tensor, ...], torch.Tensor]:
        """``sample`` (B, C, h, w) and the control image ``controlnet_cond``
        (B, 3, H, W) in [0, 1], both NHWC with ``channels_last``. Returns the
        NHWC residual of every skip and of the mid state, each times
        ``conditioning_scale``, ready for the UNet's residual hooks."""
        x, temb, context = self._inputs(
            self.config.unet, sample, timesteps, encoder_hidden_states, channels_last)
        cond = controlnet_cond if channels_last else controlnet_cond.permute(0, 2, 3, 1)
        cond = cond.to(x.dtype).contiguous()
        h = conv2d_nhwc(x, self.conv_in) + self.controlnet_cond_embedding(cond)
        h, skips = self._encode(h, temb, context)
        down = tuple(conv1x1_nhwc(s, zc) * conditioning_scale
                     for s, zc in zip(skips, self.controlnet_down_blocks))
        return down, conv1x1_nhwc(h, self.controlnet_mid_block) * conditioning_scale


__all__ = [
    "ControlNetModel",
    "ControlNetConfig",
    "ConditioningEmbedding",
    "SD15_CONTROLNET_CONFIG",
    "TINY_CONTROLNET_CONFIG",
]
