"""Conditional 2-D UNet (SD-1.5 architecture), NHWC inside.

Counterpart of ``gmdx/models/unet2d.py``: the same configs, the same forward
order, and the diffusers module tree (``down_blocks.0.resnets.1.conv2``,
``mid_block.attentions.0``, ...) so that diffusers SD-1.5 weights load with
``strict=True``. I/O is NCHW at the boundary unless ``channels_last``.

``dtype`` is the compute dtype (flax's ``dtype=``): activations run in it
and weights are cast to it at use, so a model kept in fp32 for training
computes in bf16 and its gradients land in fp32. ``None`` computes in the
parameters' own dtype. The prediction comes out in fp32 either way, so a
loss on it is taken in fp32 (``gmdx/models/unet2d.py:222-224``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch
from torch import nn

from gmdx_torch.models.layers import (
    Downsample2D,
    GroupNorm,
    ResnetBlock2D,
    TimestepEmbedding,
    Transformer2D,
    Upsample2D,
    conv2d_nhwc,
    remat_call,
    timestep_embedding,
)


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    num_attention_heads: int = 8
    cross_attention_dim: int = 768
    down_block_types: Tuple[str, ...] = (
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
        "DownBlock2D",
    )
    up_block_types: Tuple[str, ...] = (
        "UpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
        "CrossAttnUpBlock2D",
    )
    transformer_depth: int = 1
    sample_size: int = 64
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    # Gradient checkpointing: each ResnetBlock2D and Transformer2D recomputes
    # its activations in the backward pass, while the model is in training
    # mode (``gmdx/models/unet2d.py:62-66``).
    remat: bool = False


SD15_UNET_CONFIG = UNetConfig()
SD15_GM_UNET_CONFIG = UNetConfig(in_channels=8)
TINY_UNET_CONFIG = UNetConfig(
    block_out_channels=(32, 64),
    num_attention_heads=2,
    cross_attention_dim=32,
    down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
    up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"),
    sample_size=8,
)


class _DownBlock(nn.Module):
    def __init__(self, in_ch, out_ch, temb_dim, cfg, cross, add_down):
        super().__init__()
        heads = cfg.num_attention_heads
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(in_ch if j == 0 else out_ch, out_ch, temb_dim)
             for j in range(cfg.layers_per_block)]
        )
        if cross:
            self.attentions = nn.ModuleList(
                [Transformer2D(out_ch, heads, out_ch // heads, cfg.cross_attention_dim,
                               cfg.transformer_depth)
                 for _ in range(cfg.layers_per_block)]
            )
        if add_down:
            self.downsamplers = nn.ModuleList([Downsample2D(out_ch)])


class _UpBlock(nn.Module):
    def __init__(self, prev_ch, skip_chs, out_ch, temb_dim, cfg, cross, add_up):
        super().__init__()
        heads = cfg.num_attention_heads
        resnets, ch = [], prev_ch
        for skip in skip_chs:
            resnets.append(ResnetBlock2D(ch + skip, out_ch, temb_dim))
            ch = out_ch
        self.resnets = nn.ModuleList(resnets)
        if cross:
            self.attentions = nn.ModuleList(
                [Transformer2D(out_ch, heads, out_ch // heads, cfg.cross_attention_dim,
                               cfg.transformer_depth)
                 for _ in skip_chs]
            )
        if add_up:
            self.upsamplers = nn.ModuleList([Upsample2D(out_ch)])


class _MidBlock(nn.Module):
    def __init__(self, ch, temb_dim, cfg):
        super().__init__()
        heads = cfg.num_attention_heads
        self.resnets = nn.ModuleList(
            [ResnetBlock2D(ch, ch, temb_dim), ResnetBlock2D(ch, ch, temb_dim)]
        )
        self.attentions = nn.ModuleList(
            [Transformer2D(ch, heads, ch // heads, cfg.cross_attention_dim,
                           cfg.transformer_depth)]
        )


class _UNetEncoder(nn.Module):
    """conv_in, the time embedding, the down blocks and the mid block: the
    part of the UNet that the ControlNet copies, under the same names."""

    def __init__(self, cfg: UNetConfig, dtype: torch.dtype | None, remat: bool = False):
        super().__init__()
        self.compute_dtype = dtype
        self.remat = remat
        chs = tuple(cfg.block_out_channels)
        temb_dim = chs[0] * 4
        n = len(chs)
        self.conv_in = nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(chs[0], temb_dim)

        self.down_blocks = nn.ModuleList()
        # Channels of each skip, in the order the down pass stores them.
        self.skip_channels = [chs[0]]
        in_ch = chs[0]
        for i, btype in enumerate(cfg.down_block_types):
            out_ch = chs[i]
            add_down = i < n - 1
            self.down_blocks.append(_DownBlock(
                in_ch, out_ch, temb_dim, cfg, btype == "CrossAttnDownBlock2D", add_down))
            self.skip_channels += [out_ch] * (cfg.layers_per_block + add_down)
            in_ch = out_ch

        self.mid_block = _MidBlock(chs[-1], temb_dim, cfg)

    def _inputs(self, cfg: UNetConfig, sample, timesteps, encoder_hidden_states, channels_last):
        """NHWC ``x``, the time embedding and the context, in the compute dtype."""
        dtype = self.compute_dtype or self.conv_in.weight.dtype
        x = sample if channels_last else sample.permute(0, 2, 3, 1)
        x = x.to(dtype).contiguous()
        context = encoder_hidden_states.to(dtype)
        t = torch.as_tensor(timesteps, device=x.device)
        if t.ndim == 0:
            t = t.expand(x.shape[0])
        t_sin = timestep_embedding(
            t, cfg.block_out_channels[0], flip_sin_to_cos=cfg.flip_sin_to_cos,
            downscale_freq_shift=cfg.freq_shift,
        ).to(dtype)
        return x, self.time_embedding(t_sin), context

    def _block(self, module: nn.Module, *args):
        """A resnet or transformer block, under remat while training."""
        return remat_call(module, self.remat and self.training, *args)

    def _encode(self, h, temb, context):
        """Down blocks and mid block from ``conv_in``'s output ``h``: the mid
        state and the skips."""
        skips = [h]
        for block in self.down_blocks:
            attns = getattr(block, "attentions", None)
            for j, resnet in enumerate(block.resnets):
                h = self._block(resnet, h, temb)
                if attns is not None:
                    h = self._block(attns[j], h, context)
                skips.append(h)
            if hasattr(block, "downsamplers"):
                h = block.downsamplers[0](h)
                skips.append(h)
        h = self._block(self.mid_block.resnets[0], h, temb)
        h = self._block(self.mid_block.attentions[0], h, context)
        h = self._block(self.mid_block.resnets[1], h, temb)
        return h, skips


class UNet2DConditionModel(_UNetEncoder):
    def __init__(self, config: UNetConfig = SD15_UNET_CONFIG, dtype: torch.dtype | None = None):
        super().__init__(config, dtype, remat=config.remat)
        cfg = self.config = config
        chs = tuple(cfg.block_out_channels)
        temb_dim = chs[0] * 4
        n = len(chs)
        skip_chs = list(self.skip_channels)
        self.up_blocks = nn.ModuleList()
        rev = tuple(reversed(chs))
        prev_ch = chs[-1]
        for i, btype in enumerate(cfg.up_block_types):
            skips = [skip_chs.pop() for _ in range(cfg.layers_per_block + 1)]
            self.up_blocks.append(_UpBlock(
                prev_ch, skips, rev[i], temb_dim, cfg, btype == "CrossAttnUpBlock2D",
                i < n - 1))
            prev_ch = rev[i]

        self.conv_norm_out = GroupNorm(chs[0], 32, eps=1e-5)
        self.conv_out = nn.Conv2d(chs[0], cfg.out_channels, 3, padding=1)

    def forward(
        self,
        sample: torch.Tensor,
        timesteps: torch.Tensor | int,
        encoder_hidden_states: torch.Tensor,
        down_block_additional_residuals: Sequence[torch.Tensor] | None = None,
        mid_block_additional_residual: torch.Tensor | None = None,
        channels_last: bool = False,
    ) -> torch.Tensor:
        """``sample`` (B, C, H, W), or (B, H, W, C) with ``channels_last``;
        returns the fp32 prediction in the same layout. The ControlNet's
        residuals (NHWC, one per skip and one for the mid state) are added
        to each stored skip and to the mid block's output, each in its
        tensor's dtype (``gmdx/models/unet2d.py:178-189``)."""
        x, temb, context = self._inputs(
            self.config, sample, timesteps, encoder_hidden_states, channels_last)
        h, skips = self._encode(conv2d_nhwc(x, self.conv_in), temb, context)
        if down_block_additional_residuals is not None:
            if len(down_block_additional_residuals) != len(skips):
                raise ValueError(f"expected {len(skips)} down residuals, got "
                                 f"{len(down_block_additional_residuals)}")
            skips = [s + r.to(s.dtype) for s, r in zip(skips, down_block_additional_residuals)]
        if mid_block_additional_residual is not None:
            h = h + mid_block_additional_residual.to(h.dtype)

        for block in self.up_blocks:
            attns = getattr(block, "attentions", None)
            for j, resnet in enumerate(block.resnets):
                h = self._block(resnet, torch.cat([h, skips.pop()], dim=-1), temb)
                if attns is not None:
                    h = self._block(attns[j], h, context)
            if hasattr(block, "upsamplers"):
                h = block.upsamplers[0](h)

        h = conv2d_nhwc(self.conv_norm_out(h, activate=True), self.conv_out).float()
        return h if channels_last else h.permute(0, 3, 1, 2).contiguous()


def inflate_conv_in(
    state_dict: dict[str, torch.Tensor], new_in_channels: int, scale: float = 0.5
) -> dict[str, torch.Tensor]:
    """Widen a trained UNet's ``conv_in`` from C to ``new_in_channels`` input
    channels by tiling its weight along the input axis and scaling it (x0.5
    keeps the activations' magnitude), as ``gmdx/models/unet2d.py:227-245``.
    Returns a new state dict; the 8-channel GM UNet loads it."""
    w = state_dict["conv_in.weight"]  # (O, C, 3, 3)
    c_in = w.shape[1]
    if new_in_channels % c_in:
        raise ValueError(f"cannot inflate conv_in {c_in} -> {new_in_channels}")
    out = dict(state_dict)
    out["conv_in.weight"] = w.repeat(1, new_in_channels // c_in, 1, 1) * scale
    return out


__all__ = [
    "inflate_conv_in",
    "UNet2DConditionModel",
    "UNetConfig",
    "SD15_UNET_CONFIG",
    "SD15_GM_UNET_CONFIG",
    "TINY_UNET_CONFIG",
]
