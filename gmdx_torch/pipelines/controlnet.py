"""ControlNet-conditioned text-to-HDR and SDR->HDRTV up-conversion.

Counterpart of ``gmdx/pipelines/controlnet.py``: the dual-UNet joint sampler
with ControlNet residuals steering the SDR branch.
  * The ControlNet runs on the CFG-doubled batch, like the SDR UNet, with the
    control image repeated to match; with ``low_memory`` it runs once per
    context on the control image as given.
  * x0 is taken before the SDR step, and the GM branch (conditional-only)
    sees no residuals.
  * Without a control image the pipeline is the dual one.
The control image and scale are arguments of ``__call__`` and
``denoise_dual``.

:func:`upconvert_sdr_to_hdrtv` conditions the SDR branch on the input frame,
synthesizes the gain map jointly and reconstructs HDR from the input frame
with Eq. (1).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gmdx_torch.dist import tpctx
from gmdx_torch.dist.mesh import shard_rows
from gmdx_torch.ops import apply_gm_to_sdr
from gmdx_torch.pipelines.dual import StableDiffusionDualUNetPipeline


class StableDiffusionControlNetHDRPipeline(StableDiffusionDualUNetPipeline):
    """The dual pipeline plus ``controlnet`` on the SDR branch."""

    def __init__(
        self, unet: nn.Module, vae: nn.Module, scheduler, gm_unet: nn.Module,
        controlnet: nn.Module, *, text_encoder: nn.Module | None = None, tokenizer=None,
        lora: dict | None = None, device: str | torch.device = "cuda",
    ):
        super().__init__(unet, vae, scheduler, gm_unet, text_encoder=text_encoder,
                         tokenizer=tokenizer, lora=lora, device=device)
        self.controlnet = controlnet.to(self.device)

    def denoise_dual(
        self,
        prompt_embeds: torch.Tensor,
        negative_prompt_embeds: torch.Tensor | None,
        latents: torch.Tensor,
        *,
        control_image: torch.Tensor | np.ndarray | None = None,
        conditioning_scale: float = 1.0,
        **kwargs,
    ):
        """The dual loop with the ControlNet's residuals on the SDR branch;
        ``control_image`` is (B, 3, H, W) in [0, 1] at 8x the latents'
        side (under spatial parallelism, as the latents, the rank's rows).
        Other keyword arguments as the dual pipeline's ``_denoise_dual``."""
        if control_image is None:
            return super().denoise_dual(prompt_embeds, negative_prompt_embeds, latents, **kwargs)
        ctrl = torch.as_tensor(control_image, device=self.device).permute(0, 2, 3, 1).contiguous()
        if negative_prompt_embeds is not None and not kwargs.get("low_memory", False):
            ctrl = torch.cat([ctrl, ctrl])

        def sdr_eps(x, t, context):
            down, mid = self.controlnet(x, t, context, ctrl, conditioning_scale,
                                        channels_last=True)
            return self.unet(x, t, context, down_block_additional_residuals=down,
                             mid_block_additional_residual=mid, channels_last=True)

        return self._denoise_dual(sdr_eps, prompt_embeds, negative_prompt_embeds, latents,
                                  **kwargs)


def upconvert_sdr_to_hdrtv(
    pipe: StableDiffusionControlNetHDRPipeline,
    sdr_image01: torch.Tensor | np.ndarray,
    prompt: str = "high dynamic range, HDR10, 4000 nits peak brightness",
    *,
    generator: torch.Generator | None = None,
    num_inference_steps: int = 50,
    guidance_scale: float = 7.5,
    conditioning_scale: float = 1.0,
    qmax: float = 99.0,
    prompt_embeds: torch.Tensor | None = None,
    negative_prompt_embeds: torch.Tensor | None = None,
    low_memory: bool = False,
    **call_kwargs,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """SDR -> HDRTV for a (B, 3, H, W) frame batch in [0, 1]: returns the
    decoded SDR and gain map ([0, 1], NHWC) and the HDR frame (B, 3, H, W),
    numpy, from the INPUT frame and the gain map by Eq. (1), unclipped.
    ``prompt_embeds``/``negative_prompt_embeds`` bypass the tokenizer and
    text encoder; ``call_kwargs`` (``eta``, ``step_noise``,
    ``cross_attention_kwargs``, the callbacks, ...) go to the pipeline's
    ``__call__``. Under spatial parallelism every rank passes the whole
    frame, conditions the SDR branch on its rows, and returns the whole
    result."""
    sdr = torch.as_tensor(sdr_image01)
    b, _, h, w = sdr.shape
    ctx = tpctx.sp_active()
    sdr01, gm01 = pipe(
        [prompt] * b, control_image=sdr if ctx is None else shard_rows(sdr, ctx),
        conditioning_scale=conditioning_scale,
        generator=generator, height=h, width=w, num_inference_steps=num_inference_steps,
        guidance_scale=guidance_scale, prompt_embeds=prompt_embeds,
        negative_prompt_embeds=negative_prompt_embeds, low_memory=low_memory, **call_kwargs,
    )
    # The gain map at the input's resolution before Eq. (1), as the JAX
    # package does; bilinear upsampling by half-pixel centres is
    # jax.image.resize's.
    gm = torch.from_numpy(gm01).permute(0, 3, 1, 2)
    if gm.shape[-2:] != (h, w):
        gm = F.interpolate(gm, size=(h, w), mode="bilinear", align_corners=False,
                           antialias=False)
    hdr = apply_gm_to_sdr(gm, sdr.cpu().float(), qmax=qmax, clip_output=False)
    return sdr01, gm01, hdr.numpy()


__all__ = ["StableDiffusionControlNetHDRPipeline", "upconvert_sdr_to_hdrtv"]
