"""Dual-UNet text-to-HDR pipeline: joint SDR + gain-map denoising.

Counterpart of ``gmdx/pipelines/dual.py`` (``denoise_dual`` and
``prepare_latents``), keeping the reference pipeline's subtleties:
  * separate scheduler state per branch;
  * the GM branch is conditioned on the SDR branch's x0 prediction, taken
    from alphas_cumprod[t] BEFORE the SDR scheduler step;
  * the GM branch runs conditional-only (no CFG) on ``prompt_embeds``;
  * gm_latents start as a copy of the SDR latents (PNDM's
    scale_model_input, which the reference applies to both, is the
    identity);
  * ``low_memory`` runs the uncond and cond SDR passes one after the other
    instead of as one CFG-doubled batch.
Latents stay NHWC fp32 across the loop; the UNets take NHWC directly.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from gmdx_torch.pipelines.gm import (
    StableDiffusionGMPipeline,
    rescale_noise_cfg,
    scheduler_step,
)


class StableDiffusionDualUNetPipeline(StableDiffusionGMPipeline):
    """The 4-channel SDR UNet (``unet``) beside the 8-channel ``gm_unet``."""

    def __init__(
        self, unet: nn.Module, vae: nn.Module, scheduler, gm_unet: nn.Module, *,
        device: str | torch.device = "cuda",
    ):
        super().__init__(unet, vae, scheduler, device=device)
        self.gm_unet = gm_unet.to(self.device)

    def prepare_latents(
        self, generator: torch.Generator, batch_size: int, height: int, width: int
    ) -> torch.Tensor:
        """Initial noise (B, 4, H/8, W/8), fp32, from ``generator``."""
        noise = torch.randn(
            (batch_size, 4, height // 8, width // 8), generator=generator,
            device=generator.device, dtype=torch.float32,
        )
        return noise.to(self.device) * self.scheduler.init_noise_sigma

    @torch.no_grad()
    def denoise_dual(
        self,
        prompt_embeds: torch.Tensor,
        negative_prompt_embeds: torch.Tensor | None,
        latents: torch.Tensor,
        *,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        guidance_rescale: float = 0.0,
        low_memory: bool = False,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns the (SDR, GM) latents, each (B, 4, h, w) fp32."""
        dev = self.device
        sched = self.scheduler
        cond = prompt_embeds.to(dev)
        uncond = None if negative_prompt_embeds is None else negative_prompt_embeds.to(dev)
        do_cfg = uncond is not None
        context = torch.cat([uncond, cond]) if do_cfg and not low_memory else cond

        lat = latents.to(dev, torch.float32).permute(0, 2, 3, 1).contiguous()
        gm_lat = lat.clone()
        sdr_state = sched.init_state(num_inference_steps)
        gm_state = sched.init_state(num_inference_steps)
        acp = sched.alphas_cumprod

        for _ in range(sched.num_steps(num_inference_steps)):
            t = sdr_state.timestep
            if do_cfg and low_memory:
                eps_uncond = self.unet(lat, t, uncond, channels_last=True)
                eps_text = self.unet(lat, t, cond, channels_last=True)
            else:
                inp = torch.cat([lat, lat]) if do_cfg else lat
                eps = self.unet(inp, t, context, channels_last=True)
                if do_cfg:
                    eps_uncond, eps_text = eps.chunk(2)
            if do_cfg:
                eps = eps_uncond + guidance_scale * (eps_text - eps_uncond)
                if guidance_rescale > 0.0:
                    eps = rescale_noise_cfg(eps, eps_text, guidance_rescale)

            # x0 prediction BEFORE the SDR step.
            a_t = acp[t]
            x0 = (lat - float(np.sqrt(np.float32(1.0) - a_t)) * eps) / float(np.sqrt(a_t))
            lat = scheduler_step(sched, sdr_state, eps, lat)

            # GM branch, conditional-only.
            gm_eps = self.gm_unet(torch.cat([x0, gm_lat], dim=-1), t, cond, channels_last=True)
            gm_lat = scheduler_step(sched, gm_state, gm_eps, gm_lat)

        return (
            lat.permute(0, 3, 1, 2).contiguous(),
            gm_lat.permute(0, 3, 1, 2).contiguous(),
        )


__all__ = ["StableDiffusionDualUNetPipeline"]
