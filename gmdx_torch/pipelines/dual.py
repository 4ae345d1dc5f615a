"""Dual-UNet text-to-HDR pipeline: joint SDR + gain-map denoising.

Counterpart of ``gmdx/pipelines/dual.py`` (``prepare_latents``,
``denoise_dual`` and ``__call__``), keeping the reference
pipeline's subtleties:
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

Every sampler serves the loop, as in the single-UNet pipeline: DPM-Solver++
keeps its previous x0 per branch (two states), the GM branch's x0
conditioning stays the eps formula on alphas_cumprod[t] whatever the
sampler, and each step draws its randomness for the SDR branch first, then
for the GM branch (the JAX package splits the step key into k_sdr, k_gm);
explicit ``step_noise[i]`` is that (SDR, GM) pair. The callbacks see the
SDR branch's latents, as the reference's ``latents`` local is that branch.

The per-step algebra lives once, in :func:`sdr_step` and :func:`gm_step`:
the sequential loop calls both in turn, the pipeline-parallel stages of
``gmdx_torch.pipelines.pp`` one each.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from gmdx_torch.dist import tpctx
from gmdx_torch.dist.mesh import spatial_rows
from gmdx_torch.pipelines.gm import (
    StableDiffusionGMPipeline,
    reject_custom_schedule,
    rescale_noise_cfg,
    scheduler_step,
)


def sdr_step(
    sched, state, sdr_eps, lat: torch.Tensor, context: torch.Tensor, *, cond: torch.Tensor,
    uncond: torch.Tensor | None, guidance_scale: float, guidance_rescale: float = 0.0,
    low_memory: bool = False, eta: float = 0.0, generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One step of the SDR branch on NHWC ``lat``: the prediction
    ``sdr_eps(x, t, context)`` under CFG (one doubled batch on ``context``
    = [uncond ‖ cond], or with ``low_memory`` the uncond and cond passes one
    after the other; conditional-only where ``uncond`` is None), with
    ``rescale_noise_cfg``, then x0 by the eps formula on alphas_cumprod[t]
    BEFORE the scheduler's step, then the step. Returns (the latents after
    the step, x0). The sequential loop and the pipelined SDR stage
    (``gmdx_torch.pipelines.pp``) both run it."""
    t = state.timestep
    do_cfg = uncond is not None
    if do_cfg and low_memory:
        eps_uncond = sdr_eps(lat, t, uncond)
        eps_text = sdr_eps(lat, t, cond)
    else:
        eps = sdr_eps(torch.cat([lat, lat]) if do_cfg else lat, t, context)
        if do_cfg:
            eps_uncond, eps_text = eps.chunk(2)
    if do_cfg:
        eps = eps_uncond + guidance_scale * (eps_text - eps_uncond)
        if guidance_rescale > 0.0:
            eps = rescale_noise_cfg(eps, eps_text, guidance_rescale)
    a_t = sched.alphas_cumprod[t]
    x0 = (lat - float(np.sqrt(np.float32(1.0) - a_t)) * eps) / float(np.sqrt(a_t))
    lat = scheduler_step(sched, state, eps, lat, eta=eta, generator=generator, noise=noise)
    return lat, x0


def gm_step(
    sched, state, gm_unet: nn.Module, x0: torch.Tensor, gm_lat: torch.Tensor,
    cond: torch.Tensor, *, eta: float = 0.0, generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """One step of the GM branch: the conditional-only prediction of
    ``gm_unet`` on the channel concat [x0 ‖ gm_lat] (NHWC) at the state's
    timestep, then the scheduler's step. Returns the GM latents after it.
    The sequential loop and the pipelined GM stage both run it."""
    gm_eps = gm_unet(torch.cat([x0, gm_lat], dim=-1), state.timestep, cond, channels_last=True)
    return scheduler_step(sched, state, gm_eps, gm_lat, eta=eta, generator=generator,
                          noise=noise)


class StableDiffusionDualUNetPipeline(StableDiffusionGMPipeline):
    """The 4-channel SDR UNet (``unet``) beside the 8-channel ``gm_unet``.
    It takes no ``safety_checker``: the JAX package's dual ``__call__``
    applies none. A module given as None is absent (a pipeline-parallel
    stage holds only its own, ``gmdx_torch.pipelines.pp``)."""

    def __init__(
        self, unet: nn.Module | None, vae: nn.Module | None, scheduler,
        gm_unet: nn.Module | None, *, text_encoder: nn.Module | None = None, tokenizer=None,
        lora: dict | None = None, device: str | torch.device = "cuda",
    ):
        super().__init__(unet, vae, scheduler, text_encoder=text_encoder, tokenizer=tokenizer,
                         lora=lora, device=device)
        self.gm_unet = None if gm_unet is None else gm_unet.to(self.device)

    def prepare_latents(
        self, generator: torch.Generator, batch_size: int, height: int, width: int
    ) -> torch.Tensor:
        """Initial noise (B, 4, H/8, W/8), fp32, from ``generator``; under
        spatial parallelism the rank's rows of it (``height`` is the whole
        image's)."""
        ctx = tpctx.sp_active()
        rows = height // 8
        if ctx is not None:
            start, stop = spatial_rows(rows, ctx.rank, ctx.size)
            rows = stop - start
        return self._initial_noise(generator, (batch_size, 4, rows, width // 8))

    def denoise_dual(
        self,
        prompt_embeds: torch.Tensor,
        negative_prompt_embeds: torch.Tensor | None,
        latents: torch.Tensor,
        **kwargs,
    ):
        """Returns the (SDR, GM) latents, each (B, 4, h, w) fp32, and with
        ``return_intermediates`` also their per-step stacks. Keyword
        arguments as :meth:`_denoise_dual`'s."""
        return self._denoise_dual(
            lambda x, t, context: self.unet(x, t, context, channels_last=True),
            prompt_embeds, negative_prompt_embeds, latents, **kwargs,
        )

    @torch.no_grad()
    def _denoise_dual(
        self, sdr_eps, prompt_embeds, negative_prompt_embeds, latents, *,
        num_inference_steps: int = 50, guidance_scale: float = 7.5,
        guidance_rescale: float = 0.0, eta: float = 0.0,
        generator: torch.Generator | None = None,
        step_noise: Sequence[tuple[torch.Tensor, torch.Tensor]] | None = None,
        return_intermediates: bool = False, low_memory: bool = False, on_step=None,
    ):
        """The joint loop; ``sdr_eps(x, t, context)`` is the SDR branch's
        prediction on NHWC ``x`` (the ControlNet pipeline adds its
        residuals there). ``on_step(i, t, sdr_latents_nchw)`` runs after
        each step."""
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
        generator = self._default_generator(generator, step_noise)
        inter_sdr, inter_gm = [], []

        for i in range(self._num_steps(num_inference_steps)):
            t = sdr_state.timestep
            noise_sdr, noise_gm = (None, None) if step_noise is None else step_noise[i]
            lat, x0 = sdr_step(sched, sdr_state, sdr_eps, lat, context, cond=cond, uncond=uncond,
                               guidance_scale=guidance_scale, guidance_rescale=guidance_rescale,
                               low_memory=low_memory, eta=eta, generator=generator,
                               noise=noise_sdr)
            gm_lat = gm_step(sched, gm_state, self.gm_unet, x0, gm_lat, cond, eta=eta,
                             generator=generator, noise=noise_gm)
            if return_intermediates or on_step is not None:
                lat_nchw = lat.permute(0, 3, 1, 2).contiguous()
                if return_intermediates:
                    inter_sdr.append(lat_nchw)
                    inter_gm.append(gm_lat.permute(0, 3, 1, 2).contiguous())
                if on_step is not None:
                    on_step(i, t, lat_nchw)

        out = (lat.permute(0, 3, 1, 2).contiguous(), gm_lat.permute(0, 3, 1, 2).contiguous())
        if return_intermediates:
            return out, (torch.stack(inter_sdr), torch.stack(inter_gm))
        return out

    def __call__(
        self,
        prompt: str | Sequence[str] = "",
        *,
        generator: torch.Generator | None = None,
        negative_prompt: str | Sequence[str] | None = None,
        height: int = 512,
        width: int = 512,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        guidance_rescale: float = 0.0,
        eta: float = 0.0,
        latents: torch.Tensor | None = None,
        step_noise: Sequence[tuple[torch.Tensor, torch.Tensor]] | None = None,
        prompt_embeds: torch.Tensor | None = None,
        negative_prompt_embeds: torch.Tensor | None = None,
        num_images_per_prompt: int = 1,
        cross_attention_kwargs: dict | None = None,
        timesteps=None,
        sigmas=None,
        clip_skip: int | None = None,
        output_type: str = "np",
        return_intermediates: bool = False,
        low_memory: bool = False,
        callback_on_step_end=None,
        callback_on_step_end_tensor_inputs=None,
        callback=None,
        callback_steps: int | None = None,
        **denoise_kwargs,
    ):
        """Text (or ``prompt_embeds``) -> the (SDR, GM) pair: latents with
        ``output_type="latent"``, else decoded images in [0, 1], NHWC numpy
        (one batched decode; one image at a time with ``low_memory``); with
        ``return_intermediates`` the pair comes with the per-step (SDR, GM)
        latent stacks, each (steps, B, 4, h, w). ``generator`` (seed 0 on the
        pipeline's device by default) draws the initial noise unless
        ``latents`` is given, then each step's noise in turn unless
        ``step_noise`` gives it. ``denoise_kwargs`` go to
        :meth:`denoise_dual` (the ControlNet pipeline's control image)."""
        self.check_inputs(prompt, height=height, width=width, guidance_rescale=guidance_rescale,
                          negative_prompt=negative_prompt, latents=latents)
        reject_custom_schedule(timesteps, sigmas)
        cb_inputs = self._validate_callback_args(
            callback_on_step_end, callback_on_step_end_tensor_inputs, callback_steps)
        cond, uncond = self._resolve_embeds(
            prompt, negative_prompt, prompt_embeds, negative_prompt_embeds,
            do_cfg=guidance_scale > 1.0, clip_skip=clip_skip,
            num_images_per_prompt=num_images_per_prompt,
        )
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        if latents is None:
            latents = self.prepare_latents(generator, cond.shape[0], height, width)
        hook = self._step_end_hook(callback_on_step_end, cb_inputs, callback, callback_steps,
                                   cond, uncond)
        with self._lora_scaled(cross_attention_kwargs):
            out = self.denoise_dual(
                cond, uncond, torch.as_tensor(latents), num_inference_steps=num_inference_steps,
                guidance_scale=guidance_scale, guidance_rescale=guidance_rescale, eta=eta,
                generator=generator, step_noise=step_noise,
                return_intermediates=return_intermediates, low_memory=low_memory,
                on_step=hook, **denoise_kwargs,
            )
        (sdr_lat, gm_lat), inter = out if return_intermediates else (out, None)
        if output_type == "latent":
            result = (sdr_lat, gm_lat)
        else:
            both = self.decode_latents(torch.cat([sdr_lat, gm_lat]),
                                       chunk=1 if low_memory else None)
            both = (both / 2.0 + 0.5).clamp(0.0, 1.0).permute(0, 2, 3, 1).cpu().numpy()
            b = sdr_lat.shape[0]
            result = (both[:b], both[b:])
        return (result, inter) if return_intermediates else result


__all__ = ["StableDiffusionDualUNetPipeline", "gm_step", "sdr_step"]
