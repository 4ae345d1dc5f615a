"""Single-UNet gain-map pipeline: SDR-latent-conditioned GM synthesis (the
paper's SDR->HDR up-conversion at 512^2), and the parts the dual pipeline
builds on.

Counterpart of ``gmdx/pipelines/gm.py``: ``rescale_noise_cfg``,
``scheduler_step`` and ``StableDiffusionGMPipeline`` with ``check_inputs``,
``encode_prompt`` (tokenizer + CLIP text encoder), ``_resolve_embeds``
(``prompt_embeds`` passthrough, ``num_images_per_prompt``),
``encode_sdr``, ``prepare_latents``, ``decode_latents``, ``denoise`` and
``__call__``. The denoise loop keeps the reference pipeline's shape: the
4-channel GM latents start as noise sized from the SDR latent, each step
feeds the channel concat [SDR latent, GM latent] to the 8-channel UNet
under CFG (one doubled batch, or two sequential passes with
``low_memory``), with optional ``rescale_noise_cfg``. Latents stay NHWC
fp32 across the loop.

``__call__`` does not yet take step-end callbacks, ``return_intermediates``,
custom ``timesteps``/``sigmas``, LoRA ``cross_attention_kwargs`` or ``eta``
(which waits for DDIM); each raises NotImplementedError.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from gmdx_torch import resolve_device


def rescale_noise_cfg(
    noise_cfg: torch.Tensor, noise_pred_text: torch.Tensor, guidance_rescale: float = 0.0
) -> torch.Tensor:
    """Rescale the CFG output toward the text branch's std (Lin et al. 2023)."""
    dims = tuple(range(1, noise_cfg.ndim))
    std_text = noise_pred_text.std(dim=dims, keepdim=True, unbiased=False)
    std_cfg = noise_cfg.std(dim=dims, keepdim=True, unbiased=False)
    rescaled = noise_cfg * (std_text / std_cfg)
    return guidance_rescale * rescaled + (1.0 - guidance_rescale) * noise_cfg


def scheduler_step(sched, state, eps: torch.Tensor, latents: torch.Tensor) -> torch.Tensor:
    """One sampling step of the pipelines' loops (the single-UNet, dual and
    ControlNet ones). They sample with PNDM, which takes neither a generator
    nor eta; DDIM's and DDPM's arguments join here when those schedulers
    serve sampling."""
    return sched.step(state, eps, latents)


def reject_unported(pipeline: str, **options) -> None:
    """Raise NotImplementedError naming each option given (not None) that
    ``pipeline``'s ``__call__`` does not take yet."""
    given = [k for k, v in options.items() if v is not None]
    if given:
        raise NotImplementedError(f"gmdx_torch's {pipeline} pipeline does not yet take {given}")


class StableDiffusionGMPipeline:
    """Modules plus a scheduler on one device. ``unet`` is the 8-channel
    GM UNet of the single-UNet pipeline (the SDR UNet in the dual one). The
    text encoder and tokenizer are needed only to take prompts as text."""

    def __init__(
        self, unet: nn.Module, vae: nn.Module, scheduler, *,
        text_encoder: nn.Module | None = None, tokenizer=None,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.unet = unet.to(self.device)
        self.vae = vae.to(self.device)
        self.scheduler = scheduler
        self.text_encoder = None if text_encoder is None else text_encoder.to(self.device)
        self.tokenizer = tokenizer

    @staticmethod
    def check_inputs(
        prompt=None,
        height: int | None = None,
        width: int | None = None,
        guidance_rescale: float = 0.0,
        negative_prompt=None,
        latents=None,
    ) -> None:
        """Raise ValueError on malformed inputs (``gmdx/pipelines/gm.py:97-132``)."""
        for name, v in (("height", height), ("width", width)):
            if v is not None and v % 8 != 0:
                raise ValueError(f"{name} must be divisible by 8, got {v}")
        if prompt is not None and not isinstance(prompt, (str, list, tuple)):
            raise ValueError(f"prompt must be str or list, got {type(prompt)}")
        if negative_prompt is not None and not isinstance(negative_prompt, (str, list, tuple)):
            raise ValueError(f"negative_prompt must be str or list, got {type(negative_prompt)}")
        if (isinstance(prompt, (list, tuple)) and isinstance(negative_prompt, (list, tuple))
                and len(prompt) != len(negative_prompt)):
            raise ValueError(f"prompt batch {len(prompt)} != negative_prompt batch "
                             f"{len(negative_prompt)}")
        if not 0.0 <= guidance_rescale <= 1.0:
            raise ValueError(f"guidance_rescale must be in [0, 1], got {guidance_rescale}")
        if latents is not None and (latents.ndim != 4 or latents.shape[1] != 4):
            raise ValueError(f"latents must be (B, 4, h, w), got {getattr(latents, 'shape', None)}")

    @torch.no_grad()
    def encode_prompt(
        self,
        prompt: str | Sequence[str],
        negative_prompt: str | Sequence[str] | None = None,
        *,
        do_cfg: bool = True,
        clip_skip: int | None = None,
    ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(cond, uncond or None), each (B, 77, D) fp32; the negative
        prompt defaults to "" per prompt."""
        if self.tokenizer is None or self.text_encoder is None:
            raise ValueError("prompts as text need a tokenizer and a text encoder; "
                             "pass prompt_embeds instead")
        if isinstance(prompt, str):
            prompt = [prompt]

        def embed(texts):
            ids = torch.as_tensor(self.tokenizer(list(texts))["input_ids"], dtype=torch.long)
            return self.text_encoder(ids.to(self.device), clip_skip=clip_skip)

        cond = embed(prompt)
        if not do_cfg:
            return cond, None
        if negative_prompt is None:
            negative_prompt = [""] * len(prompt)
        elif isinstance(negative_prompt, str):
            negative_prompt = [negative_prompt] * len(prompt)
        return cond, embed(negative_prompt)

    def _resolve_embeds(
        self, prompt, negative_prompt, prompt_embeds, negative_prompt_embeds, *,
        do_cfg: bool, clip_skip: int | None, num_images_per_prompt: int,
    ) -> tuple[torch.Tensor, torch.Tensor | None]:
        """Prompts through :meth:`encode_prompt`, or ``prompt_embeds`` as
        given; each row repeated ``num_images_per_prompt`` times."""
        if prompt_embeds is None:
            cond, uncond = self.encode_prompt(
                prompt, negative_prompt, do_cfg=do_cfg, clip_skip=clip_skip)
        else:
            cond = torch.as_tensor(prompt_embeds, device=self.device)
            uncond = None
            if do_cfg:
                if negative_prompt_embeds is None:
                    raise ValueError("prompt_embeds with guidance_scale > 1 needs "
                                     "negative_prompt_embeds too")
                uncond = torch.as_tensor(negative_prompt_embeds, device=self.device)
        n = num_images_per_prompt
        if n > 1:
            cond = cond.repeat_interleave(n, dim=0)
            uncond = None if uncond is None else uncond.repeat_interleave(n, dim=0)
        return cond, uncond

    def _num_steps(self, num_inference_steps: int) -> int:
        return self.scheduler.num_steps(num_inference_steps)

    @torch.no_grad()
    def encode_sdr(self, sdr: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """SDR images (B, 3, H, W) in [-1, 1] -> a posterior sample drawn with
        ``generator``, times the VAE's scaling factor: (B, 4, H/8, W/8) fp32."""
        post = self.vae.encode(torch.as_tensor(sdr).to(self.device, torch.float32))
        return post.sample(generator) * self.vae.config.scaling_factor

    def prepare_latents(self, generator: torch.Generator, sdr_latent: torch.Tensor) -> torch.Tensor:
        """4-channel noise sized from the SDR latent (B, 4, h, w), fp32, from
        ``generator``, times the scheduler's initial sigma."""
        b, _, h, w = sdr_latent.shape
        noise = torch.randn((b, 4, h, w), generator=generator, device=generator.device,
                            dtype=torch.float32)
        return noise.to(self.device) * self.scheduler.init_noise_sigma

    @torch.no_grad()
    def denoise(
        self,
        sdr_latent: torch.Tensor,
        prompt_embeds: torch.Tensor,
        negative_prompt_embeds: torch.Tensor | None,
        latents: torch.Tensor,
        *,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        guidance_rescale: float = 0.0,
        low_memory: bool = False,
    ) -> torch.Tensor:
        """The GM latents (B, 4, h, w) fp32 after the loop, conditioned on
        ``sdr_latent`` (B, 4, h, w). PNDM's model input needs no scaling."""
        dev = self.device
        sched = self.scheduler
        cond = prompt_embeds.to(dev)
        uncond = None if negative_prompt_embeds is None else negative_prompt_embeds.to(dev)
        do_cfg = uncond is not None
        context = torch.cat([uncond, cond]) if do_cfg and not low_memory else cond
        sdr = sdr_latent.to(dev, torch.float32).permute(0, 2, 3, 1).contiguous()
        lat = latents.to(dev, torch.float32).permute(0, 2, 3, 1).contiguous()
        state = sched.init_state(num_inference_steps)

        def eps_of(x, ctx):
            return self.unet(x, state.timestep, ctx, channels_last=True)

        for _ in range(self._num_steps(num_inference_steps)):
            model_in = torch.cat([sdr, lat], dim=-1)
            if do_cfg and low_memory:
                eps_uncond, eps_text = eps_of(model_in, uncond), eps_of(model_in, cond)
            else:
                eps = eps_of(torch.cat([model_in, model_in]) if do_cfg else model_in, context)
                if do_cfg:
                    eps_uncond, eps_text = eps.chunk(2)
            if do_cfg:
                eps = eps_uncond + guidance_scale * (eps_text - eps_uncond)
                if guidance_rescale > 0.0:
                    eps = rescale_noise_cfg(eps, eps_text, guidance_rescale)
            lat = scheduler_step(sched, state, eps, lat)
        return lat.permute(0, 3, 1, 2).contiguous()

    def __call__(
        self,
        sdr_latent: torch.Tensor,
        prompt: str | Sequence[str] = "",
        *,
        generator: torch.Generator | None = None,
        negative_prompt: str | Sequence[str] | None = None,
        num_inference_steps: int = 50,
        guidance_scale: float = 7.5,
        guidance_rescale: float = 0.0,
        latents: torch.Tensor | None = None,
        prompt_embeds: torch.Tensor | None = None,
        negative_prompt_embeds: torch.Tensor | None = None,
        num_images_per_prompt: int = 1,
        clip_skip: int | None = None,
        output_type: str = "np",
        low_memory: bool = False,
        eta: float | None = None,
        cross_attention_kwargs: dict | None = None,
        timesteps=None,
        sigmas=None,
        return_intermediates: bool = False,
        callback_on_step_end=None,
        callback_on_step_end_tensor_inputs=None,
        callback=None,
        callback_steps: int | None = None,
    ):
        """The SDR latent (B, 4, h, w) and a prompt (or ``prompt_embeds``) ->
        the GM latents with ``output_type="latent"``, else the decoded gain
        maps in [0, 1], NHWC numpy (one at a time with ``low_memory``).
        ``num_images_per_prompt`` repeats ``sdr_latent`` as it repeats the
        embeddings. ``generator`` draws the initial noise unless ``latents``
        is given (seed 0 on the pipeline's device by default)."""
        self.check_inputs(prompt, guidance_rescale=guidance_rescale,
                          negative_prompt=negative_prompt, latents=latents)
        reject_unported(
            "single-UNet", eta=eta, cross_attention_kwargs=cross_attention_kwargs,
            timesteps=timesteps, sigmas=sigmas, return_intermediates=return_intermediates or None,
            callback_on_step_end=callback_on_step_end,
            callback_on_step_end_tensor_inputs=callback_on_step_end_tensor_inputs,
            callback=callback, callback_steps=callback_steps,
        )
        cond, uncond = self._resolve_embeds(
            prompt, negative_prompt, prompt_embeds, negative_prompt_embeds,
            do_cfg=guidance_scale > 1.0, clip_skip=clip_skip,
            num_images_per_prompt=num_images_per_prompt,
        )
        sdr_latent = torch.as_tensor(sdr_latent).to(self.device, torch.float32)
        if num_images_per_prompt > 1:
            sdr_latent = sdr_latent.repeat_interleave(num_images_per_prompt, dim=0)
        if latents is None:
            if generator is None:
                generator = torch.Generator(device=self.device).manual_seed(0)
            latents = self.prepare_latents(generator, sdr_latent)
        gm_lat = self.denoise(
            sdr_latent, cond, uncond, torch.as_tensor(latents),
            num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
            guidance_rescale=guidance_rescale, low_memory=low_memory,
        )
        if output_type == "latent":
            return gm_lat
        img = self.decode_latents(gm_lat, chunk=1 if low_memory else None)
        return np.ascontiguousarray(
            (img / 2.0 + 0.5).clamp(0.0, 1.0).permute(0, 2, 3, 1).cpu().numpy())

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor, chunk: int | None = None) -> torch.Tensor:
        """Latents (B, 4, h, w) -> images (B, 3, 8h, 8w) in [-1, 1], fp32.

        ``chunk`` decodes that many images at a time instead of one batched
        pass (the decoder's full-resolution activations dominate memory);
        it must divide the batch."""
        z = latents.to(self.device, torch.float32) / self.vae.config.scaling_factor
        b = z.shape[0]
        if chunk is None or b <= chunk:
            return self.vae.decode(z)
        if b % chunk:
            raise ValueError(f"decode chunk {chunk} must divide the batch {b}")
        return torch.cat([self.vae.decode(zc) for zc in z.split(chunk)])


__all__ = [
    "rescale_noise_cfg", "reject_unported", "scheduler_step", "StableDiffusionGMPipeline",
]
