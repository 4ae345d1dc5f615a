"""Single-UNet gain-map pipeline: the parts the dual pipeline builds on.

Counterpart of ``gmdx/pipelines/gm.py``: ``rescale_noise_cfg``,
``scheduler_step`` and, of ``StableDiffusionGMPipeline``, ``check_inputs``,
``encode_prompt`` (tokenizer + CLIP text encoder), the ``prompt_embeds``
passthrough and ``num_images_per_prompt`` of ``_resolve_embeds``, and
``decode_latents``. The single-UNet SDR->HDR denoise loop
(``encode_sdr``/``denoise``/``__call__``) comes with the SDR->HDR slice of
the port.
"""

from __future__ import annotations

from typing import Sequence

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
    """One scheduler step. PNDM, the one scheduler of the port so far, takes
    neither a generator nor eta; DDIM's and DDPM's arguments join here when
    those schedulers are ported."""
    return sched.step(state, eps, latents)


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


__all__ = ["rescale_noise_cfg", "scheduler_step", "StableDiffusionGMPipeline"]
