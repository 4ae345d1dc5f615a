"""Single-UNet gain-map pipeline: the parts the dual pipeline builds on.

Counterpart of ``gmdx/pipelines/gm.py``: ``rescale_noise_cfg``,
``scheduler_step`` and ``StableDiffusionGMPipeline.decode_latents``. The
single-UNet SDR->HDR denoise loop (``encode_sdr``/``denoise``/``__call__``)
comes with the SDR->HDR slice of the port.
"""

from __future__ import annotations

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
    GM UNet of the single-UNet pipeline (the SDR UNet in the dual one)."""

    def __init__(
        self, unet: nn.Module, vae: nn.Module, scheduler, *,
        device: str | torch.device = "cuda",
    ):
        self.device = resolve_device(device)
        self.unet = unet.to(self.device)
        self.vae = vae.to(self.device)
        self.scheduler = scheduler

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
