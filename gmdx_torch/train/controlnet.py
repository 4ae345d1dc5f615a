"""ControlNet training: epsilon prediction through a frozen SD UNet, with a
trainable ControlNet steering it.

Counterpart of ``gmdx/train/controlnet.py``. Per step: VAE-encode the target
(a posterior sample x the scaling factor), run the text encoder on the ids,
map the control image from [-1, 1] to [0, 1] (resized bilinearly to 8x the
latent grid where a VAE of another scale factor makes them differ), draw the
noise and uniform timesteps, noise the latents, run the ControlNet on the
noisy latents and the control image, add its residuals into the frozen
UNet's skips and mid state, MSE against the noise, backward, clip + AdamW
on the ControlNet's parameters only (every k-th call under gradient
accumulation). EMA advances at each optimizer update
(:func:`make_controlnet_ema_step`), as in Stage 2.

The VAE and the text encoder run without autograd. The UNet's parameters
take no gradient, but the UNet runs under autograd so that the gradient
reaches the residuals: its down and mid blocks see no tensor that needs a
gradient and take the inference kernels, its up blocks (which take the
residuals) and the whole ControlNet the training kernels
(``gmdx_torch.kernels.needs_grad``). As in the port's Stage 2, the
ControlNet's parameters live in the module and are updated in place, and
an explicit ``torch.Generator`` on the device replaces the JAX key.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from gmdx_torch import resolve_device
from gmdx_torch.dist.mesh import all_reduce_mean, batch_rows, randint_rows, randn_rows
from gmdx_torch.schedulers import DDPMScheduler
from gmdx_torch.schedulers.base import add_noise
from gmdx_torch.train.ema import EMAConfig, EMAState, ema_init, ema_update
from gmdx_torch.train.optim import (
    AdamW, MultiSteps, data_parallel, gathered, global_norm, master_params, model_params,
    param_sq_norms, reduce_gradients,
)
from gmdx_torch.train.stage2 import Stage2Config, make_optimizer

# The same settings as Stage 2 (rate, schedule, Adam, EMA, precision).
ControlNetTrainConfig = Stage2Config


@dataclasses.dataclass
class ControlNetState:
    controlnet: nn.Module  # the trained ControlNet; its parameters are the state's params
    optimizer: AdamW | MultiSteps
    ema: EMAState | None
    step: int = 0


def init_controlnet_state(config: ControlNetTrainConfig, controlnet: nn.Module,
                          optimizer: AdamW | MultiSteps | None = None) -> ControlNetState:
    """The state over ``controlnet``'s parameters that require grad (the
    optimizer and EMA allocate beside them: build the state after the
    step has moved the modules)."""
    params = [p for p in controlnet.parameters() if p.requires_grad]
    return ControlNetState(
        controlnet=controlnet,
        optimizer=optimizer or make_optimizer(config, params),
        ema=ema_init(params) if config.use_ema else None,
    )


def resize_control(cond01: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """The control image (B, 3, H, W) at ``size``: bilinear with half-pixel
    centres, as ``jax.image.resize(..., "bilinear")``, antialiased when it
    shrinks (JAX widens its kernel then)."""
    if tuple(cond01.shape[-2:]) == tuple(size):
        return cond01
    shrink = size[0] < cond01.shape[-2] or size[1] < cond01.shape[-1]
    return F.interpolate(cond01, size=size, mode="bilinear", align_corners=False,
                         antialias=shrink)


def controlnet_loss(
    controlnet: nn.Module,
    unet: nn.Module,
    *,
    noisy_latents: torch.Tensor,
    timesteps: torch.Tensor,
    encoder_hidden_states: torch.Tensor,
    control_image: torch.Tensor,
    noise: torch.Tensor,
) -> torch.Tensor:
    """The per-batch loss (fp32 scalar): the ControlNet's residuals on
    ``noisy_latents`` and ``control_image`` (B, 3, 8h, 8w) in [0, 1] fed to
    the UNet's hooks, MSE of its prediction against ``noise``."""
    downs, mid = controlnet(noisy_latents, timesteps, encoder_hidden_states, control_image)
    pred = unet(noisy_latents, timesteps, encoder_hidden_states,
                down_block_additional_residuals=downs, mid_block_additional_residual=mid)
    return torch.mean((pred.float() - noise) ** 2)


def make_controlnet_train_step(
    config: ControlNetTrainConfig,
    *,
    unet: nn.Module,
    vae: nn.Module,
    text_encoder: nn.Module,
    controlnet: nn.Module,
    noise_scheduler: DDPMScheduler | None = None,
    device: str | torch.device = "cuda",
):
    """Build the train step on ``device`` (the card unless the caller asks
    for the CPU); the four modules move there and the UNet, VAE and text
    encoder are frozen. Build the state (:func:`init_controlnet_state`)
    after this.

    Returns ``step_fn(state, batch, generator) -> (state, metrics)`` with
    ``batch = {"image", "cond": (B, 3, H, W) in [-1, 1], "input_ids":
    (B, 77)}`` and ``generator`` a ``torch.Generator`` on the device (drawn
    in order: the posterior, the noise, the timesteps). ``metrics`` holds
    device scalars ``loss`` and ``grad_norm`` (before clipping). Across
    ranks the draws are the rank's rows of the global batch's, the
    optimizer reduces the gradients and the loss is the mean over the
    ranks, as in the Stage-2 step."""
    dev = resolve_device(device)
    for m in (unet, vae, text_encoder, controlnet):
        m.to(dev)
    for m in (unet, vae, text_encoder):
        m.requires_grad_(False)
    noise_scheduler = noise_scheduler or DDPMScheduler()
    acp = torch.as_tensor(noise_scheduler.alphas_cumprod, device=dev)
    num_train_timesteps = noise_scheduler.config.num_train_timesteps
    wd = config.weight_dtype
    scaling = vae.config.scaling_factor

    def step_fn(state: ControlNetState, batch: dict, generator: torch.Generator):
        opt = state.optimizer
        with torch.no_grad():
            b = batch["input_ids"].shape[0]
            rows = batch_rows(b)
            latents = vae.encode(batch["image"].to(dev, wd)).sample(generator, rows) * scaling
            context = text_encoder(batch["input_ids"].to(dev))
            cond01 = (batch["cond"].to(dev, wd) + 1.0) / 2.0
            # The embedder downsamples 8x to the latent grid; a VAE of
            # another scale factor (the tiny test configs) needs a resize.
            cond01 = resize_control(cond01, (latents.shape[2] * 8, latents.shape[3] * 8))
            noise = randn_rows(latents.shape, generator, rows, device=dev)
            timesteps = randint_rows(num_train_timesteps, b, generator, rows, device=dev)
            noisy = add_noise(acp, latents.float(), noise, timesteps).to(wd)

        with gathered(opt):
            loss = controlnet_loss(state.controlnet, unet, noisy_latents=noisy,
                                   timesteps=timesteps, encoder_hidden_states=context,
                                   control_image=cond01, noise=noise)
            grads = list(torch.autograd.grad(loss, model_params(opt)))
        grads = reduce_gradients(opt, grads)
        with torch.no_grad():
            grad_norm = (global_norm(grads) if data_parallel(opt) is None
                         else param_sq_norms(opt, grads).sum().sqrt())
        opt.step(grads, grad_norm)
        state.step += 1
        return state, {"loss": all_reduce_mean(loss.detach()), "grad_norm": grad_norm}

    return step_fn


def make_controlnet_ema_step(
        config: ControlNetTrainConfig) -> Callable[[ControlNetState], ControlNetState]:
    """EMA advance at an optimizer-sync boundary (once per update, not per
    micro-batch)."""

    def step_fn(state: ControlNetState) -> ControlNetState:
        if state.ema is not None:
            ema_update(EMAConfig(), state.ema, master_params(state.optimizer))
        return state

    return step_fn


__all__ = [
    "ControlNetTrainConfig",
    "ControlNetState",
    "init_controlnet_state",
    "resize_control",
    "controlnet_loss",
    "make_controlnet_train_step",
    "make_controlnet_ema_step",
]
