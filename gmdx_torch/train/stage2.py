"""Stage-2 GM-UNet training: epsilon (or v) prediction DDPM over
[SDR latents | noisy GM latents].

Counterpart of ``gmdx/train/stage2.py``. Per step: VAE-encode SDR and GM
(x0.18215, frozen) or sample cached posteriors, draw noise (optional
``noise_offset`` / ``input_perturbation``) and uniform timesteps, noise the GM
latents, run the 8-channel UNet on ``cat([sdr_latents, noisy_gm], 1)`` with
the frozen CLIP text states, MSE against the target (optionally min-SNR
weighted), backward, clip + AdamW (every k-th call under gradient
accumulation). EMA advances separately, at each optimizer update
(:func:`make_ema_step`), as in the JAX package.

Differences of form, not of function: the UNet's parameters live in the
module and the optimizer updates them in place, so the step returns the same
state object it was given; an explicit ``torch.Generator`` on the device
replaces the JAX key. Under autograd the UNet's kernel calls take their
differentiated routes (``gmdx_torch.models.layers``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn

from gmdx_torch import resolve_device
from gmdx_torch.dist import tpctx
from gmdx_torch.dist.mesh import all_reduce_mean, batch_rows, randint_rows, randn_rows
from gmdx_torch.schedulers import DDPMScheduler
from gmdx_torch.schedulers.base import add_noise, get_velocity
from gmdx_torch.train.ema import EMAConfig, EMAState, ema_init, ema_update
from gmdx_torch.train.optim import (
    AdamW, MultiSteps, gathered, get_lr_schedule, make_adamw, master_params, model_params,
    param_sq_norms, reduce_gradients,
)


@dataclasses.dataclass(frozen=True)
class Stage2Config:
    learning_rate: float = 1e-5
    lr_scheduler: str = "constant"
    lr_warmup_steps: int = 0
    max_train_steps: int | None = None
    gradient_accumulation_steps: int = 1
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_weight_decay: float = 1e-2
    adam_epsilon: float = 1e-8
    max_grad_norm: float = 1.0
    noise_offset: float = 0.0
    input_perturbation: float = 0.0
    snr_gamma: float | None = None
    use_8bit_adam: bool = False  # bf16 first moment, as in the JAX package
    prediction_type: str = "epsilon"
    use_ema: bool = False
    weight_dtype: torch.dtype = torch.float32


@dataclasses.dataclass
class Stage2State:
    unet: nn.Module  # the trained UNet; its parameters are the state's params
    optimizer: AdamW | MultiSteps
    ema: EMAState | None
    step: int = 0


def make_optimizer(config: Stage2Config, params) -> AdamW | MultiSteps:
    schedule = get_lr_schedule(
        config.lr_scheduler, config.learning_rate,
        num_warmup_steps=config.lr_warmup_steps, num_training_steps=config.max_train_steps,
    )
    opt = make_adamw(
        params, schedule, beta1=config.adam_beta1, beta2=config.adam_beta2,
        weight_decay=config.adam_weight_decay, epsilon=config.adam_epsilon,
        max_grad_norm=config.max_grad_norm, low_precision_moments=config.use_8bit_adam,
    )
    if config.gradient_accumulation_steps > 1:
        opt = MultiSteps(opt, config.gradient_accumulation_steps)
    return opt


def init_state(config: Stage2Config, unet: nn.Module,
               optimizer: AdamW | MultiSteps | None = None) -> Stage2State:
    params = [p for p in unet.parameters() if p.requires_grad]
    return Stage2State(
        unet=unet,
        optimizer=optimizer or make_optimizer(config, params),
        ema=ema_init(params) if config.use_ema else None,
    )


def stage2_loss(
    unet: Callable[..., torch.Tensor],
    *,
    sdr_latents: torch.Tensor,
    gm_latents: torch.Tensor,
    encoder_hidden_states: torch.Tensor,
    noise: torch.Tensor,
    timesteps: torch.Tensor,
    alphas_cumprod: torch.Tensor,
    config: Stage2Config,
    perturbed_noise: torch.Tensor | None = None,
    row_shards: int = 1,
) -> torch.Tensor:
    """The per-batch training loss (fp32 scalar) given encoded latents.
    With ``row_shards`` (spatial parallelism: the latents are this rank's
    rows of images split over that many ranks) it is this rank's share: its
    rows' squared errors over the whole image's count, so that the ranks'
    shares sum to the loss (min-SNR weights apply per sample, alike)."""
    noising = perturbed_noise if perturbed_noise is not None else noise
    noisy_gm = add_noise(alphas_cumprod, gm_latents, noising, timesteps)
    model_in = torch.cat([sdr_latents, noisy_gm], dim=1)
    pred = unet(model_in, timesteps, encoder_hidden_states)

    if config.prediction_type == "epsilon":
        target = noise
    elif config.prediction_type == "v_prediction":
        target = get_velocity(alphas_cumprod, gm_latents, noise, timesteps)
    else:
        raise ValueError(f"unknown prediction_type {config.prediction_type!r}")

    err = (pred.float() - target.float()) ** 2
    per_sample = err.mean(dim=tuple(range(1, err.ndim))) / row_shards
    if config.snr_gamma is not None:
        acp = torch.as_tensor(alphas_cumprod, device=per_sample.device)[timesteps]
        snr = acp / (1.0 - acp)
        if config.prediction_type == "epsilon":
            weight = snr.clamp(max=config.snr_gamma) / snr
        else:  # v_prediction
            weight = snr.clamp(max=config.snr_gamma) / (snr + 1.0)
        per_sample = per_sample * weight
    return per_sample.mean()


def module_key(name: str) -> str:
    """The JAX package's top-level UNet param-tree key of a diffusers
    parameter name (``down_blocks.0.resnets.1.conv1.weight`` ->
    ``down_0_resnet_1``): the groups of ``module_grad_norms``."""
    parts = name.split(".")
    if parts[0] in ("down_blocks", "up_blocks"):
        side, i, kind = parts[0][: -len("_blocks")], parts[1], parts[2]
        if kind == "resnets":
            return f"{side}_{i}_resnet_{parts[3]}"
        if kind == "attentions":
            return f"{side}_{i}_attn_{parts[3]}"
        return f"{side}_{i}_{kind.replace('samplers', 'sample')}"
    if parts[0] == "mid_block":
        return "mid_attn" if parts[1] == "attentions" else f"mid_resnet_{parts[2]}"
    return parts[0]


def make_train_step(
    config: Stage2Config,
    *,
    unet: nn.Module,
    vae: nn.Module,
    text_encoder: nn.Module,
    noise_scheduler: DDPMScheduler | None = None,
    device: str | torch.device = "cuda",
    layout: tpctx.ParallelContext | None = None,
):
    """Build the train step on ``device`` (the card unless the caller asks
    for the CPU); the three modules are moved there, so build the state
    (:func:`init_state`, whose optimizer allocates beside the parameters)
    after this.

    Returns ``step_fn(state, batch, generator) -> (state, metrics)`` with
    ``batch = {"sdr", "gm": (B, 3, H, W) in [-1, 1], "input_ids": (B, 77)}``
    or, cached, ``{"sdr_latent_mean", "sdr_latent_std", "gm_latent_mean",
    "gm_latent_std", "input_ids"}`` with (B, 4, H/8, W/8) posteriors, and
    ``generator`` a ``torch.Generator`` on the device. ``metrics`` holds
    device scalars: ``loss``, ``grad_norm`` (before clipping) and
    ``module_grad_norms`` keyed as the JAX package's param tree.

    Across ranks (``gmdx_torch.dist``; the state distributed by
    ``apply_shard_strategy``) ``batch`` is the rank's rows, every rank
    seeds ``generator`` alike, and the step is the 1-rank step on the
    global batch: the loss reported is the mean over the ranks, the norms
    are of the reduced gradient (of the local micro-batch's while
    ``MultiSteps`` only accumulates). ``step_fn.draw_inputs(batch,
    generator)`` returns the loss's inputs as the step draws them.

    Under tensor or spatial parallelism (``layout``, from
    ``tpctx.join_train_parallel``; the state placed by
    ``apply_shard_strategy(..., layout=layout)``) ``batch`` is the data
    group's rows, alike on every rank of a model group; under sp its image
    leaves are this rank's H rows (``dist.spatial_batch``), and every draw
    is the whole image's, sliced. The UNet runs inside the layout's context
    (its weights this rank's slices under tp); the frozen VAE and text
    encoder run outside it under tp (whole, on the kernels) and the VAE
    inside it under sp (on its rows). The loss reported is the group's (sp:
    the ranks' shares summed), the norms are the whole gradient's.
    """
    dev = resolve_device(device)
    for m in (unet, vae, text_encoder):
        m.to(dev)
    vae.requires_grad_(False)
    text_encoder.requires_grad_(False)
    noise_scheduler = noise_scheduler or DDPMScheduler()
    acp = torch.as_tensor(noise_scheduler.alphas_cumprod, device=dev)
    num_train_timesteps = noise_scheduler.config.num_train_timesteps
    wd = config.weight_dtype
    scaling = vae.config.scaling_factor
    names = [n for n, p in unet.named_parameters() if p.requires_grad]
    # module_grad_norms' groups: each parameter's group index, in first-seen order.
    group_names: dict[str, int] = {}
    group_of = [group_names.setdefault(module_key(n), len(group_names)) for n in names]
    group_index = torch.tensor(group_of, device=dev)

    sp = layout if layout is not None and layout.mode == "sp" else None
    spatial = None if sp is None else (sp, 2)

    def draw_inputs(batch: dict, generator: torch.Generator) -> dict:
        """The loss's inputs for this rank's rows of the batch: latents,
        text states and the step's draws (each made for the global batch
        and sliced to the rank's rows across ranks)."""
        with torch.no_grad():
            rows = batch_rows(batch["input_ids"].shape[0], layout)
            if "sdr_latent_mean" in batch:
                # Cached posteriors: the sampling stays per step, on the device.
                def latents(prefix):
                    mean = batch[f"{prefix}_latent_mean"].to(dev, torch.float32)
                    std = batch[f"{prefix}_latent_std"].to(dev, torch.float32)
                    eps = randn_rows(mean.shape, generator, rows, device=dev, spatial=spatial)
                    return ((mean + std * eps) * scaling).to(wd)
            else:
                def latents(prefix):
                    with tpctx.entered(sp):
                        post = vae.encode(batch[prefix].to(dev, wd))
                    return post.sample(generator, rows, spatial) * scaling
            sdr_latents, gm_latents = latents("sdr"), latents("gm")
            context = text_encoder(batch["input_ids"].to(dev))

            b = gm_latents.shape[0]
            noise = randn_rows(gm_latents.shape, generator, rows, device=dev, spatial=spatial)
            if config.noise_offset > 0:
                noise = noise + config.noise_offset * randn_rows(
                    gm_latents.shape[:2] + (1, 1), generator, rows, device=dev)
            perturbed = None
            if config.input_perturbation > 0:
                perturbed = noise + config.input_perturbation * randn_rows(
                    noise.shape, generator, rows, device=dev, spatial=spatial)
            timesteps = randint_rows(num_train_timesteps, b, generator, rows, device=dev)
        return {"sdr_latents": sdr_latents, "gm_latents": gm_latents,
                "encoder_hidden_states": context, "noise": noise, "timesteps": timesteps,
                "perturbed_noise": perturbed}

    def step_fn(state: Stage2State, batch: dict, generator: torch.Generator):
        inputs = draw_inputs(batch, generator)
        opt = state.optimizer
        params = model_params(opt)  # the module's own: tp's slices once placed
        with gathered(opt), tpctx.entered(layout):
            loss = stage2_loss(state.unet, **inputs, alphas_cumprod=acp, config=config,
                               row_shards=1 if sp is None else sp.size)
            grads = list(torch.autograd.grad(loss, params))
        with torch.no_grad():
            # Across ranks: the mean gradient (as the optimizer steps it).
            # One pass over the gradients: per-parameter norms, summed in
            # squares per module and over all; the clip reuses the total.
            grads = reduce_gradients(opt, grads)
            sq = param_sq_norms(opt, grads)
            module_sq = torch.zeros(len(group_names), device=dev).index_add_(0, group_index, sq)
            grad_norm = sq.sum().sqrt()
            module_norms = module_sq.sqrt()
            metrics = {
                "loss": _group_loss(loss.detach(), sp),
                "grad_norm": grad_norm,
                "module_grad_norms": {k: module_norms[i] for k, i in group_names.items()},
            }
        opt.step(grads, grad_norm)
        state.step += 1
        return state, metrics

    step_fn.draw_inputs = draw_inputs
    return step_fn


def _group_loss(loss: torch.Tensor, sp) -> torch.Tensor:
    """The loss one process would report: the mean over the ranks; under
    spatial parallelism each rank's share summed over its model group,
    then the mean over the data axis."""
    if sp is None:
        return all_reduce_mean(loss)
    total = loss.clone()
    torch.distributed.all_reduce(total)
    return total / sp.data_size


def make_ema_step(config: Stage2Config) -> Callable[[Stage2State], Stage2State]:
    """EMA advance at an optimizer-sync boundary (once per update, not per
    micro-batch, as the JAX package does)."""

    def step_fn(state: Stage2State) -> Stage2State:
        if state.ema is not None:
            ema_update(EMAConfig(), state.ema, master_params(state.optimizer))
        return state

    return step_fn


__all__ = [
    "Stage2Config",
    "Stage2State",
    "make_optimizer",
    "init_state",
    "stage2_loss",
    "module_key",
    "make_train_step",
    "make_ema_step",
]
