"""Stage-1 VAE-LoRA + GAN training: learn the gain-map decoder head.

Counterpart of ``gmdx/train/stage1.py``. The trainables are LoRA factors on
every VAE conv and Linear weight plus the decoder's ``conv_out`` (weight and
bias); the frozen VAE's parameters are never copied. Each step merges them
into the effective weights (the trainable ``conv_out`` replaces the base
first, then LoRA adds on top) and runs the unchanged VAE with those weights
swapped in (:func:`vae_weights`); the generator step holds them over its
backward passes, where remat (``--gradient_checkpointing``) recomputes the
VAE's blocks.

* Generator step: ``sigmoid(decode(encode(miss).sample))`` is the gain map;
  Eq. (1) on the SDR input, the TMO, the gamut compression give the image
  held to the target by recon (L2 or L1) + VGG19 perceptual + w * (-D(fake)).
  w is the ratio of the perceptual and adversarial gradient norms at the
  effective ``conv_out`` kernel, clipped at ``adaptive_weight_max`` and
  detached: two ``torch.autograd.grad`` probes on that kernel alone over the
  one shared forward, then one backward of the whole loss, then clipped
  AdamW.
* Discriminator step: the fake is made without autograd; hinge loss plus
  ``gp_weight * mean((||dD(real)/dx|| - 1)^2)`` through a double backward
  (the norm's gradient is 0 at a zero norm, as ``optax.safe_norm``); clipped
  AdamW; then the spectral-norm state refreshes on the fake.
* EMA advances at each optimizer sync (:func:`make_ema_step`), after
  generator and discriminator steps alike, as in the JAX package.

Under autograd the VAE's kernel calls take their differentiated routes
(``gmdx_torch.models.layers``): the 3x3 convs the direct conv, the
GroupNorms :class:`~gmdx_torch.kernels.groupnorm.GroupNormSiLU` (forward and
backward kernels), the mid-block attention past 4096 tokens
:class:`~gmdx_torch.kernels.attention.FlashAttention` (the 512-wide flash
forward and backward kernels). Parameters stay fp32 and are cast to the
VAE's compute dtype at use.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable

import torch
from torch import nn

from gmdx_torch import resolve_device
from gmdx_torch.dist.mesh import all_reduce_mean, batch_rows, world_size
from gmdx_torch.models.lora import LoRAConfig, init_lora_params, merge_lora
from gmdx_torch.models.vgg import perceptual_loss, resize_for_vgg
from gmdx_torch.ops import apply_gm_to_sdr, gamut_compress
from gmdx_torch.train.ema import EMAConfig, EMAState, ema_init, ema_update
from gmdx_torch.train.optim import (
    AdamW, MultiSteps, data_parallel, gathered, get_lr_schedule, global_norm, master_params,
    model_params, param_sq_norms, reduce_gradients,
)

CONV_OUT = "decoder.conv_out"


@dataclasses.dataclass(frozen=True)
class Stage1Config:
    qmax: float = 49.0
    vae_loss: str = "l2"  # "l2" | "l1"
    lora: LoRAConfig = LoRAConfig(rank=64, alpha=64.0)
    gp_weight: float = 10.0
    adaptive_weight_max: float = 1e4
    scaling_factor: float = 0.18215
    use_ema: bool = False
    vgg_resolution: int = 224


@dataclasses.dataclass
class Stage1State:
    trainables: dict  # {"lora": {name: {"a", "b"}}, "conv_out": {"weight", "bias"}}
    discriminator: nn.Module  # its parameters and spectral-norm buffers
    optimizer: AdamW | MultiSteps
    disc_optimizer: AdamW | MultiSteps
    ema: EMAState | None
    step: int = 0


def trainable_list(trainables: dict) -> list[torch.Tensor]:
    """The trainables in the optimizer's fixed order: the LoRA factors by
    sorted name (``a``, then ``b``), then ``conv_out``'s weight and bias."""
    lora = trainables["lora"]
    return [lora[n][k] for n in sorted(lora) for k in ("a", "b")] + [
        trainables["conv_out"]["weight"], trainables["conv_out"]["bias"]]


def trainable_names(trainables: dict) -> list[str]:
    """Names of :func:`trainable_list`'s tensors, in its order:
    ``lora/<weight name>/a|b``, ``conv_out/weight|bias``."""
    return [f"lora/{n}/{k}" for n in sorted(trainables["lora"]) for k in ("a", "b")] + [
        "conv_out/weight", "conv_out/bias"]


def trainables_like(trainables: dict, tensors) -> dict:
    """``tensors`` in :func:`trainable_list`'s order (e.g. the EMA shadow)
    laid out as ``trainables``."""
    it = iter(tensors)
    return {"lora": {n: {k: next(it) for k in ("a", "b")} for n in sorted(trainables["lora"])},
            "conv_out": {k: next(it) for k in ("weight", "bias")}}


def init_trainables(generator: torch.Generator, vae: nn.Module, config: Stage1Config) -> dict:
    """LoRA factors for every VAE target (``a`` from ``generator``) and an
    fp32 copy of the decoder's ``conv_out``, all requiring grad, on the
    generator's device."""
    dev = generator.device
    conv_out = vae.get_submodule(CONV_OUT)
    trainables = {
        "lora": init_lora_params(generator, vae, config.lora),
        "conv_out": {"weight": conv_out.weight.detach().float().clone().to(dev),
                     "bias": conv_out.bias.detach().float().clone().to(dev)},
    }
    for t in trainable_list(trainables):
        t.requires_grad_(True)
    return trainables


def effective_vae_params(config: Stage1Config, vae: nn.Module, trainables: dict) -> dict:
    """Name -> tensor of the VAE as the step runs it: the trainable
    ``conv_out`` replaces the base first, then LoRA merges on top (so the
    ``conv_out`` factors stay in the gradient path)."""
    base = dict(vae.named_parameters())
    base[f"{CONV_OUT}.weight"] = trainables["conv_out"]["weight"]
    base[f"{CONV_OUT}.bias"] = trainables["conv_out"]["bias"]
    return merge_lora(base, trainables["lora"], config.lora.scale)


@contextlib.contextmanager
def vae_weights(vae: nn.Module, params: dict):
    """``vae`` computing with ``params`` (name -> tensor) in place of its
    own parameters until the block exits. Hold it over the backward passes
    too: remat (``--gradient_checkpointing``) recomputes the blocks there,
    with the weights the module holds at that time."""
    saved = {}
    try:
        for name, t in params.items():
            mod_name, _, leaf = name.rpartition(".")
            sub = vae.get_submodule(mod_name)
            if id(sub) not in saved:
                saved[id(sub)] = (sub, dict(sub._parameters))
            del sub._parameters[leaf]
            setattr(sub, leaf, t)
        yield vae
    finally:
        for sub, own in saved.values():
            for leaf in own:
                if leaf not in sub._parameters:
                    sub.__dict__.pop(leaf, None)
            sub._parameters.clear()
            sub._parameters.update(own)


def gm_head(config: Stage1Config, vae: nn.Module, miss_pixels: torch.Tensor,
            eps: torch.Tensor | None = None,
            generator: torch.Generator | None = None,
            rows: tuple[int, int] | None = None) -> torch.Tensor:
    """``sigmoid(decode(encode(x).sample() * s / s))`` with the VAE's
    current weights; ``miss_pixels`` (B, 3, H, W) in [-1, 1]. ``eps``
    replaces the posterior's draw (else one from ``generator``, for this
    rank's ``rows`` of the global batch across ranks)."""
    post = vae.encode(miss_pixels)
    sampled = post.sample(generator, rows) if eps is None else post.mean + post.std * eps
    latent = sampled * config.scaling_factor
    return torch.sigmoid(vae.decode(latent / config.scaling_factor))


def gm_forward(config: Stage1Config, vae: nn.Module, params: dict, miss_pixels: torch.Tensor,
               eps: torch.Tensor | None = None,
               generator: torch.Generator | None = None,
               rows: tuple[int, int] | None = None) -> torch.Tensor:
    """:func:`gm_head` with the VAE's weights taken from ``params``, for a
    caller that does not differentiate it (the generator step holds
    :func:`vae_weights` over its backward passes instead)."""
    with vae_weights(vae, params):
        return gm_head(config, vae, miss_pixels, eps, generator, rows)


def reconstruct_and_tonemap(config: Stage1Config, gm: torch.Tensor, sdr01: torch.Tensor,
                            tmo_fn: Callable) -> torch.Tensor:
    hdr = apply_gm_to_sdr(gm, sdr01, qmax=config.qmax)
    return gamut_compress(tmo_fn(hdr, qmax=config.qmax))


def perceptual(vgg: nn.Module, a01: torch.Tensor, b01: torch.Tensor,
               resolution: int = 224) -> torch.Tensor:
    """VGG19 feature-pyramid MSE at the backbone resolution; ``a01`` is the
    target, whose features take no gradient."""
    with torch.no_grad():
        fa = vgg(resize_for_vgg(a01, resolution))
    fb = vgg(resize_for_vgg(b01, resolution))
    return perceptual_loss(fa, fb)


# The CLI's learning rates (train_vqgan_lora.py:83-84).
LEARNING_RATE = DISCR_LEARNING_RATE = 1e-4


def make_optimizers(
    trainables: dict,
    discriminator: nn.Module,
    *,
    learning_rate: float = LEARNING_RATE,
    discr_learning_rate: float = DISCR_LEARNING_RATE,
    lr_scheduler: str = "constant",
    discr_lr_scheduler: str = "constant",
    lr_warmup_steps: int = 500,
    num_training_steps: int | None = None,
    beta1: float = 0.9,
    beta2: float = 0.999,
    weight_decay: float = 1e-2,
    epsilon: float = 1e-8,
    max_grad_norm: float = 1.0,
    gradient_accumulation_steps: int = 1,
) -> tuple[AdamW | MultiSteps, AdamW | MultiSteps]:
    """Clipped AdamW for the trainables and for the discriminator's
    parameters, as ``scripts/stage1/train_vqgan_lora.py:345-375`` builds
    them (the defaults are its CLI's): each its own rate and schedule
    (warmup and ``num_training_steps``, the updates of the run), the same
    moments, decay, epsilon and clip; with ``gradient_accumulation_steps``
    k > 1 each in :class:`~gmdx_torch.train.optim.MultiSteps` (the mean of
    k micro-steps' gradients, one update every k-th call, as
    ``optax.MultiSteps``)."""
    adam = dict(beta1=beta1, beta2=beta2, weight_decay=weight_decay, epsilon=epsilon,
                max_grad_norm=max_grad_norm)
    opts = []
    for params, name, lr in ((trainable_list(trainables), lr_scheduler, learning_rate),
                             (list(discriminator.parameters()), discr_lr_scheduler,
                              discr_learning_rate)):
        schedule = get_lr_schedule(name, lr, num_warmup_steps=lr_warmup_steps,
                                   num_training_steps=num_training_steps)
        opt = AdamW(params, schedule, **adam)
        opts.append(MultiSteps(opt, gradient_accumulation_steps)
                    if gradient_accumulation_steps > 1 else opt)
    return opts[0], opts[1]


def init_state(config: Stage1Config, trainables: dict, discriminator: nn.Module,
               optimizers: tuple | None = None) -> Stage1State:
    """The state; ``optimizers`` (generator's, discriminator's) default to
    :func:`make_optimizers` at its defaults."""
    gen, disc = optimizers or make_optimizers(trainables, discriminator)
    return Stage1State(
        trainables=trainables, discriminator=discriminator, optimizer=gen, disc_optimizer=disc,
        ema=ema_init(trainable_list(trainables)) if config.use_ema else None,
    )


def _frozen(vae: nn.Module, dev: torch.device, *modules: nn.Module) -> None:
    for m in (vae, *modules):
        m.to(dev).requires_grad_(False)


def make_gen_step(config: Stage1Config, *, vae: nn.Module, discriminator: nn.Module,
                  vgg: nn.Module, tmo_fn: Callable, device: str | torch.device = "cuda"):
    """The generator step on ``device`` (the card unless the caller asks for
    the CPU); the modules move there. Returns ``step_fn(state, batch,
    generator=None) -> (state, metrics)`` with ``batch = {"pixel_values",
    "miss_pixel_values": (B, 3, H, W) in [-1, 1]}`` and optionally
    ``"encode_eps"`` (B, 4, H/8, W/8), the posterior's draw (else one from
    ``generator``). ``metrics`` holds device scalars: ``gen_loss``,
    ``grad_norm`` (before clipping), ``module_grad_norms`` (``lora``,
    ``conv_out``), ``recon``, ``perceptual``, ``adversarial`` and
    ``adaptive_weight``.

    Across ranks (``batch`` the rank's rows, ``generator`` seeded alike)
    the posterior's draw is the rank's rows of the global batch's, the two
    probes are averaged over the ranks before their norms (the JAX package
    takes them on the global batch), the optimizer reduces the gradients,
    and the losses reported are means over the ranks."""
    dev = resolve_device(device)
    _frozen(vae, dev, vgg)
    discriminator.to(dev)

    def step_fn(state: Stage1State, batch: dict, generator: torch.Generator | None = None):
        target01 = (batch["pixel_values"].to(dev) + 1.0) / 2.0
        miss = batch["miss_pixel_values"].to(dev)
        sdr01 = (miss + 1.0) / 2.0
        eps = batch.get("encode_eps")
        opt = state.optimizer
        rows = batch_rows(miss.shape[0])
        with gathered(opt, state.disc_optimizer):
            params = effective_vae_params(config, vae, state.trainables)
            kernel = params[f"{CONV_OUT}.weight"]
            with vae_weights(vae, params):
                gm = gm_head(config, vae, miss, None if eps is None else eps.to(dev), generator,
                             rows)
                tmo = reconstruct_and_tonemap(config, gm, sdr01, tmo_fn)
                if config.vae_loss == "l2":
                    recon = torch.mean((target01 - tmo) ** 2)
                else:
                    recon = torch.mean(torch.abs(target01 - tmo))
                perc = perceptual(vgg, target01, tmo, config.vgg_resolution)
                adv = -torch.mean(state.discriminator(tmo, update_sn=False))

                # The adaptive weight: gradient norms at the effective conv_out
                # kernel alone, over the same forward (of the global batch:
                # the probes are averaged over the ranks).
                (g_perc,) = torch.autograd.grad(perc, kernel, retain_graph=True)
                (g_adv,) = torch.autograd.grad(adv, kernel, retain_graph=True)
                g_perc, g_adv = all_reduce_mean(g_perc), all_reduce_mean(g_adv)
                adaptive = (torch.linalg.vector_norm(g_perc)
                            / torch.linalg.vector_norm(g_adv).clamp(min=1e-8))
                adaptive = adaptive.clamp(max=config.adaptive_weight_max).detach()
                loss = recon + perc + adaptive * adv

                grads = list(torch.autograd.grad(loss, trainable_list(state.trainables)))
        grads = reduce_gradients(opt, grads)
        with torch.no_grad():
            n_lora = 2 * len(state.trainables["lora"])
            if data_parallel(opt) is None:
                lora_norm = global_norm(grads[:n_lora])
                conv_out_norm = global_norm(grads[n_lora:])
            else:
                sq = param_sq_norms(opt, grads)
                lora_norm, conv_out_norm = sq[:n_lora].sum().sqrt(), sq[n_lora:].sum().sqrt()
            grad_norm = torch.sqrt(lora_norm**2 + conv_out_norm**2)
            loss, recon, perc, adv = _mean_over_ranks(loss, recon, perc, adv)
        opt.step(grads, grad_norm)
        state.step += 1
        metrics = {
            "gen_loss": loss, "grad_norm": grad_norm,
            "module_grad_norms": {"lora": lora_norm, "conv_out": conv_out_norm},
            "recon": recon, "perceptual": perc,
            "adversarial": adv, "adaptive_weight": adaptive,
        }
        return state, metrics

    return step_fn


def safe_norm(g: torch.Tensor) -> torch.Tensor:
    """Row L2 norms of (N, M) ``g`` whose gradient is 0 at a zero row
    (``optax.safe_norm(g, 0.0, axis=1)``)."""
    zero = (g * g).sum(dim=1) <= 0
    masked = torch.where(zero[:, None], torch.ones_like(g), g)
    return torch.where(zero, torch.zeros_like(zero, dtype=g.dtype),
                       torch.linalg.vector_norm(masked, dim=1))


def make_disc_step(config: Stage1Config, *, vae: nn.Module, discriminator: nn.Module,
                   tmo_fn: Callable, device: str | torch.device = "cuda"):
    """The discriminator step on ``device``. Returns ``step_fn(state, batch,
    generator=None) -> (state, metrics)`` (batch as :func:`make_gen_step`'s)
    with device scalars ``disc_loss``, ``grad_norm``, ``hinge`` and ``gp``."""
    dev = resolve_device(device)
    _frozen(vae, dev)
    discriminator.to(dev)

    def step_fn(state: Stage1State, batch: dict, generator: torch.Generator | None = None):
        disc = state.discriminator
        opt = state.disc_optimizer
        target01 = (batch["pixel_values"].to(dev) + 1.0) / 2.0
        miss = batch["miss_pixel_values"].to(dev)
        sdr01 = (miss + 1.0) / 2.0
        eps = batch.get("encode_eps")
        with torch.no_grad(), gathered(state.optimizer):
            params = effective_vae_params(config, vae, state.trainables)
            gm = gm_forward(config, vae, params, miss, None if eps is None else eps.to(dev),
                            generator, batch_rows(miss.shape[0]))
            fake = reconstruct_and_tonemap(config, gm, sdr01, tmo_fn)

        with gathered(opt):
            real = target01.detach().requires_grad_(True)
            real_out = disc(real, update_sn=False)
            (grad_images,) = torch.autograd.grad(real_out.sum(), real, create_graph=True)
            fake_out = disc(fake, update_sn=False)
            hinge = torch.mean(torch.relu(1.0 + fake_out) + torch.relu(1.0 - real_out))
            g = grad_images.reshape(grad_images.shape[0], -1)
            gp = config.gp_weight * torch.mean((safe_norm(g) - 1.0) ** 2)
            loss = hinge + gp
            grads = list(torch.autograd.grad(loss, model_params(opt)))
        grads = reduce_gradients(opt, grads)
        with torch.no_grad():
            grad_norm = (global_norm(grads) if data_parallel(opt) is None
                         else param_sq_norms(opt, grads).sum().sqrt())
            loss, hinge, gp = _mean_over_ranks(loss, hinge, gp)
        opt.step(grads, grad_norm)
        with torch.no_grad(), gathered(opt):  # refresh the power-iteration state
            disc(fake, update_sn=True)
        state.step += 1
        metrics = {"disc_loss": loss, "grad_norm": grad_norm, "hinge": hinge, "gp": gp}
        return state, metrics

    return step_fn


def _mean_over_ranks(*scalars: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Detached scalars, each the mean over the ranks (one collective)."""
    if world_size() == 1:
        return tuple(t.detach() for t in scalars)
    return tuple(all_reduce_mean(torch.stack([t.detach().float() for t in scalars])).unbind())


def make_ema_step(config: Stage1Config) -> Callable[[Stage1State], Stage1State]:
    """EMA advance at an optimizer-sync boundary: after generator and
    discriminator steps alike, so the decay ramp advances twice a pair."""

    def step_fn(state: Stage1State) -> Stage1State:
        if state.ema is not None:
            ema_update(EMAConfig(), state.ema, master_params(state.optimizer))
        return state

    return step_fn


__all__ = [
    "Stage1Config",
    "Stage1State",
    "trainable_list",
    "trainable_names",
    "trainables_like",
    "init_trainables",
    "effective_vae_params",
    "vae_weights",
    "gm_head",
    "gm_forward",
    "reconstruct_and_tonemap",
    "perceptual",
    "make_optimizers",
    "init_state",
    "make_gen_step",
    "safe_norm",
    "make_disc_step",
    "make_ema_step",
]
