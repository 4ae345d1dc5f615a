"""Stage-1 VAE-LoRA + GAN training: learn the gain-map decoder head.

Counterpart of ``gmdx/train/stage1.py``. The trainables are LoRA factors on
every VAE conv and Linear weight plus the decoder's ``conv_out`` (weight and
bias); the frozen VAE's parameters are never copied. Each step merges them
into the effective weights (the trainable ``conv_out`` replaces the base
first, then LoRA adds on top) and runs the unchanged VAE with those weights
through ``torch.func.functional_call``.

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

import dataclasses
from typing import Callable

import torch
from torch import nn

from gmdx_torch import resolve_device
from gmdx_torch.models.lora import LoRAConfig, init_lora_params, merge_lora
from gmdx_torch.models.vgg import perceptual_loss, resize_for_vgg
from gmdx_torch.ops import apply_gm_to_sdr, gamut_compress
from gmdx_torch.train.ema import EMAConfig, EMAState, ema_init, ema_update
from gmdx_torch.train.optim import AdamW, get_lr_schedule, global_norm

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
    optimizer: AdamW
    disc_optimizer: AdamW
    ema: EMAState | None
    step: int = 0


def trainable_list(trainables: dict) -> list[torch.Tensor]:
    """The trainables in the optimizer's fixed order: the LoRA factors by
    sorted name (``a``, then ``b``), then ``conv_out``'s weight and bias."""
    lora = trainables["lora"]
    return [lora[n][k] for n in sorted(lora) for k in ("a", "b")] + [
        trainables["conv_out"]["weight"], trainables["conv_out"]["bias"]]


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


class _GMHead(nn.Module):
    """encode -> sample -> decode of ``vae``, for ``functional_call``."""

    def __init__(self, vae: nn.Module, scaling: float):
        super().__init__()
        self.vae, self.scaling = vae, scaling

    def forward(self, miss, eps, generator):
        post = self.vae.encode(miss)
        sampled = post.sample(generator) if eps is None else post.mean + post.std * eps
        latent = sampled * self.scaling
        return torch.sigmoid(self.vae.decode(latent / self.scaling))


def gm_forward(config: Stage1Config, vae: nn.Module, params: dict, miss_pixels: torch.Tensor,
               eps: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """``sigmoid(decode(encode(x).sample() * s / s))`` with the VAE's
    weights taken from ``params``; ``miss_pixels`` (B, 3, H, W) in [-1, 1].
    ``eps`` replaces the posterior's draw (else one from ``generator``)."""
    head = _GMHead(vae, config.scaling_factor)
    named = {f"vae.{k}": v for k, v in params.items()}
    return torch.func.functional_call(head, named, (miss_pixels, eps, generator))


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


# The CLI's learning rates (train_vqgan_lora.py:83-84); AdamW's defaults are
# its other optimizer defaults (:93-97).
LEARNING_RATE = DISCR_LEARNING_RATE = 1e-4


def make_optimizers(trainables: dict, discriminator: nn.Module) -> tuple[AdamW, AdamW]:
    """Clipped AdamW at the CLI's defaults, constant schedules, for the
    trainables and for the discriminator's parameters. Other settings:
    build :class:`~gmdx_torch.train.optim.AdamW` and pass it to
    :func:`init_state`."""
    gen = AdamW(trainable_list(trainables), get_lr_schedule("constant", LEARNING_RATE))
    disc = AdamW(list(discriminator.parameters()),
                 get_lr_schedule("constant", DISCR_LEARNING_RATE))
    return gen, disc


def init_state(config: Stage1Config, trainables: dict, discriminator: nn.Module,
               optimizers: tuple[AdamW, AdamW] | None = None) -> Stage1State:
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
    ``adaptive_weight``."""
    dev = resolve_device(device)
    _frozen(vae, dev, vgg)
    discriminator.to(dev)

    def step_fn(state: Stage1State, batch: dict, generator: torch.Generator | None = None):
        target01 = (batch["pixel_values"].to(dev) + 1.0) / 2.0
        miss = batch["miss_pixel_values"].to(dev)
        sdr01 = (miss + 1.0) / 2.0
        eps = batch.get("encode_eps")
        params = effective_vae_params(config, vae, state.trainables)
        kernel = params[f"{CONV_OUT}.weight"]
        gm = gm_forward(config, vae, params, miss, None if eps is None else eps.to(dev),
                        generator)
        tmo = reconstruct_and_tonemap(config, gm, sdr01, tmo_fn)
        if config.vae_loss == "l2":
            recon = torch.mean((target01 - tmo) ** 2)
        else:
            recon = torch.mean(torch.abs(target01 - tmo))
        perc = perceptual(vgg, target01, tmo, config.vgg_resolution)
        adv = -torch.mean(state.discriminator(tmo, update_sn=False))

        # The adaptive weight: gradient norms at the effective conv_out
        # kernel alone, over the same forward.
        (g_perc,) = torch.autograd.grad(perc, kernel, retain_graph=True)
        (g_adv,) = torch.autograd.grad(adv, kernel, retain_graph=True)
        adaptive = (torch.linalg.vector_norm(g_perc)
                    / torch.linalg.vector_norm(g_adv).clamp(min=1e-8))
        adaptive = adaptive.clamp(max=config.adaptive_weight_max).detach()
        loss = recon + perc + adaptive * adv

        grads = torch.autograd.grad(loss, trainable_list(state.trainables))
        with torch.no_grad():
            n_lora = 2 * len(state.trainables["lora"])
            lora_norm = global_norm(grads[:n_lora])
            conv_out_norm = global_norm(grads[n_lora:])
            grad_norm = torch.sqrt(lora_norm**2 + conv_out_norm**2)
        state.optimizer.step(grads, grad_norm)
        state.step += 1
        metrics = {
            "gen_loss": loss.detach(), "grad_norm": grad_norm,
            "module_grad_norms": {"lora": lora_norm, "conv_out": conv_out_norm},
            "recon": recon.detach(), "perceptual": perc.detach(),
            "adversarial": adv.detach(), "adaptive_weight": adaptive,
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
        target01 = (batch["pixel_values"].to(dev) + 1.0) / 2.0
        miss = batch["miss_pixel_values"].to(dev)
        sdr01 = (miss + 1.0) / 2.0
        eps = batch.get("encode_eps")
        with torch.no_grad():
            params = effective_vae_params(config, vae, state.trainables)
            gm = gm_forward(config, vae, params, miss, None if eps is None else eps.to(dev),
                            generator)
            fake = reconstruct_and_tonemap(config, gm, sdr01, tmo_fn)

        real = target01.detach().requires_grad_(True)
        real_out = disc(real, update_sn=False)
        (grad_images,) = torch.autograd.grad(real_out.sum(), real, create_graph=True)
        fake_out = disc(fake, update_sn=False)
        hinge = torch.mean(torch.relu(1.0 + fake_out) + torch.relu(1.0 - real_out))
        g = grad_images.reshape(grad_images.shape[0], -1)
        gp = config.gp_weight * torch.mean((safe_norm(g) - 1.0) ** 2)
        loss = hinge + gp
        grads = torch.autograd.grad(loss, state.disc_optimizer.params)
        with torch.no_grad():
            grad_norm = global_norm(grads)
        state.disc_optimizer.step(grads, grad_norm)
        with torch.no_grad():  # refresh the power-iteration state
            disc(fake, update_sn=True)
        state.step += 1
        metrics = {"disc_loss": loss.detach(), "grad_norm": grad_norm,
                   "hinge": hinge.detach(), "gp": gp.detach()}
        return state, metrics

    return step_fn


def make_ema_step(config: Stage1Config) -> Callable[[Stage1State], Stage1State]:
    """EMA advance at an optimizer-sync boundary: after generator and
    discriminator steps alike, so the decay ramp advances twice a pair."""

    def step_fn(state: Stage1State) -> Stage1State:
        if state.ema is not None:
            ema_update(EMAConfig(), state.ema, trainable_list(state.trainables))
        return state

    return step_fn


__all__ = [
    "Stage1Config",
    "Stage1State",
    "trainable_list",
    "init_trainables",
    "effective_vae_params",
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
