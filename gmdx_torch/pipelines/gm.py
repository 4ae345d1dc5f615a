"""Single-UNet gain-map pipeline: SDR-latent-conditioned GM synthesis (the
paper's SDR->HDR up-conversion at 512^2), and the parts the dual pipeline
builds on.

Counterpart of ``gmdx/pipelines/gm.py``: ``rescale_noise_cfg``,
``get_guidance_scale_embedding``, ``scheduler_step`` and
``StableDiffusionGMPipeline`` with ``check_inputs``, ``encode_prompt``
(tokenizer + CLIP text encoder), ``_resolve_embeds`` (``prompt_embeds``
passthrough, ``num_images_per_prompt``), ``encode_sdr``,
``prepare_latents``, ``decode_latents``, ``denoise`` and ``__call__``. The
denoise loop keeps the reference pipeline's shape: the 4-channel GM latents
start as noise sized from the SDR latent, each step feeds the channel concat
[SDR latent, GM latent] to the 8-channel UNet under CFG (one doubled batch,
or two sequential passes with ``low_memory``), with optional
``rescale_noise_cfg``, then the scheduler's step. Latents stay NHWC fp32
across the loop.

Every sampler of ``gmdx_torch.schedulers`` serves the loop; ``eta`` and the
per-step randomness reach the steps that take them. That randomness is a
``torch.Generator`` (drawn from in step order) or explicit per-step noise
``step_noise``, the counterpart of the JAX package's ``step_keys``; each
draw has the loop's NHWC latent shape. The step-end callbacks keep the JAX
package's semantics: observers of ``latents`` (NCHW), ``prompt_embeds`` and
``negative_prompt_embeds``; a callback that returns a modified tensor
raises NotImplementedError. ``cross_attention_kwargs={"scale": s}`` merges
the LoRA factors held beside each UNet (``lora``) at ``s * alpha/rank`` for
the call and restores the weights after it. Custom ``timesteps``/``sigmas``
raise ValueError, as the JAX package's do.

Inside a spatial-parallel context (``tpctx.parallel_context("sp")``)
every image-shaped tensor the pipeline takes or keeps is the rank's rows of
the image (``gmdx_torch.dist.mesh.shard_rows``): the SDR input of
``encode_sdr``, the latents, the step noise. Each random draw is the whole
image's, made on every rank as one process makes it, of which the rank
keeps its rows, so the run samples what one process samples.
``decode_latents`` returns the whole decoded images on every rank. Inside a
tensor-parallel context the modules hold their weight slices and nothing
here changes.
"""

from __future__ import annotations

import contextlib
import functools
import inspect
from typing import Sequence

import numpy as np
import torch
from torch import nn

from gmdx_torch import resolve_device
from gmdx_torch.dist import tpctx
from gmdx_torch.dist.mesh import gather_rows, randn_spatial
from gmdx_torch.models.lora import LoRAConfig, merge_lora
from gmdx_torch.schedulers.lcm import LCMScheduler


def rescale_noise_cfg(
    noise_cfg: torch.Tensor, noise_pred_text: torch.Tensor, guidance_rescale: float = 0.0
) -> torch.Tensor:
    """Rescale the CFG output toward the text branch's std (Lin et al. 2023);
    under spatial parallelism the std of the whole image."""
    dims = tuple(range(1, noise_cfg.ndim))
    ctx = tpctx.sp_active()
    if ctx is not None:
        std_text, std_cfg = _image_std(noise_pred_text, ctx), _image_std(noise_cfg, ctx)
    else:
        std_text = noise_pred_text.std(dim=dims, keepdim=True, unbiased=False)
        std_cfg = noise_cfg.std(dim=dims, keepdim=True, unbiased=False)
    rescaled = noise_cfg * (std_text / std_cfg)
    return guidance_rescale * rescaled + (1.0 - guidance_rescale) * noise_cfg


def _image_std(t: torch.Tensor, ctx) -> torch.Tensor:
    """Each image's population std over all ranks' rows of ``t``: (B, 1, ...)."""
    import torch.distributed as dist

    flat = t.reshape(t.shape[0], -1).double()
    sums = torch.stack([flat.sum(1), (flat**2).sum(1),
                        torch.full_like(flat[:, 0], flat.shape[1])])
    dist.all_reduce(sums, group=ctx.group)
    mean = sums[0] / sums[2]
    std = (sums[1] / sums[2] - mean**2).clamp_min(0).sqrt()
    return std.to(t.dtype).reshape(-1, *([1] * (t.ndim - 1)))


def get_guidance_scale_embedding(
    w: torch.Tensor | float, embedding_dim: int = 512, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Sinusoidal guidance-scale embedding (B, embedding_dim) for
    guidance-distilled UNets (SD-1.5 itself has no time_cond_proj)."""
    w = torch.atleast_1d(torch.as_tensor(w, dtype=torch.float32)) * 1000.0
    half = embedding_dim // 2
    emb = torch.log(torch.tensor(10000.0)) / (half - 1)  # float32, as the JAX package's
    emb = torch.exp(torch.arange(half, dtype=torch.float32) * -emb).to(w.device)
    emb = w[:, None] * emb[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=-1)
    if embedding_dim % 2 == 1:
        emb = torch.nn.functional.pad(emb, (0, 1))
    return emb.to(dtype)


@functools.lru_cache(maxsize=None)
def _step_kwarg_names(sched_cls) -> frozenset:
    return frozenset(inspect.signature(sched_cls.step).parameters)


def _draws_noise(sched, state, eta: float, names) -> bool:
    """Whether a step draws fresh noise: DDIM with eta > 0, DDPM at every
    step, LCM at every step but the last."""
    if "eta" in names:
        return eta > 0.0
    return not isinstance(sched, LCMScheduler) or state.step_index < len(state.timesteps) - 1


def scheduler_step(
    sched, state, eps: torch.Tensor, latents: torch.Tensor, *, eta: float = 0.0,
    generator: torch.Generator | None = None, noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """One sampling step across the family's signatures: DDIM takes eta and
    the randomness, DDPM and LCM the randomness, PNDM and DPM-Solver++
    neither. Dispatch reads the step's signature. Under spatial parallelism
    ``latents`` (NHWC) are the rank's rows, and so is an explicit
    ``noise``; a draw from ``generator`` is the whole image's, made here as
    the scheduler makes it in one process, of which the rank keeps its
    rows."""
    names = _step_kwarg_names(type(sched))
    ctx = tpctx.sp_active()
    if (ctx is not None and noise is None and generator is not None and "noise" in names
            and _draws_noise(sched, state, eta, names)):
        noise = randn_spatial(latents.shape, generator, ctx, 1, device=latents.device,
                              dtype=latents.dtype)
    kwargs = {}
    if "eta" in names:
        kwargs["eta"] = eta
    if "generator" in names:
        kwargs["generator"] = generator
    if "noise" in names:
        kwargs["noise"] = noise
    return sched.step(state, eps, latents, **kwargs)


def reject_custom_schedule(timesteps, sigmas) -> None:
    """``timesteps=``/``sigmas=`` raise, as the JAX package's pipelines do
    (the reference's retrieve_timesteps rejects them for its pinned
    schedulers)."""
    if timesteps is not None or sigmas is not None:
        raise ValueError(
            "custom `timesteps`/`sigmas` schedules are not supported by this scheduler "
            "family (matching the reference's retrieve_timesteps rejection for its "
            "pinned schedulers); use num_inference_steps"
        )


class StableDiffusionGMPipeline:
    """Modules plus a scheduler on one device. ``unet`` is the 8-channel
    GM UNet of the single-UNet pipeline (the SDR UNet in the dual one). The
    text encoder and tokenizer are needed only to take prompts as text."""

    # The step-end callbacks' tensor whitelist.
    _callback_tensor_inputs = ("latents", "prompt_embeds", "negative_prompt_embeds")

    def __init__(
        self, unet: nn.Module | None, vae: nn.Module | None, scheduler, *,
        text_encoder: nn.Module | None = None, tokenizer=None, safety_checker=None,
        lora: dict | None = None, device: str | torch.device = "cuda",
    ):
        """``safety_checker``: an optional callable (images01_nhwc) ->
        (images01_nhwc, has_nsfw) applied to the decoded images. ``lora``:
        LoRA factors by UNet attribute name ("unet", "gm_unet"), each
        ``gmdx_torch.models.lora``'s {weight name: {"a", "b"}}. A module
        given as None is absent: the calls that need it fail."""
        self.device = resolve_device(device)
        self.unet = None if unet is None else unet.to(self.device)
        self.vae = None if vae is None else vae.to(self.device)
        self.scheduler = scheduler
        self.text_encoder = None if text_encoder is None else text_encoder.to(self.device)
        self.tokenizer = tokenizer
        self.safety_checker = safety_checker
        self.lora = dict(lora or {})

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
        if hasattr(self.scheduler, "num_steps"):
            return self.scheduler.num_steps(num_inference_steps)
        return num_inference_steps

    def _default_generator(self, generator, step_noise) -> torch.Generator | None:
        """The loop's randomness: ``generator``, or with neither it nor
        ``step_noise`` a seed-0 generator on the pipeline's device (the JAX
        package's default ``step_keys`` come from key 0)."""
        if generator is None and step_noise is None:
            return torch.Generator(device=self.device).manual_seed(0)
        return generator

    # -- step-end callbacks ------------------------------------------------
    def _validate_callback_args(self, callback_on_step_end, tensor_inputs, callback_steps):
        """Validate the callback surface and resolve the tensor-input list
        (callback objects may carry their own ``tensor_inputs``)."""
        if callback_steps is not None and (
                not isinstance(callback_steps, int) or callback_steps <= 0):
            raise ValueError(f"`callback_steps` has to be a positive integer but is "
                             f"{callback_steps} of type {type(callback_steps)}.")
        if callback_on_step_end is not None and hasattr(callback_on_step_end, "tensor_inputs"):
            tensor_inputs = callback_on_step_end.tensor_inputs
        if tensor_inputs is None:
            tensor_inputs = ("latents",)
        bad = [k for k in tensor_inputs if k not in self._callback_tensor_inputs]
        if bad:
            raise ValueError(f"`callback_on_step_end_tensor_inputs` has to be in "
                             f"{list(self._callback_tensor_inputs)}, but found {bad}")
        return tuple(tensor_inputs)

    def _step_end_hook(self, callback_on_step_end, tensor_inputs, callback, callback_steps,
                       prompt_embeds, negative_prompt_embeds):
        """The loop's per-step hook ``(i, t, latents_nchw)`` calling the
        step-end callbacks, or None without any. Observer-only: a callback
        that returns a modified tensor raises NotImplementedError, and the
        legacy ``callback(i, t, latents)`` runs every ``callback_steps``
        steps."""
        if callback_on_step_end is None and callback is None:
            return None

        def hook(i: int, t: int, lat: torch.Tensor) -> None:
            if callback_on_step_end is not None:
                available = {"latents": lat, "prompt_embeds": prompt_embeds,
                             "negative_prompt_embeds": negative_prompt_embeds}
                out = callback_on_step_end(self, i, t, {k: available[k] for k in tensor_inputs})
                for k, ref in available.items():
                    v = (out or {}).pop(k, None)
                    if v is None or v is ref or (
                            ref is not None and torch.equal(torch.as_tensor(v).to(ref), ref)):
                        continue
                    raise NotImplementedError(
                        f"callback_on_step_end returned a modified '{k}': tensor-mutating "
                        f"step-end callbacks are not supported (the JAX package's denoise "
                        f"loop is a single compiled scan). Use observer callbacks, or "
                        f"return_intermediates=True for trajectory access."
                    )
            if callback is not None and i % (callback_steps or 1) == 0:
                callback(i, t, lat)

        return hook

    @contextlib.contextmanager
    def _lora_scaled(self, cross_attention_kwargs: dict | None):
        """With ``cross_attention_kwargs={"scale": s}``, each UNet's weights
        carry its LoRA factors merged at ``s * alpha/rank`` for the duration
        of the block, and are restored bit for bit after it. A no-op
        without factors or a scale."""
        scale = (cross_attention_kwargs or {}).get("scale")
        saved = []
        try:
            if scale is not None:
                for name, factors in self.lora.items():
                    module = getattr(self, name, None)
                    if module is None or not factors:
                        continue
                    params = dict(module.named_parameters())
                    dev = {k: {ab: torch.as_tensor(v).to(params[k].device, torch.float32)
                               for ab, v in f.items()} for k, f in factors.items()}
                    merged = merge_lora({k: params[k] for k in dev}, dev,
                                        scale * LoRAConfig().scale)
                    with torch.no_grad():
                        for k, w in merged.items():
                            saved.append((params[k], params[k].detach().clone()))
                            params[k].copy_(w)
            yield
        finally:
            with torch.no_grad():
                for p, orig in saved:
                    p.copy_(orig)

    @torch.no_grad()
    def encode_sdr(self, sdr: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """SDR images (B, 3, H, W) in [-1, 1] -> a posterior sample drawn with
        ``generator``, times the VAE's scaling factor: (B, 4, H/8, W/8) fp32.
        Under spatial parallelism ``sdr`` and the result are the rank's rows."""
        post = self.vae.encode(torch.as_tensor(sdr).to(self.device, torch.float32))
        ctx = tpctx.sp_active()
        if ctx is None:
            return post.sample(generator) * self.vae.config.scaling_factor
        eps = randn_spatial(post.mean.shape, generator, ctx, 2, device=post.mean.device,
                            dtype=post.mean.dtype)
        return (post.mean + post.std * eps) * self.vae.config.scaling_factor

    def prepare_latents(self, generator: torch.Generator, sdr_latent: torch.Tensor) -> torch.Tensor:
        """4-channel noise sized from the SDR latent (B, 4, h, w), fp32, from
        ``generator``, times the scheduler's initial sigma."""
        b, _, h, w = sdr_latent.shape
        return self._initial_noise(generator, (b, 4, h, w))

    def _initial_noise(self, generator: torch.Generator, shape) -> torch.Tensor:
        """fp32 noise of ``shape`` (NCHW, the rank's rows under spatial
        parallelism) from ``generator``, times the initial sigma."""
        ctx = tpctx.sp_active()
        if ctx is not None:
            noise = randn_spatial(shape, generator, ctx, 2, device=generator.device)
        else:
            noise = torch.randn(shape, generator=generator, device=generator.device,
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
        eta: float = 0.0,
        generator: torch.Generator | None = None,
        step_noise: Sequence[torch.Tensor] | None = None,
        return_intermediates: bool = False,
        low_memory: bool = False,
        on_step=None,
    ):
        """The GM latents (B, 4, h, w) fp32 after the loop, conditioned on
        ``sdr_latent`` (B, 4, h, w); with ``return_intermediates`` also the
        per-step latents (steps, B, 4, h, w). ``eta`` and the randomness
        (``generator``, or ``step_noise[i]`` NHWC for step i) go to the
        steps that take them; ``on_step(i, t, latents_nchw)`` runs after
        each step."""
        dev = self.device
        sched = self.scheduler
        cond = prompt_embeds.to(dev)
        uncond = None if negative_prompt_embeds is None else negative_prompt_embeds.to(dev)
        do_cfg = uncond is not None
        context = torch.cat([uncond, cond]) if do_cfg and not low_memory else cond
        sdr = sdr_latent.to(dev, torch.float32).permute(0, 2, 3, 1).contiguous()
        lat = latents.to(dev, torch.float32).permute(0, 2, 3, 1).contiguous()
        state = sched.init_state(num_inference_steps)
        generator = self._default_generator(generator, step_noise)
        inter = []

        def eps_of(x, ctx):
            return self.unet(x, t, ctx, channels_last=True)

        for i in range(self._num_steps(num_inference_steps)):
            t = state.timestep
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
            lat = scheduler_step(sched, state, eps, lat, eta=eta, generator=generator,
                                 noise=None if step_noise is None else step_noise[i])
            if return_intermediates or on_step is not None:
                lat_nchw = lat.permute(0, 3, 1, 2).contiguous()
                if return_intermediates:
                    inter.append(lat_nchw)
                if on_step is not None:
                    on_step(i, t, lat_nchw)
        out = lat.permute(0, 3, 1, 2).contiguous()
        return (out, torch.stack(inter)) if return_intermediates else out

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
        eta: float = 0.0,
        latents: torch.Tensor | None = None,
        step_noise: Sequence[torch.Tensor] | None = None,
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
    ):
        """The SDR latent (B, 4, h, w) and a prompt (or ``prompt_embeds``) ->
        the GM latents with ``output_type="latent"``, else the decoded gain
        maps in [0, 1], NHWC numpy (one at a time with ``low_memory``),
        through ``safety_checker`` when there is one. With
        ``return_intermediates`` the result comes with the per-step latents
        (steps, B, 4, h, w). ``num_images_per_prompt`` repeats
        ``sdr_latent`` as it repeats the embeddings. ``generator`` (seed 0 on
        the pipeline's device by default) draws the initial noise unless
        ``latents`` is given, then each step's noise in turn unless
        ``step_noise`` gives it."""
        self.check_inputs(prompt, guidance_rescale=guidance_rescale,
                          negative_prompt=negative_prompt, latents=latents)
        reject_custom_schedule(timesteps, sigmas)
        cb_inputs = self._validate_callback_args(
            callback_on_step_end, callback_on_step_end_tensor_inputs, callback_steps)
        cond, uncond = self._resolve_embeds(
            prompt, negative_prompt, prompt_embeds, negative_prompt_embeds,
            do_cfg=guidance_scale > 1.0, clip_skip=clip_skip,
            num_images_per_prompt=num_images_per_prompt,
        )
        sdr_latent = torch.as_tensor(sdr_latent).to(self.device, torch.float32)
        if num_images_per_prompt > 1:
            sdr_latent = sdr_latent.repeat_interleave(num_images_per_prompt, dim=0)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        if latents is None:
            latents = self.prepare_latents(generator, sdr_latent)
        hook = self._step_end_hook(callback_on_step_end, cb_inputs, callback, callback_steps,
                                   cond, uncond)
        with self._lora_scaled(cross_attention_kwargs):
            out = self.denoise(
                sdr_latent, cond, uncond, torch.as_tensor(latents),
                num_inference_steps=num_inference_steps, guidance_scale=guidance_scale,
                guidance_rescale=guidance_rescale, eta=eta, generator=generator,
                step_noise=step_noise, return_intermediates=return_intermediates,
                low_memory=low_memory, on_step=hook,
            )
        gm_lat, inter = out if return_intermediates else (out, None)
        if output_type == "latent":
            result = gm_lat
        else:
            img = self.decode_latents(gm_lat, chunk=1 if low_memory else None)
            result = np.ascontiguousarray(
                (img / 2.0 + 0.5).clamp(0.0, 1.0).permute(0, 2, 3, 1).cpu().numpy())
            if self.safety_checker is not None:
                result, _ = self.safety_checker(result)
        return (result, inter) if return_intermediates else result

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor, chunk: int | None = None) -> torch.Tensor:
        """Latents (B, 4, h, w) -> images (B, 3, 8h, 8w) in [-1, 1], fp32.

        ``chunk`` decodes that many images at a time instead of one batched
        pass (the decoder's full-resolution activations dominate memory);
        it must divide the batch. Under spatial parallelism ``latents`` are
        the rank's rows, each rank decodes its rows, and every rank returns
        the whole images."""
        z = latents.to(self.device, torch.float32) / self.vae.config.scaling_factor
        b = z.shape[0]
        if chunk is None or b <= chunk:
            img = self.vae.decode(z)
        elif b % chunk:
            raise ValueError(f"decode chunk {chunk} must divide the batch {b}")
        else:
            img = torch.cat([self.vae.decode(zc) for zc in z.split(chunk)])
        ctx = tpctx.sp_active()
        return img if ctx is None else gather_rows(img, ctx, 2)


__all__ = [
    "get_guidance_scale_embedding", "reject_custom_schedule", "rescale_noise_cfg",
    "scheduler_step", "StableDiffusionGMPipeline",
]
