"""The single-UNet SDR->HDR slice of gmdx_torch against the JAX package on the
CPU, with the three kernel options on.

The tiny 8-channel GM UNet and tiny VAE take the same flax weights and numpy
inputs in both packages. Latents are 32x32 so that the options act: the
short-K route takes the 77-key cross-attention at 1024 queries, and F(4x4)
the resnet convs at 32^2 and 16^2. The JAX package is traced with the
matching environment toggles (GMDX_XATTN_KERNEL, GMDX_FUSED_ADDLN,
GMDX_WINOGRAD_M); off the TPU its dispatch takes the jnp references, so the
port's plain versions of the opt-in kernels are held to XLA's direct conv
and einsum attention. The VAE encode (posterior mean and std), the denoise
loop (3 PNDM steps, CFG 7.5), the batched decode of SDR and GM latents and
Eq. (1) from the decoded and the original SDR agree to >= 100 dB.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gmdx.models import AutoencoderKL as JaxVAE
from gmdx.models import TINY_UNET_CONFIG as J_UNET
from gmdx.models import TINY_VAE_CONFIG as J_VAE
from gmdx.models import UNet2DConditionModel as JaxUNet
from gmdx.ops import apply_gm_to_sdr as jax_apply_gm_to_sdr
from gmdx.pipelines import StableDiffusionGMPipeline as JaxGMPipeline
from gmdx.schedulers import PNDMScheduler as JaxPNDM
from gmdx_torch.io.convert import (
    load_unet, load_vae, unet_state_dict_from_flax, vae_state_dict_from_flax,
)
from gmdx_torch.kernels import launch_counts, reset_launch_counts
from gmdx_torch.models import TINY_UNET_CONFIG, TINY_VAE_CONFIG, set_kernel_options
from gmdx_torch.ops import apply_gm_to_sdr
from gmdx_torch.pipelines import StableDiffusionGMPipeline
from gmdx_torch.schedulers import PNDMScheduler

PSNR_MIN_DB = 100.0
B, LAT, CTX = 1, 32, (77, 32)  # the tiny VAE downsamples 2x: 64x64 frames
STEPS = 3
OPTIONS = {"xattn_kernel": True, "fused_addln": True, "winograd_m": 4}
JAX_TOGGLES = {"GMDX_XATTN_KERNEL": "1", "GMDX_FUSED_ADDLN": "1", "GMDX_WINOGRAD_M": "4"}


def psnr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    peak = max(np.abs(a).max(), np.abs(b).max(), 1e-9)
    mse = float(np.mean((a - b) ** 2))
    return float("inf") if mse == 0.0 else 10.0 * np.log10(peak**2 / mse)


def _assert_close(name, got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    db = psnr(got, np.asarray(want))
    assert db >= PSNR_MIN_DB, f"{name}: {db:.1f} dB"


def _random_params(shapes, rng):
    """Seeded numpy leaves of a flax param tree's shapes (``init`` itself
    would cost more time than the whole comparison): kernels scaled by
    their fan-in, norm scales near 1, small non-zero biases."""
    def leaf(path, sd):
        name = path[-1].key
        x = rng.standard_normal(sd.shape).astype(np.float32)
        if name == "kernel":
            return x * np.float32(np.prod(sd.shape[:-1]) ** -0.5)
        return 1.0 + 0.1 * x if name == "scale" else 0.05 * x
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def jax_run():
    """Flax params, numpy inputs and the JAX package's results, traced once
    with the opt-in toggles set."""
    rng = np.random.default_rng(0)
    side = LAT * 2
    unet = JaxUNet(dataclasses.replace(J_UNET, in_channels=8))
    vae = JaxVAE(J_VAE)
    shapes = {
        "unet": jax.eval_shape(unet.init, jax.random.key(0), jnp.zeros((1, 8, 8, 8)),
                               jnp.array(1.0), jnp.zeros((1,) + CTX))["params"],
        "vae": jax.eval_shape(vae.init, jax.random.key(1), jnp.zeros((1, 3, 16, 16)),
                              jax.random.key(2))["params"],
    }
    params = _random_params(shapes, rng)
    inputs = {
        "sdr": rng.uniform(-1.0, 1.0, (B, 3, side, side)).astype(np.float32),
        "sdr_latent": rng.standard_normal((B, 4, LAT, LAT)).astype(np.float32),
        "latents": rng.standard_normal((B, 4, LAT, LAT)).astype(np.float32),
        "cond": rng.standard_normal((B,) + CTX).astype(np.float32),
        "uncond": rng.standard_normal((B,) + CTX).astype(np.float32),
    }
    j = {k: jnp.asarray(v) for k, v in inputs.items()}
    pipe = JaxGMPipeline(unet, vae, None, None, JaxPNDM())
    with pytest.MonkeyPatch.context() as mp, jax.default_matmul_precision("highest"):
        for k, v in JAX_TOGGLES.items():
            mp.setenv(k, v)
        post = vae.apply({"params": params["vae"]}, j["sdr"], method=vae.encode)
        gm = pipe.denoise(params, j["sdr_latent"], j["cond"], j["uncond"], j["latents"],
                          num_inference_steps=STEPS, guidance_scale=7.5)
        img = pipe.decode_latents(params, jnp.concatenate([j["sdr_latent"], gm]))
    img01 = np.clip(np.asarray(img) / 2.0 + 0.5, 0.0, 1.0)
    gm01 = img01[B:]
    orig01 = np.clip(inputs["sdr"] / 2.0 + 0.5, 0.0, 1.0)
    results = {
        "mean": np.asarray(post.mean), "std": np.asarray(post.std), "gm": np.asarray(gm),
        "img": np.asarray(img), "orig01": orig01,
        "hdr_decoded": np.asarray(jax_apply_gm_to_sdr(gm01, img01[:B], 99.0, clip_output=False)),
        "hdr_original": np.asarray(jax_apply_gm_to_sdr(gm01, orig01, 99.0, clip_output=False)),
    }
    return params, inputs, results


@pytest.fixture(scope="module")
def port_pipe(jax_run):
    params = jax_run[0]
    kw = dict(device="cpu", dtype=torch.float32)
    unet = load_unet(unet_state_dict_from_flax(params["unet"]),
                     dataclasses.replace(TINY_UNET_CONFIG, in_channels=8), **kw)
    vae = load_vae(vae_state_dict_from_flax(params["vae"]), TINY_VAE_CONFIG, **kw)
    for m in (unet, vae):
        set_kernel_options(m, **OPTIONS)
    return StableDiffusionGMPipeline(unet, vae, PNDMScheduler(), device="cpu")


def _t(inputs, *names):
    return [torch.from_numpy(inputs[n]) for n in names]


def test_encode_matches_jax(jax_run, port_pipe):
    """The posterior (F(4x4) convs at the 64^2 and 32^2 levels), and
    encode_sdr as its sample drawn from the generator, times the scale."""
    _, inputs, want = jax_run
    (sdr,) = _t(inputs, "sdr")
    with torch.no_grad():
        post = port_pipe.vae.encode(sdr)
    _assert_close("posterior mean", post.mean, want["mean"])
    _assert_close("posterior std", post.std, want["std"])
    z = port_pipe.encode_sdr(sdr, torch.Generator().manual_seed(3))
    eps = torch.randn(post.mean.shape, generator=torch.Generator().manual_seed(3))
    sf = port_pipe.vae.config.scaling_factor
    torch.testing.assert_close(z, (post.mean + post.std * eps) * sf, rtol=1e-6, atol=1e-6)


def test_denoise_decode_hdr_matches_jax(jax_run, port_pipe):
    """The loop with every option on: each route fires, and the GM latents,
    the batched decode and Eq. (1) from both SDR images match gmdx."""
    _, inputs, want = jax_run
    sdr_lat, latents, cond, uncond, sdr = _t(
        inputs, "sdr_latent", "latents", "cond", "uncond", "sdr")
    reset_launch_counts()
    gm = port_pipe.denoise(sdr_lat, cond, uncond, latents, num_inference_steps=STEPS,
                           guidance_scale=7.5)
    counts = launch_counts()
    # On the CPU the wrappers run their plain versions; the counters stay
    # at zero (they count kernel launches only).
    assert not any(counts.values()), counts
    img = port_pipe.decode_latents(torch.cat([sdr_lat, gm]))
    img01 = (img / 2.0 + 0.5).clamp(0.0, 1.0)
    gm01 = img01[B:]
    assert gm.shape == latents.shape and img.shape == (2 * B, 3, 2 * LAT, 2 * LAT)
    orig01 = torch.from_numpy(want["orig01"])
    for name, got, ref in (
        ("gm latents", gm, want["gm"]), ("decoded", img, want["img"]),
        ("hdr from decoded sdr", apply_gm_to_sdr(gm01, img01[:B], 99.0, clip_output=False),
         want["hdr_decoded"]),
        ("hdr from original sdr", apply_gm_to_sdr(gm01, orig01, 99.0, clip_output=False),
         want["hdr_original"]),
    ):
        _assert_close(name, got, ref)


def test_options_take_their_routes(port_pipe, monkeypatch):
    """Each opt-in route is reached by the tiny slice: the wrappers of the
    short-K attention, add + LayerNorm and F(4x4) are called."""
    import gmdx_torch.kernels.attention as attention
    import gmdx_torch.models.layers as layers

    calls = {"xattn": 0, "add_ln": 0, "wino4": 0}

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setitem(attention._PACKED_KERNELS, "xattn_shortk", tuple(
        counting("xattn", f) for f in attention._PACKED_KERNELS["xattn_shortk"]))
    monkeypatch.setattr(layers, "add_layer_norm", counting("add_ln", layers.add_layer_norm))
    monkeypatch.setattr(layers, "winograd4_conv3x3",
                        counting("wino4", layers.winograd4_conv3x3))
    x = torch.zeros(2, LAT, LAT, 8)
    ctx = torch.zeros(2, *CTX)
    with torch.no_grad():
        port_pipe.unet(x, 500, ctx, channels_last=True)
    # The tiny UNet's transformers: 2 in the down and 3 in the up block at
    # 32^2 (1024 queries: the short-K route), 1 in the mid block at 16^2.
    # Its resnet convs, all at 32^2 or 16^2: 4 + 4 down, 4 mid, 6 + 6 up.
    assert calls == {"xattn": 5, "add_ln": 6, "wino4": 24}, calls


def test_low_memory_matches_batched(jax_run, port_pipe):
    _, inputs, _ = jax_run
    sdr_lat, latents, cond, uncond = _t(inputs, "sdr_latent", "latents", "cond", "uncond")
    kw = dict(num_inference_steps=2, guidance_scale=7.5, guidance_rescale=0.7)
    batched = port_pipe.denoise(sdr_lat, cond, uncond, latents, **kw)
    seq = port_pipe.denoise(sdr_lat, cond, uncond, latents, low_memory=True, **kw)
    _assert_close("low_memory", seq, batched.numpy())


def test_call_from_prompt_embeds_equals_denoise(jax_run, port_pipe):
    _, inputs, _ = jax_run
    sdr_lat, latents, cond, uncond = _t(inputs, "sdr_latent", "latents", "cond", "uncond")
    emb = dict(prompt_embeds=cond, negative_prompt_embeds=uncond)
    got = port_pipe(sdr_lat, latents=latents, num_inference_steps=2, output_type="latent", **emb)
    want = port_pipe.denoise(sdr_lat, cond, uncond, latents, num_inference_steps=2)
    assert torch.equal(got, want)
    # num_images_per_prompt repeats the SDR latent with the embeddings; the
    # noise comes from the generator, sized from the repeated latent.
    two = port_pipe(sdr_lat, num_images_per_prompt=2, num_inference_steps=1,
                    generator=torch.Generator().manual_seed(1), output_type="latent", **emb)
    noise = port_pipe.prepare_latents(torch.Generator().manual_seed(1), sdr_lat.repeat(2, 1, 1, 1))
    ref = port_pipe.denoise(sdr_lat.repeat(2, 1, 1, 1), cond.repeat(2, 1, 1),
                            uncond.repeat(2, 1, 1), noise, num_inference_steps=1)
    assert torch.equal(two, ref)
    imgs = port_pipe(sdr_lat, latents=latents, num_inference_steps=1, **emb)
    assert imgs.shape == (B, 2 * LAT, 2 * LAT, 3) and 0.0 <= imgs.min() and imgs.max() <= 1.0


@pytest.mark.parametrize("option", [
    {"eta": 0.5}, {"callback": lambda *a: None},
    {"callback_on_step_end": lambda *a: None},
    {"return_intermediates": True}, {"timesteps": [999, 500]}, {"sigmas": [1.0]},
    {"cross_attention_kwargs": {"scale": 0.5}},
], ids=lambda o: next(iter(o)))
def test_call_rejects_unported_options(jax_run, port_pipe, option):
    """Each option the JAX package's ``__call__`` takes is taken: custom
    ``timesteps``/``sigmas`` raise ValueError as the JAX package's do; the
    others run, and under PNDM with no LoRA factors (eta, the observer
    callbacks, a LoRA scale) leave the latents as they are;
    ``return_intermediates`` adds the per-step stack."""
    _, inputs, _ = jax_run
    sdr_lat, cond, uncond = _t(inputs, "sdr_latent", "cond", "uncond")
    kw = dict(prompt_embeds=cond, negative_prompt_embeds=uncond, num_inference_steps=1,
              output_type="latent", generator=torch.Generator().manual_seed(2))
    if "timesteps" in option or "sigmas" in option:
        with pytest.raises(ValueError, match="custom"):
            port_pipe(sdr_lat, **kw, **option)
        return
    base = port_pipe(sdr_lat, **kw)
    kw["generator"] = torch.Generator().manual_seed(2)
    out = port_pipe(sdr_lat, **kw, **option)
    if option.get("return_intermediates"):
        out, inter = out
        n = port_pipe.scheduler.num_steps(1)
        assert inter.shape == (n,) + tuple(base.shape) and torch.equal(inter[-1], out)
    assert torch.equal(out, base)


