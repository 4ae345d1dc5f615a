"""The single-UNet pipeline's ``__call__`` with DDIM, DPM-Solver++ and LCM
against the JAX package on the CPU, fp32, on the tiny 8-channel GM UNet.

Both packages take the same flax weights (seeded numpy leaves), the same
initial latents and, for the stochastic steps, the same per-step noise: the
JAX package's ``step_keys`` (``split(key)`` -> ``k_lat, k_steps``, then
``split(k_steps, n)``), each drawn as ``jax.random.normal(k, shape)`` at the
loop's NHWC latent shape (``gmdx/pipelines/gm.py:377-379``), handed to the
port as ``step_noise``. The GM latents, the per-step latents
(``return_intermediates`` against the JAX package's callback emulation) and
the callbacks' ``(i, t)`` sequence must agree, the latents to >= 100 dB.
Also: the LoRA scale with and without factors, mutating callbacks and
custom schedules raising as the JAX package's do.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import gmdx.schedulers as J
from gmdx.models import TINY_UNET_CONFIG as J_UNET
from gmdx.models import TINY_VAE_CONFIG as J_VAE
from gmdx.models import AutoencoderKL as JaxVAE
from gmdx.models import UNet2DConditionModel as JaxUNet
from gmdx.models.lora import LoRAConfig as JaxLoRAConfig
from gmdx.models.lora import init_lora_params as jax_init_lora
from gmdx.pipelines import StableDiffusionGMPipeline as JaxGMPipeline
from gmdx.pipelines.gm import get_guidance_scale_embedding as jax_guidance_embedding
from gmdx_torch.io.convert import (
    load_unet, load_vae, unet_lora_from_flax, unet_state_dict_from_flax,
    vae_state_dict_from_flax,
)
from gmdx_torch.models import TINY_UNET_CONFIG, TINY_VAE_CONFIG
from gmdx_torch.pipelines import StableDiffusionGMPipeline
from gmdx_torch.pipelines.gm import get_guidance_scale_embedding
from gmdx_torch.schedulers import get_scheduler

PSNR_MIN_DB = 100.0
B, LAT, CTX = 1, 8, (7, 32)
STEPS = 3
SAMPLERS = {
    "ddim_eta0": ("ddim", 0.0),
    "ddim_eta05": ("ddim", 0.5),
    "dpm": ("dpm++", 0.0),
    "lcm": ("lcm", 0.0),
}
KEY = 11


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models gain nothing from intra-op threads, and under a
    parallel test run they oversubscribe the cores; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    def leaf(path, sd):
        name = path[-1].key
        x = rng.standard_normal(sd.shape).astype(np.float32)
        if name == "kernel":
            return x * np.float32(np.prod(sd.shape[:-1]) ** -0.5)
        return 1.0 + 0.1 * x if name == "scale" else 0.05 * x
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def step_noise(n_steps: int, shape_nhwc) -> list[np.ndarray]:
    """The JAX single-UNet ``__call__``'s per-step draws for ``key(KEY)``."""
    _, k_steps = jax.random.split(jax.random.key(KEY))
    keys = jax.random.split(k_steps, n_steps)
    return [np.array(jax.random.normal(k, shape_nhwc, jnp.float32)) for k in keys]


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(0)
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
        "sdr_latent": rng.standard_normal((B, 4, LAT, LAT)).astype(np.float32),
        "latents": rng.standard_normal((B, 4, LAT, LAT)).astype(np.float32),
        "cond": rng.standard_normal((B,) + CTX).astype(np.float32),
        "uncond": rng.standard_normal((B,) + CTX).astype(np.float32),
    }
    kw = dict(device="cpu", dtype=torch.float32)
    port = {
        "unet": load_unet(unet_state_dict_from_flax(params["unet"]),
                          dataclasses.replace(TINY_UNET_CONFIG, in_channels=8), **kw),
        "vae": load_vae(vae_state_dict_from_flax(params["vae"]), TINY_VAE_CONFIG, **kw),
    }
    return {"unet": unet, "vae": vae, "params": params, "inputs": inputs, "port": port,
            "jax_pipes": {}}


def _jax_pipe(tiny, name):
    """One JAX pipeline per sampler, kept so its jitted loop compiles once."""
    if name not in tiny["jax_pipes"]:
        sched = J.get_scheduler(SAMPLERS[name][0])
        tiny["jax_pipes"][name] = JaxGMPipeline(tiny["unet"], tiny["vae"], None, None, sched)
    return tiny["jax_pipes"][name]


def _port_pipe(tiny, name, lora=None):
    return StableDiffusionGMPipeline(tiny["port"]["unet"], tiny["port"]["vae"],
                                     get_scheduler(SAMPLERS[name][0]), lora=lora, device="cpu")


def _embeds(tiny, lib):
    i = tiny["inputs"]
    to = jnp.asarray if lib == "jax" else torch.from_numpy
    return dict(prompt_embeds=to(i["cond"]), negative_prompt_embeds=to(i["uncond"]))


def _run_jax(tiny, name, params=None, **kw):
    """The JAX ``__call__`` with an observer callback: (GM latents,
    [(i, t, latents_i)])."""
    seen = []
    pipe = _jax_pipe(tiny, name)
    i = tiny["inputs"]
    with jax.default_matmul_precision("highest"):
        out = pipe(params or tiny["params"], jnp.asarray(i["sdr_latent"]),
                   key=jax.random.key(KEY), latents=jnp.asarray(i["latents"]),
                   num_inference_steps=STEPS, guidance_scale=7.5, eta=SAMPLERS[name][1],
                   output_type="latent",
                   callback_on_step_end=lambda p, k, t, kw: seen.append(
                       (k, int(t), np.array(kw["latents"]))),
                   **_embeds(tiny, "jax"), **kw)
    return np.asarray(out), seen


def _port_kwargs(tiny, name):
    i = tiny["inputs"]
    noise = step_noise(STEPS, (B, LAT, LAT, 4))
    return dict(latents=torch.from_numpy(i["latents"]),
                step_noise=[torch.from_numpy(n) for n in noise],
                num_inference_steps=STEPS, guidance_scale=7.5, eta=SAMPLERS[name][1],
                output_type="latent", **_embeds(tiny, "torch"))


@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_call_matches_jax(tiny, name):
    want, seen_j = _run_jax(tiny, name)
    seen = []
    pipe = _port_pipe(tiny, name)
    got, inter = pipe(torch.from_numpy(tiny["inputs"]["sdr_latent"]), return_intermediates=True,
                      callback_on_step_end=lambda p, k, t, kw: seen.append(
                          (k, t, kw["latents"].clone())),
                      **_port_kwargs(tiny, name))
    assert got.shape == (B, 4, LAT, LAT) and inter.shape == (STEPS, B, 4, LAT, LAT)
    _assert_close(f"{name} latents", got, want)
    assert [(k, t) for k, t, _ in seen] == [(k, t) for k, t, _ in seen_j]
    for (k, _, a), (_, _, b), c in zip(seen, seen_j, inter):
        _assert_close(f"{name} step {k}", a, b)
        assert torch.equal(a, c)
    assert torch.equal(inter[-1], got)


def test_generator_draws_step_noise_in_order(tiny):
    """A generator (seeded on the pipeline's device) draws the initial
    latents, then each step's noise at the NHWC latent shape; the same draws
    passed as ``latents`` and ``step_noise`` give the same result."""
    pipe = _port_pipe(tiny, "lcm")
    sdr = torch.from_numpy(tiny["inputs"]["sdr_latent"])
    kw = dict(num_inference_steps=3, guidance_scale=7.5, output_type="latent",
              **_embeds(tiny, "torch"))
    a = pipe(sdr, generator=torch.Generator().manual_seed(3), **kw)
    g = torch.Generator().manual_seed(3)
    latents = torch.randn((B, 4, LAT, LAT), generator=g)
    noise = [torch.randn((B, LAT, LAT, 4), generator=g) for _ in range(2)]
    b = pipe(sdr, latents=latents, step_noise=noise + [None], **kw)
    assert torch.equal(a, b)


def test_legacy_callback_and_mutating_callback(tiny):
    pipe = _port_pipe(tiny, "dpm")
    sdr = torch.from_numpy(tiny["inputs"]["sdr_latent"])
    kw = _port_kwargs(tiny, "dpm")
    calls = []
    pipe(sdr, callback=lambda i, t, lat: calls.append((i, t, tuple(lat.shape))),
         callback_steps=2, **kw)
    ts = pipe.scheduler.timesteps(STEPS)
    assert calls == [(i, ts[i], (B, 4, LAT, LAT)) for i in range(0, STEPS, 2)]

    def mutate(p, i, t, kwargs):
        return {"latents": kwargs["latents"] + 1.0}

    def same(p, i, t, kwargs):
        return {"latents": kwargs["latents"].clone()}

    with pytest.raises(NotImplementedError, match="modified 'latents'"):
        pipe(sdr, callback_on_step_end=mutate, **kw)
    pipe(sdr, callback_on_step_end=same, **kw)  # an unchanged tensor is fine
    with pytest.raises(NotImplementedError, match="modified 'latents'"):
        _jax_pipe(tiny, "dpm")(
            tiny["params"], jnp.asarray(tiny["inputs"]["sdr_latent"]), key=jax.random.key(KEY),
            num_inference_steps=STEPS, output_type="latent",
            callback_on_step_end=lambda p, i, t, kw: {"latents": kw["latents"] + 1.0},
            latents=jnp.asarray(tiny["inputs"]["latents"]), **_embeds(tiny, "jax"))
    with pytest.raises(ValueError, match="callback_steps"):
        pipe(sdr, callback=print, callback_steps=0, **kw)
    with pytest.raises(ValueError, match="tensor_inputs"):
        pipe(sdr, callback_on_step_end=same, callback_on_step_end_tensor_inputs=["sdr"], **kw)


def test_lora_scale_matches_jax(tiny):
    """``cross_attention_kwargs={"scale": s}`` merges the factors beside the
    UNet at s * alpha/rank for the call, as the JAX package's
    ``_apply_lora_scale`` does, and leaves the module's weights as they
    were; without factors it is a no-op."""
    rng = np.random.default_rng(9)
    lora = jax.jit(lambda k, p: jax_init_lora(k, p, JaxLoRAConfig(rank=2, alpha=2.0)))(
        jax.random.key(5), tiny["params"]["unet"])
    lora = {p: {"a": np.asarray(f["a"]),
                "b": (0.05 * rng.standard_normal(f["b"].shape)).astype(np.float32)}
            for p, f in lora.items()}
    # The JAX package's own merge, then its compiled loop as the other tests
    # built it (a params tree with "unet_lora" beside "unet" would compile
    # another).
    j_pipe = _jax_pipe(tiny, "dpm")
    merged = jax.jit(lambda p, lo: j_pipe._apply_lora_scale(
        dict(p, unet_lora=lo), {"scale": 0.7}))(tiny["params"], lora)
    want, _ = _run_jax(tiny, "dpm", params={k: merged[k] for k in tiny["params"]})
    base, _ = _run_jax(tiny, "dpm")
    assert psnr(want, base) < 60.0  # the factors act

    port_lora = {"unet": unet_lora_from_flax(lora)}
    pipe = _port_pipe(tiny, "dpm", lora=port_lora)
    before = {k: v.clone() for k, v in pipe.unet.state_dict().items()}
    sdr = torch.from_numpy(tiny["inputs"]["sdr_latent"])
    got = pipe(sdr, cross_attention_kwargs={"scale": 0.7}, **_port_kwargs(tiny, "dpm"))
    _assert_close("lora latents", got, want)
    after = pipe.unet.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    plain = _port_pipe(tiny, "dpm")
    a = plain(sdr, cross_attention_kwargs={"scale": 0.7}, **_port_kwargs(tiny, "dpm"))
    b = plain(sdr, **_port_kwargs(tiny, "dpm"))
    assert torch.equal(a, b)
    _assert_close("no-lora latents", b, base)


def test_custom_schedule_raises_as_jax(tiny):
    pipe = _port_pipe(tiny, "ddim_eta0")
    sdr = torch.from_numpy(tiny["inputs"]["sdr_latent"])
    for opt in ({"timesteps": [999, 500]}, {"sigmas": [1.0]}):
        with pytest.raises(ValueError, match="custom `timesteps`"):
            pipe(sdr, **_port_kwargs(tiny, "ddim_eta0"), **opt)
        with pytest.raises(ValueError, match="custom `timesteps`"):
            _jax_pipe(tiny, "ddim_eta0")(tiny["params"], jnp.asarray(
                tiny["inputs"]["sdr_latent"]), **_embeds(tiny, "jax"), **opt)


def test_safety_checker_and_guidance_embedding(tiny):
    pipe = _port_pipe(tiny, "dpm")
    seen = []

    def checker(images):
        seen.append(images.shape)
        return np.zeros_like(images), [False] * len(images)

    pipe.safety_checker = checker
    kw = dict(_port_kwargs(tiny, "dpm"), output_type="np")
    img = pipe(torch.from_numpy(tiny["inputs"]["sdr_latent"]), num_images_per_prompt=1, **kw)
    assert seen == [(B, 2 * LAT, 2 * LAT, 3)] and not img.any()
    # XLA's and torch's float32 exp differ by an ulp on a few frequencies; at
    # an argument of 1000 w that is ~1000 w * 2^-23 * 2 in the sines.
    for w, dim in ((7.5, 512), (np.array([1.0, 4.0], np.float32), 33)):
        got = get_guidance_scale_embedding(torch.as_tensor(w), dim).numpy()
        want = np.asarray(jax_guidance_embedding(jnp.asarray(w), dim))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1000 * np.max(w) * 2.0**-22)
