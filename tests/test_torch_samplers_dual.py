"""The dual-UNet and ControlNet pipelines' ``__call__`` with DDIM (eta > 0),
DPM-Solver++ and LCM against the JAX package on the CPU, fp32, tiny models.

Both packages take the same flax weights (seeded numpy leaves; the
ControlNet's zero convs non-zero so that it acts), the same initial latents
and the same per-step noise: each JAX ``step_keys[i]`` splits into
``k_sdr, k_gm`` (``gmdx/pipelines/dual.py:200``), each drawn as
``jax.random.normal(k, shape)`` at the loop's NHWC latent shape, handed to the
port as ``step_noise[i] = (sdr, gm)``. The (SDR, GM) latents, their per-step
stacks (``return_intermediates``) and the step-end callbacks' ``(i, t)`` and
SDR latents must agree, the latents to >= 100 dB.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import gmdx.schedulers as J
from gmdx.models import TINY_CONTROLNET_CONFIG as J_CNET
from gmdx.models import TINY_UNET_CONFIG as J_UNET
from gmdx.models import TINY_VAE_CONFIG as J_VAE
from gmdx.models import AutoencoderKL as JaxVAE
from gmdx.models import ControlNetModel as JaxControlNet
from gmdx.models import UNet2DConditionModel as JaxUNet
from gmdx.pipelines import StableDiffusionControlNetHDRPipeline as JaxControlPipe
from gmdx.pipelines import StableDiffusionDualUNetPipeline as JaxDualPipe
from gmdx_torch.io.convert import (
    controlnet_state_dict_from_flax, load_controlnet, load_unet, load_vae,
    unet_state_dict_from_flax, vae_state_dict_from_flax,
)
from gmdx_torch.models import TINY_CONTROLNET_CONFIG, TINY_UNET_CONFIG, TINY_VAE_CONFIG
from gmdx_torch.pipelines import (
    StableDiffusionControlNetHDRPipeline,
    StableDiffusionDualUNetPipeline,
    upconvert_sdr_to_hdrtv,
)
from gmdx_torch.schedulers import get_scheduler

PSNR_MIN_DB = 100.0
B, LAT, CTX = 1, 4, (7, 32)
SIDE = 8 * LAT  # the ControlNet's embedder downsamples 8x
STEPS = 3
SAMPLERS = {"ddim_eta05": ("ddim", 0.5), "dpm": ("dpm++", 0.0), "lcm": ("lcm", 0.0)}
KEY = 13


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


def dual_step_noise(n_steps: int) -> list[tuple[np.ndarray, np.ndarray]]:
    """The JAX dual ``__call__``'s per-step (SDR, GM) draws for ``key(KEY)``."""
    _, k_steps = jax.random.split(jax.random.key(KEY))
    out = []
    for k in jax.random.split(k_steps, n_steps):
        k_sdr, k_gm = jax.random.split(k)
        out.append(tuple(np.array(jax.random.normal(kk, (B, LAT, LAT, 4), jnp.float32))
                         for kk in (k_sdr, k_gm)))
    return out


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(1)
    x, t, ctx = jnp.zeros((1, 4, LAT, LAT)), jnp.array(1.0), jnp.zeros((1,) + CTX)
    mods = {"unet": JaxUNet(J_UNET),
            "gm_unet": JaxUNet(dataclasses.replace(J_UNET, in_channels=8)),
            "vae": JaxVAE(J_VAE), "controlnet": JaxControlNet(J_CNET)}
    shapes = {
        "unet": jax.eval_shape(mods["unet"].init, jax.random.key(0), x, t, ctx)["params"],
        "gm_unet": jax.eval_shape(mods["gm_unet"].init, jax.random.key(1),
                                  jnp.zeros((1, 8, LAT, LAT)), t, ctx)["params"],
        "vae": jax.eval_shape(mods["vae"].init, jax.random.key(2), jnp.zeros((1, 3, 16, 16)),
                              jax.random.key(3))["params"],
        "controlnet": jax.eval_shape(mods["controlnet"].init, jax.random.key(4), x, t, ctx,
                                     jnp.zeros((1, 3, SIDE, SIDE)))["params"],
    }
    params = _random_params(shapes, rng)
    inputs = {
        "latents": rng.standard_normal((B, 4, LAT, LAT)).astype(np.float32),
        "cond": rng.standard_normal((B,) + CTX).astype(np.float32),
        "uncond": rng.standard_normal((B,) + CTX).astype(np.float32),
        "control": rng.uniform(0.0, 1.0, (B, 3, SIDE, SIDE)).astype(np.float32),
    }
    kw = dict(device="cpu", dtype=torch.float32)
    port = {
        "unet": load_unet(unet_state_dict_from_flax(params["unet"]), TINY_UNET_CONFIG, **kw),
        "gm_unet": load_unet(unet_state_dict_from_flax(params["gm_unet"]),
                             dataclasses.replace(TINY_UNET_CONFIG, in_channels=8), **kw),
        "vae": load_vae(vae_state_dict_from_flax(params["vae"]), TINY_VAE_CONFIG, **kw),
        "controlnet": load_controlnet(controlnet_state_dict_from_flax(params["controlnet"]),
                                      TINY_CONTROLNET_CONFIG, **kw),
    }
    return {"mods": mods, "params": params, "inputs": inputs, "port": port}


def _pipes(tiny, kind, name):
    sched, port_sched = J.get_scheduler(SAMPLERS[name][0]), get_scheduler(SAMPLERS[name][0])
    m, p = tiny["mods"], tiny["port"]
    if kind == "dual":
        return (JaxDualPipe(m["unet"], m["vae"], None, None, sched, gm_unet=m["gm_unet"]),
                StableDiffusionDualUNetPipeline(p["unet"], p["vae"], port_sched, p["gm_unet"],
                                                device="cpu"))
    return (JaxControlPipe(m["unet"], m["vae"], None, None, sched, gm_unet=m["gm_unet"],
                           controlnet=m["controlnet"]),
            StableDiffusionControlNetHDRPipeline(p["unet"], p["vae"], port_sched, p["gm_unet"],
                                                 p["controlnet"], device="cpu"))


def _run(tiny, kind, name):
    """Both packages' ``__call__`` with return_intermediates and an observer
    callback: [(latents pair, stacks pair, [(i, t, sdr latents)])] for JAX,
    then the port."""
    i = tiny["inputs"]
    j_pipe, pipe = _pipes(tiny, kind, name)
    kw = dict(height=SIDE, width=SIDE, num_inference_steps=STEPS, guidance_scale=7.5,
              eta=SAMPLERS[name][1], output_type="latent", return_intermediates=True)
    out = []
    seen = []
    with jax.default_matmul_precision("highest"):
        extra = {} if kind == "dual" else {"control_image": jnp.asarray(i["control"])}
        (lat, stacks) = j_pipe(
            tiny["params"], key=jax.random.key(KEY), latents=jnp.asarray(i["latents"]),
            prompt_embeds=jnp.asarray(i["cond"]), negative_prompt_embeds=jnp.asarray(i["uncond"]),
            callback_on_step_end=lambda p, k, t, d: seen.append(
                (k, int(t), np.array(d["latents"]))),
            **extra, **kw)
    out.append((lat, stacks, seen))
    seen = []
    noise = [tuple(torch.from_numpy(n) for n in pair) for pair in dual_step_noise(STEPS)]
    extra = {} if kind == "dual" else {"control_image": torch.from_numpy(i["control"])}
    lat, stacks = pipe(
        latents=torch.from_numpy(i["latents"]), step_noise=noise,
        prompt_embeds=torch.from_numpy(i["cond"]),
        negative_prompt_embeds=torch.from_numpy(i["uncond"]),
        callback_on_step_end=lambda p, k, t, d: seen.append((k, t, d["latents"].clone())),
        **extra, **kw)
    out.append((lat, stacks, seen))
    return out


@pytest.mark.parametrize("kind", ["dual", "controlnet"])
@pytest.mark.parametrize("name", sorted(SAMPLERS))
def test_call_matches_jax(tiny, kind, name):
    (j_lat, j_stacks, j_seen), (lat, stacks, seen) = _run(tiny, kind, name)
    for branch, a, b in zip(("sdr", "gm"), lat, j_lat):
        assert a.shape == (B, 4, LAT, LAT)
        _assert_close(f"{kind} {name} {branch}", a, b)
    for branch, a, b in zip(("sdr", "gm"), stacks, j_stacks):
        assert a.shape == (STEPS, B, 4, LAT, LAT)
        _assert_close(f"{kind} {name} {branch} stack", a, b)
    assert [(k, t) for k, t, _ in seen] == [(k, t) for k, t, _ in j_seen]
    for (k, _, a), (_, _, b), c in zip(seen, j_seen, stacks[0]):
        _assert_close(f"{kind} {name} step {k}", a, b)
        assert torch.equal(a, c)


def test_generator_draws_sdr_then_gm(tiny):
    """With a generator, each step draws for the SDR branch, then for the GM
    branch, at the NHWC latent shape."""
    _, pipe = _pipes(tiny, "dual", "lcm")
    kw = dict(height=SIDE, width=SIDE, num_inference_steps=STEPS, guidance_scale=7.5,
              output_type="latent", prompt_embeds=torch.from_numpy(tiny["inputs"]["cond"]),
              negative_prompt_embeds=torch.from_numpy(tiny["inputs"]["uncond"]))
    a = pipe(generator=torch.Generator().manual_seed(4), **kw)
    g = torch.Generator().manual_seed(4)
    latents = torch.randn((B, 4, LAT, LAT), generator=g)
    noise = [tuple(torch.randn((B, LAT, LAT, 4), generator=g) for _ in range(2))
             for _ in range(STEPS - 1)] + [(None, None)]
    b = pipe(latents=latents, step_noise=noise, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_upconvert_passes_options_on(tiny):
    """``upconvert_sdr_to_hdrtv`` hands eta and the randomness to the
    pipeline: its frame equals the pipeline's own run with them."""
    _, pipe = _pipes(tiny, "controlnet", "ddim_eta05")
    i = tiny["inputs"]
    emb = dict(prompt_embeds=torch.from_numpy(i["cond"]),
               negative_prompt_embeds=torch.from_numpy(i["uncond"]))
    noise = [tuple(torch.from_numpy(n) for n in pair) for pair in dual_step_noise(STEPS)]
    sdr01, gm01, hdr = upconvert_sdr_to_hdrtv(
        pipe, torch.from_numpy(i["control"]), num_inference_steps=STEPS, eta=0.5,
        latents=torch.from_numpy(i["latents"]), step_noise=noise, **emb)
    want = pipe(control_image=torch.from_numpy(i["control"]), height=SIDE, width=SIDE,
                num_inference_steps=STEPS, eta=0.5, latents=torch.from_numpy(i["latents"]),
                step_noise=noise, **emb)
    assert np.array_equal(sdr01, want[0]) and np.array_equal(gm01, want[1])
    assert hdr.shape == (B, 3, SIDE, SIDE) and np.isfinite(hdr).all()


@pytest.mark.parametrize("kind", ["dual", "controlnet"])
def test_dual_pipelines_take_no_safety_checker(tiny, kind):
    """The JAX package's dual ``__call__`` applies no safety checker, so the
    port's dual and ControlNet constructors do not take one."""
    p = tiny["port"]
    args = (p["unet"], p["vae"], get_scheduler("ddim"), p["gm_unet"])
    cls = StableDiffusionDualUNetPipeline
    if kind == "controlnet":
        args, cls = args + (p["controlnet"],), StableDiffusionControlNetHDRPipeline
    with pytest.raises(TypeError, match="safety_checker"):
        cls(*args, safety_checker=lambda x: (x, None), device="cpu")
