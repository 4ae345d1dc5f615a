"""gmdx_torch scheduler, pipeline, HDR ops and I/O against the JAX package on
the CPU, plus the port's import boundary and the smoke script's refusals.

The tiny dual-UNet path (3 PNDM steps, CFG 7.5, batched decode, Eq. (1))
takes the same flax weights and numpy inputs in both packages and must agree
to >= 100 dB PSNR.
"""

import ast
import dataclasses
import glob
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import gmdx.schedulers as jax_schedulers
from gmdx.io.rgbe import read_hdr as jax_read_hdr
from gmdx.io.rgbe import rgbe_encode as jax_rgbe_encode
from gmdx.ops import apply_gm_to_sdr as jax_apply_gm_to_sdr
from gmdx.pipelines.gm import rescale_noise_cfg as jax_rescale_noise_cfg
from gmdx_torch.io.hdr import read_hdr, rgbe_encode, save_hdr_image, write_hdr
from gmdx_torch.ops import apply_gm_to_sdr
from gmdx_torch.pipelines.gm import rescale_noise_cfg
from gmdx_torch.schedulers import PNDMScheduler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(REPO, "tests", "goldens", "schedulers")
PSNR_MIN_DB = 100.0


def psnr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    peak = max(np.abs(a).max(), np.abs(b).max(), 1e-9)
    mse = float(np.mean((a - b) ** 2))
    return float("inf") if mse == 0.0 else 10.0 * np.log10(peak**2 / mse)


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("steps", [1, 10, 49, 50])
def test_pndm_timesteps_match_jax(steps):
    ours, theirs = PNDMScheduler(), jax_schedulers.PNDMScheduler()
    assert ours.timesteps(steps) == [int(t) for t in np.asarray(theirs.timesteps(steps))]
    assert ours.num_steps(steps) == theirs.num_steps(steps)
    # A sequential fp32 cumprod against XLA's scan: ~1 ulp apart per entry.
    np.testing.assert_allclose(
        ours.alphas_cumprod, np.asarray(theirs.alphas_cumprod), rtol=1e-5, atol=0
    )


@pytest.mark.parametrize(
    "path", sorted(glob.glob(os.path.join(GOLDEN_DIR, "pndm_*.npz"))),
    ids=os.path.basename,
)
def test_pndm_matches_golden(path):
    """The committed torch-oracle trajectories the JAX scheduler is held to
    (tests/test_scheduler_goldens.py), with its fake model and tolerance."""
    data = np.load(path)
    steps = int(data["steps"])
    base_eps = data["base_eps"]
    sched = PNDMScheduler()
    state = sched.init_state(steps)
    x = torch.from_numpy(data["x0"])
    for i in range(sched.num_steps(steps)):
        t = state.timestep
        eps = 0.3 * x + float(np.float32(np.sin(t * 0.01))) * torch.from_numpy(base_eps)
        x = sched.step(state, eps, x)
        err = float(np.abs(x.numpy() - data["traj"][i]).max())
        assert err < 5e-4, f"step {i} (t={t}): maxabs {err}"


def test_pndm_matches_jax_trajectory():
    rng = np.random.default_rng(0)
    steps, shape = 20, (2, 4, 8, 8)
    ours, theirs = PNDMScheduler(), jax_schedulers.PNDMScheduler()
    s_ours, s_theirs = ours.init_state(steps), theirs.init_state(steps, shape)
    x_ours = x_theirs = rng.standard_normal(shape).astype(np.float32)
    x_ours = torch.from_numpy(x_ours)
    for _ in range(ours.num_steps(steps)):
        assert s_ours.timestep == int(s_theirs.timestep)
        eps = rng.standard_normal(shape).astype(np.float32)
        x_ours = ours.step(s_ours, torch.from_numpy(eps), x_ours)
        s_theirs, x_theirs = theirs.step(s_theirs, jnp.asarray(eps), x_theirs)
        np.testing.assert_allclose(x_ours.numpy(), np.asarray(x_theirs), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# pipeline pieces, ops, io
# ---------------------------------------------------------------------------


def test_rescale_noise_cfg_matches_jax():
    rng = np.random.default_rng(1)
    cfg, text = (rng.standard_normal((2, 4, 8, 8)).astype(np.float32) for _ in range(2))
    want = jax_rescale_noise_cfg(jnp.asarray(cfg), jnp.asarray(text), 0.7)
    got = rescale_noise_cfg(torch.from_numpy(cfg), torch.from_numpy(text), 0.7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("clip_output", [True, False])
def test_apply_gm_to_sdr_matches_jax(clip_output):
    rng = np.random.default_rng(2)
    gm = rng.uniform(0.0, 1.0, (2, 3, 8, 8)).astype(np.float32)
    sdr = rng.uniform(-0.1, 1.1, (2, 3, 8, 8)).astype(np.float32)
    want = jax_apply_gm_to_sdr(jnp.asarray(gm), jnp.asarray(sdr), 99.0, clip_output=clip_output)
    got = apply_gm_to_sdr(torch.from_numpy(gm), torch.from_numpy(sdr), 99.0,
                          clip_output=clip_output)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("width", [5, 40])
def test_hdr_codec_matches_jax(tmp_path, width):
    """Flat (narrow) and RLE scanlines: the same RGBE bytes as the JAX
    package's codec, and each reads the other's file back."""
    rng = np.random.default_rng(3)
    img = (rng.uniform(0.0, 4.0, (6, width, 3)) ** 3).astype(np.float32)
    img[:, : width // 2] = img[0, 0]  # runs for the RLE encoder
    np.testing.assert_array_equal(rgbe_encode(img), jax_rgbe_encode(img))
    path = str(tmp_path / "x.hdr")
    write_hdr(path, img)
    back = read_hdr(path)
    np.testing.assert_array_equal(back, jax_read_hdr(path))
    tol = img.max(axis=-1, keepdims=True) / 128.0
    assert np.all(np.abs(back - img) <= tol)
    save_hdr_image(path, img, qmax=99.0)
    assert np.all(np.abs(read_hdr(path) - img / 100.0) <= tol / 100.0)


# ---------------------------------------------------------------------------
# the tiny dual path against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_dual():
    from gmdx.models import AutoencoderKL as JaxVAE
    from gmdx.models import TINY_UNET_CONFIG as J_UNET
    from gmdx.models import TINY_VAE_CONFIG as J_VAE
    from gmdx.models import UNet2DConditionModel as JaxUNet
    from gmdx.pipelines import StableDiffusionDualUNetPipeline as JaxDual

    j_sdr = JaxUNet(J_UNET)
    j_gm = JaxUNet(dataclasses.replace(J_UNET, in_channels=8))
    j_vae = JaxVAE(J_VAE)
    params = {
        "unet": j_sdr.init(jax.random.key(0), jnp.zeros((1, 4, 8, 8)), jnp.array(1.0),
                           jnp.zeros((1, 7, 32)))["params"],
        "gm_unet": j_gm.init(jax.random.key(1), jnp.zeros((1, 8, 8, 8)), jnp.array(1.0),
                             jnp.zeros((1, 7, 32)))["params"],
        "vae": j_vae.init(jax.random.key(2), jnp.zeros((1, 3, 32, 32)),
                          jax.random.key(3))["params"],
    }
    params = jax.tree.map(np.asarray, params)
    j_pipe = JaxDual(j_sdr, j_vae, None, None, jax_schedulers.PNDMScheduler(), gm_unet=j_gm)
    rng = np.random.default_rng(4)
    inputs = (
        rng.standard_normal((2, 7, 32)).astype(np.float32),  # cond
        rng.standard_normal((2, 7, 32)).astype(np.float32),  # uncond
        rng.standard_normal((2, 4, 8, 8)).astype(np.float32),  # latents
    )
    return j_pipe, params, inputs


def _port_pipeline(params):
    from gmdx_torch.io.convert import (
        load_unet, load_vae, unet_state_dict_from_flax, vae_state_dict_from_flax,
    )
    from gmdx_torch.models import TINY_UNET_CONFIG, TINY_VAE_CONFIG
    from gmdx_torch.pipelines import StableDiffusionDualUNetPipeline

    kw = dict(device="cpu", dtype=torch.float32)
    sdr = load_unet(unet_state_dict_from_flax(params["unet"]), TINY_UNET_CONFIG, **kw)
    gm = load_unet(unet_state_dict_from_flax(params["gm_unet"]),
                   dataclasses.replace(TINY_UNET_CONFIG, in_channels=8), **kw)
    vae = load_vae(vae_state_dict_from_flax(params["vae"]), TINY_VAE_CONFIG, **kw)
    return StableDiffusionDualUNetPipeline(sdr, vae, PNDMScheduler(), gm, device="cpu")


def test_denoise_dual_decode_hdr_matches_jax(tiny_dual):
    j_pipe, params, (cond, uncond, latents) = tiny_dual
    with jax.default_matmul_precision("highest"):
        j_sdr, j_gm = j_pipe.denoise_dual(
            params, jnp.asarray(cond), jnp.asarray(uncond), jnp.asarray(latents),
            num_inference_steps=3, guidance_scale=7.5,
        )
        j_img = j_pipe.decode_latents(params, jnp.concatenate([j_sdr, j_gm]))
    j_img = np.asarray(j_img)
    j01 = np.clip(j_img / 2.0 + 0.5, 0.0, 1.0)
    j_hdr = np.asarray(jax_apply_gm_to_sdr(j01[2:], j01[:2], 99.0, clip_output=False))

    pipe = _port_pipeline(params)
    t = torch.from_numpy
    sdr, gm = pipe.denoise_dual(t(cond), t(uncond), t(latents), num_inference_steps=3,
                                guidance_scale=7.5)
    img = pipe.decode_latents(torch.cat([sdr, gm]))
    p01 = (img / 2.0 + 0.5).clamp(0.0, 1.0)
    hdr = apply_gm_to_sdr(p01[2:], p01[:2], 99.0, clip_output=False)

    assert sdr.shape == gm.shape == latents.shape
    assert img.shape == (4, 3, 16, 16)
    for name, a, b in (
        ("sdr latents", sdr, j_sdr), ("gm latents", gm, j_gm),
        ("decoded", img, j_img), ("hdr", hdr, j_hdr),
    ):
        db = psnr(a.numpy(), b)
        assert db >= PSNR_MIN_DB, f"{name}: {db:.1f} dB"


def test_low_memory_and_chunked_decode_match(tiny_dual):
    """Sequential CFG and a chunked decode compute the same thing as the
    batched forms."""
    _, params, (cond, uncond, latents) = tiny_dual
    pipe = _port_pipeline(params)
    t = torch.from_numpy
    batched = pipe.denoise_dual(t(cond), t(uncond), t(latents), num_inference_steps=2)
    seq = pipe.denoise_dual(t(cond), t(uncond), t(latents), num_inference_steps=2,
                            low_memory=True)
    for a, b in zip(batched, seq):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)
    z = torch.cat(batched)
    np.testing.assert_allclose(
        pipe.decode_latents(z, chunk=2).numpy(), pipe.decode_latents(z).numpy(),
        rtol=1e-4, atol=1e-5,
    )
    with pytest.raises(ValueError, match="must divide"):
        pipe.decode_latents(z, chunk=3)


def test_pipeline_defaults_to_cuda(tiny_dual):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from gmdx_torch.models import TINY_UNET_CONFIG, TINY_VAE_CONFIG, AutoencoderKL
    from gmdx_torch.models import UNet2DConditionModel
    from gmdx_torch.pipelines import StableDiffusionDualUNetPipeline

    unet = UNet2DConditionModel(TINY_UNET_CONFIG)
    with pytest.raises(RuntimeError, match="no card"):
        StableDiffusionDualUNetPipeline(unet, AutoencoderKL(TINY_VAE_CONFIG),
                                        PNDMScheduler(), unet)


# ---------------------------------------------------------------------------
# the port's boundary and the smoke script
# ---------------------------------------------------------------------------


def _imported_roots(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_neither_jax_nor_gmdx():
    """No runtime file of the port (the package, its scripts, the smoke)
    imports JAX or the JAX package, nor PIL, safetensors or cv2, which the
    card's machine lacks."""
    files = glob.glob(os.path.join(REPO, "gmdx_torch", "**", "*.py"), recursive=True)
    files += glob.glob(os.path.join(REPO, "scripts", "torch", "*.py"))
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 15
    banned = {"jax", "jaxlib", "flax", "gmdx", "optax", "PIL", "safetensors", "cv2"}
    for path in files:
        bad = {r for r in _imported_roots(path)} & banned
        assert not bad, f"{os.path.relpath(path, REPO)} imports {sorted(bad)}"


def _smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=120,
    )


def test_chip_smoke_refuses_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _smoke(REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_refuses_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    proc = _smoke(str(tmp_path))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
