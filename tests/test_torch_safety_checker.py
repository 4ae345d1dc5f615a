"""The port's safety checker against the JAX package's, on the CPU.

``gmdx_torch.models.safety_checker`` against ``gmdx.models.safety_checker``
on the same seeded weights (carried through ``gmdx_torch.io.convert``'s one
table): pooled and projected embeddings at >= 100 dB in float32, the same
flags; ``preprocess_for_clip`` (``jax.image.resize``'s antialiased Keys
cubic) at >= 100 dB at four sizes; the blackout, alone and through the
single-UNet pipeline; and the key space of the port's four SD-1.5
components against ``tests/goldens/sd15_manifest.json``.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gmdx.io.pipeline as jax_pipeline
from gmdx.models import safety_checker as jax_sc
from gmdx_torch.io import pipeline as port_pipeline
from gmdx_torch.io.convert import (
    safety_checker_flax_from_state_dict, safety_checker_state_dict_from_flax,
)
from gmdx_torch.models import (
    CLIP_VIT_L_CONFIG, CLIP_VIT_L_VISION_CONFIG, SD15_UNET_CONFIG, SD15_VAE_CONFIG,
    TINY_UNET_CONFIG, TINY_VAE_CONFIG, TINY_VISION_CONFIG, AutoencoderKL, CLIPTextModel,
    StableDiffusionSafetyChecker, UNet2DConditionModel, make_safety_checker_fn,
    preprocess_for_clip, run_safety_checker,
)
from gmdx_torch.pipelines import StableDiffusionGMPipeline
from gmdx_torch.schedulers import get_scheduler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PSNR_MIN_DB = 100.0
CFG = TINY_VISION_CONFIG


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


def _jax_params(rng) -> dict:
    """Seeded numpy params of gmdx's tiny checker, from its shapes."""
    checker = jax_sc.StableDiffusionSafetyChecker(CFG)
    shapes = jax.eval_shape(checker.init, jax.random.key(0), jnp.zeros((1, 3, 32, 32)))["params"]

    def leaf(path, sd):
        name = path[-1].key
        x = rng.standard_normal(sd.shape).astype(np.float32)
        if name in ("kernel", "embedding") or name.endswith("embeds"):
            return x * np.float32(np.prod(sd.shape[:-1]) ** -0.5)
        return 1.0 + 0.1 * x if name in ("scale",) or name.endswith("weights") else 0.2 * x
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _port_checker(params) -> StableDiffusionSafetyChecker:
    checker = StableDiffusionSafetyChecker(CFG).eval()
    sd = safety_checker_state_dict_from_flax(params)
    checker.load_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
                            strict=True)
    return checker


@pytest.fixture(scope="module")
def tiny():
    rng = np.random.default_rng(3)
    params = _jax_params(rng)
    return {"params": params, "port": _port_checker(params),
            "x": rng.standard_normal((6, 3, 32, 32)).astype(np.float32)}


def _cos(a, b):
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    return a @ (b / np.linalg.norm(b, axis=-1, keepdims=True)).T


def test_checker_matches_jax(tiny):
    """Pooled and projected embeddings at >= 100 dB; with thresholds set so
    that some images fire and some not (the special-care adjustment on
    some), the same flags."""
    params, port, x = tiny["params"], tiny["port"], tiny["x"]
    pooled_j = jax_sc.CLIPVisionModel(CFG).apply({"params": params["vision_model"]},
                                                 jnp.asarray(x))
    with torch.no_grad():
        pooled_p = port.vision_model(torch.from_numpy(x))
        embeds_p = port.image_embeds(torch.from_numpy(x))
    embeds_j = np.asarray(pooled_j) @ np.asarray(params["visual_projection"]["kernel"])
    assert pooled_p.dtype == torch.float32
    assert psnr(pooled_p.numpy(), pooled_j) >= PSNR_MIN_DB
    assert psnr(embeds_p.numpy(), embeds_j) >= PSNR_MIN_DB

    # Each concept's threshold between its two largest cosines over the
    # batch (so each fires on one image), the special-care ones at the median.
    tuned = dict(params)
    top2 = np.sort(_cos(embeds_j, np.asarray(params["concept_embeds"])), axis=0)[-2:]
    tuned["concept_embeds_weights"] = top2.mean(axis=0).astype(np.float32)
    cos = _cos(embeds_j, np.asarray(params["special_care_embeds"]))
    tuned["special_care_embeds_weights"] = np.median(cos, axis=0).astype(np.float32) + 2e-3
    want = np.asarray(jax_sc.StableDiffusionSafetyChecker(CFG).apply({"params": tuned},
                                                                      jnp.asarray(x)))
    port_t = _port_checker(tuned)
    with torch.no_grad():
        got = port_t(torch.from_numpy(x)).numpy()
        special, concept = port_t.scores(port_t.image_embeds(torch.from_numpy(x)))
    assert np.array_equal(got, want)
    assert got.any() and not got.all()
    assert (special > 0).any() and not (special > 0).all()
    assert concept.shape == (6, CFG.num_concepts)


@pytest.mark.parametrize("hw,size", [((64, 48), 32), ((16, 16), 32), ((512, 512), 224),
                                     ((480, 640), 224)])
def test_preprocess_for_clip_matches_jax(hw, size):
    """Shortest edge to ``size`` (antialiased Keys cubic when it shrinks,
    plain when it grows), centre crop, CLIP normalisation."""
    rng = np.random.default_rng(hw[0] + hw[1])
    imgs = rng.uniform(0, 1, (2,) + hw + (3,)).astype(np.float32)
    want = np.asarray(jax_sc.preprocess_for_clip(jnp.asarray(imgs), image_size=size))
    got = preprocess_for_clip(torch.from_numpy(imgs), image_size=size).numpy()
    assert got.shape == want.shape == (2, 3, size, size)
    assert psnr(got, want) >= PSNR_MIN_DB


def test_make_safety_checker_fn_matches_jax(tiny):
    """The pipelines' hook: NHWC numpy in [0, 1] -> (filtered images,
    flags), as gmdx's, passing images through and blacking out flagged
    ones."""
    imgs = np.random.default_rng(4).uniform(0, 1, (3, 40, 56, 3)).astype(np.float32)
    for w in (2.0, -2.0):
        params = dict(tiny["params"], concept_embeds_weights=np.full(CFG.num_concepts, w,
                                                                     np.float32))
        want_out, want_flags = jax_sc.make_safety_checker_fn(
            jax_sc.StableDiffusionSafetyChecker(CFG), params)(imgs)
        got_out, got_flags = make_safety_checker_fn(_port_checker(params))(imgs)
        assert isinstance(got_out, np.ndarray) and got_out.dtype == np.float32
        assert np.array_equal(got_flags, want_flags) and got_flags.all() == (w < 0)
        assert np.array_equal(got_out, want_out)


def test_run_safety_checker_blackout(tiny):
    """Thresholds of 2 never fire, of -2 always (a cosine is within
    [-1, 1]); flagged images come out black (``tests/test_models.py:361``)."""
    port = tiny["port"]
    x = torch.from_numpy(tiny["x"][:2])
    with torch.no_grad():
        port.concept_embeds_weights.fill_(2.0)
        port.special_care_embeds_weights.fill_(2.0)
        assert not port(x).any()
        port.concept_embeds_weights.fill_(-2.0)
        assert port(x).all()
        out, flags = run_safety_checker(port, torch.full((2, 16, 16, 3), 0.5))
        port.load_state_dict(_port_checker(tiny["params"]).state_dict())
    assert flags.all() and not out.any()


def test_pipeline_applies_checker():
    """``StableDiffusionGMPipeline(safety_checker=make_safety_checker_fn(...))``
    on the tiny single-UNet pipeline: every image black with every concept
    firing, the same images as without a checker with none firing."""
    torch.manual_seed(0)
    unet = UNet2DConditionModel(dataclasses.replace(TINY_UNET_CONFIG, in_channels=8)).eval()
    vae = AutoencoderKL(TINY_VAE_CONFIG).eval()
    checker = StableDiffusionSafetyChecker(CFG).eval()
    gen = torch.Generator().manual_seed(1)
    sdr = torch.randn(2, 4, 8, 8, generator=gen)
    embeds = torch.randn(2, 77, 32, generator=gen)
    kw = dict(num_inference_steps=2, prompt_embeds=embeds, negative_prompt_embeds=embeds,
              output_type="np")

    def run(fn):
        pipe = StableDiffusionGMPipeline(unet, vae, get_scheduler("ddim"), safety_checker=fn,
                                         device="cpu")
        return pipe(sdr, generator=torch.Generator().manual_seed(2), **kw)

    plain = run(None)
    with torch.no_grad():
        checker.concept_embeds_weights.fill_(2.0)
        checker.special_care_embeds_weights.fill_(2.0)
    assert np.array_equal(run(make_safety_checker_fn(checker)), plain) and plain.any()
    with torch.no_grad():
        checker.concept_embeds_weights.fill_(-2.0)
    black = run(make_safety_checker_fn(checker))
    assert black.shape == plain.shape == (2, 16, 16, 3) and not black.any()


def test_checker_components_cross_both_ways(tiny, tmp_path):
    """A checker component the JAX package writes loads in the port (float32,
    the same params), and one the port writes loads in gmdx and runs."""
    params = tiny["params"]
    jax_pipeline.save_component(str(tmp_path / "j"), CFG, params, "StableDiffusionSafetyChecker")
    port = port_pipeline.load_component(str(tmp_path / "j"), device="cpu")
    assert isinstance(port, StableDiffusionSafetyChecker) and port.config == CFG
    flat = safety_checker_flax_from_state_dict(port.state_dict())
    got = jax.tree_util.tree_leaves_with_path(flat)
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(got) == len(want)
    for path, v in got:
        assert v.dtype == torch.float32 and np.array_equal(v.numpy(), np.asarray(want[path]))
    port_pipeline.save_component(str(tmp_path / "p"), port)
    module, back = jax_pipeline.load_component(str(tmp_path / "p"))
    x = jnp.asarray(tiny["x"])
    assert np.array_equal(np.asarray(module.apply({"params": back}, x)),
                          np.asarray(module.apply({"params": params}, x)))


@pytest.mark.parametrize("name", ["unet", "vae", "text_encoder", "safety_checker"])
def test_sd15_key_space_matches_manifest(name):
    """The port's SD-1.5 modules (meta device) hold exactly the manifest's
    keys and shapes, less ``position_ids``: 686 UNet, 248 VAE, 196 text and
    396 checker keys."""
    with open(os.path.join(REPO, "tests", "goldens", "sd15_manifest.json")) as f:
        want = {k: v for k, v in json.load(f)[name].items() if not k.endswith("position_ids")}
    build = {"unet": lambda: UNet2DConditionModel(SD15_UNET_CONFIG),
             "vae": lambda: AutoencoderKL(SD15_VAE_CONFIG),
             "text_encoder": lambda: CLIPTextModel(CLIP_VIT_L_CONFIG),
             "safety_checker": lambda: StableDiffusionSafetyChecker(CLIP_VIT_L_VISION_CONFIG)}
    with torch.device("meta"):
        got = {k: list(v.shape) for k, v in build[name]().state_dict().items()}
    assert len(got) == {"unet": 686, "vae": 248, "text_encoder": 196, "safety_checker": 396}[name]
    assert got == want
