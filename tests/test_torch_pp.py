"""Pipeline-parallel dual-UNet serving of the port (``gmdx_torch.pipelines.pp``)
on the CPU, held against the JAX package's sequential loop and the port's.

* ``pp_stage_ranks`` puts in stage 0 the ranks that ``pp_stage_meshes`` puts
  devices in, at 2, 4 and 8; an odd world raises in both; ``pp_stage_groups``
  on 8 gloo ranks makes each stage's data group and each pair {i, i + 4}, and
  on 3 it raises.
* The pipelined loop on 2 gloo ranks (one a stage) and on 4 (data
  parallelism 2 a stage, batch 4; ``tests/torch_pp_ranks.py``) against gmdx's
  sequential ``denoise_dual``: PNDM at 4 steps (5 iterations) in chunks of 2,
  a ragged tail; DDIM at eta 0.7 with ``guidance_rescale`` 0.3 on the JAX
  step keys' draws as ``step_noise``, in chunks of 3; PNDM without CFG. The
  bar is 100 dB and ``tests/test_pp.py``'s ``rtol=2e-4, atol=5e-5``.
* Under a generator (DDIM at eta 0.5, LCM): one rank a stage equals the
  port's sequential run bit for bit; data parallelism 2 a stage is held to
  it at 100 dB.
* Placement: a stage-0 rank holds the SDR UNet alone, a stage-1 rank the GM
  UNet and the VAE; a ControlNet pipeline raises.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gmdx.schedulers as J
from gmdx.models import TINY_UNET_CONFIG as J_UNET
from gmdx.models import TINY_VAE_CONFIG as J_VAE
from gmdx.models import AutoencoderKL as JaxVAE
from gmdx.models import UNet2DConditionModel as JaxUNet
from gmdx.pipelines import StableDiffusionDualUNetPipeline as JaxDualPipe
from gmdx.pipelines import pp_stage_meshes
from gmdx_torch.io.convert import (
    load_unet, load_vae, unet_state_dict_from_flax, vae_state_dict_from_flax,
)
from gmdx_torch.io.pipeline import save_pipeline
from gmdx_torch.models import (
    TINY_CLIP_CONFIG, TINY_UNET_CONFIG, TINY_VAE_CONFIG, CLIPTextModel, CLIPTokenizer,
)
from gmdx_torch.pipelines import (
    PipelinedDualUNet, StableDiffusionControlNetHDRPipeline, StableDiffusionDualUNetPipeline,
    pp_stage_groups,
)
from gmdx_torch.pipelines.pp import pp_stage_ranks
from gmdx_torch.schedulers import get_scheduler

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_ranks import Ranks  # noqa: E402

PSNR_MIN_DB = 100.0
RTOL, ATOL = 2e-4, 5e-5  # tests/test_pp.py's
B, LAT, CTX = 4, 4, (7, 32)
# (name, scheduler, steps, chunk, extra): against gmdx ...
JAX_CASES = (("pndm", "pndm", 4, 2, {}),
             ("ddim", "ddim", 4, 3, {"eta": 0.7, "guidance_rescale": 0.3}),
             ("no_cfg", "pndm", 3, 3, {}))
# ... and under a generator, against the port's sequential loop.
GEN_CASES = (("gen_ddim", "ddim", 4, 2, {"eta": 0.5, "seed": 5}),
             ("gen_lcm", "lcm", 4, 3, {"seed": 6}))
WORLDS = (2, 4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """As the ranks run (bit equality needs the same kernels); restored after."""
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


def _random_params(shapes, rng):
    def leaf(path, sd):
        x = rng.standard_normal(sd.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return x * np.float32(np.prod(sd.shape[:-1]) ** -0.5)
        return 1.0 + 0.1 * x if name == "scale" else 0.05 * x
    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _step_noise(key: int, n_steps: int) -> list:
    """gmdx's per-step (SDR, GM) draws for ``step_keys = split(key(key), n)``
    (each step key splits into k_sdr, k_gm), NHWC."""
    out = []
    for k in jax.random.split(jax.random.key(key), n_steps):
        out.append(tuple(np.array(jax.random.normal(kk, (B, LAT, LAT, 4), jnp.float32))
                         for kk in jax.random.split(k)))
    return out


def _case(name, sched, steps, chunk, extra, inputs):
    case = {"name": name, "scheduler": sched, "steps": steps, "chunk": chunk,
            "cond": inputs["cond"], "latents": inputs["latents"],
            "uncond": None if name == "no_cfg" else inputs["uncond"], **extra}
    if name == "ddim":
        case["step_noise"] = _step_noise(4, steps)
    return case


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks of each world (started first: they run while gmdx's loops
    compile), gmdx's sequential run of each JAX case and the port's of each
    generator case."""
    rng = np.random.default_rng(2)
    x, t, ctx = jnp.zeros((1, 4, LAT, LAT)), jnp.array(1.0), jnp.zeros((1,) + CTX)
    mods = {"unet": JaxUNet(J_UNET), "gm_unet": JaxUNet(dataclasses.replace(J_UNET, in_channels=8)),
            "vae": JaxVAE(J_VAE)}
    shapes = {
        "unet": jax.eval_shape(mods["unet"].init, jax.random.key(0), x, t, ctx)["params"],
        "gm_unet": jax.eval_shape(mods["gm_unet"].init, jax.random.key(1),
                                  jnp.zeros((1, 8, LAT, LAT)), t, ctx)["params"],
        "vae": jax.eval_shape(mods["vae"].init, jax.random.key(2), jnp.zeros((1, 3, 16, 16)),
                              jax.random.key(3))["params"],
    }
    params = _random_params(shapes, rng)
    inputs = {"latents": rng.standard_normal((B, 4, LAT, LAT)).astype(np.float32),
              "cond": (0.5 * rng.standard_normal((B,) + CTX)).astype(np.float32),
              "uncond": (0.5 * rng.standard_normal((B,) + CTX)).astype(np.float32)}
    cases = [_case(*c, inputs) for c in JAX_CASES + GEN_CASES]
    setup = {"unet_sd": unet_state_dict_from_flax(params["unet"]),
             "gm_unet_sd": unet_state_dict_from_flax(params["gm_unet"]),
             "vae_sd": vae_state_dict_from_flax(params["vae"]), "cases": cases}
    kw = dict(device="cpu", dtype=torch.float32)
    seq = StableDiffusionDualUNetPipeline(
        load_unet(setup["unet_sd"], TINY_UNET_CONFIG, **kw),
        load_vae(setup["vae_sd"], TINY_VAE_CONFIG, **kw), None,
        load_unet(setup["gm_unet_sd"], dataclasses.replace(TINY_UNET_CONFIG, in_channels=8),
                  **kw), device="cpu")
    setup["pipe_dir"] = str(tmp_path_factory.mktemp("pipe"))
    torch.manual_seed(0)
    save_pipeline(setup["pipe_dir"], components={
        "unet": seq.unet, "gm_unet": seq.gm_unet, "vae": seq.vae,
        "text_encoder": CLIPTextModel(TINY_CLIP_CONFIG)}, tokenizer=CLIPTokenizer.tiny(),
        scheduler=get_scheduler("pndm"))
    started = {n: Ranks("pp", n, tmp_path_factory.mktemp(f"pp{n}"), setup) for n in WORLDS}

    want = {}
    with jax.default_matmul_precision("highest"):
        for name, sched, steps, _, extra in JAX_CASES:
            pipe = JaxDualPipe(mods["unet"], mods["vae"], None, None, J.get_scheduler(sched),
                               gm_unet=mods["gm_unet"])
            case = next(c for c in cases if c["name"] == name)
            n_steps = pipe._num_steps(steps)
            keys = jax.random.split(jax.random.key(4), n_steps)
            uncond = None if case["uncond"] is None else jnp.asarray(case["uncond"])
            sdr, gm = pipe.denoise_dual(
                params, jnp.asarray(case["cond"]), uncond, jnp.asarray(case["latents"]),
                num_inference_steps=steps, step_keys=keys,
                **{k: v for k, v in extra.items() if k in ("eta", "guidance_rescale")})
            want[name] = {"sdr": np.asarray(sdr), "gm": np.asarray(gm)}

    for name, sched, steps, _, extra in GEN_CASES:
        seq.scheduler = get_scheduler(sched)
        sdr, gm = seq.denoise_dual(
            torch.from_numpy(inputs["cond"]), torch.from_numpy(inputs["uncond"]),
            torch.from_numpy(inputs["latents"]), num_inference_steps=steps,
            eta=extra.get("eta", 0.0), generator=torch.Generator().manual_seed(extra["seed"]))
        want[name] = {"sdr": sdr.numpy(), "gm": gm.numpy()}
    names = {k: sorted(n for n, _ in getattr(seq, k).named_parameters())
             for k in ("unet", "gm_unet", "vae")}
    return {"want": want, "names": names,
            "ranks": {n: r.results() for n, r in started.items()}}


def _whole(ranks: list[dict], case: str, stage: int, branch: str) -> np.ndarray:
    """The whole batch of ``branch`` from the rows of ``stage``'s ranks."""
    parts = sorted((r["first_row"], r["cases"][case][branch]) for r in ranks
                   if r["stage"] == stage)
    return np.concatenate([p for _, p in parts])


@pytest.mark.parametrize("world", [2, 4, 8])
def test_stage_ranks_match_jax_meshes(world):
    m0, m1 = pp_stage_meshes(jax.devices()[:world])
    sdr, gm = pp_stage_ranks(world)
    assert sdr == [d.id for d in m0.devices.flat] and gm == [d.id for d in m1.devices.flat]


@pytest.mark.parametrize("world", [1, 3, 5])
def test_odd_world_raises_as_jax(world):
    with pytest.raises(ValueError):
        pp_stage_meshes(jax.devices()[:world])
    with pytest.raises(ValueError, match="even rank count"):
        pp_stage_ranks(world)


def test_stage_groups_on_ranks(tmp_path):
    """Eight ranks: stage r // 4, its data group the stage's ranks, its pair
    {r % 4, r % 4 + 4}; three ranks raise on every rank; one process (no
    group) raises."""
    (tmp_path / "w8").mkdir()
    (tmp_path / "w3").mkdir()
    eight = Ranks("pp_groups", 8, tmp_path / "w8", {})
    three = Ranks("pp_groups", 3, tmp_path / "w3", {})
    with pytest.raises(ValueError, match="got 1"):
        pp_stage_groups()
    for r, got in enumerate(eight.results()):
        stage, i = divmod(r, 4)
        ranks = list(range(4 * stage, 4 * stage + 4))
        assert got == {"stage": stage, "ranks": ranks, "data_size": 4, "data_rank": i,
                       "pair": [i, i + 4], "members": {"data": ranks, "pair": [i, i + 4]}}
    assert all("even rank count >= 2, got 3" in got["error"] for got in three.results())


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", [c[0] for c in JAX_CASES])
def test_pipelined_matches_gmdx_sequential(runs, world, case):
    ranks, want = runs["ranks"][world], runs["want"][case]
    got = {"sdr": _whole(ranks, case, 1, "sdr"), "gm": _whole(ranks, case, 1, "gm")}
    for branch in ("sdr", "gm"):
        assert got[branch].shape == (B, 4, LAT, LAT)
        db = psnr(got[branch], want[branch])
        assert db >= PSNR_MIN_DB, f"{case} {branch} on {world} ranks: {db:.1f} dB"
        np.testing.assert_allclose(got[branch], want[branch], rtol=RTOL, atol=ATOL)
    # The final SDR latents crossed the hop unchanged.
    assert np.array_equal(_whole(ranks, case, 0, "sdr"), got["sdr"])
    assert all(r["cases"][case]["gm"] is None for r in ranks if r["stage"] == 0)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", [c[0] for c in GEN_CASES])
def test_pipelined_generator_replays_sequential(runs, world, case):
    """Each stage replays the generator's (SDR, GM) stream and keeps its
    branch's draws (its rows of them under data parallelism)."""
    ranks, want = runs["ranks"][world], runs["want"][case]
    for branch in ("sdr", "gm"):
        got = _whole(ranks, case, 1, branch)
        if world == 2:
            assert np.array_equal(got, want[branch]), f"{case} {branch}"
        else:  # a rank's UNet calls take half the rows: CPU kernels round otherwise
            assert psnr(got, want[branch]) >= PSNR_MIN_DB, f"{case} {branch}"


@pytest.mark.parametrize("world", WORLDS)
def test_each_rank_holds_its_stage_only(runs, world):
    """No stage-0 parameter belongs to the GM UNet or the VAE, no stage-1
    parameter to the SDR UNet; each holds its modules whole."""
    names = runs["names"]
    for r in runs["ranks"][world]:
        want = ("unet",) if r["stage"] == 0 else ("gm_unet", "vae")
        assert r["held"] == {k: names[k] for k in want}, r["stage"]


@pytest.mark.parametrize("world", WORLDS)
def test_from_pretrained_loads_the_stage_only(runs, world):
    """From a pipeline directory each rank loads its stage's components
    (stage 1: the GM UNet, the VAE, the text encoder and the tokenizer) and
    runs as the wrapper built from the modules does, bit for bit."""
    for r in runs["ranks"][world]:
        loaded = r["loaded"]
        want = ["unet"] if r["stage"] == 0 else ["gm_unet", "text_encoder", "vae"]
        assert loaded["held"] == want and loaded["tokenizer"] == (r["stage"] == 1)
        for branch, got in loaded["case"].items():
            want_case = r["cases"][JAX_CASES[0][0]][branch]
            assert (got is None and want_case is None) or np.array_equal(got, want_case)


def test_controlnet_pipeline_raises():
    from gmdx_torch.models import TINY_CONTROLNET_CONFIG, ControlNetModel, UNet2DConditionModel

    torch.manual_seed(0)
    unet = UNet2DConditionModel(TINY_UNET_CONFIG)
    pipe = StableDiffusionControlNetHDRPipeline(
        unet, None, get_scheduler("pndm"),
        UNet2DConditionModel(dataclasses.replace(TINY_UNET_CONFIG, in_channels=8)),
        ControlNetModel(TINY_CONTROLNET_CONFIG), device="cpu")
    with pytest.raises(TypeError, match="ControlNet"):
        PipelinedDualUNet(pipe, groups=object())
