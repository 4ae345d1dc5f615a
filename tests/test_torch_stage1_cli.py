"""The port's Stage-1 training entry point against the JAX package on the
CPU at tiny size: the exposure augmentation (``gmdx.ops.exposure``), the
Stage-1 optimizers with warmup schedules and gradient accumulation
(``optax.MultiSteps``), the discriminator component both ways and a
``--perceptual_ckpt`` VGG19 in both packages, ``Stage1State`` checkpoints
(exact, with the spectral-norm buffers; a restore across kinds raises), and
``scripts/torch/train_vqgan_lora.py``: its artifacts (``finetuned_VAE``
loads in gmdx's ``load_pipeline`` with the port's merged EMA weights),
validation and ``--debug_mode``, exact resume, the generator /
discriminator cadence and the refused flags.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import gmdx.io.pipeline as jax_pipeline
from gmdx.io.params import flatten_tree as jax_flatten_tree
from gmdx.io.params import load_params as jax_load_params
from gmdx.io.torch_import import convert_vgg19_state_dict as jax_convert_vgg19
from gmdx.io.torch_import import export_vgg19_state_dict as jax_export_vgg19
from gmdx.io.torch_import import load_torch_checkpoint as jax_load_torch_checkpoint
from gmdx.models.discriminator import Discriminator as JaxDiscriminator
from gmdx.models.vgg import VGG19Features as JaxVGG
from gmdx.ops import exposure as jax_exposure
from gmdx.train.optim import get_lr_schedule as jax_lr_schedule
from gmdx.train.optim import make_adamw as jax_make_adamw
from gmdx_torch.data import write_parquet_dataset
from gmdx_torch.io import load_component
from gmdx_torch.io.convert import (
    discriminator_flax_from_state_dict,
    discriminator_state_dict_from_flax,
    load_vgg19_checkpoint,
)
from gmdx_torch.io.params import save_file
from gmdx_torch.io.pipeline import save_component
from gmdx_torch.io.png import encode_png, write_png
from gmdx_torch.io.to_flax import convert_vae_state_dict
from gmdx_torch.models import (
    TINY_UNET_CONFIG,
    TINY_VAE_CONFIG,
    AutoencoderKL,
    Discriminator,
    LoRAConfig,
    UNet2DConditionModel,
    VGG19Features,
)
from gmdx_torch.ops import exposure
from gmdx_torch.ops import tmo as tk_tmo
from gmdx_torch.train import Stage2Config, make_manager, restore_state, save_state
from gmdx_torch.train import init_state as stage2_init_state
from gmdx_torch.train import stage1
from gmdx_torch.train.checkpoint import state_tensors, tensor_digest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXPOSURE_RTOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _card_like_host():
    """One torch thread (intra-op threads oversubscribe a parallel run) and
    no tensorboard (importing it here pulls in TensorFlow), as in the
    port's other trainer tests; both restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = sys.modules.get("torch.utils.tensorboard", False)
    sys.modules["torch.utils.tensorboard"] = None
    yield
    torch.set_num_threads(n)
    if saved is False:
        del sys.modules["torch.utils.tensorboard"]
    else:
        sys.modules["torch.utils.tensorboard"] = saved


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_cli_{name}", os.path.join(REPO, "scripts", "torch", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _max_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# the exposure augmentation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("exp,n,sigma", [(0.1, 0.4, 0.8), (4.0, 0.65, 0.6), (16.0, 0.87, 0.45)])
def test_exposure_chain_matches_jax(exp, n, sigma):
    """At fixed (exposure, n, sigma), fp32: the curve and hdr_to_ldr each
    within 1e-6 relative of gmdx's; discretize_to_uint16 on the same input
    to the bit (round half to even); the whole chain within 1e-6 relative
    L2 (the two packages' pow differ by an ulp in ~2 % of the elements,
    which moves a uint16 level where it straddles a rounding boundary)."""
    y = np.random.default_rng(0).random((4, 3, 64, 64)).astype(np.float32)
    n32, s32 = float(np.float32(n)), float(np.float32(sigma))
    jcurve = np.asarray(jax_exposure.apply_inv_sigmoid_curve(
        jnp.asarray(y), jnp.float32(n32), jnp.float32(s32)))
    curve = exposure.apply_inv_sigmoid_curve(torch.from_numpy(y), n32, s32).numpy()
    assert _max_rel(curve, jcurve) <= EXPOSURE_RTOL
    jdisc = np.asarray(jax_exposure.discretize_to_uint16(jnp.asarray(jcurve)))
    np.testing.assert_array_equal(
        exposure.discretize_to_uint16(torch.from_numpy(jcurve.copy())).numpy(), jdisc)
    halves = np.array([0.5, 1.5, 2.5, 3.5], np.float32) / 65535
    np.testing.assert_array_equal(
        exposure.discretize_to_uint16(torch.from_numpy(halves)).numpy(),
        np.asarray(jax_exposure.discretize_to_uint16(jnp.asarray(halves))))
    jldr = np.asarray(jax_exposure.hdr_to_ldr(jnp.asarray(jdisc), jnp.float32(exp)))
    assert _max_rel(exposure.hdr_to_ldr(torch.from_numpy(jdisc.copy()), exp).numpy(),
                    jldr) <= EXPOSURE_RTOL
    chain = exposure.hdr_to_ldr(exposure.discretize_to_uint16(torch.from_numpy(curve)), exp)
    assert _rel_l2(chain.numpy(), jldr) <= EXPOSURE_RTOL


def test_exposure_draws():
    """Over 300 calls at prob 1 every level is drawn and n, sigma stay in
    their clips, with the chain's output at the drawn values; at prob 0
    the input comes back with the identity metadata; one seed gives one
    output; the class form draws as the function."""
    img = torch.rand(2, 3, 8, 8, generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(0)
    levels = set()
    for _ in range(300):
        out, meta = exposure.random_exposure_adjust(gen, img)
        levels.add(meta["exposure"])
        # The clips are float32's 0.4, 0.9 and 0.8, as gmdx's.
        lo, hi_n, hi_s = (float(np.float32(v)) for v in (0.4, 0.9, 0.8))
        assert lo <= meta["n"] <= hi_n and lo <= meta["sigma"] <= hi_s
        assert meta["n"] == float(np.float32(meta["n"]))
    assert levels == set(exposure.EXPOSURE_LEVELS.tolist())
    want = exposure.hdr_to_ldr(exposure.discretize_to_uint16(
        exposure.apply_inv_sigmoid_curve(img, meta["n"], meta["sigma"])), meta["exposure"])
    assert torch.equal(out, want)
    for _ in range(50):
        out, meta = exposure.random_exposure_adjust(gen, img, prob=0.0)
        assert out is img and meta == {"exposure": 1.0, "n": 1.0, "sigma": 0.0}
    a = exposure.random_exposure_adjust(torch.Generator().manual_seed(7), img, prob=0.7)
    b = exposure.random_exposure_adjust(torch.Generator().manual_seed(7), img, prob=0.7)
    assert torch.equal(a[0], b[0]) and a[1] == b[1]
    aug = exposure.RandomExposureAdjust(prob=0.7)
    c, meta_c = aug(torch.Generator().manual_seed(7), img, return_metadata=True)
    assert torch.equal(c, a[0]) and meta_c == a[1]
    applied = sum(exposure.random_exposure_adjust(gen, img, prob=0.7)[1]["n"] != 1.0
                  for _ in range(300))
    assert 150 < applied < 270


# ---------------------------------------------------------------------------
# optimizers, components, checkpoints
# ---------------------------------------------------------------------------


def _small_trainables(seed):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    return {"lora": {"x.weight": {"a": r(2, 3), "b": r(4, 2)},
                     "y.weight": {"a": r(2, 3, 3, 3), "b": r(5, 2, 1, 1)}},
            "conv_out": {"weight": r(3, 4, 3, 3), "bias": r(3)}}


@pytest.mark.parametrize("ga", [1, 2])
def test_stage1_optimizers_match_optax(ga):
    """make_optimizers with the CLI's settings (linear schedules with
    warmup over num_training_steps, both learning rates, Adam settings,
    clip) against gmdx's make_adamw, in optax.MultiSteps under
    accumulation: 6 calls of seeded gradients, the parameters after each
    within 2e-6 relative; a window moves them once, with the mean of its
    gradients."""
    torch.manual_seed(0)
    trainables = _small_trainables(0)
    disc = Discriminator(hidden_channels=16, depth=4)
    kw = dict(lr_warmup_steps=2, num_training_steps=8, beta1=0.8, beta2=0.99,
              weight_decay=0.05, epsilon=1e-6, max_grad_norm=0.5)
    gen_opt, disc_opt = stage1.make_optimizers(
        trainables, disc, learning_rate=1e-2, discr_learning_rate=3e-3, lr_scheduler="linear",
        discr_lr_scheduler="cosine", gradient_accumulation_steps=ga, **kw)
    jkw = dict(beta1=0.8, beta2=0.99, weight_decay=0.05, epsilon=1e-6, max_grad_norm=0.5)
    for opt, sched, lr in ((gen_opt, "linear", 1e-2), (disc_opt, "cosine", 3e-3)):
        jopt = jax_make_adamw(jax_lr_schedule(sched, lr, num_warmup_steps=2,
                                              num_training_steps=8), **jkw)
        if ga > 1:
            jopt = optax.MultiSteps(jopt, every_k_schedule=ga)
        params = {str(i): p.detach().numpy().copy() for i, p in enumerate(opt.params)}
        jstate, update = jopt.init(params), jax.jit(jopt.update)
        rng = np.random.default_rng(5)
        for call in range(6):
            grads = {k: rng.standard_normal(v.shape).astype(np.float32)
                     for k, v in params.items()}
            before = [p.detach().clone() for p in opt.params]
            opt.step([torch.from_numpy(grads[str(i)]) for i in range(len(opt.params))])
            upd, jstate = update(grads, jstate, params)
            params = jax.tree.map(np.asarray, optax.apply_updates(params, upd))
            moved = any(not torch.equal(a, p) for a, p in zip(before, opt.params))
            assert moved == ((call + 1) % ga == 0), call
            for i, p in enumerate(opt.params):
                np.testing.assert_allclose(p.detach().numpy(), params[str(i)], rtol=2e-6,
                                           atol=1e-7, err_msg=f"{sched} call {call} leaf {i}")


@pytest.fixture(scope="module")
def jax_disc_vars():
    disc = JaxDiscriminator(depth=4, hidden_channels=64)
    variables = jax.jit(disc.init)(jax.random.key(0), jnp.zeros((1, 3, 32, 32)))
    variables = jax.tree.map(np.asarray, variables)
    # Non-trivial spectral-norm state (one power-iteration update).
    _, upd = jax.jit(lambda v, x: disc.apply(v, x, update_sn=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(np.random.default_rng(1).random((2, 3, 32, 32), np.float32)))
    return {"params": variables["params"], **jax.tree.map(np.asarray, upd)}


def test_discriminator_component_both_ways(tmp_path, jax_disc_vars):
    """gmdx's Discriminator variables -> the port's module -> save_component
    gives the file gmdx's trainer writes (config.json with depth,
    hidden_channels and _class_name; params.safetensors with params and
    batch_stats, bit for bit); gmdx's save_component's directory loads in
    the port's load_component with the same state."""
    sd = discriminator_state_dict_from_flax(jax_disc_vars["params"],
                                            jax_disc_vars["batch_stats"])
    disc = Discriminator(depth=4, hidden_channels=64)
    disc.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    save_component(str(tmp_path / "port"), disc)
    with open(tmp_path / "port" / "config.json") as f:
        assert json.load(f) == {"depth": 4, "hidden_channels": 64, "_class_name": "Discriminator"}
    got = jax_flatten_tree(jax_load_params(str(tmp_path / "port" / "params.safetensors")))
    want = jax_flatten_tree(jax_disc_vars)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    back = discriminator_flax_from_state_dict(disc.state_dict())
    assert jax_flatten_tree(jax.tree.map(lambda t: t.numpy(), back)).keys() == want.keys()

    jax_pipeline.save_component(str(tmp_path / "jax"), {"depth": 4, "hidden_channels": 64},
                                jax_disc_vars, "Discriminator")
    loaded = load_component(str(tmp_path / "jax"), device="cpu")
    assert isinstance(loaded, Discriminator) and loaded.depth == 4
    for k, v in disc.state_dict().items():
        assert loaded.state_dict()[k].dtype == torch.float32
        assert torch.equal(loaded.state_dict()[k], v), k
    with pytest.raises(KeyError, match="unhandled Discriminator key"):
        discriminator_flax_from_state_dict({"convs.0.extra": torch.zeros(1)})


@pytest.fixture(scope="module")
def vgg_ckpts(tmp_path_factory):
    """gmdx's VGG19 params at random and torchvision-layout checkpoints of
    them (export_vgg19_state_dict, with a classifier entry): a .pth
    wrapping a state_dict and a .safetensors."""
    root = tmp_path_factory.mktemp("vgg")
    params = jax.tree.map(np.asarray, jax.jit(JaxVGG().init)(
        jax.random.key(2), jnp.zeros((1, 3, 32, 32)))["params"])
    sd = jax_export_vgg19(params)
    sd["classifier.0.weight"] = np.ones((4, 3), np.float32)
    pth, st = str(root / "vgg19.pth"), str(root / "vgg19.safetensors")
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, pth)
    save_file(sd, st)
    return pth, st


@pytest.mark.parametrize("kind", ["pth", "safetensors"])
def test_perceptual_ckpt_same_features(vgg_ckpts, kind):
    """The same checkpoint gives the same five VGG19 stage maps in both
    packages (each within 1e-5 relative L2, fp32)."""
    path = vgg_ckpts[0] if kind == "pth" else vgg_ckpts[1]
    x = np.random.default_rng(4).random((2, 3, 32, 32), np.float32)
    jparams = jax_convert_vgg19(jax_load_torch_checkpoint(path))
    with jax.default_matmul_precision("highest"):
        want = jax.jit(JaxVGG().apply)({"params": jparams}, jnp.asarray(x))
    vgg = VGG19Features()
    vgg.load_state_dict(load_vgg19_checkpoint(path), strict=True)
    with torch.no_grad():
        got = vgg(torch.from_numpy(x))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):  # gmdx's maps are NHWC
        assert _rel_l2(g.numpy(), np.transpose(np.asarray(w), (0, 3, 1, 2))) <= 1e-5


def test_perceptual_ckpt_refuses_other_keys(tmp_path):
    torch.save({"features.1.weight": torch.zeros(1)}, str(tmp_path / "bad.pth"))
    with pytest.raises(KeyError, match="non-conv"):
        load_vgg19_checkpoint(str(tmp_path / "bad.pth"))
    torch.save({"features.0.weight": torch.zeros(1)}, str(tmp_path / "short.pth"))
    with pytest.raises(KeyError, match="missing conv"):
        load_vgg19_checkpoint(str(tmp_path / "short.pth"))


def _stage1_state(seed, ga, steps=3):
    """A Stage-1 state on the tiny VAE (LoRA r = 2, EMA) after ``steps``
    seeded updates of both optimizers, its spectral-norm buffers moved."""
    torch.manual_seed(seed)
    cfg = stage1.Stage1Config(lora=LoRAConfig(rank=2, alpha=2.0), use_ema=True)
    vae = AutoencoderKL(TINY_VAE_CONFIG)
    disc = Discriminator(depth=4, hidden_channels=64)
    trainables = stage1.init_trainables(torch.Generator().manual_seed(seed), vae, cfg)
    state = stage1.init_state(cfg, trainables, disc, stage1.make_optimizers(
        trainables, disc, gradient_accumulation_steps=ga))
    g = torch.Generator().manual_seed(seed + 1)
    for _ in range(steps):
        for opt in (state.optimizer, state.disc_optimizer):
            opt.step([torch.randn(p.shape, generator=g) for p in opt.params])
        with torch.no_grad():
            for b in disc.buffers():
                b.add_(torch.randn(b.shape, generator=g))
        state.step += 1
        stage1.make_ema_step(cfg)(state)
    return state


@pytest.mark.parametrize("ga", [1, 2])
@pytest.mark.parametrize("asynchronous", [False, True])
def test_stage1_checkpoint_round_trip_is_exact(tmp_path, ga, asynchronous):
    """The trainables and both optimizers' moments, counts, accumulators and
    phases, the discriminator's parameters and spectral-norm buffers, the
    EMA shadow and step: saved and restored into a fresh state bit for bit;
    an asynchronous save holds the state as it was when the call
    returned."""
    state = _stage1_state(0, ga)
    want, want_scalars = state_tensors(state)
    assert {"disc_buffers/convs.0.u", "disc_buffers/convs.3.sigma"} <= set(want)
    assert any(k.startswith("gen_acc/") for k in want) == (ga > 1)
    assert want_scalars["gen_mini_step"] == (None if ga == 1 else 1)
    frozen = {k: v.clone() for k, v in want.items()}
    manager = make_manager(str(tmp_path), async_checkpointing=asynchronous)
    digest = save_state(manager, 3, state, wait=not asynchronous)
    with torch.no_grad():
        for t in want.values():
            t.add_(1.0)
    manager.wait_until_finished()
    with open(tmp_path / "checkpoint_3" / "state.json") as f:
        assert json.load(f)["format"] == "gmdx_torch.stage1.v1"
    fresh = _stage1_state(1, ga, steps=1)
    restore_state(manager, 3, fresh)
    got, got_scalars = state_tensors(fresh)
    assert got_scalars == want_scalars and sorted(got) == sorted(frozen)
    for k in frozen:
        assert got[k].dtype == frozen[k].dtype and torch.equal(got[k], frozen[k]), k
    assert tensor_digest(got) == digest


@pytest.mark.parametrize("saved_kind", ["stage1", "stage2"])
def test_restore_across_kinds_raises(tmp_path, saved_kind):
    s1 = _stage1_state(0, 1, steps=1)
    torch.manual_seed(0)
    s2 = stage2_init_state(Stage2Config(), UNet2DConditionModel(TINY_UNET_CONFIG))
    saved, other = (s1, s2) if saved_kind == "stage1" else (s2, s1)
    manager = make_manager(str(tmp_path))
    save_state(manager, 1, saved)
    with pytest.raises(ValueError, match="gmdx_torch.stage1.v1.*gmdx_torch.stage2.v1|"
                                         "gmdx_torch.stage2.v1.*gmdx_torch.stage1.v1"):
        restore_state(manager, 1, other)


class _Recorder:
    """An optimizer stand-in: records the gradients, moves nothing."""

    def __init__(self, params):
        self.params, self.grads = list(params), None

    def step(self, grads, grad_norm=None):
        self.grads = [g.clone() for g in grads]


def test_gen_step_under_remat_matches_plain():
    """--gradient_checkpointing: the generator step on a VAE whose blocks
    recompute in the backward pass gives the plain VAE's loss and every
    trainable's gradient (1e-6 relative L2); the merged LoRA weights stay
    swapped in over the backward passes, where the recompute reads them,
    and the VAE's own parameters are back in place afterwards."""
    import dataclasses

    cfg = stage1.Stage1Config(lora=LoRAConfig(rank=2, alpha=2.0), vgg_resolution=32)
    torch.manual_seed(0)
    plain = AutoencoderKL(TINY_VAE_CONFIG)
    remat = AutoencoderKL(dataclasses.replace(TINY_VAE_CONFIG, remat=True))
    remat.load_state_dict(plain.state_dict())
    vgg, disc = VGG19Features(), Discriminator(depth=4, hidden_channels=64)
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.rand(2, 3, 16, 16, generator=g) * 2 - 1
             for k in ("pixel_values", "miss_pixel_values")}
    batch["encode_eps"] = torch.randn(2, 4, 8, 8, generator=g)
    out = {}
    for name, vae in (("plain", plain), ("remat", remat)):
        trainables = stage1.init_trainables(torch.Generator().manual_seed(2), vae, cfg)
        gb = torch.Generator().manual_seed(3)
        with torch.no_grad():  # non-zero b factors: every factor takes gradient
            for f in trainables["lora"].values():
                f["b"].normal_(0.0, 1e-2, generator=gb)
        rec = _Recorder(stage1.trainable_list(trainables))
        state = stage1.init_state(cfg, trainables, disc, (rec, _Recorder(disc.parameters())))
        step = stage1.make_gen_step(cfg, vae=vae.train(), discriminator=disc, vgg=vgg,
                                    tmo_fn=tk_tmo.fix_mulog_tmo, device="cpu")
        before = {n: p for n, p in vae.named_parameters()}
        _, m = step(state, batch)
        assert {n: p for n, p in vae.named_parameters()} == before
        out[name] = (float(m["gen_loss"]), rec.grads)
    assert out["remat"][0] == pytest.approx(out["plain"][0], rel=1e-6)
    for a, b in zip(out["remat"][1], out["plain"][1]):
        assert _rel_l2(a.numpy(), b.numpy()) <= 1e-6


# ---------------------------------------------------------------------------
# the trainer CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A tiny pipeline directory (the port's init_pipeline), 6 pairs of
    40x48 PNGs in a parquet written by the port, and a validation PNG."""
    root = tmp_path_factory.mktemp("s1_cli")
    _script("init_pipeline").main(["--output_dir", str(root / "pipe"), "--size", "tiny",
                                   "--device", "cpu"])
    rng = np.random.default_rng(0)
    (root / "data").mkdir()
    (root / "val").mkdir()
    paths, gms = [], []
    for i in range(6):
        p = str(root / "data" / f"sdr_{i}.png")
        write_png(p, rng.integers(0, 255, (40, 48, 3), dtype=np.uint8))
        paths.append(p)
        gms.append(encode_png(rng.integers(0, 255, (40, 48, 3), dtype=np.uint8)))
    write_png(str(root / "val" / "v.png"), rng.integers(0, 255, (32, 32, 3), dtype=np.uint8))
    meta = str(root / "train.parquet")
    write_parquet_dataset(meta, paths, gms, [f"test caption {i}" for i in range(6)])
    return root, meta


def _train(root, meta, out, *extra):
    return _script("train_vqgan_lora").main([
        "--pretrained_model_name_or_path", str(root / "pipe"), "--train_metadata", meta,
        "--output_dir", str(out), "--resolution", "16", "--train_batch_size", "1",
        "--rank", "2", "--seed", "0", "--clip_pixel", "--use_ema", "--log_steps", "1",
        "--device", "cpu", *extra])


def test_trainer_artifacts_load_in_jax(workdir):
    """Two updates (a generator and a discriminator step) with
    --clip_pixel, EMA, remat, validation and --debug_mode: checkpoint_2,
    every scalar metric logged, validation .hdr / grid / log, the debug
    strip, finetuned_VAE loading in gmdx's load_pipeline with the port's
    EMA-merged VAE bit for bit, and discriminator/ in gmdx's trainer layout
    at the CLI's width."""
    root, meta = workdir
    out = root / "artifacts"
    r = _train(root, meta, out, "--max_train_steps", "2", "--checkpointing_steps", "2",
               "--val_images_dir", str(root / "val"), "--validation_steps", "2",
               "--debug_mode", "--gradient_checkpointing")
    assert r["global_step"] == 2 and os.path.isdir(out / "checkpoint_2")
    assert sorted(os.listdir(out / "validation")) == [
        "evaluation_log.txt", "grid_step2_0.png", "hdr_step2_0.hdr"]
    assert os.path.exists(out / "debug_train" / "step_0_concat_image.png")
    with open(out / "logs" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert {"step_gen_loss", "recon", "perceptual", "adversarial", "adaptive_weight",
            "grad_norm"} <= set(rows[0])
    assert {"step_discr_loss", "hinge", "gp"} <= set(rows[1])

    state = r["state"]
    cfg = stage1.Stage1Config(lora=LoRAConfig(rank=2, alpha=2.0))
    vae = load_component(str(root / "pipe" / "vae"), device="cpu")
    shadow = stage1.trainables_like(state.trainables, state.ema.shadow)
    with torch.no_grad():
        want = convert_vae_state_dict(stage1.effective_vae_params(cfg, vae, shadow))
    bundle = jax_pipeline.load_pipeline(str(out / "finetuned_VAE"))
    assert sorted(bundle["modules"]) == ["vae"] and bundle["tokenizer"] is not None
    got = jax_flatten_tree(bundle["params"]["vae"])
    want = jax_flatten_tree(jax.tree.map(lambda t: t.detach().numpy(), want))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    with open(out / "discriminator" / "config.json") as f:
        assert json.load(f) == {"depth": 6, "hidden_channels": 512,
                                "_class_name": "Discriminator"}
    shapes = jax.eval_shape(JaxDiscriminator().init, jax.random.key(0),
                            jnp.zeros((1, 3, 64, 64)))
    saved = jax_flatten_tree(jax_load_params(str(out / "discriminator" / "params.safetensors")))
    want_shapes = jax_flatten_tree(jax.tree.map(lambda a: np.empty(a.shape, a.dtype), shapes))
    assert {k: v.shape for k, v in saved.items()} == {k: v.shape for k, v in want_shapes.items()}
    mine = discriminator_state_dict_from_flax(
        *(jax_load_params(str(out / "discriminator" / "params.safetensors"))[c]
          for c in ("params", "batch_stats")))
    for k, v in state.discriminator.state_dict().items():
        np.testing.assert_array_equal(np.asarray(mine[k]), v.numpy(), err_msg=k)


@pytest.fixture(scope="module")
def resumed(workdir):
    """For ga 1 and 2: an uninterrupted run of 2 updates, and a run of 1
    update (a checkpoint) resumed to 2."""
    root, meta = workdir
    runs = {}
    for ga in (1, 2):
        base = ["--checkpointing_steps", "1", "--gradient_accumulation_steps", str(ga)]
        full = _train(root, meta, root / f"full_ga{ga}", *base, "--max_train_steps", "2")
        first = _train(root, meta, root / f"part_ga{ga}", *base, "--max_train_steps", "1")
        again = _train(root, meta, root / f"part_ga{ga}", *base, "--max_train_steps", "2",
                       "--resume_from_checkpoint", "latest")
        runs[ga] = (full, first, again)
    return runs


@pytest.mark.parametrize("ga", [1, 2])
def test_resume_continuity_matches_uninterrupted(resumed, ga):
    """Resumed after the generator's update, the run restores the saved
    bits, takes the discriminator's update next, logs the uninterrupted
    run's step-2 loss and ends in its state, bit for bit."""
    full, first, again = resumed[ga]
    assert again["start_step"] == 1 and again["global_step"] == 2
    assert again["restored_digest"] == first["saved_digests"][1]
    assert [c[1] for c in again["cadence"]] == ["discr"] * ga
    assert again["losses"] == {2: full["losses"][2]}
    assert (tensor_digest(state_tensors(again["state"])[0])
            == tensor_digest(state_tensors(full["state"])[0]))


@pytest.mark.parametrize("ga", [1, 2])
def test_cadence_and_global_step_follow_jax_rule(resumed, ga):
    """Generator on batch i iff (i // ga) % 2 == 0; an update (global_step,
    EMA, logs, checkpoints) iff (i + 1) % ga == 0; max_train_steps counts
    updates: 2 of them take 2 * ga batches."""
    full, _, again = resumed[ga]
    want = [[i, "gen" if (i // ga) % 2 == 0 else "discr", (i + 1) % ga == 0]
            for i in range(2 * ga)]
    assert full["cadence"] == want and full["global_step"] == 2
    assert again["cadence"] == want[ga:]
    assert sorted(full["losses"]) == [1, 2] and full["state"].ema.step == 2


def test_refused_flags(workdir):
    root, meta = workdir
    train = _script("train_vqgan_lora")
    common = ["--pretrained_model_name_or_path", str(root / "pipe"), "--device", "cpu",
              "--output_dir", str(root / "refused")]
    for flags in (["--push_to_hub", "--train_metadata", meta], []):
        with pytest.raises(SystemExit):
            train.parse_args(common + flags)
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        train.main(common + ["--train_metadata", meta, "--shard_strategy", "tp"])
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        train.main(common + ["--dataset_name", "some/hub-set"])
    assert not os.path.exists(root / "refused")
