"""gmdx_torch's Stage-1 VAE-LoRA + GAN training against gmdx's, on the CPU.

The fixture is tests/test_train.py's tiny Stage-1 setup (TINY_VAE_CONFIG,
Discriminator(depth=4, hidden_channels=64), VGG19, LoRA r = 2), with the
VGG resolution at 32^2 and non-zero LoRA ``b`` factors (so the ``a``
factors take gradient too). Weights, factors and spectral-norm state are
carried across; both packages get the same batch and ``encode_eps`` from
numpy. Both packages' gradients are read by running their steps with an
optimizer that records the gradients and leaves the parameters as they are
(in JAX, one that keeps them in its state: ``optax.sgd(1.0)``'s
``old - new`` would carry one ulp of each parameter, 2e-4 relative on the
smallest leaves).
"""

import copy

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from gmdx.io.torch_import import export_vgg19_state_dict
from gmdx.models import TINY_VAE_CONFIG as JAX_TINY_VAE
from gmdx.models import AutoencoderKL as JaxVAE
from gmdx.models.discriminator import Discriminator as JaxDiscriminator
from gmdx.models.lora import LoRAConfig as JaxLoRAConfig
from gmdx.models.lora import merge_lora as jax_merge_lora
from gmdx.models.vgg import VGG19Features as JaxVGG
from gmdx.models.vgg import perceptual_loss as jax_perceptual_loss
from gmdx.models.vgg import resize_for_vgg as jax_resize_for_vgg
from gmdx.ops import gamut as jax_gamut
from gmdx.ops import tmo as jax_tmo
from gmdx.train import stage1 as jax_stage1
from gmdx.train.optim import get_lr_schedule as jax_lr_schedule
from gmdx.train.optim import make_adamw as jax_make_adamw
from gmdx_torch.io.convert import (
    discriminator_state_dict_from_flax, load_vae, lora_from_flax,
    stage1_trainables_from_flax, vae_state_dict_from_flax, vgg19_state_dict_from_flax,
)
from gmdx_torch.kernels import attention as tk_attention
from gmdx_torch.models import TINY_VAE_CONFIG, AutoencoderKL, set_use_kernels
from gmdx_torch.models.discriminator import Discriminator
from gmdx_torch.models.layers import Conv3x3
from gmdx_torch.models.lora import LoRAConfig, lora_targets, merge_lora
from gmdx_torch.models.vgg import VGG19Features, perceptual_loss, resize_for_vgg
from gmdx_torch.ops import gamut_compress
from gmdx_torch.ops import tmo as tk_tmo
from gmdx_torch.train import stage1

RTOL = 1e-5
GRAD_REL_L2 = 1e-4
H = W = 16
VGG_RES = 32


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _psnr_db(a, b) -> float:
    """10 log10(peak^2 / mse) of ``a`` against ``b``, peak = max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    return float("inf") if mse == 0 else float(10 * np.log10(np.max(np.abs(b)) ** 2 / mse))


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _close(got, want, rtol=RTOL):
    assert abs(float(got) - float(want)) <= rtol * abs(float(want)), (float(got), float(want))


# ---------------------------------------------------------------------------
# the modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_merge_lora_matches_jax(kind):
    rng = np.random.default_rng(0)
    shape, a_shape, b_shape = {
        "conv": ((3, 3, 8, 16), (3, 3, 8, 4), (1, 1, 4, 16)),
        "dense": ((8, 16), (8, 4), (4, 16)),
    }[kind]
    w, a, b = (rng.standard_normal(s).astype(np.float32) for s in (shape, a_shape, b_shape))
    want = jax_merge_lora({"m": {"kernel": jnp.asarray(w)}},
                          {("m", "kernel"): {"a": jnp.asarray(a), "b": jnp.asarray(b)}}, 0.5)
    want = np.asarray(want["m"]["kernel"])
    if kind == "conv":
        inv = lambda x: np.ascontiguousarray(x.transpose(3, 2, 0, 1))  # noqa: E731
        want = inv(want)
    else:
        inv = lambda x: np.ascontiguousarray(x.T)  # noqa: E731
        want = want.T
    got = merge_lora({"m.weight": _t(inv(w))}, {"m.weight": {"a": _t(inv(a)), "b": _t(inv(b))}},
                     0.5)["m.weight"]
    assert _psnr_db(got.numpy(), want) >= 100


def test_gamut_compress_matches_jax():
    x = np.random.default_rng(1).uniform(-0.2, 1.2, (2, 3, 8, 8)).astype(np.float32)
    want = np.asarray(jax_gamut.gamut_compress(jnp.asarray(x)))
    assert _psnr_db(gamut_compress(_t(x)).numpy(), want) >= 100


@pytest.mark.parametrize("name", ["linear_scale", "hard_clip", "fix_mulog", "mulog", "2446a",
                                  "choose_2446a"])
def test_tmo_matches_jax(name):
    hdr = np.random.default_rng(2).uniform(0.0, 50.0, (2, 3, 8, 8)).astype(np.float32)
    qmax = 49.0
    jfn, tfn = {
        "linear_scale": (lambda x: jax_tmo.linear_scale_tmo(x, qmax),
                         lambda x: tk_tmo.linear_scale_tmo(x, qmax)),
        "hard_clip": (jax_tmo.hard_clip_tmo, tk_tmo.hard_clip_tmo),
        "fix_mulog": (lambda x: jax_tmo.fix_mulog_tmo(x, qmax),
                      lambda x: tk_tmo.fix_mulog_tmo(x, qmax)),
        "mulog": (jax_tmo.mulog_tmo, tk_tmo.mulog_tmo),
        "2446a": (lambda x: jax_tmo.tmo_2446a(x / (qmax + 1)),
                  lambda x: tk_tmo.tmo_2446a(x / (qmax + 1))),
        "choose_2446a": (lambda x: jax_tmo.tmo_2446a(x / (qmax + 1.0)),
                         lambda x: tk_tmo.choose_tmo("fix_mulog", True)(x, qmax=qmax)),
    }[name]
    want = np.asarray(jfn(jnp.asarray(hdr)))
    assert _psnr_db(tfn(_t(hdr)).numpy(), want) >= 100


def test_random_tmo_is_the_mulog_curve_at_its_draw():
    """mu ~ U(500, 5000) from the generator; the curve is the JAX one at that
    mu (the two packages' random draws differ by design)."""
    hdr = np.random.default_rng(3).uniform(0.0, 50.0, (2, 3, 8, 8)).astype(np.float32)
    gen = torch.Generator().manual_seed(7)
    u = float(torch.rand((), generator=torch.Generator().manual_seed(7)))
    mu = jnp.float32(500.0 + 4500.0 * u)
    x = jnp.asarray(hdr) / 50.0
    want = np.asarray(jnp.clip(jnp.log1p(mu * x) / jnp.log1p(mu), 0.0, 1.0))
    got = tk_tmo.random_tmo(gen, _t(hdr), 49.0).numpy()
    assert 500.0 <= float(mu) <= 5000.0
    assert _psnr_db(got, want) >= 100


@pytest.mark.parametrize("hw", [16, 40, 224])
def test_resize_for_vgg_matches_jax(hw):
    x = np.random.default_rng(4).standard_normal((1, 3, hw, hw + 3)).astype(np.float32)
    want = np.asarray(jax_resize_for_vgg(jnp.asarray(x), VGG_RES))
    np.testing.assert_array_equal(resize_for_vgg(_t(x), VGG_RES).numpy(), want)


# ---------------------------------------------------------------------------
# the Stage-1 fixture
# ---------------------------------------------------------------------------


def _jax_recorder() -> optax.GradientTransformation:
    """Zero updates; the state is the last gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads),
    )


@pytest.fixture(scope="module")
def s1():
    """Both packages' modules, state and batch, and the JAX package's
    results of one gen step and one disc step under the recording
    optimizer."""
    jvae = JaxVAE(JAX_TINY_VAE)
    jdisc = JaxDiscriminator(depth=4, hidden_channels=64)
    jvgg = JaxVGG()
    vae_params = jvae.init(jax.random.key(0), jnp.zeros((1, 3, H, W)), jax.random.key(1))["params"]
    disc_vars = jdisc.init(jax.random.key(2), jnp.zeros((1, 3, H, W)))
    vgg_params = jvgg.init(jax.random.key(3), jnp.zeros((1, 3, VGG_RES, VGG_RES)))["params"]
    cfg = jax_stage1.Stage1Config(lora=JaxLoRAConfig(rank=2, alpha=2.0), vgg_resolution=VGG_RES)
    trainables = jax_stage1.init_trainables(jax.random.key(4), vae_params, cfg)
    rng = np.random.default_rng(5)
    for f in trainables["lora"].values():
        f["b"] = jnp.asarray(0.05 * rng.standard_normal(f["b"].shape).astype(np.float32))
    trainables = jax.tree.map(np.asarray, trainables)
    disc_params = jax.tree.map(np.asarray, disc_vars["params"])
    disc_stats = jax.tree.map(np.asarray, {k: v for k, v in disc_vars.items() if k != "params"})
    batch = {
        "pixel_values": rng.uniform(-1, 1, (2, 3, H, W)).astype(np.float32),
        "miss_pixel_values": rng.uniform(-1, 1, (2, 3, H, W)).astype(np.float32),
        "encode_eps": rng.standard_normal((2, 4, H // 2, W // 2)).astype(np.float32),
    }
    rec = _jax_recorder()
    state = jax_stage1.Stage1State(
        trainables=trainables, disc_params=disc_params, disc_vars=disc_stats,
        opt_state=rec.init(trainables), disc_opt_state=rec.init(disc_params), ema=None,
        step=jnp.zeros((), jnp.int32),
    )
    frozen = {"vae": vae_params, "vgg": vgg_params}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with jax.default_matmul_precision("highest"):
        gen = jax_stage1.make_gen_step(cfg, vae=jvae, discriminator=jdisc, vgg=jvgg,
                                       tmo_fn=jax_tmo.fix_mulog_tmo, optimizer=rec, donate=False)
        g_state, g_metrics = gen(state, frozen, jbatch, jax.random.key(0))
        disc = jax_stage1.make_disc_step(cfg, vae=jvae, discriminator=jdisc,
                                         tmo_fn=jax_tmo.fix_mulog_tmo, optimizer=rec,
                                         donate=False)
        d_state, d_metrics = disc(state, frozen, jbatch, jax.random.key(0))
    jax_out = {
        "gen_metrics": jax.tree.map(np.asarray, g_metrics),
        "gen_grads": jax.tree.map(np.asarray, g_state.opt_state),
        "disc_metrics": jax.tree.map(np.asarray, d_metrics),
        "disc_grads": jax.tree.map(np.asarray, d_state.disc_opt_state),
        "disc_stats": jax.tree.map(np.asarray, d_state.disc_vars),
    }
    return {
        "vae_sd": vae_state_dict_from_flax(jax.tree.map(np.asarray, vae_params)),
        "vgg_sd": vgg19_state_dict_from_flax(jax.tree.map(np.asarray, vgg_params)),
        "disc_sd": discriminator_state_dict_from_flax(disc_params, disc_stats),
        "trainables": trainables, "disc_params": disc_params, "batch": batch, "jax": jax_out,
        "vgg_params": vgg_params, "disc_stats": disc_stats,
    }


def _config():
    return stage1.Stage1Config(lora=LoRAConfig(rank=2, alpha=2.0), vgg_resolution=VGG_RES)


def _modules(s1):
    vae = load_vae(s1["vae_sd"], TINY_VAE_CONFIG, device="cpu", dtype=torch.float32)
    vgg = VGG19Features()
    vgg.load_state_dict({k: _t(v) for k, v in s1["vgg_sd"].items()}, strict=True)
    disc = Discriminator(depth=4, hidden_channels=64)
    disc.load_state_dict({k: _t(v) for k, v in s1["disc_sd"].items()}, strict=True)
    return vae, vgg, disc


def _trainables(s1):
    tr = stage1_trainables_from_flax(s1["trainables"])
    out = {"lora": {n: {k: _t(v).requires_grad_(True) for k, v in f.items()}
                    for n, f in tr["lora"].items()},
           "conv_out": {k: _t(v).requires_grad_(True) for k, v in tr["conv_out"].items()}}
    return out


class _Recorder:
    """The optimizer's interface: records the gradients and leaves the
    parameters as they are, as the JAX side's recorder does."""

    def __init__(self, params):
        self.params, self.grads = list(params), None

    def step(self, grads, grad_norm=None):
        self.grads = [g.clone() for g in grads]


def _port_state(s1, disc, trainables, optimizers=None):
    if optimizers is None:
        optimizers = (_Recorder(stage1.trainable_list(trainables)), _Recorder(disc.parameters()))
    return stage1.init_state(_config(), trainables, disc, optimizers)


def _batch(s1):
    return {k: _t(v) for k, v in s1["batch"].items()}


@pytest.fixture(scope="module")
def port_gen(s1):
    vae, vgg, disc = _modules(s1)
    state = _port_state(s1, disc, _trainables(s1))
    step = stage1.make_gen_step(_config(), vae=vae, discriminator=disc, vgg=vgg,
                                tmo_fn=tk_tmo.fix_mulog_tmo, device="cpu")
    state, metrics = step(state, _batch(s1))
    return state, metrics


@pytest.fixture(scope="module")
def port_disc(s1):
    vae, _, disc = _modules(s1)
    state = _port_state(s1, disc, _trainables(s1))
    step = stage1.make_disc_step(_config(), vae=vae, discriminator=disc,
                                 tmo_fn=tk_tmo.fix_mulog_tmo, device="cpu")
    state, metrics = step(state, _batch(s1))
    return state, metrics


def _port_grads_by_jax_path(s1, state):
    """The port's recorded gen-step gradients keyed as the JAX trainables."""
    names = sorted(lora_from_flax(s1["trainables"]["lora"]))
    by_name = {}
    grads = state.optimizer.grads
    for i, n in enumerate(names):
        by_name[n] = {"a": grads[2 * i].numpy(), "b": grads[2 * i + 1].numpy()}
    return by_name, {"weight": grads[-2].numpy(), "bias": grads[-1].numpy()}


def _assert_grads(got: dict, want: dict):
    """The Stage-2 rule: each leaf within GRAD_REL_L2 relative L2, or, where
    the leaf is zero up to rounding, within 1e-6 of the whole gradient's
    norm."""
    total = np.sqrt(sum(np.sum(np.asarray(w, np.float64) ** 2) for w in want.values()))
    for n, w in want.items():
        if np.linalg.norm(w) > 1e-6 * total:
            assert _rel_l2(got[n], w) <= GRAD_REL_L2, n
        else:
            assert np.linalg.norm(got[n] - w) <= 1e-6 * total, n


# ---------------------------------------------------------------------------
# weights carried across
# ---------------------------------------------------------------------------


def test_vgg_state_dict_is_the_jax_export(s1):
    want = export_vgg19_state_dict(s1["vgg_params"])
    got = s1["vgg_sd"]
    assert list(got) == list(want) or set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    assert set(VGG19Features().state_dict()) == set(want)


def test_lora_targets_are_the_jax_targets(s1):
    vae, _, _ = _modules(s1)
    lora = lora_from_flax(s1["trainables"]["lora"])
    targets = lora_targets(vae)
    assert set(lora) == set(targets)
    for n, f in lora.items():
        w = targets[n]
        assert f["a"].shape[1] == w.shape[1] and f["b"].shape[0] == w.shape[0]
        assert f["a"].shape[2:] == w.shape[2:] and f["b"].shape[2:] == (1,) * (w.ndim - 2)


def test_effective_params_match_jax(s1):
    """conv_out replaced, then LoRA merged: every merged weight as gmdx's
    effective_vae_params makes it."""
    vae, _, _ = _modules(s1)
    cfg = jax_stage1.Stage1Config(lora=JaxLoRAConfig(rank=2, alpha=2.0))
    frozen = jax.tree.map(jnp.asarray, {k: v for k, v in _jax_vae_params(s1).items()})
    want = vae_state_dict_from_flax(jax.tree.map(
        np.asarray, jax_stage1.effective_vae_params(cfg, frozen, s1["trainables"])))
    got = stage1.effective_vae_params(_config(), vae, _trainables(s1))
    assert set(got) == set(want)
    for k, w in want.items():
        assert _psnr_db(got[k].detach().numpy(), w) >= 100, k


def _jax_vae_params(s1):
    jvae = JaxVAE(JAX_TINY_VAE)
    return jvae.init(jax.random.key(0), jnp.zeros((1, 3, H, W)), jax.random.key(1))["params"]


def test_discriminator_forward_and_spectral_update_match_jax(s1):
    x = np.random.default_rng(6).uniform(0, 1, (2, 3, H, W)).astype(np.float32)
    jdisc = JaxDiscriminator(depth=4, hidden_channels=64)
    variables = {"params": s1["disc_params"], **s1["disc_stats"]}
    with jax.default_matmul_precision("highest"):
        want, upd = jax.jit(lambda v, x: jdisc.apply(v, x, update_sn=True,
                                                     mutable=list(s1["disc_stats"])))(
            variables, jnp.asarray(x))
    _, _, disc = _modules(s1)
    got = disc(_t(x), update_sn=True)
    assert got.shape == want.shape
    assert _psnr_db(got.detach().numpy(), np.asarray(want)) >= 100
    sd = discriminator_state_dict_from_flax(s1["disc_params"], jax.tree.map(np.asarray, upd))
    for k, w in sd.items():
        if k.endswith((".u", ".sigma")):
            assert _rel_l2(disc.state_dict()[k].numpy(), w) <= RTOL, k


def test_perceptual_loss_matches_jax(s1):
    rng = np.random.default_rng(7)
    a, b = (rng.uniform(0, 1, (2, 3, H, W)).astype(np.float32) for _ in range(2))
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda p, a, b: jax_stage1.perceptual(JaxVGG(), p, a, b, VGG_RES))(
            s1["vgg_params"], jnp.asarray(a), jnp.asarray(b))
        feats = jax.jit(lambda p, a: JaxVGG().apply({"params": p}, jax_resize_for_vgg(a, VGG_RES)))(
            s1["vgg_params"], jnp.asarray(a))
    _, vgg, _ = _modules(s1)
    got = stage1.perceptual(vgg, _t(a), _t(b), VGG_RES)
    assert _psnr_db(float(got.detach()), float(want)) >= 100
    with torch.no_grad():
        tfeats = vgg(resize_for_vgg(_t(a), VGG_RES))
    for f, w in zip(tfeats, feats):
        assert _psnr_db(f.detach().permute(0, 2, 3, 1).numpy(), np.asarray(w)) >= 100
    assert _psnr_db(float(perceptual_loss(tfeats, tfeats)) + 1.0,
                    float(jax_perceptual_loss(feats, feats)) + 1.0) >= 100


# ---------------------------------------------------------------------------
# the two steps
# ---------------------------------------------------------------------------


def test_gen_step_losses_match_jax(s1, port_gen):
    _, m = port_gen
    jm = s1["jax"]["gen_metrics"]
    for k in ("recon", "perceptual", "adversarial", "adaptive_weight", "gen_loss"):
        _close(m[k], jm[k])


def test_gen_step_grads_match_jax(s1, port_gen):
    state, m = port_gen
    lora_g, co_g = _port_grads_by_jax_path(s1, state)
    want_lora = lora_from_flax(s1["jax"]["gen_grads"]["lora"])
    jco = s1["jax"]["gen_grads"]["conv_out"]
    want = {**{f"{n}.{k}": v for n, f in want_lora.items() for k, v in f.items()},
            "conv_out.weight": np.ascontiguousarray(jco["kernel"].transpose(3, 2, 0, 1)),
            "conv_out.bias": jco["bias"]}
    got = {**{f"{n}.{k}": v for n, f in lora_g.items() for k, v in f.items()},
           "conv_out.weight": co_g["weight"], "conv_out.bias": co_g["bias"]}
    _assert_grads(got, want)
    _close(m["grad_norm"], s1["jax"]["gen_metrics"]["grad_norm"], 1e-4)


def test_disc_step_losses_match_jax(s1, port_disc):
    _, m = port_disc
    jm = s1["jax"]["disc_metrics"]
    for k in ("hinge", "gp", "disc_loss"):
        _close(m[k], jm[k])


def test_disc_step_grads_and_spectral_state_match_jax(s1, port_disc):
    state, _ = port_disc
    names = [n for n, _ in state.discriminator.named_parameters()]
    got = dict(zip(names, (g.numpy() for g in state.disc_optimizer.grads)))
    want = discriminator_state_dict_from_flax(s1["jax"]["disc_grads"], {})
    _assert_grads(got, want)
    stats = discriminator_state_dict_from_flax({}, s1["jax"]["disc_stats"])
    sd = state.discriminator.state_dict()
    for k, w in stats.items():
        assert _rel_l2(sd[k].numpy(), w) <= RTOL, k


def test_adamw_steps_match_optax(s1):
    """One gen step and one disc step with the port's clipped AdamW against
    gmdx's make_adamw applied to the JAX steps' gradients."""
    cfg = _config()
    opt = jax_make_adamw(jax_lr_schedule("constant", stage1.LEARNING_RATE))
    jg = s1["jax"]["gen_grads"]
    upd, _ = jax.jit(opt.update)(jg, opt.init(s1["trainables"]), s1["trainables"])
    want_tr = stage1_trainables_from_flax(jax.tree.map(np.asarray,
                                                       optax.apply_updates(s1["trainables"], upd)))
    dopt = jax_make_adamw(jax_lr_schedule("constant", stage1.DISCR_LEARNING_RATE))
    dupd, _ = jax.jit(dopt.update)(s1["jax"]["disc_grads"], dopt.init(s1["disc_params"]),
                                   s1["disc_params"])
    want_disc = discriminator_state_dict_from_flax(
        jax.tree.map(np.asarray, optax.apply_updates(s1["disc_params"], dupd)), {})

    vae, vgg, disc = _modules(s1)
    trainables = _trainables(s1)
    state = stage1.init_state(cfg, trainables, disc)
    gen = stage1.make_gen_step(cfg, vae=vae, discriminator=disc, vgg=vgg,
                               tmo_fn=tk_tmo.fix_mulog_tmo, device="cpu")
    dstep = stage1.make_disc_step(cfg, vae=vae, discriminator=disc,
                                  tmo_fn=tk_tmo.fix_mulog_tmo, device="cpu")
    before = copy.deepcopy(trainables)
    state, _ = dstep(state, _batch(s1))  # the disc step reads the trainables before gen's update
    for n, f in before["lora"].items():
        for k, v in f.items():
            assert torch.equal(v, trainables["lora"][n][k])
    state, _ = gen(state, _batch(s1))
    for n, f in want_tr["lora"].items():
        for k, w in f.items():
            assert _rel_l2(trainables["lora"][n][k].detach().numpy(), w) <= RTOL, (n, k)
    for k, w in want_tr["conv_out"].items():
        assert _rel_l2(trainables["conv_out"][k].detach().numpy(), w) <= RTOL, k
    sd = disc.state_dict()
    for k, w in want_disc.items():
        assert _rel_l2(sd[k].numpy(), w) <= RTOL, k


def test_ema_step_advances_the_trainables(s1):
    vae, _, disc = _modules(s1)
    trainables = _trainables(s1)
    cfg = stage1.Stage1Config(lora=LoRAConfig(rank=2, alpha=2.0), use_ema=True)
    state = stage1.init_state(cfg, trainables, disc)
    shadow = [s.clone() for s in state.ema.shadow]
    with torch.no_grad():
        for p in stage1.trainable_list(trainables):
            p.add_(1.0)
    stage1.make_ema_step(cfg)(state)
    assert state.ema.step == 1
    assert all(not torch.equal(a, b) for a, b in zip(shadow, state.ema.shadow))


# ---------------------------------------------------------------------------
# the routes the step takes
# ---------------------------------------------------------------------------


def test_vae_attention_takes_flash_attention_under_autograd(monkeypatch):
    """A tiny VAE at 1024 mid-block tokens (64^2 images): under autograd the
    mid-block attentions go through FlashAttention (the flash forward and
    backward wrappers, the 512-wide kernels' at SD-1.5 width), and the
    gradient equals the plain route's."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = tk_attention.flash_attention_fwd, tk_attention.flash_attention_bwd

    def counting(key, fn):
        def wrapped(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tk_attention, "flash_attention_fwd", counting("fwd", fwd))
    monkeypatch.setattr(tk_attention, "flash_attention_bwd", counting("bwd", bwd))
    assert tk_attention.attention_route(1024, 64, packed=False) == "flash"
    torch.manual_seed(0)
    vae = AutoencoderKL(TINY_VAE_CONFIG)
    x = torch.rand(1, 3, 64, 64) * 2 - 1
    eps = torch.randn(1, 4, 32, 32)
    params = {n: p.detach().clone().requires_grad_(True) for n, p in vae.named_parameters()}
    weight = torch.randn(1, 3, 64, 64)
    grads = {}
    for flag in (True, False):
        set_use_kernels(vae, flag)
        gm = stage1.gm_forward(_config(), vae, params, x, eps)
        grads[flag] = dict(zip(params, (g.numpy() for g in torch.autograd.grad(
            (gm * weight).sum(), list(params.values())))))
    assert calls == {"fwd": 2, "bwd": 2}  # the encoder's and the decoder's mid block
    _assert_grads(grads[True], grads[False])


def test_conv_cache_refuses_a_new_tensor_at_a_freed_pointer():
    """A weight swapped in by functional_call at the storage and version of
    a freed one (what the caching allocator does to the merged LoRA weights
    of two steps) gets its own packing."""
    torch.manual_seed(1)
    conv = Conv3x3(8, 8)
    x = torch.randn(1, 6, 6, 8)
    buf = np.random.default_rng(8).standard_normal((8, 8, 3, 3)).astype(np.float32)
    outs = []
    for scale in (1.0, -2.0):
        buf *= scale  # numpy writes: the torch tensor's version stays 0
        w = torch.from_numpy(buf)
        assert w._version == 0
        with torch.no_grad():
            out = torch.func.functional_call(conv, {"weight": w, "bias": conv.bias}, (x,))
            ref = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, conv.bias, padding=1)
        outs.append(out)
        np.testing.assert_allclose(out.numpy(), ref.permute(0, 2, 3, 1).numpy(), rtol=1e-5,
                                   atol=1e-5)
        del w
    assert not torch.allclose(outs[0], outs[1])


def test_two_disc_steps_with_new_lora_factors_match_fresh_modules(s1):
    """Disc steps with two sets of LoRA factors on one VAE (its conv caches
    warm from the first) give what the second gives on a fresh VAE."""

    def factors(flip: bool):
        tr = _trainables(s1)
        if flip:
            with torch.no_grad():
                for f in tr["lora"].values():
                    f["b"].mul_(-3.0)
        return tr

    def disc_step(vae, state):
        step = stage1.make_disc_step(_config(), vae=vae, discriminator=state.discriminator,
                                     tmo_fn=tk_tmo.fix_mulog_tmo, device="cpu")
        return step(state, _batch(s1))[1]

    vae, _, disc = _modules(s1)
    state = _port_state(s1, disc, factors(False))
    disc_step(vae, state)
    state.trainables = factors(True)
    warm = disc_step(vae, state)

    vae_a, _, disc_f = _modules(s1)
    state_f = _port_state(s1, disc_f, factors(False))
    disc_step(vae_a, state_f)
    state_f.trainables = factors(True)
    fresh = disc_step(_modules(s1)[0], state_f)
    for k in ("hinge", "gp", "disc_loss"):
        _close(warm[k], fresh[k], 1e-6)
