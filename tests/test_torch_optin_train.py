"""Training with the opt-in kernels against the JAX package on the CPU, fp32.

gmdx reaches its opt-in kernels in training through its environment
toggles (``GMDX_WINOGRAD_TRAIN`` with ``GMDX_WINOGRAD_M``,
``GMDX_FUSED_ADDLN``, ``GMDX_XATTN_KERNEL``); the port through
``set_kernel_options`` and its CLIs' flags. Here, at the tiny configs:

* each differentiated form against gmdx's custom VJP, its Pallas kernel in
  interpret mode and the toggle set on the JAX side: the conv's training
  forward under ``winograd_m`` 2 and 4 (``_wino_conv``), add + LayerNorm
  (``add_layer_norm``) and the short-K attention (``cross_attention_shortk``):
  every output and gradient within 1e-5 relative L2;
* a Stage-2 step (one process, and two gloo ranks under SP), a ControlNet
  step and a Stage-1 generator + discriminator pair with all four options,
  against gmdx's step under the same toggles: the loss within 1e-5
  relative, every gradient within 1e-4 relative L2. The latents are 32^2,
  so the first level's 1024 queries take the short-K route and its convs
  F(4x4);
* each of the five CLIs parses the flags and sets them on every module it
  builds; the Stage-1 CLI's discriminator and VGG19 compute in the dtype
  ``--mixed_precision`` gives.
"""

import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from parallel_reference import assert_grads_close, jax_stage2_step  # noqa: E402
from torch_dist_ranks import Ranks  # noqa: E402
from torch_tp_ranks import train_run, train_setup  # noqa: E402

from gmdx.kernels.flash_attention import cross_attention_shortk as jax_xattn  # noqa: E402
from gmdx.kernels.geglu_ff import add_layer_norm as jax_add_layer_norm  # noqa: E402
from gmdx.kernels.winograd import _select_tiling, _wino_conv  # noqa: E402
from gmdx_torch.kernels.flash_attention import cross_attention_shortk  # noqa: E402
from gmdx_torch.kernels.geglu_ff import add_layer_norm  # noqa: E402
from gmdx_torch.kernels.winograd import conv_route  # noqa: E402
from gmdx_torch.models.layers import Conv3x3, set_kernel_options  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL = 1e-5  # each function: fp32 on both sides, sums in other orders
LOSS_RTOL = 1e-5  # a training step's loss; its gradients: assert_grads_close (1e-4)
ALL_OPTIONS = {"xattn_kernel": True, "fused_addln": True, "winograd_m": 4,
               "winograd_train": True}
TOGGLES = {"GMDX_XATTN_KERNEL": "1", "GMDX_FUSED_ADDLN": "1", "GMDX_WINOGRAD_M": "4",
           "GMDX_WINOGRAD_TRAIN": "1"}
LATENT = 32  # the first level's 1024 queries take the short-K route


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _leaves(*arrays):
    return [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]


def _jit_vjp(fn, primals, cotangent):
    """``fn``'s outputs and ``jax.vjp`` cotangents at ``primals``, as one
    jitted computation (one compile, not one for each eager operation)."""
    def outputs_and_grads(primals, cotangent):
        out, vjp = jax.vjp(fn, *primals)
        return out, vjp(cotangent)

    return jax.jit(outputs_and_grads)(jax.tree.map(jnp.asarray, tuple(primals)),
                                      jax.tree.map(jnp.asarray, cotangent))


@pytest.fixture
def toggles(monkeypatch):
    """gmdx's four toggles set, read at its next trace."""
    for k, v in TOGGLES.items():
        monkeypatch.setenv(k, v)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# each differentiated form against gmdx's custom VJP
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m", [2, 4])
def test_conv_training_forward_matches_wino_conv_vjp(monkeypatch, m):
    """``Conv3x3`` under ``winograd_train`` (the kernel forward, the direct
    conv's backward) against ``jax.vjp`` of ``_wino_conv`` with
    ``GMDX_WINOGRAD_TRAIN=1``, whose primal is the Pallas kernel of
    ``GMDX_WINOGRAD_M``."""
    monkeypatch.setenv("GMDX_WINOGRAD_TRAIN", "1")
    monkeypatch.setenv("GMDX_WINOGRAD_M", str(m))
    rng = np.random.default_rng(m)
    b, hw, c, o = 1, 16, 16, 8
    x, k_hwio, bias = _normal(rng, b, hw, hw, c), _normal(rng, 3, 3, c, o, scale=0.2), \
        _normal(rng, o, scale=0.1)
    cot = _normal(rng, b, hw, hw, o)
    tiling = _select_tiling(hw, hw, c, o, 4, 4)
    assert tiling[0] == m
    _, split, ochunks, stream, trs = tiling
    conv = lambda *a: _wino_conv(*a, split, ochunks, False, True, m, stream, trs)  # noqa: E731
    with jax.default_matmul_precision("highest"):
        want, want_grads = _jit_vjp(conv, (x, k_hwio, bias), cot)

    conv = Conv3x3(c, o)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(k_hwio.transpose(3, 2, 0, 1).copy()))
        conv.bias.copy_(torch.from_numpy(bias))
    set_kernel_options(conv, winograd_m=m, winograd_train=True)
    assert conv_route(hw, hw, c, o, m, 4) == ("wino4" if m == 4 else "conv3x3")
    (xt,) = _leaves(x)
    out = conv(xt)
    assert out.grad_fn.name().startswith("ConvKernelTrain")
    gx, gw, gb = torch.autograd.grad(out, [xt, conv.weight, conv.bias], torch.from_numpy(cot))
    assert _rel(out.detach().numpy(), want) <= REL
    for got, w in zip((gx, gw.permute(2, 3, 1, 0), gb), want_grads):
        assert _rel(got.numpy(), w) <= REL


def test_add_layer_norm_matches_add_ln_fused_vjp():
    """Both outputs and the four gradients against ``jax.vjp`` of gmdx's
    ``add_layer_norm`` on its Pallas kernel (``_add_ln_fused``), over a
    ragged 200 tokens."""
    rng = np.random.default_rng(1)
    args = [_normal(rng, 2, 100, 320), _normal(rng, 2, 100, 320),
            1.0 + _normal(rng, 320, scale=0.2), _normal(rng, 320, scale=0.2)]
    cots = [_normal(rng, 2, 100, 320), _normal(rng, 2, 100, 320)]
    want, want_grads = _jit_vjp(lambda *a: jax_add_layer_norm(*a, interpret=True), args,
                                tuple(cots))
    leaves = _leaves(*args)
    got = add_layer_norm(*leaves)
    grads = torch.autograd.grad(got, leaves, [torch.from_numpy(c) for c in cots])
    for g, w in zip([*got, *grads], [*want, *want_grads]):
        assert _rel(g.detach().numpy(), w) <= REL


@pytest.mark.parametrize("d", [40, 80])
def test_cross_attention_shortk_matches_xattn_bsc_vjp(d):
    """The output and dq, dk, dv at 77 keys against ``jax.vjp`` of gmdx's
    ``cross_attention_shortk`` (``_xattn_bsc``: the flash forward and
    backward kernels under differentiation)."""
    rng = np.random.default_rng(d)
    b, sq, sk, heads = 1, 128, 77, 2
    args = [_normal(rng, b, s, heads * d) for s in (sq, sk, sk)]
    cot = _normal(rng, b, sq, heads * d)
    with jax.default_matmul_precision("highest"):
        want, want_grads = _jit_vjp(lambda q, k, v: jax_xattn(q, k, v, heads, interpret=True),
                                    args, cot)
    leaves = _leaves(*args)
    got = cross_attention_shortk(*leaves, heads)
    assert got.grad_fn.name().startswith("FlashAttention")
    grads = torch.autograd.grad(got, leaves, torch.from_numpy(cot))
    for g, w in zip([got, *grads], [want, *want_grads]):
        assert _rel(g.detach().numpy(), w) <= REL


# ---------------------------------------------------------------------------
# the trainers' steps with all four options against gmdx's under the toggles
# ---------------------------------------------------------------------------


def _count_routes(mp, counts: dict) -> None:
    """Count the differentiated forms' forwards by route: ``conv3x3`` /
    ``wino4`` (the conv kernel's training forward), ``add_ln``,
    ``flash_k<keys>``."""
    from gmdx_torch.kernels.attention import FlashAttention
    from gmdx_torch.kernels.geglu_ff import AddLayerNorm
    from gmdx_torch.kernels.winograd import ConvKernelTrain

    for cls, key in ((ConvKernelTrain, lambda a: "wino4" if a[4] else "conv3x3"),
                     (AddLayerNorm, lambda a: "add_ln"),
                     (FlashAttention, lambda a: f"flash_k{a[1].shape[1]}")):
        def forward(ctx, *a, _orig=cls.forward, _key=key):
            counts[_key(a)] = counts.get(_key(a), 0) + 1
            return _orig(ctx, *a)

        mp.setattr(cls, "forward", staticmethod(forward))


@pytest.fixture(scope="module")
def stage2(tmp_path_factory):
    """The tiny GM UNet's Stage-2 update with all four options: two gloo
    ranks under SP, the port's one process (its differentiated routes
    counted) and gmdx's step under the toggles at the one process's draws."""
    work = tmp_path_factory.mktemp("optin_stage2")
    setup = train_setup("sp", str(work))
    rng = np.random.default_rng(11)
    shape = (2, 4, LATENT, LATENT)
    setup["batch"] = {f"{k}_latent_{s}": (rng.standard_normal(shape) if s == "mean"
                                          else rng.uniform(0.05, 0.3, shape)).astype(np.float32)
                      for k in ("sdr", "gm") for s in ("mean", "std")}
    setup["batch"]["input_ids"] = rng.integers(0, 1000, (2, 77)).astype(np.int64)
    setup["kernel_options"] = ALL_OPTIONS
    ranks = Ranks("optin_train", 2, work, setup)
    counts: dict = {}
    with pytest.MonkeyPatch.context() as mp:
        _count_routes(mp, counts)
        one = train_run(setup, None, steps=(0,))
        for k, v in TOGGLES.items():
            mp.setenv(k, v)
        jax_loss, jax_grads = jax_stage2_step(setup, one["draws"][0])
    return {"one": one, "counts": counts, "ranks": ranks.results(),
            "jax": (jax_loss, jax_grads)}


def test_stage2_step_with_options_matches_gmdx(stage2):
    """One process: the loss 1e-5 relative, every gradient 1e-4 relative
    L2 of gmdx's; F(4x4) for the convs, add + LN in each block and the flash
    kernels at the 77 keys of the first level's five cross-attentions took
    the step."""
    loss, grads = stage2["jax"]
    one = stage2["one"]
    assert abs(one["loss"][0] - loss) <= LOSS_RTOL * abs(loss)
    assert_grads_close(one["grads"], grads)
    counts = stage2["counts"]
    assert counts.get("wino4", 0) > 0 and counts.get("add_ln", 0) > 0, counts
    assert counts.get("flash_k77", 0) == 5, counts  # the 1024-query level: 2 down, 3 up


def test_stage2_step_with_options_under_sp_matches_gmdx(stage2):
    """Two gloo ranks under SP (a rank's rows: the conv kernel on its halo
    slab, add + LN on its tokens): each rank's loss and whole gradient
    against gmdx's single process, the same bars."""
    loss, grads = stage2["jax"]
    for r in stage2["ranks"]:
        assert abs(r["loss"][0] - loss) <= LOSS_RTOL * abs(loss)
        assert_grads_close(r["grads"], grads)


def _assert_step(loss, grads: dict, want_loss, want_grads: dict) -> None:
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    assert_grads_close(grads, want_grads)


def test_controlnet_step_with_options_matches_gmdx(toggles):
    """The ControlNet's loss and gradients through the frozen UNet (its up
    path differentiated with the options too) against gmdx's under the
    toggles, from weights the port's modules drew; the adapters non-zero."""
    from gmdx.models import TINY_CONTROLNET_CONFIG as J_CNET
    from gmdx.models import TINY_UNET_CONFIG as J_UNET
    from gmdx.models import ControlNetModel as JaxControlNet
    from gmdx.models import UNet2DConditionModel as JaxUNet
    from gmdx_torch.io.convert import controlnet_state_dict_from_flax
    from gmdx_torch.io.to_flax import convert_controlnet_state_dict, convert_unet_state_dict
    from gmdx_torch.models import TINY_CONTROLNET_CONFIG, TINY_UNET_CONFIG, ControlNetModel, \
        UNet2DConditionModel
    from gmdx_torch.train.controlnet import controlnet_loss

    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    unet, cnet = UNet2DConditionModel(TINY_UNET_CONFIG), ControlNetModel(TINY_CONTROLNET_CONFIG)
    with torch.no_grad():
        for n, p in cnet.named_parameters():
            if n.startswith(("controlnet_down_", "controlnet_mid", "cond_embedding.conv_out")):
                p.copy_(torch.from_numpy(_normal(rng, *p.shape, scale=0.05)))
    unet.requires_grad_(False)
    np_tree = lambda tree: jax.tree.map(lambda t: np.array(t.detach()), tree)  # noqa: E731
    unet_params = np_tree(convert_unet_state_dict(unet.state_dict()))
    cnet_params = np_tree(convert_controlnet_state_dict(cnet.state_dict()))
    b = 2
    inputs = {"noisy_latents": _normal(rng, b, 4, LATENT, LATENT),
              "timesteps": np.array([17, 903], np.int32),
              "encoder_hidden_states": _normal(rng, b, 77, 32),
              "control_image": rng.uniform(0, 1, (b, 3, 8 * LATENT, 8 * LATENT)).astype(
                  np.float32),
              "noise": _normal(rng, b, 4, LATENT, LATENT)}
    j = {k: jnp.asarray(v) for k, v in inputs.items()}
    junet, jcnet = JaxUNet(J_UNET), JaxControlNet(J_CNET)

    def jloss(params):
        downs, mid = jcnet.apply({"params": params}, j["noisy_latents"], j["timesteps"],
                                 j["encoder_hidden_states"], j["control_image"])
        pred = junet.apply({"params": unet_params}, j["noisy_latents"], j["timesteps"],
                           j["encoder_hidden_states"], down_block_additional_residuals=downs,
                           mid_block_additional_residual=mid)
        return jnp.mean((pred.astype(jnp.float32) - j["noise"]) ** 2)

    with jax.default_matmul_precision("highest"):
        want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(cnet_params)
    want = controlnet_state_dict_from_flax(jax.tree.map(np.asarray, want_grads))

    set_kernel_options(unet, **ALL_OPTIONS)
    set_kernel_options(cnet, **ALL_OPTIONS)
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    t["timesteps"] = t["timesteps"].long()
    counts: dict = {}
    with pytest.MonkeyPatch.context() as mp:
        _count_routes(mp, counts)
        loss = controlnet_loss(cnet, unet, **t)
        names = [n for n, _ in cnet.named_parameters()]
        grads = torch.autograd.grad(loss, list(cnet.parameters()))
    _assert_step(loss.detach(), {n: g.numpy() for n, g in zip(names, grads)}, want_loss, want)
    assert counts.get("wino4", 0) > 0 and counts.get("add_ln", 0) > 0, counts
    # The ControlNet's two 1024-query blocks and the UNet's three up blocks
    # there (its down path, frozen and off the gradient's way, runs the
    # inference kernels).
    assert counts.get("flash_k77", 0) == 5, counts


class _Recorder:
    """An optimizer that records the gradients and moves nothing, as the
    JAX side's ``_jax_recorder``."""

    def __init__(self, params):
        self.params, self.grads = list(params), None

    def step(self, grads, grad_norm=None):
        self.grads = [g.clone() for g in grads]


def _jax_recorder() -> optax.GradientTransformation:
    """Zero updates; the state is the last gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree.map(jnp.zeros_like, grads), grads),
    )


def test_stage1_pair_with_options_matches_gmdx(toggles):
    """A generator step (the merged LoRA weights swapped into the VAE reach
    the conv's training forward) and a discriminator step, at 16^2 with the
    VAE's options all on, against gmdx's under the toggles: every loss part
    1e-5 relative, every LoRA, ``conv_out`` and discriminator gradient 1e-4
    relative L2. The weights are drawn by the port's modules."""
    from gmdx.io.torch_import import convert_vgg19_state_dict
    from gmdx.models import TINY_VAE_CONFIG as J_VAE
    from gmdx.models import AutoencoderKL as JaxVAE
    from gmdx.models.discriminator import Discriminator as JaxDiscriminator
    from gmdx.models.lora import LoRAConfig as JaxLoRAConfig
    from gmdx.models.vgg import VGG19Features as JaxVGG
    from gmdx.ops import tmo as jax_tmo
    from gmdx.train import stage1 as jax_stage1
    from gmdx_torch.io.convert import (
        discriminator_flax_from_state_dict, discriminator_state_dict_from_flax, lora_from_flax,
        stage1_trainables_from_flax,
    )
    from gmdx_torch.io.to_flax import convert_vae_state_dict
    from gmdx_torch.models import TINY_VAE_CONFIG, AutoencoderKL, Discriminator, VGG19Features
    from gmdx_torch.models.lora import LoRAConfig
    from gmdx_torch.ops import fix_mulog_tmo
    from gmdx_torch.train import stage1

    side, vgg_res = 16, 32  # the VAE's convs: F(4x4) at 16^2, the conv kernel at 8^2
    torch.manual_seed(0)
    vae, vgg = AutoencoderKL(TINY_VAE_CONFIG), VGG19Features()
    disc = Discriminator(depth=3, hidden_channels=32)
    def flax(convert, module):
        sd = {k: v.detach().numpy().copy() for k, v in module.state_dict().items()}
        return jax.tree.map(np.asarray, convert(sd))

    def sn_keys(tree, pre=""):  # flax keys a spectral norm's u / sigma "conv_0/kernel/u"
        return {k: v for n, t in tree.items() for k, v in (
            sn_keys(t, f"{pre}{n}/").items() if isinstance(t, dict) else [(pre + n, t)])}

    vae_params = flax(convert_vae_state_dict, vae)
    vgg_params = flax(convert_vgg19_state_dict, vgg)
    disc_vars = flax(discriminator_flax_from_state_dict, disc)
    disc_vars["batch_stats"] = {n: sn_keys(t) for n, t in disc_vars["batch_stats"].items()}
    jcfg = jax_stage1.Stage1Config(lora=JaxLoRAConfig(rank=2, alpha=2.0), vgg_resolution=vgg_res)
    # gmdx's trainables tree, its factors drawn here (b non-zero, so that the
    # a factors take gradient too); eval_shape compiles nothing.
    rng = np.random.default_rng(5)
    shapes = jax.eval_shape(lambda: jax_stage1.init_trainables(jax.random.key(4), vae_params,
                                                               jcfg))
    trainables = jax.tree.map(lambda t: _normal(rng, *t.shape, scale=0.1), shapes)
    batch = {"pixel_values": rng.uniform(-1, 1, (2, 3, side, side)).astype(np.float32),
             "miss_pixel_values": rng.uniform(-1, 1, (2, 3, side, side)).astype(np.float32),
             "encode_eps": _normal(rng, 2, 4, side // 2, side // 2)}
    rec = _jax_recorder()
    stats = {k: v for k, v in disc_vars.items() if k != "params"}
    jstate = jax_stage1.Stage1State(
        trainables=trainables, disc_params=disc_vars["params"], disc_vars=stats,
        opt_state=rec.init(trainables), disc_opt_state=rec.init(disc_vars["params"]), ema=None,
        step=jnp.zeros((), jnp.int32))
    frozen = {"vae": vae_params, "vgg": vgg_params}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jvae, jdisc = JaxVAE(J_VAE), JaxDiscriminator(depth=3, hidden_channels=32)
    with jax.default_matmul_precision("highest"):
        g_state, g_metrics = jax_stage1.make_gen_step(
            jcfg, vae=jvae, discriminator=jdisc, vgg=JaxVGG(), tmo_fn=jax_tmo.fix_mulog_tmo,
            optimizer=rec, donate=False)(jstate, frozen, jbatch, jax.random.key(0))
        d_state, d_metrics = jax_stage1.make_disc_step(
            jcfg, vae=jvae, discriminator=jdisc, tmo_fn=jax_tmo.fix_mulog_tmo, optimizer=rec,
            donate=False)(jstate, frozen, jbatch, jax.random.key(0))

    set_kernel_options(vae, **ALL_OPTIONS)
    cfg = stage1.Stage1Config(lora=LoRAConfig(rank=2, alpha=2.0), vgg_resolution=vgg_res)
    t = {k: torch.from_numpy(v) for k, v in batch.items()}

    def port_state():
        tr = stage1_trainables_from_flax(trainables)
        tr = {"lora": {n: dict(zip(f, _leaves(*f.values()))) for n, f in tr["lora"].items()},
              "conv_out": dict(zip(tr["conv_out"], _leaves(*tr["conv_out"].values())))}
        d = Discriminator(depth=3, hidden_channels=32)
        d.load_state_dict(disc.state_dict())
        return stage1.init_state(cfg, tr, d, (_Recorder(stage1.trainable_list(tr)),
                                              _Recorder(d.parameters())))

    counts: dict = {}
    with pytest.MonkeyPatch.context() as mp:
        _count_routes(mp, counts)
        gen = stage1.make_gen_step(cfg, vae=vae, discriminator=disc, vgg=vgg,
                                   tmo_fn=fix_mulog_tmo, device="cpu")
        gs, gm = gen(port_state(), t)
    assert counts.get("wino4", 0) > 0 and counts.get("conv3x3", 0) > 0, counts
    disc_step = stage1.make_disc_step(cfg, vae=vae, discriminator=disc, tmo_fn=fix_mulog_tmo,
                                      device="cpu")
    ds, dm = disc_step(port_state(), t)

    jm = jax.tree.map(np.asarray, g_metrics)
    for k in ("recon", "perceptual", "adversarial", "adaptive_weight", "gen_loss"):
        assert abs(float(gm[k]) - float(jm[k])) <= LOSS_RTOL * abs(float(jm[k])), k
    names = sorted(lora_from_flax(trainables["lora"]))
    got = {f"{n}.{ab}": gs.optimizer.grads[2 * i + j].numpy()
           for i, n in enumerate(names) for j, ab in enumerate("ab")}
    got.update({"conv_out.weight": gs.optimizer.grads[-2].numpy(),
                "conv_out.bias": gs.optimizer.grads[-1].numpy()})
    jg = jax.tree.map(np.asarray, g_state.opt_state)
    want = {f"{n}.{k}": v for n, f in lora_from_flax(jg["lora"]).items() for k, v in f.items()}
    want.update({"conv_out.weight": np.ascontiguousarray(
        jg["conv_out"]["kernel"].transpose(3, 2, 0, 1)), "conv_out.bias": jg["conv_out"]["bias"]})
    assert_grads_close(got, want)

    jm = jax.tree.map(np.asarray, d_metrics)
    for k in ("hinge", "gp", "disc_loss"):
        assert abs(float(dm[k]) - float(jm[k])) <= LOSS_RTOL * abs(float(jm[k])), k
    dnames = [n for n, _ in ds.discriminator.named_parameters()]
    assert_grads_close(dict(zip(dnames, (g.numpy() for g in ds.disc_optimizer.grads))),
                       discriminator_state_dict_from_flax(
                           jax.tree.map(np.asarray, d_state.disc_opt_state), {}))


# ---------------------------------------------------------------------------
# the CLIs' flags
# ---------------------------------------------------------------------------


def _script(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"torch_cli_{name}", os.path.join(REPO, "scripts", "torch", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Built(Exception):
    """The spy's stop: the CLI has built its modules and set the options."""


@pytest.fixture(scope="module")
def tiny_pipe(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("optin_cli") / "pipe")
    _script("init_pipeline").main(["--output_dir", out, "--size", "tiny", "--dual",
                                   "--device", "cpu"])
    return out


# Each CLI's required flags and the modules it builds before its first step.
_CLIS = {
    "generate_hdr": (["--unet_ckpt", "{pipe}/gm_unet", "--sdr_input_path", "{pipe}"],
                     ["AutoencoderKL", "CLIPTextModel", "UNet2DConditionModel"]),
    "upconvert_hdrtv": (["--sdr_input_path", "{pipe}"],
                        ["AutoencoderKL", "CLIPTextModel", "ControlNetModel",
                         "UNet2DConditionModel", "UNet2DConditionModel"]),
    "train_gm_unet": (["--train_metadata", "{pipe}/none.parquet", "--output_dir", "{out}"],
                      ["AutoencoderKL", "CLIPTextModel", "UNet2DConditionModel"]),
    "train_controlnet": (["--train_metadata", "{pipe}/none.parquet", "--output_dir", "{out}"],
                         ["AutoencoderKL", "CLIPTextModel", "ControlNetModel",
                          "UNet2DConditionModel"]),
    "train_vqgan_lora": (["--train_metadata", "{pipe}/none.parquet", "--output_dir", "{out}"],
                         ["AutoencoderKL"]),
}
_TRAINERS = ("train_gm_unet", "train_controlnet", "train_vqgan_lora")


def _argv(name, pipe, out, *flags):
    extra = [a.format(pipe=pipe, out=out) for a in _CLIS[name][0]]
    return ["--pretrained_model_name_or_path", pipe, *extra, *flags, "--device", "cpu"]


@pytest.mark.parametrize("name", sorted(_CLIS))
def test_cli_takes_the_kernel_flags(name, tiny_pipe, tmp_path, capsys):
    """The flags parse to ``set_kernel_options``' arguments, default to
    gmdx's defaults, and their help names the toggles they stand for."""
    from gmdx_torch.kernel_flags import kernel_options

    mod = _script(name)
    train = name in _TRAINERS
    args = mod.parse_args(_argv(name, tiny_pipe, str(tmp_path)))
    assert kernel_options(args) == {"xattn_kernel": False, "fused_addln": False,
                                    "winograd_m": 2, "winograd_train": False}
    flags = ["--xattn_kernel", "--fused_addln", "--winograd_m", "4"]
    args = mod.parse_args(_argv(name, tiny_pipe, str(tmp_path), *flags,
                                *(["--winograd_train"] if train else [])))
    assert kernel_options(args) == {**ALL_OPTIONS, "winograd_train": train}
    with pytest.raises(SystemExit):
        mod.parse_args(["--help"])
    help_text = " ".join(capsys.readouterr().out.split())
    toggles = [t for t in TOGGLES if train or t != "GMDX_WINOGRAD_TRAIN"]
    assert all(f"{t}=" in help_text or f"{t}," in help_text for t in toggles), help_text
    if not train:
        with pytest.raises(SystemExit):
            mod.parse_args(_argv(name, tiny_pipe, str(tmp_path), "--winograd_train"))


@pytest.mark.parametrize("name", sorted(_CLIS))
def test_cli_sets_the_options_on_every_module(name, tiny_pipe, tmp_path, monkeypatch):
    """Run up to the options: every module the CLI has built by then carries
    them, in every layer that takes one."""
    import gmdx_torch.kernel_flags as kf

    real, seen = kf.apply_kernel_flags, []

    def spy(args, *modules):
        real(args, *modules)
        seen.extend(modules)
        raise _Built

    monkeypatch.setattr(kf, "apply_kernel_flags", spy)
    train = name in _TRAINERS
    flags = ["--xattn_kernel", "--fused_addln", "--winograd_m", "4",
             *(["--winograd_train"] if train else [])]
    with pytest.raises(_Built):
        _script(name).main(_argv(name, tiny_pipe, str(tmp_path / "out"), *flags))
    assert sorted(type(m).__name__ for m in seen) == _CLIS[name][1]
    want = {**ALL_OPTIONS, "winograd_train": train}
    took = 0
    for m in seen:
        for sub in m.modules():
            for k, v in want.items():
                if hasattr(sub, k):
                    assert getattr(sub, k) == v, (type(m).__name__, k)
                    took += 1
    assert took > 0


@pytest.mark.parametrize("mixed_precision,dtype", [
    (None, torch.float32), ("no", torch.float32), ("bf16", torch.bfloat16),
    ("fp16", torch.float16)])
def test_stage1_cli_gan_models_follow_mixed_precision(mixed_precision, dtype):
    """The discriminator and VGG19 compute in the dtype ``--mixed_precision``
    gives (``scripts/stage1/train_vqgan_lora.py:263-282``), their
    parameters float32."""
    import argparse

    disc, vgg = _script("train_vqgan_lora").build_gan_models(
        argparse.Namespace(mixed_precision=mixed_precision, seed=0), "cpu")
    for m in (disc, vgg):
        assert m.compute_dtype == dtype
        assert all(p.dtype == torch.float32 for p in m.parameters())
