"""gmdx_torch's opt-in kernels against the JAX package on the CPU.

The four kernels the JAX package reaches only through opt-ins (short-K
cross-attention under GMDX_XATTN_KERNEL=1, fused add + LayerNorm under
GMDX_FUSED_ADDLN=1, Winograd F(4x4) under GMDX_WINOGRAD_M=4, and the LN-free
GEGLU FF): each plain version, which a gmdx_torch wrapper runs for a CPU
tensor, against its Pallas kernel in interpret mode (fp32, matmul precision
highest); the port's routes against the JAX dispatch itself at every SD-1.5
shape of the 512^2 and 1024^2 paths; and the modules that take the options
against the JAX modules. The hand-written kernels are held to the plain
versions on the card by tests/test_torch_card.py.
"""

import importlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import gmdx.kernels.attention as jax_attention
from gmdx.kernels.flash_attention import cross_attention_shortk as jax_xattn
from gmdx.kernels.geglu_ff import add_layer_norm as jax_add_layer_norm
from gmdx.kernels.geglu_ff import geglu_ff as jax_geglu_ff
from gmdx.kernels.winograd import _conv3x3_reference, _select_tiling, _wino_conv
from gmdx_torch.io.convert import _flatten, _transformer2d
from gmdx_torch.kernels.attention import attention_route
from gmdx_torch.kernels.flash_attention import cross_attention_shortk
from gmdx_torch.kernels.geglu_ff import add_layer_norm, geglu_ff
from gmdx_torch.kernels.winograd import (
    conv_route,
    pack_weight4,
    winograd4_conv3x3,
    winograd4_conv3x3_plain,
)
from gmdx_torch.models.layers import GEGLUFeedForward, Transformer2D, set_kernel_options

REL = 1e-5  # fp32 on both sides, sums in other orders
# The module (gmdx.kernels re-exports a function of the same name).
jax_flash = importlib.import_module("gmdx.kernels.flash_attention")


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------------------
# each plain version against its Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [40, 16])
def test_cross_attention_shortk_plain_matches_pallas(d):
    rng = np.random.default_rng(0)
    b, sq, sk, heads = 2, 256, 77, 2
    q, k, v = (_normal(rng, b, s, heads * d) for s in (sq, sk, sk))
    with jax.default_matmul_precision("highest"):
        want = jax_xattn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads, interpret=True)
    assert want is not None
    got = cross_attention_shortk(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                 heads)
    assert _rel(got.numpy(), want) <= REL


def test_add_layer_norm_plain_matches_pallas():
    """C 320 over a ragged 200 tokens (the kernel pads to its block)."""
    rng = np.random.default_rng(1)
    x, y = _normal(rng, 2, 100, 320), _normal(rng, 2, 100, 320)
    gamma, beta = 1.0 + _normal(rng, 320, scale=0.2), _normal(rng, 320, scale=0.2)
    want = jax_add_layer_norm(*(jnp.asarray(a) for a in (x, y, gamma, beta)), interpret=True)
    got = add_layer_norm(*(torch.from_numpy(a) for a in (x, y, gamma, beta)))
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w) <= REL


def test_geglu_ff_plain_matches_pallas():
    """C 320 over a ragged 200 tokens; the kernel's A&S erf is 1.5e-7 off."""
    rng = np.random.default_rng(2)
    dim, inner = 320, 1280
    x, res = _normal(rng, 2, 100, dim), _normal(rng, 2, 100, dim)
    w1, b1 = _normal(rng, dim, 2 * inner, scale=dim**-0.5), _normal(rng, 2 * inner, scale=0.1)
    w2, b2 = _normal(rng, inner, dim, scale=inner**-0.5), _normal(rng, dim, scale=0.1)
    with jax.default_matmul_precision("highest"):
        want = jax_geglu_ff(*(jnp.asarray(a) for a in (x, res, w1, b1, w2, b2)), interpret=True)
    t = torch.from_numpy
    got = geglu_ff(t(x), t(res), t(w1.T.copy()), t(b1), t(w2.T.copy()), t(b2))
    assert _rel(got.numpy(), want) <= REL


def _wino_operands(rng, b, hw, c, o):
    x = _normal(rng, b, hw, hw, c)
    k_hwio = _normal(rng, 3, 3, c, o, scale=0.1)
    bias = _normal(rng, o, scale=0.1)
    return x, k_hwio, bias


def _oihw(k_hwio):
    return torch.from_numpy(np.ascontiguousarray(k_hwio.transpose(3, 2, 0, 1)))


# The shapes of tests/test_kernels.py:TestWinograd4Conv3x3, raw and pre-padded.
@pytest.mark.parametrize("pre_padded", [False, True], ids=["raw", "pre_padded"])
@pytest.mark.parametrize("b,hw,c,o", [(2, 16, 32, 16), (1, 32, 64, 32), (2, 16, 40, 24)])
def test_winograd4_plain_matches_pallas(b, hw, c, o, pre_padded):
    rng = np.random.default_rng(3)
    x, k_hwio, bias = _wino_operands(rng, b, hw, c, o)
    xin = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0))) if pre_padded else x
    with jax.default_matmul_precision("highest"):
        want = _wino_conv(jnp.asarray(xin), jnp.asarray(k_hwio), jnp.asarray(bias), 1, 1,
                          pre_padded, True, 4)
        direct = _conv3x3_reference(jnp.asarray(x), jnp.asarray(k_hwio), jnp.asarray(bias))
    u = pack_weight4(_oihw(k_hwio), torch.float32)
    got = winograd4_conv3x3(torch.from_numpy(xin), u, torch.from_numpy(bias),
                            pre_padded=pre_padded)
    assert conv_route(hw, hw, c, o, 4) == "wino4"
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(direct), rtol=2e-4, atol=2e-4)


def test_winograd4_bf16_rounds_where_the_pallas_kernel_does():
    """bf16 input, fp32 weight (the JAX kernel's param dtype): U and V are
    rounded to bf16 at the same points, so the port's plain version lands
    within bf16 output rounding of the Pallas kernel, while the F(4x4)
    arithmetic itself is an order of magnitude further from the fp32 conv."""
    rng = np.random.default_rng(4)
    x, k_hwio, bias = _wino_operands(rng, 1, 32, 64, 32)
    x16 = jnp.asarray(x).astype(jnp.bfloat16)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(_wino_conv(x16, jnp.asarray(k_hwio), jnp.asarray(bias), 1, 1, False,
                                     True, 4).astype(jnp.float32))
        ref = np.asarray(_conv3x3_reference(jnp.asarray(x), jnp.asarray(k_hwio),
                                            jnp.asarray(bias)))
    xt = torch.from_numpy(np.array(x16.astype(jnp.float32))).to(torch.bfloat16)
    got = winograd4_conv3x3_plain(xt, pack_weight4(_oihw(k_hwio), torch.bfloat16),
                                  torch.from_numpy(bias)).float().numpy()
    unrounded = winograd4_conv3x3_plain(xt.float(), pack_weight4(_oihw(k_hwio), torch.float32),
                                        torch.from_numpy(bias)).numpy()
    algo = _rel(want, ref)
    assert 5e-3 < algo < 5e-2, algo
    assert _rel(got, want) < algo / 10
    assert _rel(unrounded, want) > algo / 2


# ---------------------------------------------------------------------------
# the routes against the JAX dispatch
# ---------------------------------------------------------------------------

# SD-1.5 attention calls of the 512^2 and 1024^2 paths: (queries, keys,
# head dim); cross-attention has the 77 CLIP keys.
_UNET_LEVELS = [(4096, 40), (1024, 80), (256, 160), (64, 160),  # 512^2
                (16384, 40), (4096, 80), (1024, 160), (256, 160)]  # 1024^2
_ATTN_SHAPES = sorted({(s, s, d) for s, d in _UNET_LEVELS} | {(s, 77, d) for s, d in _UNET_LEVELS})


def _jax_packed_route(monkeypatch, sq, sk, d, xattn):
    """The route the JAX package's head-packed dispatch takes on a TPU, read
    by running it with each kernel and the XLA fallback replaced by a
    recorder."""
    taken = []

    def recorder(name):
        def fn(q, *a, **kw):
            taken.append(name)
            return jnp.zeros(q.shape, q.dtype)
        return fn

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setenv("GMDX_XATTN_KERNEL", "1" if xattn else "0")
    monkeypatch.setattr(jax_flash, "attention_kv_resident", recorder("kv_resident"))
    monkeypatch.setattr(jax_flash, "flash_attention_bsc", recorder("flash_bsc"))
    monkeypatch.setattr(jax_flash, "cross_attention_shortk", recorder("xattn_shortk"))
    monkeypatch.setattr(jax_attention, "dot_product_attention", recorder("plain"))
    heads = 8
    q = jnp.zeros((1, sq, heads * d), jnp.bfloat16)
    k = jnp.zeros((1, sk, heads * d), jnp.bfloat16)
    jax_attention.attention_packed(q, k, k, heads)
    assert len(taken) == 1, taken
    return taken[0]


@pytest.mark.parametrize("xattn", [False, True], ids=["default", "xattn_kernel"])
def test_attention_route_matches_jax_dispatch(monkeypatch, xattn):
    for sq, sk, d in _ATTN_SHAPES:
        want = _jax_packed_route(monkeypatch, sq, sk, d, xattn)
        got = attention_route(sk, d, sq=sq, xattn_kernel=xattn)
        assert got == want, (sq, sk, d, xattn, got, want)
    # The 77-key cross-attention of the two widest 512^2 levels takes the
    # short-K kernel only when opted in: 10 calls per UNet forward.
    assert (attention_route(77, 40, sq=4096, xattn_kernel=xattn) == "xattn_shortk") == xattn


# SD-1.5 3x3 resnet convs (square side, C, O) of the 512^2 and 1024^2 paths:
# the UNet's four levels with their up-block concats, and the VAE's levels.
_UNET_CONVS = [(320, 320), (320, 640), (640, 640), (640, 1280), (1280, 1280), (2560, 1280),
               (1920, 1280), (1920, 640), (1280, 640), (960, 640), (960, 320), (640, 320)]
_VAE_CONVS = [(128, 128), (128, 256), (256, 256), (256, 512), (512, 512), (512, 256),
              (256, 128)]
_CONV_SHAPES = sorted(
    {(h, c, o) for base in (64, 128) for h in (base, base // 2, base // 4, base // 8)
     for c, o in _UNET_CONVS}
    | {(h, c, o) for base in (512, 1024) for h in (base, base // 2, base // 4, base // 8)
       for c, o in _VAE_CONVS}
)


@pytest.mark.parametrize("m", [2, 4])
def test_conv_route_matches_jax_rule(monkeypatch, m):
    """The port takes F(4x4) exactly where the JAX package does: its shape
    gate, then ``_select_tiling`` with the TPU's tiling budget
    (``_pick_tiling4``), at bf16 and fp32 activations."""
    monkeypatch.setenv("GMDX_WINOGRAD_M", str(m))
    for itemsize in (2, 4):
        for h, c, o in _CONV_SHAPES:
            # winograd_conv3x3's shape gate, then the tiling choice.
            jax_m = (_select_tiling(h, h, c, o, itemsize, itemsize)[0]
                     if h % 2 == 0 and h >= 16 else 0)
            got = conv_route(h, h, c, o, m, itemsize)
            assert (got == "wino4") == (jax_m == 4), (h, c, o, itemsize)


# ---------------------------------------------------------------------------
# the modules that take the options against the JAX modules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim", [32, 320], ids=["reference_route", "kernel_route"])
@pytest.mark.parametrize("with_residual", [True, False])
def test_geglu_feedforward_residual_branch_matches_jax(dim, with_residual):
    """GEGLUFeedForward without LayerNorm parameters: the JAX module's
    ``residual=`` branch (dims 320/640 take the kernel's plain version on the
    CPU, other dims the reference)."""
    from gmdx.models.layers import GEGLUFeedForward as JaxFF

    rng = np.random.default_rng(5)
    x, res = _normal(rng, 2, 24, dim), _normal(rng, 2, 24, dim)
    j_ff = JaxFF(dim)
    params = jax.tree.map(np.array, j_ff.init(jax.random.key(0), jnp.asarray(x))["params"])
    with jax.default_matmul_precision("highest"):
        want = j_ff.apply({"params": params}, jnp.asarray(x),
                          residual=jnp.asarray(res) if with_residual else None)
    ff = GEGLUFeedForward(dim)
    t = torch.from_numpy
    with torch.no_grad():
        ff.net[0].proj.weight.copy_(t(params["proj_in"]["kernel"].T.copy()))
        ff.net[0].proj.bias.copy_(t(params["proj_in"]["bias"]))
        ff.net[2].weight.copy_(t(params["proj_out"]["kernel"].T.copy()))
        ff.net[2].bias.copy_(t(params["proj_out"]["bias"]))
        got = ff(t(x), residual=t(res) if with_residual else None)
    assert _rel(got.numpy(), want) <= REL


@pytest.mark.parametrize("options", [
    {"fused_addln": True},
    {"fused_addln": True, "xattn_kernel": True, "winograd_m": 4},
], ids=["fused_addln", "all_options"])
def test_transformer_with_options_matches_jax(monkeypatch, options):
    """A Transformer2D over a 32x32 grid (1024 queries, so the short-K
    route takes its 77 keys) against the JAX module traced with the matching
    environment toggles (off the TPU its dispatch takes the jnp references)."""
    from gmdx.models.layers import Transformer2D as JaxTransformer

    monkeypatch.setenv("GMDX_FUSED_ADDLN", "1")
    monkeypatch.setenv("GMDX_XATTN_KERNEL", "1" if options.get("xattn_kernel") else "0")
    rng = np.random.default_rng(6)
    c, heads, hd = 32, 2, 16
    x, ctx = _normal(rng, 1, 32, 32, c), _normal(rng, 1, 77, 32)
    j_mod = JaxTransformer(c, heads, hd, 32)
    params = j_mod.init(jax.random.key(1), jnp.asarray(x), jnp.asarray(ctx))["params"]
    with jax.default_matmul_precision("highest"):
        want = j_mod.apply({"params": params}, jnp.asarray(x), jnp.asarray(ctx))
    mod = Transformer2D(c, heads, hd, 32)
    sd = dict(_transformer2d(k, v, "t") for k, v in _flatten(params).items())
    mod.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    set_kernel_options(mod, **options)
    assert mod.transformer_blocks[0].fused_addln
    assert mod.transformer_blocks[0].attn2.xattn_kernel == bool(options.get("xattn_kernel"))
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(ctx))
    assert _rel(got.numpy(), want) <= REL


def test_opt_in_kernels_refuse_autograd():
    """The three opt-in wrappers differentiate under autograd, each against
    autograd through its plain counterpart (fp32 on the CPU): the short-K
    attention through FlashAttention, add + LayerNorm through its recomputed
    backward (both outputs), F(4x4) through the direct conv's backward. What
    they still refuse: F(4x4) under autograd without the OIHW weight its U
    was made from, and a winograd_m other than 2 or 4."""
    from gmdx_torch.kernels.attention import attention_kv_resident_plain
    from gmdx_torch.kernels.geglu_ff import add_layer_norm_plain
    from gmdx_torch.kernels.winograd import conv3x3_direct

    rng = np.random.default_rng(7)

    def leaves(*shapes):
        return [torch.from_numpy(_normal(rng, *s)).requires_grad_() for s in shapes]

    def check(fn, ref, args, n_out=1):
        outs, refs = fn(*args), ref(*args)
        outs, refs = (outs, refs) if n_out > 1 else ((outs,), (refs,))
        cots = [torch.from_numpy(_normal(rng, *o.shape)) for o in refs]
        for o, r in zip(outs, refs):
            assert _rel(o.detach().numpy(), r.detach().numpy()) <= REL
        got = torch.autograd.grad(outs, args, cots)
        want = torch.autograd.grad(refs, args, cots)
        for g, w in zip(got, want):
            assert _rel(g.numpy(), w.numpy()) <= REL

    check(lambda q, k, v: cross_attention_shortk(q, k, v, 2),
          lambda q, k, v: attention_kv_resident_plain(q, k, v, 2),
          leaves((1, 16, 16), (1, 8, 16), (1, 8, 16)))
    check(add_layer_norm, add_layer_norm_plain, leaves((1, 4, 16), (1, 4, 16), (16,), (16,)),
          n_out=2)
    x, w, bias = leaves((1, 16, 16, 8), (8, 8, 3, 3), (8,))
    u = pack_weight4(w, torch.float32)
    check(lambda x_, w_, b_: winograd4_conv3x3(x_, u, b_, weight=w_),
          lambda x_, w_, b_: conv3x3_direct(x_, w_, b_), [x, w, bias])
    with pytest.raises(ValueError, match="weight="):
        winograd4_conv3x3(x, u, bias)
    with pytest.raises(ValueError, match="winograd_m"):
        set_kernel_options(torch.nn.Linear(2, 2), winograd_m=3)


def test_geglu_ff_autograd_matches_plain_gradients():
    """GegluFF's recomputed backward against autograd through the plain
    version (fp32 on the CPU: the same function)."""
    from gmdx_torch.kernels.geglu_ff import GegluFF, geglu_ff_plain

    rng = np.random.default_rng(8)
    args = [torch.from_numpy(a).requires_grad_() for a in (
        _normal(rng, 2, 8, 32), _normal(rng, 2, 8, 32), _normal(rng, 256, 32, scale=0.2),
        _normal(rng, 256, scale=0.1), _normal(rng, 32, 128, scale=0.1), _normal(rng, 32))]
    cot = torch.from_numpy(_normal(rng, 2, 8, 32))
    got = torch.autograd.grad(GegluFF.apply(*args), args, cot)
    want = torch.autograd.grad(geglu_ff_plain(*args), args, cot)
    for g, w in zip(got, want):
        assert _rel(g.numpy(), w.numpy()) <= REL


def test_options_default_to_the_jax_defaults():
    mod = Transformer2D(32, 2, 16, 32)
    block = mod.transformer_blocks[0]
    assert not block.fused_addln and not block.attn1.xattn_kernel
    set_kernel_options(mod, xattn_kernel=True, fused_addln=True)
    set_kernel_options(mod)
    assert not block.fused_addln and not block.attn2.xattn_kernel
