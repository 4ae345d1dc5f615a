"""gmdx_torch kernels' plain versions against the JAX package's Pallas kernels.

On the CPU every gmdx_torch kernel wrapper runs its plain PyTorch version;
these tests hold that version to the JAX kernel run in Pallas interpret mode
on the same numpy inputs, in fp32 with matmul precision pinned to highest
(max-abs <= 1e-4). The hand-written kernels are held to the plain versions
on the card by tests/test_torch_card.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gmdx.kernels.flash_attention import attention_kv_resident as jax_attention_kv_resident
from gmdx.kernels.geglu_ff import geglu_ff_ln as jax_geglu_ff_ln
from gmdx.kernels.groupnorm import fused_group_norm_silu, parity_gn_pad_silu
from gmdx.kernels.winograd import nhwc_to_parity5, parity5_to_nhwc, winograd_conv3x3
from gmdx_torch.kernels import attention as tk_attention
from gmdx_torch.kernels.geglu_ff import geglu_ff_ln
from gmdx_torch.kernels.groupnorm import group_norm_silu
from gmdx_torch.kernels.winograd import conv3x3, pack_weight

TOL = 1e-4  # fp32 on both sides; the sums run in different orders


def _rng(seed):
    return np.random.default_rng(seed)


def _normal(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("sk", [256, 77])
def test_attention_matches_jax(sk):
    """Sk=256 takes the KV-resident kernel (held to the Pallas kernel in
    interpret mode); Sk=77 the plain einsum path (held to the JAX package's
    dispatch, which takes XLA there)."""
    from gmdx.kernels.attention import attention_packed as jax_attention_packed

    rng = _rng(0)
    b, sq, heads, d = 2, 256, 2, 40
    q = _normal(rng, b, sq, heads * d)
    k = _normal(rng, b, sk, heads * d)
    v = _normal(rng, b, sk, heads * d)
    with jax.default_matmul_precision("highest"):
        if sk >= 256:
            want = jax_attention_kv_resident(
                jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads, interpret=True
            )
            assert want is not None
        else:
            want = jax_attention_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads)
    assert tk_attention.uses_kernel(sk, d) == (sk >= 256)
    got = tk_attention.attention_packed(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), heads
    )
    assert _max_abs(got.numpy(), want) <= TOL


@pytest.mark.parametrize("pre_padded", [False, True])
def test_conv3x3_matches_winograd(pre_padded):
    rng = _rng(1)
    x = _normal(rng, 2, 16, 16, 32)
    k_hwio = _normal(rng, 3, 3, 32, 32, scale=0.1)
    bias = _normal(rng, 32, scale=0.1)
    xin = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0))) if pre_padded else x
    with jax.default_matmul_precision("highest"):
        want = winograd_conv3x3(
            jnp.asarray(xin), jnp.asarray(k_hwio), jnp.asarray(bias),
            pre_padded=pre_padded, interpret=True,
        )
    assert want is not None
    w_oihw = torch.from_numpy(np.ascontiguousarray(np.transpose(k_hwio, (3, 2, 0, 1))))
    got = conv3x3(
        torch.from_numpy(xin), pack_weight(w_oihw), torch.from_numpy(bias),
        pre_padded=pre_padded,
    )
    assert got.shape == (2, 16, 16, 32)
    assert _max_abs(got.numpy(), want) <= TOL


@pytest.mark.parametrize("activate", [True, False])
def test_group_norm_matches_fused_kernel(activate):
    rng = _rng(2)
    x = _normal(rng, 2, 16, 16, 64, scale=2.0) + 0.5
    scale = 1.0 + _normal(rng, 64, scale=0.2)
    bias = _normal(rng, 64, scale=0.2)
    want = fused_group_norm_silu(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), num_groups=32,
        eps=1e-5, activate=activate, interpret=True, pad_output=True,
    )
    got = group_norm_silu(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
        eps=1e-5, activate=activate, pad_output=True,
    )
    assert got.shape == (2, 18, 18, 64)
    assert _max_abs(got.numpy(), want) <= TOL


def test_group_norm_temb_matches_parity_kernel():
    """The temb pre-add variant against parity_gn_pad_silu, converted to and
    from the parity layout outside the kernel."""
    rng = _rng(3)
    x = _normal(rng, 2, 16, 16, 64)
    scale = 1.0 + _normal(rng, 64, scale=0.2)
    bias = _normal(rng, 64, scale=0.2)
    temb = _normal(rng, 2, 64)
    out5 = parity_gn_pad_silu(
        nhwc_to_parity5(jnp.asarray(x)), jnp.asarray(scale), jnp.asarray(bias),
        jnp.asarray(temb), num_groups=32, eps=1e-5, activate=True, interpret=True,
    )
    assert out5 is not None
    want = parity5_to_nhwc(out5)
    got = group_norm_silu(
        torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(bias),
        torch.from_numpy(temb), eps=1e-5, activate=True, pad_output=True,
    )
    assert _max_abs(got.numpy(), want) <= TOL


def test_geglu_ff_ln_matches_kernel():
    rng = _rng(4)
    dim, inner = 320, 1280
    x = _normal(rng, 2, 64, dim)
    a = _normal(rng, 2, 64, dim)
    gamma = 1.0 + _normal(rng, dim, scale=0.2)
    beta = _normal(rng, dim, scale=0.2)
    w1 = _normal(rng, dim, 2 * inner, scale=dim**-0.5)  # flax (in, out)
    b1 = _normal(rng, 2 * inner, scale=0.1)
    w2 = _normal(rng, inner, dim, scale=inner**-0.5)
    b2 = _normal(rng, dim, scale=0.1)
    with jax.default_matmul_precision("highest"):
        want = jax_geglu_ff_ln(
            *(jnp.asarray(t) for t in (x, gamma, beta, w1, b1, w2, b2)),
            add=jnp.asarray(a), eps=1e-5, interpret=True,
        )
    t = torch.from_numpy
    got = geglu_ff_ln(
        t(x), t(a), t(gamma), t(beta), t(np.ascontiguousarray(w1.T)), t(b1),
        t(np.ascontiguousarray(w2.T)), t(b2), eps=1e-5,
    )
    assert _max_abs(got.numpy(), want) <= TOL


# ---------------------------------------------------------------------------
# The training kernels' plain versions and the differentiated routes
# ---------------------------------------------------------------------------


def _flat(x, heads):
    """(B, S, H*D) numpy -> the JAX kernels' (B*H, S, D)."""
    b, s, c = x.shape
    return jnp.asarray(x.reshape(b, s, heads, c // heads).transpose(0, 2, 1, 3)
                       .reshape(b * heads, s, c // heads))


def _packed(x, b, heads):
    """The JAX kernels' (B*H, S, D) -> (B, S, H*D) numpy."""
    x = np.asarray(x)
    _, s, d = x.shape
    return x.reshape(b, heads, s, d).transpose(0, 2, 1, 3).reshape(b, s, heads * d)


@pytest.mark.parametrize("sq,sk", [(256, 256), (256, 200)])
def test_flash_attention_plain_matches_flash_kernels(sq, sk):
    """Forward (out, base-2 lse) and backward (dq, dk, dv) against
    _flash_forward/_flash_backward in interpret mode; Sk = 200 is not a
    multiple of the key tile, so the JAX kernels mask a ragged tile."""
    from gmdx.kernels.flash_attention import _flash_backward, _flash_forward
    from gmdx_torch.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd

    rng = _rng(5)
    b, heads, d = 2, 2, 40
    q, do = _normal(rng, b, sq, heads * d), _normal(rng, b, sq, heads * d)
    k, v = _normal(rng, b, sk, heads * d), _normal(rng, b, sk, heads * d)
    scale = d**-0.5
    with jax.default_matmul_precision("highest"):
        out, lse = _flash_forward(_flat(q, heads), _flat(k, heads), _flat(v, heads), scale,
                                  interpret=True)
        grads = _flash_backward(_flat(q, heads), _flat(k, heads), _flat(v, heads), out, lse,
                                _flat(do, heads), scale, interpret=True)
    t = torch.from_numpy
    got_out, got_lse = flash_attention_fwd(t(q), t(k), t(v), heads)
    assert _max_abs(got_out.numpy(), _packed(out, b, heads)) <= TOL
    assert _max_abs(got_lse.numpy(), np.asarray(lse).reshape(b, heads, sq)) <= TOL
    got = flash_attention_bwd(t(q), t(k), t(v), got_out, got_lse, t(do), heads)
    for g, want in zip(got, grads):
        assert _max_abs(g.numpy(), _packed(want, b, heads)) <= TOL


@pytest.mark.parametrize("activate,temb", [(True, False), (False, False), (True, True)])
def test_group_norm_bwd_plain_matches_gn_backward(activate, temb):
    """dx, dscale, dbias against _gn_backward in interpret mode, each
    package from its own forward's statistics. The JAX package adds temb
    outside its kernels, so its side normalises x + temb and takes
    dtemb = sum over pixels of dx."""
    from gmdx.kernels.groupnorm import _gn_backward, _gn_forward
    from gmdx_torch.kernels.groupnorm import group_norm_silu_bwd

    rng = _rng(6)
    x = _normal(rng, 2, 8, 8, 64, scale=2.0) + 0.5
    scale = 1.0 + _normal(rng, 64, scale=0.2)
    bias = _normal(rng, 64, scale=0.2)
    tm = _normal(rng, 2, 64) if temb else None
    g = _normal(rng, 2, 8, 8, 64)
    xs = x + tm[:, None, None, :] if temb else x
    with jax.default_matmul_precision("highest"):
        args = (jnp.asarray(xs), jnp.asarray(scale), jnp.asarray(bias))
        _, jstats = _gn_forward(*args, 32, 1e-5, activate, True)
        want = _gn_backward(*args, jstats, jnp.asarray(g), 32, 1e-5, activate, True)
    t = torch.from_numpy
    _, stats = group_norm_silu(t(x), t(scale), t(bias), t(tm) if temb else None,
                               eps=1e-5, activate=activate, return_stats=True)
    dx, dscale, dbias, dtemb = group_norm_silu_bwd(
        t(x), t(scale), t(bias), t(tm) if temb else None, stats, t(g), activate=activate)
    for a, w in zip((dx, dscale, dbias), want):
        assert _max_abs(a.numpy(), w) <= TOL
    if temb:
        assert _max_abs(dtemb.numpy(), np.asarray(want[0]).sum(axis=(1, 2))) <= TOL
    else:
        assert dtemb is None


def test_group_norm_autograd_pad_output_matches_jax_vjp():
    """The padded output's border carries no gradient: GroupNormSiLU's
    backward against jax.vjp through fused_group_norm_silu(pad_output=True)."""
    from gmdx_torch.kernels.groupnorm import GroupNormSiLU

    rng = _rng(7)
    x = _normal(rng, 2, 8, 8, 64, scale=2.0) + 0.5
    scale = 1.0 + _normal(rng, 64, scale=0.2)
    bias = _normal(rng, 64, scale=0.2)
    g = _normal(rng, 2, 10, 10, 64)
    with jax.default_matmul_precision("highest"):
        _, vjp = jax.vjp(
            lambda a, s, c: fused_group_norm_silu(a, s, c, num_groups=32, eps=1e-5, activate=True,
                                                  interpret=True, pad_output=True),
            jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
        want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, scale, bias)]
    GroupNormSiLU.apply(*leaves, None, 32, 1e-5, True, True).backward(torch.from_numpy(g))
    for leaf, w in zip(leaves, want):
        assert _max_abs(leaf.grad.numpy(), w) <= TOL


def _autograd_grads(fn, args, cot):
    leaves = [torch.from_numpy(a).requires_grad_() if a is not None else None for a in args]
    fn(*leaves).backward(torch.from_numpy(cot))
    return [leaf.grad for leaf in leaves if leaf is not None]


def test_autograd_functions_match_autograd_of_plain_versions():
    """Each differentiated route on the CPU (plain forward + plain backward
    formula) against torch.autograd through the forward plain version."""
    from gmdx_torch.kernels.attention import FlashAttention, attention_kv_resident_plain
    from gmdx_torch.kernels.geglu_ff import GegluFFLN, geglu_ff_ln_plain
    from gmdx_torch.kernels.groupnorm import GroupNormSiLU, group_norm_silu_plain

    rng = _rng(8)
    heads = 2
    qkv = [_normal(rng, 2, 256, 80) for _ in range(3)]
    cot = _normal(rng, 2, 256, 80)
    got = _autograd_grads(lambda *a: FlashAttention.apply(*a, heads, 40**-0.5), qkv, cot)
    want = _autograd_grads(lambda *a: attention_kv_resident_plain(*a, heads), qkv, cot)
    for a, w in zip(got, want):
        assert _max_abs(a.numpy(), w.numpy()) <= TOL

    gn = [_normal(rng, 2, 8, 8, 64, scale=2.0), 1.0 + _normal(rng, 64, scale=0.2),
          _normal(rng, 64, scale=0.2), _normal(rng, 2, 64)]
    cot = _normal(rng, 2, 10, 10, 64)
    got = _autograd_grads(lambda *a: GroupNormSiLU.apply(*a, 32, 1e-5, True, True), gn, cot)
    want = _autograd_grads(lambda *a: group_norm_silu_plain(*a, pad_output=True), gn, cot)
    for a, w in zip(got, want):
        assert _max_abs(a.numpy(), w.numpy()) <= TOL

    dim, inner = 64, 256
    ff = [_normal(rng, 2, 16, dim), _normal(rng, 2, 16, dim), 1.0 + _normal(rng, dim, scale=0.2),
          _normal(rng, dim, scale=0.2), _normal(rng, 2 * inner, dim, scale=dim**-0.5),
          _normal(rng, 2 * inner, scale=0.1), _normal(rng, dim, inner, scale=inner**-0.5),
          _normal(rng, dim, scale=0.1)]
    cot = _normal(rng, 2, 16, dim)
    got = _autograd_grads(lambda *a: GegluFFLN.apply(*a, 1e-5), ff, cot)
    want = _autograd_grads(lambda *a: geglu_ff_ln_plain(*a), ff, cot)
    for a, w in zip(got, want):
        assert _max_abs(a.numpy(), w.numpy()) <= TOL
