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
