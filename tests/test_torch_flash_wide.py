"""The flash backward at the VAE's 512-wide head, on the CPU.

``flash_attention_bwd_plain`` at d = 512 against the VJP of the JAX
package's ``flash_attention`` in interpret mode (its ``_flash_backward``
Pallas kernels), and a walk of ``csrc/attention_wide_bwd.cuh``'s arithmetic
(its bf16 roundings of Qs, P and dS) against the plain version. The kernels
themselves run only on the card (tests/test_torch_card.py).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gmdx.kernels.flash_attention import flash_attention as jax_flash_attention
from gmdx_torch.kernels import LAUNCHES
from gmdx_torch.kernels.attention import FlashAttention
from gmdx_torch.kernels.flash_attention import (
    _LOG2_E, flash_attention_bwd, flash_attention_bwd_dd_plain, flash_attention_bwd_plain,
    flash_attention_fwd, flash_attention_fwd_plain,
)

D = 512
B, SQ, SK = 1, 256, 200  # Sk 200: a ragged key tile, masked


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _operands(seed: int, b=B, sq=SQ, sk=SK, heads=1):
    rng = np.random.default_rng(seed)
    c = heads * D
    q, do = (rng.standard_normal((b, sq, c)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, sk, c)).astype(np.float32) for _ in range(2))
    return q, k, v, do


@pytest.fixture(scope="module")
def jax_vjp():
    """out and (dq, dk, dv) of the JAX flash attention (B, S, H, D) in
    interpret mode, fp32, for the module's operands."""
    q, k, v, do = _operands(0)
    as4 = lambda x: jnp.asarray(x.reshape(x.shape[0], x.shape[1], 1, D))  # noqa: E731
    with jax.default_matmul_precision("highest"):
        out, pull = jax.vjp(lambda q, k, v: jax_flash_attention(q, k, v, interpret=True),
                            as4(q), as4(k), as4(v))
        grads = pull(as4(do))
    return (np.asarray(out).reshape(B, SQ, D),
            tuple(np.asarray(g).reshape(g.shape[0], g.shape[1], D) for g in grads))


def test_plain_backward_matches_jax_vjp(jax_vjp):
    q, k, v, do = _operands(0)
    t = torch.from_numpy
    out, lse = flash_attention_fwd_plain(t(q), t(k), t(v), 1, D**-0.5)
    assert _rel_l2(out.numpy(), jax_vjp[0]) <= 1e-5
    got = flash_attention_bwd_plain(t(q), t(k), t(v), out, lse, t(do), 1, D**-0.5)
    for g, want, name in zip(got, jax_vjp[1], ("dq", "dk", "dv")):
        assert _rel_l2(g.numpy(), want) <= 1e-5, name


def test_wrapper_and_autograd_take_d512_on_the_cpu(jax_vjp):
    """flash_attention_bwd and FlashAttention accept head dim 512; on CPU
    tensors they run the plain versions and count no launch."""
    q, k, v, do = _operands(0)
    t = torch.from_numpy
    before = dict(LAUNCHES)
    out, lse = flash_attention_fwd(t(q), t(k), t(v), 1)
    got = flash_attention_bwd(t(q), t(k), t(v), out, lse, t(do), 1)
    qa, ka, va = (t(x).requires_grad_(True) for x in (q, k, v))
    out_a = FlashAttention.apply(qa, ka, va, 1, D**-0.5)
    auto = torch.autograd.grad(out_a, (qa, ka, va), t(do))
    for g, a, want in zip(got, auto, jax_vjp[1]):
        assert _rel_l2(g.numpy(), want) <= 1e-5
        assert torch.equal(g, a)
    assert LAUNCHES == before


def _wide_bwd_walk(q, k, v, out, lse, dout, scale, heads=1):
    """csrc/attention_wide_bwd.cuh's arithmetic in fp32 on the CPU: Qs
    rounded to bf16 as the forward rounds it, P and dS rounded to bf16 before
    their products, 32-key blocks (dK, dV) and 32-query blocks (dQ) of
    32-row tiles, keys past Sk masked to P = 0."""
    bf = lambda x: x.to(torch.bfloat16).float()  # noqa: E731
    b, sq, c = q.shape
    sk = k.shape[1]
    cq = scale * _LOG2_E
    split = lambda x: x.float().reshape(x.shape[0], x.shape[1], heads, D)  # noqa: E731
    qs = bf(split(q) * cq)
    kf, vf, g = split(k), split(v), split(dout)
    dd = flash_attention_bwd_dd_plain(out, dout, heads)
    dk, dv, dq = torch.zeros_like(kf), torch.zeros_like(vf), torch.zeros_like(qs)
    for k0 in range(0, sk, 32):
        for q0 in range(0, sq, 32):
            qt, gt = qs[:, q0:q0 + 32], g[:, q0:q0 + 32]
            st = torch.einsum("bkhd,bqhd->bhkq", kf[:, k0:k0 + 32], qt)
            dpt = torch.einsum("bkhd,bqhd->bhkq", vf[:, k0:k0 + 32], gt)
            p = torch.exp2(st - lse[:, :, None, q0:q0 + 32])
            ds = p * (dpt - dd[:, :, None, q0:q0 + 32])
            dv[:, k0:k0 + 32] += torch.einsum("bhkq,bqhd->bkhd", bf(p), gt)
            dk[:, k0:k0 + 32] += torch.einsum("bhkq,bqhd->bkhd", bf(ds), qt)
    for q0 in range(0, sq, 32):
        for k0 in range(0, sk, 32):
            kt = kf[:, k0:k0 + 32]
            s = torch.einsum("bqhd,bkhd->bhqk", qs[:, q0:q0 + 32], kt)
            dp = torch.einsum("bqhd,bkhd->bhqk", g[:, q0:q0 + 32], vf[:, k0:k0 + 32])
            p = torch.exp2(s - lse[:, :, q0:q0 + 32, None])
            ds = p * (dp - dd[:, :, q0:q0 + 32, None])
            dq[:, q0:q0 + 32] += torch.einsum("bhqk,bkhd->bqhd", bf(ds), kt)
    return (bf(dq * scale).reshape(q.shape), bf(dk * 0.6931471805599453).reshape(k.shape),
            bf(dv).reshape(v.shape))


def _rounded_forward_lse(q, k, scale):
    """The 512-wide forward's lse: from Qs rounded to bf16 in place."""
    qs = (q.float() * (scale * _LOG2_E)).to(torch.bfloat16).float()
    s2 = torch.einsum("bqd,bkd->bqk", qs, k.float())
    return torch.logsumexp(s2 * np.log(2.0), dim=-1)[:, None] / np.log(2.0), qs


@pytest.mark.parametrize("b,sq,sk", [(1, 256, 200), (2, 96, 130)])
def test_kernel_walk_matches_the_plain_version(b, sq, sk):
    """bf16 operands: the walk of the kernel's arithmetic lands within the
    card bar (relative L2 1e-2) of the fp32 plain version, and each row of P,
    recomputed from the forward's bf16 Qs, sums to one."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in _operands(1, b, sq, sk))
    scale = D**-0.5
    lse, qs = _rounded_forward_lse(q, k, scale)
    out = flash_attention_fwd_plain(q.float(), k.float(), v.float(), 1, scale)[0]
    out = out.to(torch.bfloat16)
    p = torch.exp2(torch.einsum("bqd,bkd->bqk", qs, k.float()) - lse[:, 0, :, None])
    assert float((p.sum(-1) - 1).abs().max()) <= 1e-5
    walk = _wide_bwd_walk(q, k, v, out, lse, do, scale)
    ref = flash_attention_bwd_plain(q.float(), k.float(), v.float(), out.float(), lse,
                                    do.float(), 1, scale)
    for w, r, name in zip(walk, ref, ("dq", "dk", "dv")):
        assert _rel_l2(w.numpy(), r.numpy()) <= 1e-2, name


def test_unrounded_q_biases_the_recomputed_softmax():
    """The reason the kernel rounds Qs: P from the unrounded Q against the
    forward's lse misses a row sum of one by about bf16 epsilon."""
    q, k, _, _ = (torch.from_numpy(x).to(torch.bfloat16) for x in _operands(2))
    scale = D**-0.5
    lse, _ = _rounded_forward_lse(q, k, scale)
    s2 = torch.einsum("bqd,bkd->bqk", q.float() * (scale * _LOG2_E), k.float())
    miss = float((torch.exp2(s2 - lse[:, 0, :, None]).sum(-1) - 1).abs().max())
    assert 1e-4 < miss < 5e-2
