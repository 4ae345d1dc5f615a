"""The flash attention at the VAE's 512-wide head, on the CPU.

``flash_attention_bwd_plain`` at d = 512 against the VJP of the JAX
package's ``flash_attention`` in interpret mode (its ``_flash_backward``
Pallas kernels), and walks of ``csrc/attention_wide_sm90.cuh``'s forward and
backward arithmetic against the plain versions: Q unrounded with the scale
folded into exp2, every score product formed as two 256-column partial sums
(the two CTAs of a cluster) added in fp32, P and dS rounded to bf16 before
their products, the plans' tiles, TMA's zeros past S. The kernels
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
    flash_attention_fwd, flash_attention_fwd_plain, wide_bwd_plans, wide_fwd_plan,
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


def _bf(x):
    return x.to(torch.bfloat16).float()


def _halves(a, b):
    """a b^T over the last dim as the cluster forms it: each CTA's 256
    columns apart, in fp32, then the two partial sums added."""
    h = D // 2
    return a[..., :h] @ b[..., :h].transpose(-1, -2) + a[..., h:] @ b[..., h:].transpose(-1, -2)


def _padded(x, rows):
    """(B, S, 512) fp32 zero-padded to ``rows`` rows: TMA's zeros past S."""
    out = torch.zeros(x.shape[0], rows, D)
    out[:, :x.shape[1]] = x.float()
    return out


def _wide_fwd_walk(q, k, v, scale):
    """csrc/attention_wide_sm90.cuh's forward in fp32 on the CPU: clusters of
    128 queries, key tiles of the plan's rows, the split score product,
    keys past Sk masked to -inf, the online softmax with exp2(S c - m c), P
    rounded to bf16 for O += P V, lse = m c + log2(l). One head."""
    b, sq, _ = q.shape
    sk = k.shape[1]
    plan = wide_fwd_plan(b, sq, sk, 1)
    t, c = plan.tile, scale * _LOG2_E
    nkv = -(-sk // t)
    qp = _padded(q, plan.grid[0] // plan.cluster * plan.owned)
    kp, vp = _padded(k, nkv * t), _padded(v, nkv * t)
    m = torch.full(qp.shape[:2], -torch.inf)
    lsum = torch.zeros(qp.shape[:2])
    o = torch.zeros_like(qp)
    for j in range(nkv):
        keys = slice(j * t, (j + 1) * t)
        s = _halves(qp, kp[:, keys])
        s[..., torch.arange(j * t, (j + 1) * t) >= sk] = -torch.inf
        mx = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2((m - mx) * c)
        p = torch.exp2(s * c - (mx * c)[..., None])
        lsum = lsum * alpha + p.sum(-1)
        o = o * alpha[..., None] + _bf(p) @ vp[:, keys]
        m = mx
    out = _bf(o / lsum[..., None])[:, :sq]
    return out, (m * c + torch.log2(lsum))[:, None, :sq]


def _wide_bwd_walk(q, k, v, out, lse, dout, scale):
    """csrc/attention_wide_sm90.cuh's dV, dK and dQ kernels in fp32 on the
    CPU, as their plans cut them: dV over query tiles of 64, dK over query
    tiles of 32 (lse +inf and dd 0 past Sq, so P = 0), dQ over key tiles of
    32 (P masked to 0 past Sk); Q unrounded, the scale in exp2, each score
    product split in halves, P and dS rounded to bf16 before their
    products. One head."""
    b, sq, _ = q.shape
    sk = k.shape[1]
    pv, pk, pq = wide_bwd_plans(b, sq, sk, 1)
    c = scale * _LOG2_E
    dd = flash_attention_bwd_dd_plain(out, dout, 1)[:, 0]
    keys = pv.grid[0] // pv.cluster * pv.owned
    kp, vp = _padded(k, keys), _padded(v, keys)

    def query_tiles(tile):
        n = -(-sq // tile) * tile
        lse_p = torch.full((b, n), torch.inf)
        dd_p = torch.zeros(b, n)
        lse_p[:, :sq], dd_p[:, :sq] = lse[:, 0], dd
        return _padded(q, n), _padded(dout, n), lse_p, dd_p, range(0, n, tile)

    qp, gp, lse_p, _, starts = query_tiles(pv.tile)
    dv = torch.zeros_like(vp)
    for q0 in starts:
        rows = slice(q0, q0 + pv.tile)
        pt = torch.exp2(_halves(kp, qp[:, rows]) * c - lse_p[:, None, rows])
        dv += _bf(pt) @ gp[:, rows]
    qp, gp, lse_p, dd_p, starts = query_tiles(pk.tile)
    dk = torch.zeros_like(kp)
    for q0 in starts:
        rows = slice(q0, q0 + pk.tile)
        pt = torch.exp2(_halves(kp, qp[:, rows]) * c - lse_p[:, None, rows])
        dst = pt * (_halves(vp, gp[:, rows]) - dd_p[:, None, rows])
        dk += _bf(dst) @ qp[:, rows]

    own = pq.grid[0] // pq.cluster * pq.owned
    nk = -(-sk // pq.tile) * pq.tile
    qp, gp, kp, vp = _padded(q, own), _padded(dout, own), _padded(k, nk), _padded(v, nk)
    lse_r = torch.full((b, own), torch.inf)
    dd_r = torch.zeros(b, own)
    lse_r[:, :sq], dd_r[:, :sq] = lse[:, 0], dd
    dq = torch.zeros_like(qp)
    for k0 in range(0, nk, pq.tile):
        cols = slice(k0, k0 + pq.tile)
        p = torch.exp2(_halves(qp, kp[:, cols]) * c - lse_r[..., None])
        p[..., torch.arange(k0, k0 + pq.tile) >= sk] = 0.0
        ds = p * (_halves(gp, vp[:, cols]) - dd_r[..., None])
        dq += _bf(ds) @ kp[:, cols]
    return (_bf(dq * scale)[:, :sq], _bf(dk * scale)[:, :sk], _bf(dv)[:, :sk])


def _rounded_forward_lse(q, k, scale):
    """An lse under the rounding convention the 512-wide kernels no longer
    use: from Qs = bf16(Q * c), rounded in place before S."""
    qs = (q.float() * (scale * _LOG2_E)).to(torch.bfloat16).float()
    s2 = torch.einsum("bqd,bkd->bqk", qs, k.float())
    return torch.logsumexp(s2 * np.log(2.0), dim=-1)[:, None] / np.log(2.0)


def _row_sums(q, k, lse, scale):
    """Each row's sum of P = exp2(S c - lse), S from the unrounded Q, as the
    backward recomputes it."""
    s2 = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * (scale * _LOG2_E)
    return torch.exp2(s2 - lse[:, 0, :, None]).sum(-1)


@pytest.mark.parametrize("b,sq,sk", [(1, 256, 200), (2, 130, 300), (1, 64, 1)])
def test_forward_walk_matches_the_plain_version(b, sq, sk):
    """bf16 operands: the forward walk's out and lse land within the card
    bar (relative L2 1e-2) of the fp32 plain version, and P recomputed from
    the walk's lse with the same unrounded Q sums to one in every row."""
    q, k, v, _ = (torch.from_numpy(x).to(torch.bfloat16) for x in _operands(3, b, sq, sk))
    scale = D**-0.5
    out, lse = _wide_fwd_walk(q, k, v, scale)
    ref, ref_lse = flash_attention_fwd_plain(q.float(), k.float(), v.float(), 1, scale)
    assert out.shape == ref.shape and lse.shape == ref_lse.shape
    assert _rel_l2(out.numpy(), ref.numpy()) <= 1e-2
    assert _rel_l2(lse.numpy(), ref_lse.numpy()) <= 1e-2
    assert float((_row_sums(q, k, lse, scale) - 1).abs().max()) <= 1e-5


@pytest.mark.parametrize("b,sq,sk", [(1, 256, 200), (2, 96, 130)])
def test_kernel_walk_matches_the_plain_version(b, sq, sk):
    """bf16 operands: the walk of the backward kernels, on the forward
    walk's out and lse, lands within the card bar (relative L2 1e-2) of the
    fp32 plain version, and each row of P, recomputed from the forward's lse
    with the same unrounded Q, sums to one."""
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in _operands(1, b, sq, sk))
    scale = D**-0.5
    out, lse = _wide_fwd_walk(q, k, v, scale)
    assert float((_row_sums(q, k, lse, scale) - 1).abs().max()) <= 1e-5
    walk = _wide_bwd_walk(q, k, v, out, lse, do, scale)
    ref = flash_attention_bwd_plain(q.float(), k.float(), v.float(), out.float(), lse,
                                    do.float(), 1, scale)
    for w, r, name in zip(walk, ref, ("dq", "dk", "dv")):
        assert w.shape == r.shape, name
        assert _rel_l2(w.numpy(), r.numpy()) <= 1e-2, name


def test_unrounded_q_biases_the_recomputed_softmax():
    """Why forward and backward must share one rounding convention: P from
    the unrounded Q against an lse written from Qs = bf16(Q c), the
    convention the 512-wide kernels used before, misses a row sum of one by
    about bf16 epsilon."""
    q, k, _, _ = (torch.from_numpy(x).to(torch.bfloat16) for x in _operands(2))
    scale = D**-0.5
    lse = _rounded_forward_lse(q, k, scale)
    miss = float((_row_sums(q, k, lse, scale) - 1).abs().max())
    assert 1e-4 < miss < 5e-2
