"""The launch plans of the Hopper attention kernels, on the CPU.

``csrc/attention_sm90.cuh`` runs the forward of ``flash_attention_bsc`` and
the two kernels of ``flash_attention_bwd`` as
``gmdx_torch/kernels/flash_attention.py:flash_bsc_plan`` and
``flash_bwd_plan`` lay them out (``tests/test_torch_card.py`` holds the
plans to the kernels' own structs on the card). These tests hold the plans
at every self-attention shape of the SD-1.5 paths and walk the kernels'
tiles in numpy, as the plans cut them: columns past D and rows past S as
TMA's zeros, keys past Sk masked, the scale folded into exp2. Plain numpy
and torch: no JAX, no card.
"""

import numpy as np
import pytest
import torch

from gmdx_torch.kernels.flash_attention import (
    BOX_COLS, SMEM_BUDGET, flash_attention_bsc_plain, flash_attention_bwd_dd_plain,
    flash_attention_bwd_plain, flash_attention_fwd_plain, flash_bsc_plan, flash_bwd_plan,
)

LOG2_E = 1.0 / np.log(2.0)
# The self-attention levels of the SD-1.5 UNet at 64^2 and 128^2 latents
# (512^2 and 1024^2 images): tokens and head dim, 8 heads each.
PATH_LEVELS = [(4096, 40), (1024, 80), (256, 160), (16384, 40), (4096, 80), (1024, 160)]
# The paths' batches: hdrtv's 1 and CFG 2, training's 8, serving's CFG 16.
BATCHES = (1, 2, 8, 16)


def _plans(b, s, d):
    return (flash_bsc_plan(b, s, s, 8, d), *flash_bwd_plan(b, s, s, 8, d))


def _cols(d):
    """Columns of the chunk tiles a row of D fills: D padded to whole
    64-column boxes."""
    return -(-d // BOX_COLS) * BOX_COLS


def _k16(d):
    """The k16 loop's reach over D: D padded to a multiple of 16."""
    return -(-d // 16) * 16


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("s,d", PATH_LEVELS)
def test_plans_fit_the_card(b, s, d):
    heads = 8
    # The byte strides of a head-packed operand's dims H, S and B, as its
    # 4-D TMA map (D, H, S, B) gives them: multiples of 16 for TMA.
    assert all(st % 16 == 0 for st in (d * 2, heads * d * 2, s * heads * d * 2))
    # The k16 loop covers D inside the chunk tiles.
    assert d <= _k16(d) <= _cols(d)
    assert BOX_COLS * 2 == 128
    for plan in _plans(b, s, d):
        assert plan.smem_bytes <= SMEM_BUDGET, plan
        assert plan.stages >= 2, plan
        # TMA: boxes of (64, 1, rows, 1), each dim at most 256.
        assert all(1 <= rows <= 256 for rows in plan.boxes), plan
        # 64 rows for each consumer warpgroup, two or three of them.
        assert plan.owned in (128, 192), plan
        assert plan.grid[1] == heads and plan.grid[2] == b and max(plan.grid[1:]) <= 65535


@pytest.mark.parametrize("sq,sk", [(16384, 16384), (300, 16300), (16300, 300), (1, 1)])
@pytest.mark.parametrize("d", [40, 80, 160])
def test_grids_cover_every_row(sq, sk, d):
    fwd = flash_bsc_plan(2, sq, sk, 8, d)
    dkv, dq = flash_bwd_plan(2, sq, sk, 8, d)
    for plan, rows in ((fwd, sq), (dkv, sk), (dq, sq)):
        assert (plan.grid[0] - 1) * plan.owned < rows <= plan.grid[0] * plan.owned, plan


def test_d40_forward_takes_three_consumers():
    """The d = 40 forward runs three consumer warpgroups (192 queries a
    block); the wider heads keep two for their accumulators."""
    assert flash_bsc_plan(2, 16384, 16384, 8, 40).owned == 192
    assert flash_bsc_plan(2, 4096, 4096, 8, 80).owned == 128
    assert flash_bwd_plan(8, 256, 256, 8, 160)[0].tile == 32


def _heads(x, heads, rows, cols):
    """(B, S, H*D) -> (B, H, rows, cols) fp32, zero past S and D: what the
    TMA boxes put in shared memory."""
    b, s, c = x.shape
    d = c // heads
    out = np.zeros((b, heads, rows, cols), np.float32)
    out[:, :, :s, :d] = x.reshape(b, s, heads, d).transpose(0, 2, 1, 3)
    return out


def _packed(x, s, d):
    b, h = x.shape[:2]
    return x[:, :, :s, :d].transpose(0, 2, 1, 3).reshape(b, s, h * d)


def _inputs(b, sq, sk, heads, d, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, n, heads * d)).astype(np.float32) for n in (sq, sk, sk))
    return q, k, v


def emulate_bsc(q, k, v, heads, scale):
    """The forward's tile walk: blocks of ``owned`` queries, key tiles of
    ``tile`` rows, online softmax with exp2(S c - m c). Returns the output
    and the base-2 logsumexp m c + log2(l) of the form with LSE."""
    b, sq, c = q.shape
    sk, d = k.shape[1], c // heads
    plan = flash_bsc_plan(b, sq, sk, heads, d)
    cols = _cols(d)
    nkv = -(-sk // plan.tile)
    qp = _heads(q, heads, plan.grid[0] * plan.owned, cols)[..., :_k16(d)]
    kp = _heads(k, heads, nkv * plan.tile, cols)[..., :_k16(d)]
    vp = _heads(v, heads, nkv * plan.tile, cols)
    cf = np.float32(scale * LOG2_E)
    m = np.full(qp.shape[:3], -np.inf, np.float32)
    lsum = np.zeros(qp.shape[:3], np.float32)
    o = np.zeros(qp.shape[:3] + (cols,), np.float32)
    for j in range(nkv):
        keys = slice(j * plan.tile, (j + 1) * plan.tile)
        s = qp @ kp[:, :, keys].transpose(0, 1, 3, 2)
        s[..., np.arange(j * plan.tile, (j + 1) * plan.tile) >= sk] = -np.inf
        mx = np.maximum(m, s.max(-1))
        alpha = np.exp2((m - mx) * cf)
        p = np.exp2(s * cf - (mx * cf)[..., None])
        lsum = lsum * alpha + p.sum(-1)
        o = o * alpha[..., None] + p @ vp[:, :, keys]
        m = mx
    return _packed(o / lsum[..., None], sq, d), (m * cf + np.log2(lsum))[..., :sq]


def emulate_bwd(q, k, v, out, lse, dout, heads, scale):
    """The two backward kernels' tile walks: dK/dV over query tiles of the
    dkv plan (lse +inf and dd 0 past Sq), dQ over key tiles of the dq plan
    (P masked to 0 past Sk), Q unscaled with the scale folded into exp2."""
    b, sq, c = q.shape
    sk, d = k.shape[1], c // heads
    dkv, dq = flash_bwd_plan(b, sq, sk, heads, d)
    cols, ks = _cols(d), _k16(d)
    cf = np.float32(scale * LOG2_E)
    dd = flash_attention_bwd_dd_plain(torch.from_numpy(out), torch.from_numpy(dout), heads)
    dd = dd.numpy()

    nq = -(-sq // dkv.tile)
    qp, dop = (_heads(x, heads, nq * dkv.tile, cols) for x in (q, dout))
    kp, vp = (_heads(x, heads, dkv.grid[0] * dkv.owned, cols) for x in (k, v))
    lse_p = np.full((b, heads, nq * dkv.tile), np.inf, np.float32)
    dd_p = np.zeros((b, heads, nq * dkv.tile), np.float32)
    lse_p[..., :sq], dd_p[..., :sq] = lse, dd
    dk = np.zeros_like(kp)
    dv = np.zeros_like(vp)
    for i in range(nq):
        rows = slice(i * dkv.tile, (i + 1) * dkv.tile)
        st = kp[..., :ks] @ qp[:, :, rows, :ks].transpose(0, 1, 3, 2)
        pt = np.exp2(st * cf - lse_p[:, :, None, rows])
        dpt = vp[..., :ks] @ dop[:, :, rows, :ks].transpose(0, 1, 3, 2)
        dst = pt * (dpt - dd_p[:, :, None, rows])
        dv += pt @ dop[:, :, rows]
        dk += dst @ qp[:, :, rows]
    dk *= np.float32(scale)

    nk = -(-sk // dq.tile)
    qp, dop = (_heads(x, heads, dq.grid[0] * dq.owned, cols) for x in (q, dout))
    kp, vp = (_heads(x, heads, nk * dq.tile, cols) for x in (k, v))
    lse_r = np.full(qp.shape[:3], np.inf, np.float32)
    dd_r = np.zeros(qp.shape[:3], np.float32)
    lse_r[..., :sq], dd_r[..., :sq] = lse, dd
    dqa = np.zeros_like(qp)
    for j in range(nk):
        keys = slice(j * dq.tile, (j + 1) * dq.tile)
        s = qp[..., :ks] @ kp[:, :, keys, :ks].transpose(0, 1, 3, 2)
        p = np.exp2(s * cf - lse_r[..., None])
        p[..., np.arange(j * dq.tile, (j + 1) * dq.tile) >= sk] = 0.0
        dp = dop[..., :ks] @ vp[:, :, keys, :ks].transpose(0, 1, 3, 2)
        dqa += (p * (dp - dd_r[..., None])) @ kp[:, :, keys]
    dqa *= np.float32(scale)
    return _packed(dqa, sq, d), _packed(dk, sk, d), _packed(dv, sk, d)


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("sq,sk,d", [(300, 16300, 40), (400, 1000, 80), (200, 300, 160),
                                     (130, 70, 40)])
def test_forward_tiles_are_the_plain_function(sq, sk, d):
    heads = 2
    q, k, v = _inputs(1, sq, sk, heads, d, seed=sq + d)
    got, lse = emulate_bsc(q, k, v, heads, d**-0.5)
    ref = flash_attention_bsc_plain(*(torch.from_numpy(x) for x in (q, k, v)), heads)
    assert _rel_l2(got, ref.numpy()) <= 1e-5
    _, ref_lse = flash_attention_fwd_plain(*(torch.from_numpy(x) for x in (q, k, v)), heads,
                                           d**-0.5)
    assert _rel_l2(lse, ref_lse.numpy()) <= 1e-5


@pytest.mark.parametrize("sq,sk,d", [(300, 1000, 40), (300, 260, 80), (100, 200, 160),
                                     (70, 130, 40)])
def test_backward_tiles_sum_to_the_plain_gradients(sq, sk, d):
    heads, scale = 2, d**-0.5
    q, k, v = _inputs(1, sq, sk, heads, d, seed=sk + d)
    dout = np.random.default_rng(sq).standard_normal(q.shape).astype(np.float32)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    out, lse = flash_attention_fwd_plain(*t, heads, scale)
    got = emulate_bwd(q, k, v, out.numpy(), lse.numpy(), dout, heads, scale)
    ref = flash_attention_bwd_plain(*t, out, lse, torch.from_numpy(dout), heads, scale)
    for g, r in zip(got, ref):
        assert _rel_l2(g, r.numpy()) <= 1e-5
