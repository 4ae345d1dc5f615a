"""The launch plans of the Hopper attention kernels, on the CPU.

``csrc/attention_sm90.cuh`` runs the forward of ``attention_kv_resident``,
``flash_attention_fwd`` and ``flash_attention_bsc`` and the two kernels of
``flash_attention_bwd`` as
``gmdx_torch/kernels/flash_attention.py:attention_fwd_plan`` and
``flash_bwd_plan`` lay them out, and ``csrc/attention_xattn.cuh`` the
short-K cross-attention as ``xattn_plan`` does (``tests/test_torch_card.py`` holds the
plans to the kernels' own structs on the card). These tests hold the plans
at every self-attention shape of the SD-1.5 paths, check that the dispatch
sends those shapes to the kernels whose plans they are, and walk the
kernels' tiles in numpy, as the plans cut them: the forward's persistent
blocks over (query tile, head, batch), columns past D and rows past S as
TMA's zeros, keys past Sk masked, the scale folded into exp2. Plain numpy
and torch: no JAX, no card.
"""

import numpy as np
import pytest
import torch

from gmdx_torch.kernels.attention import attention_route
from gmdx_torch.kernels.flash_attention import (
    BOX_COLS, SMEM_BUDGET, SMS, attention_fwd_plan, cross_attention_shortk_plain,
    flash_attention_bsc_plain, flash_attention_bwd_dd_plain, flash_attention_bwd_plain,
    flash_attention_fwd_plain, flash_bwd_plan, wide_bwd_plans, wide_fwd_plan, xattn_plan,
)

LOG2_E = 1.0 / np.log(2.0)
# The self-attention levels of the SD-1.5 UNet at 64^2 and 128^2 latents
# (512^2 and 1024^2 images): tokens and head dim, 8 heads each.
PATH_LEVELS = [(4096, 40), (1024, 80), (256, 160), (16384, 40), (4096, 80), (1024, 160)]
# The paths' batches: hdrtv's 1 and CFG 2, training's 8, serving's CFG 16.
BATCHES = (1, 2, 8, 16)
# Every (batch, tokens, head dim) that reaches the KV-resident kernel or the
# training forward on a path: the 512^2 UNet levels at the smoke's and the
# headline's CFG batches 4 and 16 and the GM UNet's headline batch 8, the
# 1024^2 levels below the first at the up-conversion's batches 1 and 2, the
# Stage-2 step's levels at batches 2 and 8.
UNET_512 = [(4096, 40), (1024, 80), (256, 160)]
UNET_1024 = [(4096, 80), (1024, 160), (256, 160)]
KVRES_SHAPES = sorted({(b, s, d) for b in (4, 8, 16) for s, d in UNET_512}
                      | {(b, s, d) for b in (1, 2) for s, d in UNET_1024})
TRAIN_SHAPES = [(b, s, d) for b in (2, 8) for s, d in UNET_512]


def _plans(b, s, d):
    return (attention_fwd_plan(b, s, s, 8, d), *flash_bwd_plan(b, s, s, 8, d))


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
    fwd, dkv, dq = _plans(b, s, d)
    for plan in (fwd, dkv, dq):
        assert plan.smem_bytes <= SMEM_BUDGET, plan
        assert plan.stages >= 2, plan
        # TMA: boxes of (64, 1, rows, 1), each dim at most 256.
        assert all(1 <= rows <= 256 for rows in plan.boxes), plan
        # 64 rows for each consumer warpgroup, two or three of them.
        assert plan.owned in (128, 192), plan
    for plan in (dkv, dq):
        assert plan.grid[1] == heads and plan.grid[2] == b and max(plan.grid[1:]) <= 65535
    # The forward is persistent: one block an SM at most, over every
    # (query tile, head, batch).
    assert fwd.grid == (min(-(-s // fwd.owned) * heads * b, SMS), 1, 1), fwd


@pytest.mark.parametrize("sq,sk", [(16384, 16384), (300, 16300), (16300, 300), (1, 1)])
@pytest.mark.parametrize("d", [40, 80, 160])
def test_grids_cover_every_row(sq, sk, d):
    fwd = attention_fwd_plan(2, sq, sk, 8, d)
    dkv, dq = flash_bwd_plan(2, sq, sk, 8, d)
    for plan, rows in ((dkv, sk), (dq, sq)):
        assert (plan.grid[0] - 1) * plan.owned < rows <= plan.grid[0] * plan.owned, plan
    tiles = -(-sq // fwd.owned)
    assert (tiles - 1) * fwd.owned < sq <= tiles * fwd.owned
    assert fwd.grid[0] == min(tiles * 8 * 2, SMS)


def test_d40_forward_takes_three_consumers():
    """The d = 40 forward runs three consumer warpgroups (192 queries a
    block); the wider heads keep two for their accumulators."""
    assert attention_fwd_plan(2, 16384, 16384, 8, 40).owned == 192
    assert attention_fwd_plan(2, 4096, 4096, 8, 80).owned == 128
    assert flash_bwd_plan(8, 256, 256, 8, 160)[0].tile == 32


@pytest.mark.parametrize("b,s,d", KVRES_SHAPES + TRAIN_SHAPES)
def test_path_shapes_route_to_the_planned_forward(b, s, d):
    """Every path shape of the KV-resident kernel and the training forward
    takes the KV-resident route (under autograd, the training forward) and
    not the long-sequence one, and its forward plan fits the card."""
    assert attention_route(s, d, sq=s) == "kv_resident"
    assert attention_route(s, d, sq=s, xattn_kernel=True) == "kv_resident"
    plan = attention_fwd_plan(b, s, s, 8, d)
    assert plan.smem_bytes <= SMEM_BUDGET and plan.stages >= 2
    assert plan.owned == (192 if d == 40 else 128) and plan.tile == (64 if d == 160 else 128)
    assert attention_route(4 * s, d, sq=4 * s) == ("flash_bsc" if 4 * s > 4096 else "kv_resident")


@pytest.mark.parametrize("b,sq,heads,d", [(16, 4096, 8, 40), (2, 256, 8, 160), (1, 300, 3, 80),
                                          (3, 16384, 8, 40), (1, 1, 1, 40)])
def test_persistent_walk_takes_every_tile_once(b, sq, heads, d):
    """Block i of the forward's grid takes tiles i, i + grid, ...; the query
    tile is the fastest index, then the head, then the batch: every (query
    tile, head, batch) is taken once, and no block takes two tiles more
    than another."""
    plan = attention_fwd_plan(b, sq, sq, heads, d)
    q_tiles = -(-sq // plan.owned)
    taken, per_block = {}, []
    for blk in range(plan.grid[0]):
        mine = range(blk, q_tiles * heads * b, plan.grid[0])
        per_block.append(len(mine))
        for t in mine:
            key = (t % q_tiles, t // q_tiles % heads, t // q_tiles // heads)
            taken[key] = taken.get(key, 0) + 1
    assert len(taken) == q_tiles * heads * b and set(taken.values()) == {1}
    assert max(per_block) - min(per_block) <= 1


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


def emulate_fwd(q, k, v, heads, scale):
    """The forward's tile walk: query tiles of ``owned`` rows, key tiles of
    ``tile`` rows, online softmax with exp2(S c - m c). Returns the output
    and the base-2 logsumexp m c + log2(l) of the form with LSE."""
    b, sq, c = q.shape
    sk, d = k.shape[1], c // heads
    plan = attention_fwd_plan(b, sq, sk, heads, d)
    cols = _cols(d)
    nkv = -(-sk // plan.tile)
    qp = _heads(q, heads, -(-sq // plan.owned) * plan.owned, cols)[..., :_k16(d)]
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


def _check_forward_walk(sq, sk, d, heads, plan=None):
    q, k, v = _inputs(1, sq, sk, heads, d, seed=sq + d)
    if plan is not None:  # the walk at one batch takes the full shape's tiles
        walk = attention_fwd_plan(1, sq, sk, heads, d)
        assert (walk.owned, walk.tile, walk.stages) == (plan.owned, plan.tile, plan.stages)
    got, lse = emulate_fwd(q, k, v, heads, d**-0.5)
    ref = flash_attention_bsc_plain(*(torch.from_numpy(x) for x in (q, k, v)), heads)
    assert _rel_l2(got, ref.numpy()) <= 1e-5
    _, ref_lse = flash_attention_fwd_plain(*(torch.from_numpy(x) for x in (q, k, v)), heads,
                                           d**-0.5)
    assert _rel_l2(lse, ref_lse.numpy()) <= 1e-5


@pytest.mark.parametrize("sq,sk,d", [(300, 16300, 40), (400, 1000, 80), (200, 300, 160),
                                     (130, 70, 40), (4000, 4096, 40), (1000, 1100, 80),
                                     (300, 256, 160), (4096, 4000, 40)])
def test_forward_tiles_are_the_plain_function(sq, sk, d):
    """Ragged query and key counts: the last query tile part empty, the
    last key tile masked."""
    _check_forward_walk(sq, sk, d, heads=2)


@pytest.mark.parametrize("b,s,d", sorted({(b, s, d) for b, s, d in KVRES_SHAPES + TRAIN_SHAPES
                                          if b in (2, 8)}))
def test_path_forward_tiles_are_the_plain_function(b, s, d):
    """The tile walk of each path shape's plan, out and lse, on one batch
    and two heads of it (the walk of one (batch, head) is the same at
    every batch)."""
    _check_forward_walk(s, s, d, heads=2, plan=attention_fwd_plan(b, s, s, 8, d))


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


def _c_entry_points():
    """{name: (source stem, [parameters])} of every ``extern "C"`` entry
    point in gmdx_torch/csrc/*.cu, read from the sources."""
    import re
    from pathlib import Path

    from gmdx_torch.kernels import _build

    found = {}
    for path in Path(_build.CSRC).glob("*.cu"):
        text = path.read_text()
        for name, params in re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text):
            found[name] = (path.stem, [p.strip() for p in params.split(",")])
    return found


def test_ctypes_signatures_match_the_c_entry_points():
    """Each entry point's library and ctypes argtypes (_build.ENTRY_POINTS)
    match its source and C parameters one for one: a pointer or the stream
    as c_void_p, an int as c_int, a float as c_float, so that no argument is
    cut or shifted (the kernels build only on the card)."""
    import ctypes

    from gmdx_torch.kernels import _build

    found = _c_entry_points()
    assert set(found) == set(_build.ENTRY_POINTS)
    for name, (lib, argtypes) in _build.ENTRY_POINTS.items():
        source, params = found[name]
        want = [ctypes.c_void_p if "*" in p else ctypes.c_float if p.startswith("float")
                else ctypes.c_int for p in params]
        assert (lib, argtypes) == (source, want), name


# The short-K cross-attention's path shapes: the 512^2 GM UNet's 64^2 and
# 32^2 levels (4096 x 40, 1024 x 80; 8 heads) against the 77 CLIP tokens,
# and the 16^2 level's head dim, at the paths' batches.
XATTN_LEVELS = [(4096, 40), (1024, 80), (256, 160)]


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("s,d", XATTN_LEVELS)
def test_xattn_plan_at_path_shapes(b, s, d):
    plan = xattn_plan(b, s, 77, 8, d)
    # The key tile is the 77 keys rounded up to 80, not 128, and the S
    # product's depth is D in k16 steps (3 at D = 40), not the 64-column box.
    assert plan.key_tile == 80 and plan.ksteps == -(-d // 16) == _k16(d) // 16
    assert plan.consumers == (3 if d == 40 else 2)
    # Two Q stages a consumer: a stage always serves the same consumer.
    assert plan.stages == 2 * plan.consumers and plan.smem_bytes <= SMEM_BUDGET
    # One block a (batch, head) run; the runs of a head fill the SMs in one
    # wave where B H alone would not.
    q_tiles = -(-s // 64)
    assert plan.splits == max(1, min(SMS // (b * 8), q_tiles))
    assert plan.grid == b * 8 * plan.splits and (plan.grid <= SMS or plan.splits == 1)
    assert plan.tiles_per_block == -(-q_tiles // plan.splits)
    # TMA boxes (64, 1, 64, 1) for Q and (64, 1, 80, 1) for K and V.
    assert max(64, plan.key_tile) <= 256


def test_xattn_plan_sizes_the_key_tile_to_sk():
    assert [xattn_plan(2, 1000, sk, 8, 40).key_tile for sk in (1, 8, 32, 33, 77, 80, 81, 128)] \
        == [32, 32, 32, 80, 80, 80, 128, 128]
    assert [xattn_plan(b, 4096, 77, 8, 40).grid for b in (16, 4, 2, 1)] == [128, 128, 128, 128]
    # One stage a consumer where two do not fit beside 128 keys of d = 160.
    assert xattn_plan(2, 1000, 128, 8, 160).stages == 2


def _xattn_runs(plan, q_tiles, bh_count):
    """Block i's (batch-head, [first tile, end)): run i % splits of head
    i // splits, each head's tiles cut at q_tiles * k // splits."""
    s = plan.splits
    return [(i // s, q_tiles * (i % s) // s, q_tiles * (i % s + 1) // s)
            for i in range(bh_count * s)]


@pytest.mark.parametrize("b,s,d", [(16, 4096, 40), (16, 1024, 80), (2, 4096, 40), (4, 1024, 80),
                                   (3, 300, 160)])
def test_xattn_blocks_take_every_tile_once(b, s, d):
    """The runs cover every (query tile, head, batch) once, with one head a
    block (K and V loaded once a block) and a head's runs balanced within
    one tile."""
    plan = xattn_plan(b, s, 77, 8, d)
    q_tiles = -(-s // 64)
    runs = _xattn_runs(plan, q_tiles, b * 8)
    assert len(runs) == plan.grid
    taken = sorted((bh, t) for bh, t0, t1 in runs for t in range(t0, t1))
    assert taken == [(bh, t) for bh in range(b * 8) for t in range(q_tiles)]
    sizes = [t1 - t0 for _, t0, t1 in runs]
    assert max(sizes) - min(sizes) <= 1 and max(sizes) == plan.tiles_per_block


def emulate_xattn(q, k, v, heads, scale):
    """The short-K kernel's walk: each block's run of 64-query tiles of one
    head, whose K and V it holds in key_tile rows and 64-column chunks
    (TMA's zeros past Sk and D); S over ksteps k16 steps, keys past Sk
    masked, P = exp2(S c - m c), the fp32 row sum, O = P V over the key
    tile."""
    b, sq, c = q.shape
    sk, d = k.shape[1], c // heads
    plan = xattn_plan(b, sq, sk, heads, d)
    kt, depth = plan.key_tile, 16 * plan.ksteps
    q_tiles = -(-sq // 64)
    qp = _heads(q, heads, q_tiles * 64, _cols(d))
    kp, vp = _heads(k, heads, kt, _cols(d)), _heads(v, heads, kt, _cols(d))
    cf = np.float32(scale * LOG2_E)
    out = np.zeros_like(qp)
    for bh, t0, t1 in _xattn_runs(plan, q_tiles, b * heads):
        kh, vh = kp[bh // heads, bh % heads], vp[bh // heads, bh % heads]
        for t in range(t0, t1):
            rows = slice(t * 64, t * 64 + 64)
            s = qp[bh // heads, bh % heads, rows, :depth] @ kh[:, :depth].T
            s[:, np.arange(kt) >= sk] = -np.inf
            p = np.exp2(s * cf - (s.max(-1) * cf)[:, None])
            out[bh // heads, bh % heads, rows] = (p @ vh) / p.sum(-1)[:, None]
    return _packed(out, sq, d)


@pytest.mark.parametrize("sq,sk,d", [(4096, 77, 40), (1000, 77, 80), (300, 128, 160),
                                     (130, 1, 40), (700, 8, 80), (64, 33, 160)])
def test_xattn_tiles_are_the_plain_function(sq, sk, d):
    """Ragged query counts, each key tile; 3 heads, each split into runs.
    fp32, where the plain version's two roundings to the operands' dtype
    are no-ops."""
    heads = 3
    q, k, v = _inputs(1, sq, sk, heads, d, seed=sq + sk)
    got = emulate_xattn(q, k, v, heads, d**-0.5)
    ref = cross_attention_shortk_plain(*(torch.from_numpy(x) for x in (q, k, v)), heads)
    assert _rel_l2(got, ref.numpy()) <= 1e-5


@pytest.mark.parametrize("name", ["gmdx_xattn", "gmdx_xattn_plan", "gmdx_group_norm_silu",
                                  "gmdx_group_norm_plan"])
def test_rebuilt_kernels_ctypes_signatures_match_the_c_sources(name):
    """The ctypes argtypes of the short-K and GroupNorm entry points
    (_build.ENTRY_POINTS) against their C parameters one for one."""
    import ctypes

    from gmdx_torch.kernels import _build

    lib, argtypes = _build.ENTRY_POINTS[name]
    source, params = _c_entry_points()[name]
    want = [ctypes.c_void_p if "*" in p else ctypes.c_float if p.startswith("float")
            else ctypes.c_int for p in params]
    assert (lib, argtypes) == (source, want)


# The 512-wide kernels' shapes: Stage 1 at 1024^2 (batch 1) and 768^2 (batch
# 4), the HDRTV decode's batched SDR + GM (batch 2), one head; and ragged
# ones.
WIDE_PATH_SHAPES = [(1, 16384, 16384), (2, 16384, 16384), (4, 9216, 9216)]
WIDE_RAGGED_SHAPES = [(2, 100, 77), (2, 4096, 4000), (2, 33, 16400), (1, 1, 1), (3, 129, 127)]


@pytest.mark.parametrize("b,sq,sk", WIDE_PATH_SHAPES + WIDE_RAGGED_SHAPES)
def test_wide_plans_fit_the_card(b, sq, sk):
    """Each 512-wide plan fits 232,448 bytes with its mbarriers, its two
    16 KB exchange buffers and its lse/dd rows, with at least two stages;
    its boxes are whole 64-column boxes of 128 or its tile's rows (at most
    256), every shared-memory tile 1024-byte aligned, and its cluster pairs
    the two 256-column halves of the head."""
    plans = (wide_fwd_plan(b, sq, sk, 1), *wide_bwd_plans(b, sq, sk, 1))
    assert [p.tile for p in plans] == [64, 64, 32, 32]
    for p in plans:
        assert p.smem_bytes <= SMEM_BUDGET and p.stages >= 2, p
        assert p.cluster == 2 and 512 // p.cluster % BOX_COLS == 0
        assert p.owned == 128 and 1 <= p.tile <= 256
        assert (4 * p.owned * 128) % 1024 == 0 and (2 * 4 * p.tile * 128) % 1024 == 0
        # Each consumer thread exchanges 32 fp32 partials: S (or S^T) of
        # 64 columns, or S and dP of 32.
        assert (2 if p.tile == 32 else 1) * p.tile // 2 == 32
        assert p.grid[0] % p.cluster == 0 and p.grid[1:] == (1, b)


@pytest.mark.parametrize("b,sq,sk", WIDE_PATH_SHAPES + WIDE_RAGGED_SHAPES)
def test_wide_clusters_cover_every_row_once(b, sq, sk):
    """Cluster i // 2 of each kernel owns rows [128 (i // 2), + 128) of the
    queries (forward, dQ) or keys (dV, dK) of its (head, batch): together
    the clusters take every row once, and the streamed tiles cover the
    other side."""
    plans = dict(zip(("fwd", "dv", "dk", "dq"), (wide_fwd_plan(b, sq, sk, 1),
                                                 *wide_bwd_plans(b, sq, sk, 1))))
    for kind, p in plans.items():
        owned_rows, streamed = (sk, sq) if kind in ("dv", "dk") else (sq, sk)
        taken = np.zeros(owned_rows, int)
        for cta in range(p.grid[0]):
            lo = cta // p.cluster * p.owned
            if cta % p.cluster == 0:  # both CTAs of a cluster hold the same rows
                taken[lo:lo + p.owned] += 1
        assert taken.min() == taken.max() == 1, kind
        assert (p.grid[0] // p.cluster - 1) * p.owned < owned_rows <= p.grid[0] // p.cluster * p.owned
        tiles = -(-streamed // p.tile)
        assert (tiles - 1) * p.tile < streamed <= tiles * p.tile
