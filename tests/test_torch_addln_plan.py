"""The add + LayerNorm kernel's launch plan and its ring walk, on the CPU.

``csrc/add_ln.cu`` runs as ``gmdx_torch/kernels/geglu_ff.py:
add_layer_norm_plan`` lays it out: persistent blocks over tiles of whole
rows, each tile one bulk copy of x and one of y into a ring of stages, a row
taken by L lanes of K 8-channel chunks, the tile's s and h stored by bulk
copies from one of two output stages. These tests hold the plan at the four
shapes of the single-UNet SDR->HDR path and at its tails
(``tests/test_torch_card.py`` holds it to the kernel's own on the card), and
replay the walk in numpy: every block's tiles, every row's lane sums and
shuffle trees. The replay is held to ``add_layer_norm_plain`` and to the JAX
package's ``add_layer_norm`` in interpret mode.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from gmdx_torch.kernels.geglu_ff import (
    ADD_LN_BLOCKS_PER_SM, ADD_LN_MAX_DIM, ADD_LN_OUT_STAGES, ADD_LN_STAGES, ADD_LN_TILE_BYTES,
    ADD_LN_WARPS, NUM_SMS, SM_SMEM, add_layer_norm_plain, add_layer_norm_plan,
)

SMEM_BUDGET = 232448  # the dynamic shared memory a block may use
# (CFG batch, tokens, C) of the four add + LN shapes of a GM-UNet call at
# 512^2 (64^2, 32^2, 16^2 and the 8^2 mid block).
SDR2HDR_SHAPES = [(16, 4096, 320), (16, 1024, 640), (16, 256, 1280), (16, 64, 1280)]


def _lanes(c: int) -> tuple[int, int]:
    """(L lanes a row, K chunks a lane): exact at 320, 640, 1280; the
    generic instance's 32 x 8 behind a guard elsewhere."""
    return {320: (8, 5), 640: (16, 5), 1280: (32, 5)}.get(c, (32, ADD_LN_MAX_DIM // 256))


def _smem(rows: int, c: int) -> int:
    return (2 * (ADD_LN_STAGES + ADD_LN_OUT_STAGES) * rows * c * 2 + 2 * c * 4
            + (2 * ADD_LN_STAGES + 1) * 8)


@pytest.mark.parametrize("b,s,c", SDR2HDR_SHAPES)
def test_plan_at_the_sdr2hdr_shapes(b, s, c):
    """Tiles of exactly ADD_LN_TILE_BYTES a tensor, one pass of the four
    consumer warps (32 / L rows each), two blocks an SM, as many blocks as
    tiles up to two an SM."""
    m = b * s
    plan = add_layer_norm_plan(m, c)
    lanes, chunks = _lanes(c)
    assert plan.rows * c * 2 == ADD_LN_TILE_BYTES and lanes * chunks * 8 == c
    assert plan.rows == ADD_LN_WARPS * (32 // lanes)
    assert plan.per_sm == ADD_LN_BLOCKS_PER_SM
    assert plan.blocks == min(-(-m // plan.rows), ADD_LN_BLOCKS_PER_SM * NUM_SMS)
    assert plan.smem_bytes == _smem(plan.rows, c) <= SMEM_BUDGET
    assert plan.per_sm * (plan.smem_bytes + 1024) <= SM_SMEM
    assert (plan.threads, plan.stages) == ((ADD_LN_WARPS + 1) * 32, ADD_LN_STAGES)
    assert plan.c_fields() == [plan.rows, plan.stages, plan.blocks, plan.threads,
                               plan.smem_bytes, NUM_SMS]


@pytest.mark.parametrize("m,c", [(1, 320), (15, 320), (31, 320), (7, 640), (1, 1280),
                                 (1, 8), (639, 8), (1, 2048), (3, 2048), (9, 24)])
def test_plan_tails(m, c):
    """One row; one short of a tile or of two; C = 8 (640-row tiles) and
    2048 (one block an SM): the tiles cover the rows, the last short tile
    is whole rows of 16-byte multiples, and shared memory holds the plan."""
    plan = add_layer_norm_plan(m, c)
    tiles = -(-m // plan.rows)
    last = m - (tiles - 1) * plan.rows
    assert 0 < last <= plan.rows and (last * c * 2) % 16 == 0
    assert plan.rows % ADD_LN_WARPS == 0
    assert plan.blocks == min(tiles, plan.per_sm * NUM_SMS)
    assert plan.smem_bytes == _smem(plan.rows, c) <= SMEM_BUDGET
    assert plan.per_sm == min(ADD_LN_BLOCKS_PER_SM, SM_SMEM // (plan.smem_bytes + 1024)) >= 1
    if c == ADD_LN_MAX_DIM:
        assert plan.per_sm == 1


def _round(a: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    return torch.from_numpy(a).to(dtype).float().numpy()


def _tree(vals, lanes: int) -> np.float32:
    """An xor shuffle tree over ``lanes`` lanes' values; lane 0's result."""
    v = np.asarray(vals, np.float32)
    o = lanes // 2
    while o:
        v = v + v[np.arange(lanes) ^ o]
        o //= 2
    return v[0]


def _lane_sum(a: np.ndarray) -> np.float32:
    """A lane's running fp32 sum of its values in order (0 for none)."""
    return np.cumsum(a, dtype=np.float32)[-1] if a.size else np.float32(0)


def emulate_add_ln(x, y, gamma, beta, eps, plan, dtype):
    """The kernel's arithmetic in numpy as ``plan`` cuts it: block k takes
    tiles k, k + blocks, ... (tile i of a block in ring stage i % stages and
    output stage i % 2); each tile's rows, a short last one included, are
    taken by L lanes, lane l summing s = x + y (rounded to ``dtype``) over
    its chunks l, l + L, ... in fp32, the lanes then folded by an xor
    shuffle tree; the centred squares the same way; h rounded to
    ``dtype``. Returns (s, h) and each tile's (block, ring stage, output
    stage)."""
    f32 = np.float32
    m, c = x.shape
    lanes, k_chunks = _lanes(c)
    assert -(-(c // 8) // lanes) <= k_chunks  # a lane's chunks fit its registers
    s = _round(x + y, dtype)
    h = np.full((m, c), np.nan, f32)
    walk = {}
    tiles = -(-m // plan.rows)
    for blk in range(plan.blocks):
        for i, t in enumerate(range(blk, tiles, plan.blocks)):
            assert t not in walk
            walk[t] = (blk, i % plan.stages, i % ADD_LN_OUT_STAGES)
            for r in range(t * plan.rows, min(t * plan.rows + plan.rows, m)):
                own = [np.concatenate([s[r, 8 * j:8 * j + 8] for j in range(li, c // 8, lanes)]
                                      + [np.zeros(0, f32)]) for li in range(lanes)]
                mean = _tree([_lane_sum(o) for o in own], lanes) / f32(c)
                sq = _tree([_lane_sum((o - mean) * (o - mean)) for o in own], lanes)
                rstd = f32(1.0) / np.sqrt(sq / f32(c) + f32(eps))
                h[r] = ((s[r] - mean) * rstd) * gamma + beta
    assert sorted(walk) == list(range(tiles))
    return s, _round(h, dtype), walk


@functools.lru_cache(maxsize=None)
def _jax_reference(m, c):
    import jax.numpy as jnp

    from gmdx.kernels.geglu_ff import add_layer_norm as jax_add_layer_norm

    x, y, gamma, beta = _inputs(m, c)
    s, h = jax_add_layer_norm(*(jnp.asarray(a)[None] if a.ndim == 2 else jnp.asarray(a)
                                for a in (x, y, gamma, beta)), interpret=True)
    return np.asarray(s)[0], np.asarray(h)[0]


def _inputs(m, c, seed=3):
    rng = np.random.default_rng(seed + c)
    x, y = (_round(rng.standard_normal((m, c)).astype(np.float32), torch.bfloat16)
            for _ in range(2))
    gamma = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.2 * rng.standard_normal(c)).astype(np.float32)
    return x, y, gamma, beta


# (m, c, blocks): 37 rows of 320 in 3 tiles (the last of 5 rows) over 2
# blocks, so block 0 takes tiles 0 and 2 through two ring stages; 19 of 640
# (3 tiles, 3 rows last) on one block; 10 of 1280 over 2 blocks; the
# generic instance at C = 24 (4 x 53 rows a tile) over 2 blocks.
WALK_CASES = [(37, 320, 2), (19, 640, 1), (10, 1280, 2), (250, 24, 2)]


@pytest.mark.parametrize("m,c,blocks", WALK_CASES)
def test_ring_walk_is_the_plain_function_and_the_jax_kernel(m, c, blocks):
    """In fp32 (s not rounded) against add_layer_norm_plain and, at the
    JAX kernel's widths, _add_ln_pallas in interpret mode: relative L2 1e-5
    (sums in other orders). In bf16 against add_layer_norm_plain: s the same
    bits, h within one bf16 rounding."""
    x, y, gamma, beta = _inputs(m, c)
    plan = dataclasses.replace(add_layer_norm_plan(m, c), blocks=blocks)
    t = [torch.from_numpy(a) for a in (x, y, gamma, beta)]
    got_s, got_h, walk = emulate_add_ln(x, y, gamma, beta, 1e-5, plan, torch.float32)
    assert len({w[0] for w in walk.values()}) == blocks
    want = add_layer_norm_plain(*t)
    refs = [want] + ([_jax_reference(m, c)] if c in (320, 640, 1280) else [])
    for ref_s, ref_h in refs:
        for a, r in ((got_s, ref_s), (got_h, ref_h)):
            r = np.asarray(r, np.float64)
            assert np.linalg.norm(a - r) <= 1e-5 * np.linalg.norm(r)

    bf = [t[0].to(torch.bfloat16), t[1].to(torch.bfloat16), t[2], t[3]]
    s16, h16 = emulate_add_ln(x, y, gamma, beta, 1e-5, plan, torch.bfloat16)[:2]
    want_s, want_h = (a.float().numpy() for a in add_layer_norm_plain(*bf))
    assert np.array_equal(s16, want_s)
    assert np.all(np.abs(h16 - want_h) <= np.abs(want_h) * 2.0**-7 + 1e-6)
