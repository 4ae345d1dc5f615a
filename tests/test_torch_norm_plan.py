"""The GroupNorm kernels' launch plans and their walks, on the CPU.

``csrc/groupnorm.cu`` runs the forward as ``gmdx_torch/kernels/groupnorm.py:
group_norm_plan`` lays it out: one thread-block cluster an image, each CTA a
contiguous pixel slice resident in shared memory, where it fits; else the
stats + apply pair. These tests hold the plan at every GroupNorm shape of
the four paths (``tests/test_torch_card.py`` holds it to the kernel's own
on the card), and replay the kernel's sums in numpy as the plan cuts them:
per-thread strided sums about each group's first element, the fixed-order
fold of each block, the rank-order fp64 combine, the apply with its border.
The replay is held to the plain version and to the JAX package's Pallas
kernels in interpret mode.

The backward (``group_norm_bwd_plan``, one cooperative launch of
``gn_bwd_kernel``) is held the same way: its plan at every GroupNorm shape
of the Stage-2 step at batches 1, 2 and 8, and a numpy replay of its walk -
per-thread strided sums, the block's fixed-order fold, the group fold over
the ranges, dx walked back, the dtemb fold over each image's ranges and the
dgamma / dbeta fold over every tile (each in fold8's fixed order) - against
``group_norm_silu_bwd_plain`` and ``_gn_backward`` in interpret mode.
"""

import functools

import numpy as np
import pytest
import torch

from gmdx_torch.kernels.groupnorm import (
    CLUSTERS, FORMS, LOAD_PIECES, MAX_GROUPS, NUM_SMS, RESIDENT_CLUSTERS, SMEM_BUDGET, WAVE_BYTES,
    GroupNormBwdPlan, _bwd_resident, _pair_plan, _splits, _threads, group_norm_bwd_plan,
    group_norm_plan, group_norm_silu_bwd_plain, group_norm_silu_plain,
)

BATCHES = (1, 2, 8, 16)


def _gn_calls(lat: int, decoder: bool = True, encoder: bool = True) -> list[tuple[int, int, int]]:
    """(H, W, C) of every GroupNorm call of the SD-1.5 UNet at ``lat``^2
    latents and of the VAE decoder from them and the encoder at 8 * lat,
    in call order, from forwards on the meta device."""
    from gmdx_torch.models import (
        SD15_UNET_CONFIG, SD15_VAE_CONFIG, AutoencoderKL, UNet2DConditionModel,
    )
    from gmdx_torch.models.layers import GroupNorm

    calls = []

    def hook(mod, args):
        calls.append(tuple(args[0].shape[1:]))

    with torch.device("meta"), torch.no_grad():
        unet = UNet2DConditionModel(SD15_UNET_CONFIG)
        vae = AutoencoderKL(SD15_VAE_CONFIG)
        for m in (*unet.modules(), *vae.modules()):
            if isinstance(m, GroupNorm):
                m.register_forward_pre_hook(hook)
        unet(torch.empty(2, lat, lat, 4), 500, torch.empty(2, 77, 768), channels_last=True)
        if decoder:
            vae.decode(torch.empty(1, 4, lat, lat))
        if encoder:
            vae.encode(torch.empty(1, 3, 8 * lat, 8 * lat))
    return calls


@functools.lru_cache(maxsize=None)
def _path_shapes() -> tuple[tuple[int, int, int], ...]:
    return tuple(sorted({s for lat in (64, 128) for s in _gn_calls(lat)}))


def _fitting(h, w, c) -> list[int]:
    """The cluster sizes whose slice fits shared memory beside the scratch
    (the plan's arithmetic, restated)."""
    threads = (c // 8) * max(1, 512 // (c // 8))
    fixed = 64 * threads + 4 * MAX_GROUPS * 4 + LOAD_PIECES * 8
    return [n for n in CLUSTERS if n <= h * w and -(-h * w // n) * c * 2 + fixed <= SMEM_BUDGET]


@pytest.mark.parametrize("b", BATCHES)
def test_plan_at_every_path_shape(b):
    for h, w, c in _path_shapes():
        plan = group_norm_plan(b, h, w, c)
        assert plan.smem_bytes <= SMEM_BUDGET and plan.cluster in CLUSTERS
        assert plan.threads <= 1024 and plan.threads % (c // 8) == 0
        fitting = _fitting(h, w, c)
        assert (plan.form == "resident") == bool(fitting), (h, w, c, plan)
        if plan.form == "pair":
            assert plan.cluster == 1 and plan.grid == (_splits(b, h * w, c), b)
            assert h * w <= plan.grid[0] * plan.pixels  # the last blocks may be empty
            continue
        n = plan.cluster
        assert plan.grid == (n, b)
        # The slices cover the image, none of them empty.
        assert (n - 1) * plan.pixels < h * w <= n * plan.pixels
        # Resident: the fitting cluster size with the least waves (of the
        # clusters resident at once) times a CTA's slice bytes and a wave's
        # fixed cost, the smaller on a tie.
        cost = {m: -(-b // RESIDENT_CLUSTERS[m]) * (-(-h * w // m) * c * 2 + WAVE_BYTES)
                for m in fitting}
        assert n == min(fitting, key=lambda m: (cost[m], m))
        assert plan.smem_bytes == (64 * plan.threads + 4 * MAX_GROUPS * 4 + 8 * LOAD_PIECES
                                   + plan.pixels * c * 2)


def test_the_512_unet_call_is_resident_where_it_fits():
    """57 of the 61 GroupNorm calls of one 512^2 UNet call fit 16 CTAs'
    shared memory and take the cluster kernel at the serving batch; the
    other four (64^2 x 640 twice, 64^2 x 960, 32^2 x 1920) the pair."""
    calls = _gn_calls(64, decoder=False, encoder=False)
    assert len(calls) == 61
    forms = [group_norm_plan(16, h, w, c).form for h, w, c in calls]
    assert forms.count("resident") == 57
    rest = sorted(s for s, f in zip(calls, forms) if f != "resident")
    assert rest == [(32, 32, 1920), (64, 64, 640), (64, 64, 640), (64, 64, 960)]
    assert {f for f in forms if f != "resident"} == {"pair"}


@pytest.mark.parametrize("b,h,w,c,form,n", [
    (132, 8, 8, 64, "resident", 1), (60, 8, 8, 64, "resident", 2), (30, 8, 8, 64, "resident", 4),
    (16, 8, 8, 1280, "resident", 4), (16, 16, 16, 1280, "resident", 4),
    (8, 8, 8, 1280, "resident", 8), (8, 32, 32, 640, "resident", 8),
    (16, 32, 32, 640, "resident", 16), (16, 16, 16, 2560, "resident", 16),
    (16, 64, 64, 320, "resident", 16), (16, 64, 64, 640, "pair", 1),
    (8, 256, 256, 256, "pair", 1), (2, 512, 512, 128, "pair", 1),
    (2, 128, 128, 320, "pair", 1),
])
def test_plan_forms_and_cluster_sizes(b, h, w, c, form, n):
    plan = group_norm_plan(b, h, w, c)
    assert (plan.form, plan.cluster) == (form, n)
    assert plan.c_fields()[:2] == [FORMS.index(form), n]


@pytest.mark.parametrize("b,n", [(8, 8), (16, 4)])
def test_a_batch_runs_in_one_wave_where_it_can(b, n):
    """The Stage-2 batch 8 fits one wave of 8-CTA clusters (15 resident at
    once, 7 of 16), the CFG batch 16 one wave of 4-CTA clusters (30): the
    plan takes that n wherever n CTAs hold the image of a 512^2 UNet
    GroupNorm, 8^2 x 1280 among them, not the two or three waves of 16."""
    shapes = set(_gn_calls(64, decoder=False, encoder=False))
    held = [s for s in shapes if n in _fitting(*s)]
    assert (8, 8, 1280) in held and len(held) >= 4
    for h, w, c in held:
        assert group_norm_plan(b, h, w, c).cluster == n, (h, w, c)
    assert b <= RESIDENT_CLUSTERS[n] and b > RESIDENT_CLUSTERS[16]


def emulate_group_norm(x, scale, bias, temb, num_groups, eps, activate, pad, plan):
    """The kernel's arithmetic in numpy, as ``plan`` cuts it: every thread
    (an 8-channel chunk, pixel row k of R) sums x + t - shift and its square
    in fp32 over its slice's pixels k, k + R, ... (a resident slice in its
    LOAD_PIECES pieces, each walk restarting at the piece); each block folds
    those over the rows per channel, then over each group's channels, in
    fp32; the slices' partials are combined in order in fp64."""
    b, h, w, c = x.shape
    hw, cg = h * w, c // num_groups
    rows = plan.threads // (c // 8)
    xs = x.reshape(b, hw, c).astype(np.float32)
    t = np.zeros((b, c), np.float32) if temb is None else temb.astype(np.float32)
    first = np.arange(c) // cg * cg
    shift = xs[:, 0, first] + t[:, first]
    d = xs + t[:, None, :] - shift[:, None, :]
    nslices = plan.grid[0]
    tot = np.zeros((2, b, num_groups), np.float64)
    for r in range(nslices):
        p0 = min(r * plan.pixels, hw)
        p1 = min(p0 + plan.pixels, hw)
        np_ = p1 - p0
        if plan.form == "resident":
            piece = -(-np_ // LOAD_PIECES)
            walks = [(min(k * piece, np_), min(k * piece + piece, np_)) for k in range(LOAD_PIECES)]
        else:
            walks = [(0, np_)]
        acc = np.zeros((2, rows, b, c), np.float32)
        for q0, q1 in walks:
            for k in range(rows):
                for p in range(q0 + k, q1, rows):
                    v = d[:, p0 + p]
                    acc[0, k] += v
                    acc[1, k] += v * v
        chan = acc[:, 0].copy()
        for k in range(1, rows):
            chan += acc[:, k]
        grp = np.zeros((2, b, num_groups), np.float32)
        for j in range(cg):
            grp += chan[:, :, j::cg]
        tot += grp.astype(np.float64)
    n = float(hw * cg)
    md = tot[0] / n
    var = np.maximum(tot[1] / n - md * md, 0.0)
    mean = md.astype(np.float32) + shift[:, ::cg]
    rstd = (1.0 / np.sqrt(var.astype(np.float32) + np.float32(eps))).astype(np.float32)
    sc = np.repeat(rstd, cg, axis=1) * scale[None]
    sh = (t - np.repeat(mean, cg, axis=1)) * sc + bias[None]
    z = xs * sc[:, None, :] + sh[:, None, :]
    y = (z / (1.0 + np.exp(-z)) if activate else z).reshape(b, h, w, c)
    if pad:
        y = np.pad(y, ((0, 0), (1, 1), (1, 1), (0, 0)))
    return y, np.stack([mean, rstd], 1)


# (B, H, W, C, temb, activate, pad): tiny images whose cluster slices hold 4
# and 16 pixels (C = 64: chunk rows 64; C = 32: 128).
WALK_CASES = [(2, 8, 8, 64, False, True, True), (2, 8, 8, 64, True, True, True),
              (2, 16, 16, 32, False, False, False), (2, 16, 16, 32, True, True, True)]


def _inputs(b, h, w, c, temb, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, h, w, c)) * 2.0 + 0.5).astype(np.float32)
    scale = (1.0 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.2 * rng.standard_normal(c)).astype(np.float32)
    t = rng.standard_normal((b, c)).astype(np.float32) if temb else None
    return x, scale, bias, t


@functools.lru_cache(maxsize=None)
def _jax_reference(case):
    """The JAX package's kernels in interpret mode on the case's inputs:
    fused_group_norm_silu without temb, parity_gn_pad_silu (through the
    parity layout) with it."""
    import jax.numpy as jnp

    from gmdx.kernels.groupnorm import fused_group_norm_silu, parity_gn_pad_silu
    from gmdx.kernels.winograd import nhwc_to_parity5, parity5_to_nhwc

    b, h, w, c, temb, act, pad = case
    x, scale, bias, t = _inputs(b, h, w, c, temb, seed=c + h)
    if temb:
        assert act and pad
        out5 = parity_gn_pad_silu(
            nhwc_to_parity5(jnp.asarray(x)), jnp.asarray(scale), jnp.asarray(bias),
            jnp.asarray(t), num_groups=32, eps=1e-5, activate=True, interpret=True,
        )
        return np.asarray(parity5_to_nhwc(out5))
    return np.asarray(fused_group_norm_silu(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), num_groups=32, eps=1e-5,
        activate=act, interpret=True, pad_output=pad,
    ))


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("case", WALK_CASES)
def test_cluster_walk_is_the_plain_function_and_the_jax_kernels(case, form):
    b, h, w, c, temb, act, pad = case
    x, scale, bias, t = _inputs(b, h, w, c, temb, seed=c + h)
    plan = group_norm_plan(b, h, w, c) if form == "resident" else _pair_plan(b, h * w, c)
    if form != "pair":
        assert plan.form == form and plan.cluster == 16 and plan.pixels == h * w // 16
    got, stats = emulate_group_norm(x, scale, bias, t, 32, 1e-5, act, pad, plan)
    want, want_stats = group_norm_silu_plain(
        *(torch.from_numpy(a) if a is not None else None for a in (x, scale, bias, t)),
        eps=1e-5, activate=act, pad_output=pad, return_stats=True,
    )
    assert float(np.abs(got - want.numpy()).max()) <= 1e-4
    assert float(np.abs(stats - want_stats.numpy()).max()) <= 1e-4
    assert float(np.abs(got - _jax_reference(case)).max()) <= 1e-4


# ---------------------------------------------------------------------------
# the backward
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _stage2_shapes() -> tuple[tuple[int, int, int], ...]:
    """(H, W, C) of the GroupNorms of the Stage-2 step: the 512^2 UNet's."""
    return tuple(sorted(set(_gn_calls(64, decoder=False, encoder=False))))


@pytest.mark.parametrize("b", (1, 2, 8))
def test_bwd_plan_at_every_stage2_shape(b):
    """Every block resident at once (the grid barrier's condition), the
    image's pixels cut into equal contiguous ranges, none empty, no more
    ranges than the rows of threads need, and as many blocks as the card
    holds where the pixels allow."""
    shapes = _stage2_shapes()
    assert (16, 16, 2560) in shapes and (64, 64, 320) in shapes
    for h, w, c in shapes:
        plan = group_norm_bwd_plan(b, h, w, c)
        splits, images = plan.grid
        hw, rows = h * w, plan.threads // (c // 8)
        cap = plan.resident * NUM_SMS
        assert plan.threads == _threads(c) <= 512 and plan.resident == _bwd_resident(plan.threads)
        assert plan.resident >= 1 and splits * images <= cap, (h, w, c, plan)
        assert images == b
        assert (splits - 1) * plan.pixels < hw <= splits * plan.pixels
        assert splits <= -(-hw // rows)
        want = min(cap // b, -(-hw // rows))
        assert splits == -(-hw // -(-hw // want))  # the rule's split count, trimmed of empties
        assert plan.smem_bytes == 64 * plan.threads + 2 * MAX_GROUPS * 4 <= 48 * 1024
        assert plan.c_fields() == [splits, images, plan.pixels, plan.threads, plan.smem_bytes,
                                   plan.resident, NUM_SMS]


@pytest.mark.parametrize("b,h,w,c", [(300, 8, 8, 1280), (2, 1, 1, 8), (1, 3, 5, 4096)])
def test_bwd_plan_tails(b, h, w, c):
    """More images than blocks: one range an image, each block row takes
    several images; a one-pixel image; the widest C."""
    plan = group_norm_bwd_plan(b, h, w, c)
    splits, images = plan.grid
    assert splits * images <= plan.resident * NUM_SMS and images <= b
    assert (splits - 1) * plan.pixels < h * w <= splits * plan.pixels
    if b > plan.resident * NUM_SMS:
        assert splits == 1 and images == plan.resident * NUM_SMS


def _fold8(vals: np.ndarray) -> np.ndarray:
    """The kernel's fold of partials vals[0..n) in fp64 (fold8): four
    lanes sum parts k, k + 4, ... in order, then two shuffle steps add
    them as (S0 + S1) + (S2 + S3)."""
    lanes = np.zeros((4,) + vals.shape[1:], np.float64)
    for p in range(vals.shape[0]):
        lanes[p % 4] += vals[p]
    return (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])


def emulate_group_norm_bwd(x, scale, bias, temb, stats, g, num_groups, activate, pad, plan):
    """The backward kernel's arithmetic in numpy as ``plan`` cuts it, tile by
    tile (image b, range s): thread row k of R sums dy and dy * xhat over
    pixels k, k + R, ... of the range in fp32 (xhat and the pre-activation y
    as affine maps of x, and dx = dy ya - (x dp + dq), as the kernel takes
    them); the block folds those over
    the rows per channel, then gamma-weighted over each group's channels;
    after the barrier each image's group partials are folded over its
    ranges; dx is walked back from each row's last pixel, its per-channel
    sum folded over the rows and, once all its ranges arrived, over them;
    dgamma and dbeta fold every tile (each cross-block fold as fold8
    takes it: four strided lane sums in fp64, then two shuffle steps)."""
    f32 = np.float32
    b, h, w, c = x.shape
    hw, cg = h * w, c // num_groups
    splits, rows = plan.grid[0], plan.threads // (c // 8)
    grp = np.arange(c) // cg
    t = np.zeros((b, c), f32) if temb is None else temb.astype(f32)
    rs = stats[:, 1][:, grp].astype(f32)
    shr = ((t - stats[:, 0][:, grp]) * rs).astype(f32)
    xs = x.reshape(b, hw, c).astype(f32)
    gs = (g[:, 1:-1, 1:-1] if pad else g).reshape(b, hw, c).astype(f32)
    ya, yb = rs * scale, shr * scale + bias  # y = x ya + yb, the forward's pre-activation
    xh = xs * rs[:, None] + shr[:, None]
    dy = gs
    if activate:
        y = xs * ya[:, None] + yb[:, None]
        sig = f32(1.0) / (f32(1.0) + np.exp(-y))
        dy = gs * (sig * (y * (f32(1.0) - sig) + f32(1.0)))
    ranges = [(s * plan.pixels, min(s * plan.pixels + plan.pixels, hw)) for s in range(splits)]
    chpart = np.zeros((b, splits, 2, c), f32)
    grpart = np.zeros((b, splits, 2, num_groups), f32)
    for bi in range(b):
        for s, (p0, p1) in enumerate(ranges):
            acc = np.zeros((2, rows, c), f32)
            for k in range(rows):
                for p in range(p0 + k, p1, rows):
                    acc[0, k] += dy[bi, p]
                    acc[1, k] += dy[bi, p] * xh[bi, p]
            chan = acc[:, 0].copy()
            for k in range(1, rows):
                chan += acc[:, k]
            chpart[bi, s] = chan
            for j in range(cg):
                grpart[bi, s] += scale[j::cg] * chan[:, j::cg]
    dx = np.zeros((b, hw, c), f32)
    dtemb = np.zeros((b, c), f32)
    for bi in range(b):
        m = (_fold8(grpart[bi]) * (1.0 / (hw * cg))).astype(f32)
        m1, m2 = m[0][grp], m[1][grp]
        dp, dq = rs[bi] * rs[bi] * m2, rs[bi] * (shr[bi] * m2 + m1)
        tpart = np.zeros((splits, c), f32)
        for s, (p0, p1) in enumerate(ranges):
            dt = np.zeros((rows, c), f32)
            for k in range(rows):
                for p in reversed(range(p0 + k, p1, rows)):
                    d = dy[bi, p] * ya[bi] - (xs[bi, p] * dp + dq)
                    dx[bi, p] = d
                    dt[k] += d
            tpart[s] = dt[0]
            for k in range(1, rows):
                tpart[s] += dt[k]
        dtemb[bi] = _fold8(tpart)
    sums = _fold8(chpart.reshape(b * splits, 2, c)).astype(f32)
    return dx.reshape(b, h, w, c), sums[1], sums[0], dtemb if temb is not None else None


# (temb, activate, pad) at B = 2, 8^2 x 64: the resnet norm2 (temb, SiLU,
# padded), norm1 (SiLU, padded), the transformer's GN (neither).
BWD_CASES = [(False, True, False), (False, False, False), (True, True, True),
             (False, True, True)]


def _bwd_inputs(temb, seed=7):
    rng = np.random.default_rng(seed)
    x, scale, bias, t = _inputs(2, 8, 8, 64, temb, seed)
    return x, scale, bias, t, rng.standard_normal((2, 10, 10, 64)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_bwd_reference(temb, activate):
    """_gn_backward in interpret mode from the JAX forward's statistics; the
    JAX package adds temb outside its kernels, so it normalises x + temb and
    dtemb is its dx summed over the pixels."""
    import jax
    import jax.numpy as jnp

    from gmdx.kernels.groupnorm import _gn_backward, _gn_forward

    x, scale, bias, t, gp = _bwd_inputs(temb)
    xs = x + t[:, None, None, :] if temb else x
    with jax.default_matmul_precision("highest"):
        args = (jnp.asarray(xs), jnp.asarray(scale), jnp.asarray(bias))
        _, jstats = _gn_forward(*args, 32, 1e-5, activate, True)
        dx, dscale, dbias = _gn_backward(*args, jstats, jnp.asarray(gp[:, 1:-1, 1:-1]), 32, 1e-5,
                                         activate, True)
    dx = np.asarray(dx)
    return dx, np.asarray(dscale), np.asarray(dbias), dx.sum(axis=(1, 2)) if temb else None


def _close(got, want, tol=1e-4):
    """Max abs error within tol of the larger of 1 and the reference's peak."""
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()) <= tol * max(
        1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("cut", ["plan", "split"])
@pytest.mark.parametrize("temb,activate,pad", BWD_CASES)
def test_bwd_walk_is_the_plain_function_and_the_jax_kernels(temb, activate, pad, cut):
    """The replay as the plan cuts 2 x 8^2 x 64 (one range an image: 512
    threads, 64 rows) and as a five-range cut with three rows of threads
    (ranges of 13 pixels, the last 12, rows with 4 or 5 pixels each), held
    to the plain version and to _gn_backward, max abs error 1e-4 of the
    peak (fp32 on every side, sums in other orders)."""
    x, scale, bias, t, gp = _bwd_inputs(temb)
    g = gp if pad else np.ascontiguousarray(gp[:, 1:-1, 1:-1])
    plan = group_norm_bwd_plan(2, 8, 8, 64)
    if cut == "split":
        plan = GroupNormBwdPlan((5, 2), 13, 24, 64 * 24 + 2 * MAX_GROUPS * 4, 1)
    else:
        assert plan.grid == (1, 2) and plan.threads == 512
    tt = [torch.from_numpy(a) if a is not None else None for a in (x, scale, bias, t)]
    _, stats = group_norm_silu_plain(*tt, eps=1e-5, activate=activate, pad_output=pad,
                                     return_stats=True)
    got = emulate_group_norm_bwd(x, scale, bias, t, stats.numpy(), g, 32, activate, pad, plan)
    want = group_norm_silu_bwd_plain(*tt, stats, torch.from_numpy(g), activate=activate,
                                     pad_output=pad)
    jax_want = _jax_bwd_reference(temb, activate)
    for a, p, j in zip(got, want, jax_want):
        assert (a is None) == (p is None) == (j is None)
        if a is not None:
            assert _close(a, p.numpy()) and _close(a, j)
