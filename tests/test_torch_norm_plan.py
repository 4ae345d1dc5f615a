"""The GroupNorm forward's launch plan and its cluster walk, on the CPU.

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
"""

import functools

import numpy as np
import pytest
import torch

from gmdx_torch.kernels.groupnorm import (
    CLUSTERS, FORMS, LOAD_PIECES, MAX_GROUPS, RESIDENT_CLUSTERS, SMEM_BUDGET, WAVE_BYTES,
    _pair_plan, _splits, group_norm_plan, group_norm_silu_plain,
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
