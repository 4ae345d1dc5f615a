"""The launch plans of the Hopper GEMM core's kernels, on the CPU.

``csrc/conv3x3.cu``, ``csrc/geglu_ff.cu`` and ``csrc/winograd4.cu`` run what
``gmdx_torch/kernels/winograd.py:conv3x3_plan``,
``gmdx_torch/kernels/geglu_ff.py:geglu_ff_ln_plan`` and
``gmdx_torch/kernels/winograd.py:winograd4_plan`` lay out. These tests
hold the plans at every conv shape of the four paths and replay the
kernels' tile arithmetic in torch. Plain torch: no JAX, no card.
"""

import math

import pytest
import torch
import torch.nn.functional as F
from test_torch_attention_plan import _c_entry_points
from test_torch_card import CONV_SHAPES

from gmdx_torch.kernels.geglu_ff import (
    GEGLU_FF_KERNEL_DIMS, geglu_ff_ln_plan, geglu_ff_plain, geglu_ff_uses_kernel,
)
from gmdx_torch.kernels.winograd import (
    AT4, BT4, SMS, conv3x3_plain, conv3x3_plan, conv_route, pack_weight, pack_weight4,
    winograd4_conv3x3_plain, winograd4_plan,
)

# The headline batches of the four paths (PERF.md, section 4): the UNets at
# the CFG batch 16 (serving and sdr2hdr, batch 8) and 2 (hdrtv, one frame);
# the VAE decoder at 16 (8 SDR + 8 GM) and 2; the encoder at 8.
HEADLINE_BATCHES = (1, 2, 8, 16)


def _path_conv_shapes():
    """(H, C, O) of every Conv3x3 call of the SD-1.5 UNet at 64^2 and 128^2
    latents and of the VAE decoder and encoder at 512^2 and 1024^2, from
    forwards on the meta device (no memory, no arithmetic)."""
    from gmdx_torch.models import (
        SD15_UNET_CONFIG, SD15_VAE_CONFIG, AutoencoderKL, UNet2DConditionModel,
    )
    from gmdx_torch.models.layers import Conv3x3

    shapes = set()

    def hook(mod, args, kwargs):
        x = args[0]
        pre = kwargs.get("pre_padded", args[1] if len(args) > 1 else False)
        assert x.shape[1] == x.shape[2]
        shapes.add((x.shape[1] - 2 * pre, x.shape[3], mod.out_channels))

    with torch.device("meta"), torch.no_grad():
        unet = UNet2DConditionModel(SD15_UNET_CONFIG)
        vae = AutoencoderKL(SD15_VAE_CONFIG)
        for m in (*unet.modules(), *vae.modules()):
            if isinstance(m, Conv3x3):
                m.register_forward_pre_hook(hook, with_kwargs=True)
        for lat in (64, 128):
            unet(torch.empty(2, lat, lat, 4), 500, torch.empty(2, 77, 768), channels_last=True)
            vae.decode(torch.empty(1, 4, lat, lat))
            vae.encode(torch.empty(1, 3, 8 * lat, 8 * lat))
    return shapes


def test_card_list_is_every_path_conv_shape():
    assert _path_conv_shapes() == set(CONV_SHAPES)


@pytest.mark.parametrize("hw,c,o", CONV_SHAPES)
def test_conv_plan_takes_tma_boxes_at_path_shapes(hw, c, o):
    for b in HEADLINE_BATCHES:
        for pre in (True, False):
            plan = conv3x3_plan(b, hw, hw, c, o, pre)
            assert plan.route == "tma"
            bw, bh, bb = plan.box
            assert max(plan.block_k, bw, bh, bb) <= 256  # TMA box limit
            assert plan.block_k * 2 == 128  # one SWIZZLE_128B row
            assert bw * bh * bb == plan.block_m == 128
            # The box is the tile's pixels in M order: whole rows of one
            # image, or whole images.
            assert bw == hw or (bh == bb == 1 and hw % bw == 0)
            assert bb == 1 or bh == hw
            # Splits cut at slice boundaries, and no slice straddles a tap.
            assert plan.slices == 9 * c // 64
            assert plan.split * plan.slices_per_split >= plan.slices
            assert (plan.split - 1) * plan.slices_per_split < plan.slices
            assert c % plan.block_k == 0
            if b == 16 and hw <= 64:  # the 512^2 paths' CFG batch fills the SMs
                assert plan.units >= SMS, (hw, c, o, plan)
            if plan.m_tiles * plan.n_tiles >= SMS:
                assert plan.split == 1


def test_conv_plan_fills_the_8x8_level_with_a_split():
    plan = conv3x3_plan(16, 8, 8, 1280, 1280, True)
    assert plan.m_tiles * plan.n_tiles < SMS <= plan.units
    assert plan.split > 1


@pytest.mark.parametrize("b,h,w,c,o", [(2, 17, 17, 72, 40), (1, 12, 12, 64, 64), (2, 8, 8, 8, 8)])
def test_conv_plan_gathers_where_no_box_fits(b, h, w, c, o):
    assert conv3x3_plan(b, h, w, c, o).route == "gather"


def _emulate(x, wp, bias, plan):
    """The kernel's arithmetic: for each work unit, the A tile of each K
    slice is the TMA box at :meth:`ConvPlan.box_origin` with zero fill out
    of range, multiplied into an fp32 tile; splits are summed in order, then
    the bias is added."""
    bw, bh, bb = plan.box
    bk, bm = plan.block_k, plan.block_m
    b_in, h_in, w_in, c = x.shape
    k = 9 * c
    wpad = F.pad(wp, (0, plan.slices * bk - k))
    m = plan.b * plan.h * plan.w
    out = torch.zeros(plan.m_tiles * bm, plan.o)
    for mt in range(plan.m_tiles):
        partials = []
        for sp in range(plan.split):
            acc = torch.zeros(bm, plan.o)
            for s in range(sp * plan.slices_per_split,
                           min(plan.slices, (sp + 1) * plan.slices_per_split)):
                c0, x0, y0, b0 = plan.box_origin(mt, s)
                bs, ys, xs = (torch.arange(n) + o0 for n, o0 in ((bb, b0), (bh, y0), (bw, x0)))
                ok = ((bs < b_in)[:, None, None] & ((ys >= 0) & (ys < h_in))[None, :, None]
                      & ((xs >= 0) & (xs < w_in))[None, None, :])
                tile = x[bs.clamp(0, b_in - 1)][:, ys.clamp(0, h_in - 1)][
                    :, :, xs.clamp(0, w_in - 1), c0:c0 + bk] * ok[..., None]
                acc += tile.reshape(bm, bk) @ wpad[:, s * bk:(s + 1) * bk].t()
            partials.append(acc)
        out[mt * bm:(mt + 1) * bm] = sum(partials[1:], partials[0])
    return (out[:m] + bias).reshape(plan.b, plan.h, plan.w, plan.o)


@pytest.mark.parametrize("b,h,w,c,o,pre", [
    (3, 4, 4, 16, 8, False),   # W | tile: whole rows; 3 images, 3 tiles
    (3, 2, 4, 8, 8, True),     # W | tile, H*W | tile: 2 images a box; ragged last tile
    (2, 3, 32, 8, 16, False),  # tile | W: part of one row
    (1, 6, 8, 16, 24, True),   # 2 rows a tile
])
def test_box_emulation_reproduces_plain_conv(b, h, w, c, o, pre):
    """Integer-valued operands, so that every sum is exact in fp32: the
    emulated tiles must give conv3x3_plain's output bit for bit."""
    g = torch.Generator().manual_seed(0)
    x = torch.randint(-2, 3, (b, h, w, c), generator=g).float()
    if pre:
        x = F.pad(x, (0, 0, 1, 1, 1, 1))
    wp = pack_weight(torch.randint(-2, 3, (o, c, 3, 3), generator=g).float())
    bias = torch.randint(-3, 4, (o,), generator=g).float()
    plan = conv3x3_plan(b, h, w, c, o, pre, block_m=16, block_k=8)
    assert plan.route == "tma"
    got = _emulate(x, wp, bias, plan)
    assert torch.equal(got, conv3x3_plain(x, wp, bias, pre_padded=pre))


def test_box_emulation_covers_a_split():
    g = torch.Generator().manual_seed(1)
    x = F.pad(torch.randint(-2, 3, (1, 4, 4, 16), generator=g).float(), (0, 0, 1, 1, 1, 1))
    wp = pack_weight(torch.randint(-2, 3, (8, 16, 3, 3), generator=g).float())
    bias = torch.randint(-3, 4, (8,), generator=g).float()
    plan = conv3x3_plan(1, 4, 4, 16, 8, True, block_m=16, block_k=8)
    assert plan.split > 1  # one tile: the plan splits K to fill the SMs
    assert torch.equal(_emulate(x, wp, bias, plan), conv3x3_plain(x, wp, bias, pre_padded=True))


@pytest.mark.parametrize("dim", [320, 640, 1280])
def test_ff_plan_tiles(dim):
    inner = 4 * dim
    m = 16 * 4096 * 320 // dim  # the 512^2 UNet's tokens at CFG 16
    plan = geglu_ff_ln_plan(m, dim, inner)
    assert dim % plan["bn2"] == 0 and plan["bn2"] in (128, 160)
    m1, n1, k1 = plan["gemm1_tiles"]
    m2, n2, k2 = plan["gemm2_tiles"]
    assert m1 == m2 == math.ceil(m / 128)
    assert n1 * 64 == inner and k1 == math.ceil(dim / 64)
    assert n2 * plan["bn2"] == dim and k2 == inner // 64
    assert min(m1 * n1, m2 * n2) >= SMS


def test_ff_gemm1_tiles_pair_hidden_and_gate_columns():
    """GEMM1's B stage for column tile nt holds W1's hidden rows [64 nt,
    64 nt + 64) then their gate rows [inner + 64 nt, ...): the GEGLU of
    each tile's two halves is the plain GEGLU of those 64 columns."""
    g = torch.Generator().manual_seed(1)
    dim, inner, m = 16, 192, 10
    h = torch.randn(m, dim, generator=g, dtype=torch.float64)
    w1 = torch.randn(2 * inner, dim, generator=g, dtype=torch.float64)
    b1 = torch.randn(2 * inner, generator=g, dtype=torch.float64)
    hidden, gate = (h @ w1.t() + b1).chunk(2, dim=-1)
    want = hidden * F.gelu(gate)
    n1 = geglu_ff_ln_plan(m, dim, inner)["gemm1_tiles"][1]
    got = torch.empty(m, inner, dtype=torch.float64)
    for nt in range(n1):
        rows = torch.cat([torch.arange(64) + 64 * nt, torch.arange(64) + inner + 64 * nt])
        acc = h @ w1[rows].t() + b1[rows]
        got[:, 64 * nt:64 * nt + 64] = acc[:, :64] * F.gelu(acc[:, 64:])
    assert torch.allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dim", GEGLU_FF_KERNEL_DIMS)
def test_ln_free_ff_plan_tiles(dim):
    """The LN-free FF (gmdx_geglu_ff) launches on geglu_ff_ln_plan at the
    dims the JAX rule gives it: GEMM2 160 wide, no tile of padding, both
    GEMMs filling the SMs at the sdr2hdr path's CFG batch 16."""
    inner = 4 * dim
    assert geglu_ff_uses_kernel(dim, inner)
    for m in (16 * 4096 * 320 // dim, 2 * 1000):
        plan = geglu_ff_ln_plan(m, dim, inner)
        assert plan["bn2"] == 160
        m1, n1, k1 = plan["gemm1_tiles"]
        m2, n2, k2 = plan["gemm2_tiles"]
        assert m1 == m2 == math.ceil(m / 128)
        assert (n1 * 64, k1 * 64, n2 * 160, k2 * 64) == (inner, dim, dim, inner)
        if m > 4096:
            assert min(m1 * n1, m2 * n2) >= SMS


def test_ln_free_ff_tiles_are_the_plain_function():
    """A torch walk of the LN-free FF's tiles as the plan lays them out (the
    GEGLU of hidden/gate column pairs of 64, GEMM2's BN-wide column tiles
    over 64-wide K slices, the residual optional), against
    geglu_ff_plain."""
    g = torch.Generator().manual_seed(2)
    dim, inner, m = 320, 1280, 200
    x = torch.randn(m, dim, generator=g)
    res = torch.randn(m, dim, generator=g)
    w1 = torch.randn(2 * inner, dim, generator=g) * dim ** -0.5
    b1 = torch.randn(2 * inner, generator=g) * 0.1
    w2 = torch.randn(dim, inner, generator=g) * inner ** -0.5
    b2 = torch.randn(dim, generator=g) * 0.1
    plan = geglu_ff_ln_plan(m, dim, inner)
    act = torch.empty(m, inner)
    for nt in range(plan["gemm1_tiles"][1]):
        rows = torch.cat([torch.arange(64) + 64 * nt, torch.arange(64) + inner + 64 * nt])
        acc = x @ w1[rows].t() + b1[rows]
        act[:, 64 * nt:64 * nt + 64] = acc[:, :64] * F.gelu(acc[:, 64:])
    bn = plan["bn2"]
    for r in (res, None):
        out = torch.empty(m, dim)
        for nt in range(plan["gemm2_tiles"][1]):
            cols = slice(nt * bn, nt * bn + bn)
            acc = torch.zeros(m, bn)
            for s in range(plan["gemm2_tiles"][2]):
                acc += act[:, 64 * s:64 * s + 64] @ w2[cols, 64 * s:64 * s + 64].t()
            out[:, cols] = acc + b2[cols] + (0 if r is None else r[:, cols])
        want = geglu_ff_plain(x, r, w1, b1, w2, b2)
        assert float((out - want).norm() / want.norm()) <= 1e-5


@pytest.mark.parametrize("name", ["gmdx_wino4", "gmdx_wino4_plan", "gmdx_geglu_ff",
                                  "gmdx_geglu_ff_ln", "gmdx_conv3x3"])
def test_gemm_core_ctypes_signatures_match_the_c_sources(name):
    """The ctypes argtypes of the GEMM core's entry points (_build.ENTRY_POINTS)
    against their C parameters one for one."""
    import ctypes

    from gmdx_torch.kernels import _build

    lib, argtypes = _build.ENTRY_POINTS[name]
    source, params = _c_entry_points()[name]
    want = [ctypes.c_void_p if "*" in p else ctypes.c_float if p.startswith("float")
            else ctypes.c_int for p in params]
    assert (lib, argtypes) == (source, want)


# Every F(4x4) conv of the four paths under winograd_m=4 (conv_route), with
# its headline batches: the GM UNet at 512^2 latents 64^2 (CFG 16 and 2),
# the VAE decoder (SDR + GM, 16 and 2) and encoder (8 and 1) at 512^2, and
# the 1024^2 levels (UNets at CFG 2, the VAE at 2).
WINO4_LEVELS = (64, 32, 16, 128, 256, 512, 1024)


def _wino4_path_shapes():
    return sorted((hw, c, o) for hw, c, o in CONV_SHAPES
                  if conv_route(hw, hw, c, o, 4) == "wino4")


def test_wino4_path_shapes_take_the_route():
    shapes = _wino4_path_shapes()
    # The VAE's 512^2 level is past the JAX package's F(4x4) tiling budget.
    assert (64, 320, 320) in shapes and (256, 128, 256) in shapes
    assert (512, 128, 128) not in shapes
    assert {hw for hw, _, _ in shapes} <= set(WINO4_LEVELS)


def test_wino4_plan_at_path_shapes():
    """Units, tile width, TMA boxes and shared memory at every F(4x4) shape
    and headline batch of the four paths."""
    for hw, c, o in _wino4_path_shapes():
        for b in HEADLINE_BATCHES:
            for pre in (True, False):
                p = winograd4_plan(b, hw, hw, c, o, pre)
                assert p.halo == (0 if pre else 1) and p.bn == 64
                assert p.tiles == b * (hw // 4) ** 2
                assert p.t_tiles * 128 >= p.tiles > (p.t_tiles - 1) * 128
                assert p.n_tiles * p.bn >= o > (p.n_tiles - 1) * p.bn
                assert p.units == 6 * p.t_tiles * p.n_tiles
                assert p.slices == 6 * math.ceil(c / 64)
                assert p.grid == min(p.units, SMS)
                assert p.v_box == (64, 128, 1) and p.u_box == (64, 64, 1)
                assert max(p.v_box + p.u_box) <= 256  # TMA box limit
                assert p.stages >= 3 and p.smem_bytes <= 232448
                assert p.in_cgt * p.in_tx * p.in_ty == 128
                assert c % (8 * p.in_cgt) == 0 and p.in_smem <= 48 * 1024
                if b == 16 and hw <= 64:
                    assert p.units >= SMS


def _walk_wino4(x, u, bias, plan):
    """The kernel's arithmetic in torch, in its own order: the input
    transform by the plan's blocks (a zero-filled slab per block, rows first
    then columns), the products unit by unit from TMA-like boxes (zero
    past T, O and C) with the fold after each xi, then the output transform
    of the 24 planes (over nu, then the bias)."""
    bt = torch.tensor(BT4, dtype=torch.float64).float()
    at = torch.tensor(AT4, dtype=torch.float64).float()
    th, tw = plan.h // 4, plan.w // 4
    t_count, c, o = plan.tiles, plan.c, plan.o
    hin, win = x.shape[1], x.shape[2]
    v = torch.full((36, t_count, c), float("nan"))
    by_n, bx_n = -(-th // plan.in_ty), -(-tw // plan.in_tx)
    assert plan.in_grid == (plan.b * by_n * bx_n, c // (8 * plan.in_cgt))
    for blk in range(plan.in_grid[0]):
        bxi, rest = blk % bx_n, blk // bx_n
        byi, b = rest % by_n, rest // by_n
        ty0, tx0 = byi * plan.in_ty, bxi * plan.in_tx
        y0, x0 = 4 * ty0 - plan.halo, 4 * tx0 - plan.halo
        sr, sc = 4 * plan.in_ty + 2, 4 * plan.in_tx + 2
        ys, xs = torch.arange(sr) + y0, torch.arange(sc) + x0
        ok = ((ys >= 0) & (ys < hin))[:, None] & ((xs >= 0) & (xs < win))[None, :]
        slab = x[b][ys.clamp(0, hin - 1)][:, xs.clamp(0, win - 1)] * ok[..., None]
        for ly in range(plan.in_ty):
            for lx in range(plan.in_tx):
                if ty0 + ly >= th or tx0 + lx >= tw:
                    continue
                t = (b * th + ty0 + ly) * tw + tx0 + lx
                d = slab[4 * ly:4 * ly + 6, 4 * lx:4 * lx + 6]  # (6, 6, C)
                rowt = torch.einsum("xi,ijc->xjc", bt, d)
                v[:, t] = torch.einsum("nj,xjc->xnc", bt, rowt).reshape(36, c)
    assert not torch.isnan(v).any()
    v = v.to(x.dtype).float()

    rows, cols = plan.t_tiles * 128, plan.n_tiles * plan.bn
    kpad = plan.c_slices * 64
    vp = F.pad(v, (0, kpad - c, 0, rows - t_count))
    up = F.pad(u.float(), (0, kpad - c, 0, cols - o))
    planes = torch.full((24, rows, cols), float("nan"))
    for unit in range(plan.units):
        nu, tt, nt = plan.unit(unit)
        r, n = slice(tt * 128, tt * 128 + 128), slice(nt * plan.bn, nt * plan.bn + plan.bn)
        z = torch.zeros(4, 128, plan.bn)
        for s in range(plan.slices):
            p, c0 = plan.slice(nu, s)
            if s % plan.c_slices == 0:
                acc = torch.zeros(128, plan.bn)
            acc += vp[p, r, c0:c0 + 64] @ up[p, n, c0:c0 + 64].t()
            if s % plan.c_slices == plan.c_slices - 1:
                z += at[:, s // plan.c_slices, None, None] * acc
        for i in range(4):
            planes[6 * i + nu, r, n] = z[i]
    planes = planes[:, :t_count, :o]
    assert not torch.isnan(planes).any()
    z = planes.reshape(4, 6, t_count, o)
    y = torch.einsum("qn,inth->tiqh", at, z) + bias.float()
    y = y.reshape(plan.b, th, tw, 4, 4, o).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(plan.b, plan.h, plan.w, o).to(x.dtype)


@pytest.mark.parametrize("b,hw,c,o,pre", [
    (1, 16, 8, 24, True),     # T = 16: one ragged row tile; C = 8 (16-byte rows); O = 24
    (1, 16, 8, 24, False),
    (2, 24, 72, 40, False),   # ragged slab blocks (tw = 6), C past one 64-wide slice
    (1, 32, 16, 136, True),   # two column tiles, the second ragged
])
def test_wino4_walk_is_the_plain_conv(b, hw, c, o, pre):
    """The torch walk of the plan's blocks and units, in fp32, against
    winograd4_conv3x3_plain to 1e-5 relative."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(b, hw, hw, c, generator=g)
    if pre:
        x = F.pad(x, (0, 0, 1, 1, 1, 1))
    u = pack_weight4(torch.randn(o, c, 3, 3, generator=g) * (9 * c) ** -0.5, torch.float32)
    bias = torch.randn(o, generator=g) * 0.1
    plan = winograd4_plan(b, hw, hw, c, o, pre)
    got = _walk_wino4(x, u, bias, plan)
    want = winograd4_conv3x3_plain(x, u, bias, pre_padded=pre)
    assert float((got - want).norm() / want.norm()) <= 1e-5
