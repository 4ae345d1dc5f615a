"""The launch plans of the Hopper GEMM core's kernels, on the CPU.

``csrc/conv3x3.cu`` and ``csrc/geglu_ff.cu`` run what
``gmdx_torch/kernels/winograd.py:conv3x3_plan`` and
``gmdx_torch/kernels/geglu_ff.py:geglu_ff_ln_plan`` lay out. These tests
hold the plans at every conv shape of the four paths and replay the
kernels' tile arithmetic in torch. Plain torch: no JAX, no card.
"""

import math

import pytest
import torch
import torch.nn.functional as F
from test_torch_card import CONV_SHAPES

from gmdx_torch.kernels.geglu_ff import geglu_ff_ln_plan
from gmdx_torch.kernels.winograd import SMS, conv3x3_plain, conv3x3_plan, pack_weight

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
