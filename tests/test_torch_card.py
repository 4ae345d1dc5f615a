"""gmdx_torch's hand-written kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without an sm_90 card. The file
imports neither JAX nor gmdx, so it runs on a machine with PyTorch for CUDA
alone; tests/conftest.py imports JAX, so run it there with

    python -m pytest --noconftest -q tests/test_torch_card.py

Inputs are seeded bf16 on the card; the plain versions run in fp32 with TF32
off; the bound is relative L2 <= 1e-2 (bf16 rounding of inputs and output).
"""

import inspect

import numpy as np
import pytest
import torch

from gmdx_torch.kernels import attention as tk_attention
from gmdx_torch.kernels import launch_counts
from gmdx_torch.kernels.flash_attention import (
    attention_fwd_plan, flash_attention_bsc, flash_attention_bsc_plain, flash_attention_bwd,
    flash_attention_bwd_dd, flash_attention_bwd_dd_plain, flash_attention_bwd_plain,
    flash_attention_fwd, flash_attention_fwd_plain, flash_bwd_plan, wide_bwd_plans, wide_fwd_plan,
)
from gmdx_torch.kernels.geglu_ff import GegluFFLN, geglu_ff_ln, geglu_ff_ln_plain
from gmdx_torch.kernels.groupnorm import (
    GroupNormSiLU, group_norm_silu, group_norm_silu_bwd, group_norm_silu_bwd_plain,
    group_norm_silu_plain,
)
from gmdx_torch.kernels.winograd import conv3x3, conv3x3_plain, conv3x3_plan, pack_weight

# Every distinct Conv3x3 (H = W, C, O) of the four paths: the SD-1.5 UNet at
# 64^2 and 128^2 latents (the ControlNet runs the UNet's down-block shapes),
# the VAE decoder from 64^2 and 128^2 latents and its encoder at 512^2 and
# 1024^2. tests/test_torch_gemm_plan.py checks the list against the configs.
CONV_SHAPES = [
    (8, 1280, 1280), (8, 2560, 1280), (16, 640, 1280), (16, 1280, 1280), (16, 1920, 1280),
    (16, 2560, 1280), (32, 320, 640), (32, 640, 640), (32, 640, 1280), (32, 960, 640),
    (32, 1280, 640), (32, 1280, 1280), (32, 1920, 640), (32, 1920, 1280), (32, 2560, 1280),
    (64, 320, 320), (64, 320, 640), (64, 512, 512), (64, 640, 320), (64, 640, 640),
    (64, 960, 320), (64, 960, 640), (64, 1280, 640), (64, 1920, 640), (128, 256, 512),
    (128, 320, 320), (128, 512, 512), (128, 640, 320), (128, 960, 320), (256, 128, 256),
    (256, 256, 256), (256, 256, 512), (256, 512, 256), (256, 512, 512), (512, 128, 128),
    (512, 128, 256), (512, 256, 128), (512, 256, 256), (512, 512, 256), (1024, 128, 128),
    (1024, 256, 128),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an NVIDIA sm_90 card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _bf16(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)


def _rel_l2(out, ref):
    return float((out.float() - ref.float()).norm() / ref.float().norm())


@pytest.mark.cuda
@pytest.mark.parametrize("s,c,heads", [(4096, 320, 8), (1000, 640, 8), (256, 1280, 8)])
def test_attention_kernel_on_card(card, s, c, heads):
    q, k, v = (_bf16(card, 2, s, c) for _ in range(3))
    out = tk_attention.attention_kv_resident(q, k, v, heads)
    ref = tk_attention.attention_kv_resident_plain(q.float(), k.float(), v.float(), heads)
    assert _rel_l2(out, ref) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("hw,c,o,pre", [(64, 320, 320, True), (17, 64, 40, False), (8, 1280, 1280, False)])
def test_conv3x3_kernel_on_card(card, hw, c, o, pre):
    x = _bf16(card, 2, hw, hw, c)
    if pre:
        x = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    wp = pack_weight(_bf16(card, o, c, 3, 3, scale=(9 * c) ** -0.5))
    bias = _bf16(card, o, scale=0.1)
    out = conv3x3(x, wp, bias, pre_padded=pre)
    ref = conv3x3_plain(x.float(), wp.float(), bias.float(), pre_padded=pre)
    assert _rel_l2(out, ref) <= 1e-2


def _conv_case(gen, b, hw, c, o, pre):
    x = _bf16(gen, b, hw, hw, c)
    if pre:
        x = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    wp = pack_weight(_bf16(gen, o, c, 3, 3, scale=(9 * c) ** -0.5))
    bias = _bf16(gen, o, scale=0.1)
    out = conv3x3(x, wp, bias, pre_padded=pre)
    ref = conv3x3_plain(x.float(), wp.float(), bias.float(), pre_padded=pre)
    return out, ref


@pytest.mark.cuda
@pytest.mark.parametrize("hw,c,o", CONV_SHAPES)
def test_conv3x3_path_shapes_on_card(card, hw, c, o):
    """Every Conv3x3 shape of the four paths, pre-padded as the resnets call
    it, through the TMA route; batch 2 up to 64^2, else 1."""
    b = 2 if hw <= 64 else 1
    assert conv3x3_plan(b, hw, hw, c, o, True).route == "tma"
    out, ref = _conv_case(card, b, hw, c, o, True)
    assert _rel_l2(out, ref) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("b,hw,c,o,pre,route,split", [
    (2, 64, 320, 320, False, "tma", False),     # raw: the TMA's zero fill is the padding
    (1, 256, 256, 256, False, "tma", False),    # raw, 128 | W
    (3, 8, 1280, 1280, True, "tma", True),      # ragged M: 192 pixels, half a last tile
    (3, 8, 1280, 1280, False, "tma", True),
    (16, 8, 1280, 1280, True, "tma", True),     # the CFG-16 8^2 level, split K
    (16, 16, 1280, 1280, False, "tma", False),
    (2, 17, 72, 40, False, "gather", True),     # C % 64 != 0, W fits no box
    (2, 17, 72, 40, True, "gather", True),
])
def test_conv3x3_routes_on_card(card, b, hw, c, o, pre, route, split):
    plan = conv3x3_plan(b, hw, hw, c, o, pre)
    assert plan.route == route and (plan.split > 1) == split
    out, ref = _conv_case(card, b, hw, c, o, pre)
    assert _rel_l2(out, ref) <= 1e-2


@pytest.mark.cuda
def test_conv3x3_and_ff_are_deterministic_on_card(card):
    """Two identical calls give bit-identical outputs: the split-K sum runs
    in a fixed order and nothing uses atomics."""
    x = _bf16(card, 16, 10, 10, 1280)
    wp = pack_weight(_bf16(card, 1280, 1280, 3, 3, scale=(9 * 1280) ** -0.5))
    bias = _bf16(card, 1280, scale=0.1)
    assert conv3x3_plan(16, 8, 8, 1280, 1280, True).split > 1
    assert torch.equal(conv3x3(x, wp, bias, pre_padded=True), conv3x3(x, wp, bias, pre_padded=True))
    args = _ff_args(card, 320, 1000, True)
    assert torch.equal(geglu_ff_ln(*args), geglu_ff_ln(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("temb,pad", [(False, False), (True, True)])
def test_group_norm_kernel_on_card(card, temb, pad):
    x = _bf16(card, 2, 32, 32, 640, scale=2.0)
    g = (1.0 + _bf16(card, 640, scale=0.2).float()).to(torch.bfloat16)
    b = _bf16(card, 640, scale=0.2)
    t = _bf16(card, 2, 640) if temb else None
    out = group_norm_silu(x, g, b, t, pad_output=pad)
    ref = group_norm_silu_plain(
        x.float(), g.float(), b.float(), t.float() if temb else None, pad_output=pad
    )
    assert _rel_l2(out, ref) <= 1e-2


def _ff_args(gen, dim, tokens, add):
    inner = 4 * dim
    return [
        _bf16(gen, 2, tokens, dim), _bf16(gen, 2, tokens, dim) if add else None,
        (1.0 + _bf16(gen, dim, scale=0.2).float()).to(torch.bfloat16),
        _bf16(gen, dim, scale=0.2), _bf16(gen, 2 * inner, dim, scale=dim**-0.5),
        _bf16(gen, 2 * inner, scale=0.1), _bf16(gen, dim, inner, scale=inner**-0.5),
        _bf16(gen, dim, scale=0.1),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("dim,tokens", [(320, 4096), (640, 1000), (1280, 256)])
def test_geglu_ff_kernel_on_card(card, dim, tokens):
    args = _ff_args(card, dim, tokens, True)
    out = geglu_ff_ln(*args)
    ref = geglu_ff_ln_plain(*(a.float() for a in args))
    assert _rel_l2(out, ref) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [320, 640, 1280])
@pytest.mark.parametrize("add", [True, False])
def test_geglu_ff_ln_dims_on_card(card, dim, add):
    """1000 tokens a batch element (2000 rows: a ragged last row tile),
    with and without the pending residual."""
    args = _ff_args(card, dim, 1000, add)
    out = geglu_ff_ln(*args)
    ref = geglu_ff_ln_plain(*(a.float() if a is not None else None for a in args))
    assert _rel_l2(out, ref) <= 1e-2


@pytest.mark.cuda
def test_wrappers_count_launches_and_refuse_other_dtypes(card):
    x = _bf16(card, 1, 16, 16, 64)
    g, b = _bf16(card, 64), _bf16(card, 64)
    before = launch_counts()["group_norm_silu"]
    group_norm_silu(x, g, b)
    assert launch_counts()["group_norm_silu"] == before + 1
    with pytest.raises(TypeError, match="bfloat16"):
        group_norm_silu(x.float(), g.float(), b.float())
    q = _bf16(card, 1, 256, 2 * 24)
    with pytest.raises(ValueError, match="head dim"):
        tk_attention.attention_kv_resident(q, q, q, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,c", [
    (4096, 4096, 320), (4096, 4000, 320), (1000, 1000, 640), (256, 300, 1280),
])
def test_flash_attention_kernels_on_card(card, sq, sk, c):
    """Forward (out, lse) and backward (dq, dk, dv) against the fp32 plain
    versions; 4000, 1000 and 300 leave ragged query and key tiles."""
    heads = 8
    q = _bf16(card, 2, sq, c)
    k, v = _bf16(card, 2, sk, c), _bf16(card, 2, sk, c)
    dout = _bf16(card, 2, sq, c)
    out, lse = flash_attention_fwd(q, k, v, heads)
    f32 = [t.float() for t in (q, k, v)]
    ref_out, ref_lse = flash_attention_fwd_plain(*f32, heads, (c // heads) ** -0.5)
    assert _rel_l2(out, ref_out) <= 1e-2
    assert float((lse - ref_lse).abs().max()) <= 2e-2
    grads = flash_attention_bwd(q, k, v, out, lse, dout, heads)
    refs = flash_attention_bwd_plain(*f32, ref_out, ref_lse, dout.float(), heads,
                                     (c // heads) ** -0.5)
    for got, ref in zip(grads, refs):
        assert _rel_l2(got, ref) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("hw,c,temb,act,pad", [
    (64, 320, True, True, True), (32, 640, False, False, False), (16, 1280, False, True, True),
])
def test_group_norm_bwd_kernel_on_card(card, hw, c, temb, act, pad):
    x = _bf16(card, 2, hw, hw, c, scale=2.0)
    gam = (1.0 + _bf16(card, c, scale=0.2).float()).to(torch.bfloat16)
    bet = _bf16(card, c, scale=0.2)
    t = _bf16(card, 2, c) if temb else None
    g = _bf16(card, 2, hw + 2 * pad, hw + 2 * pad, c)
    _, stats = group_norm_silu(x, gam, bet, t, activate=act, pad_output=pad, return_stats=True)
    _, ref_stats = group_norm_silu_plain(
        x.float(), gam.float(), bet.float(), t.float() if temb else None,
        activate=act, pad_output=pad, return_stats=True,
    )
    assert _rel_l2(stats, ref_stats) <= 1e-4  # fp32 statistics on both sides
    got = group_norm_silu_bwd(x, gam, bet, t, stats, g, activate=act, pad_output=pad)
    ref = group_norm_silu_bwd_plain(
        x.float(), gam.float(), bet.float(), t.float() if temb else None, ref_stats,
        g.float(), activate=act, pad_output=pad,
    )
    for a, b in zip(got, ref):
        if b is not None:
            assert _rel_l2(a, b) <= 1e-2


@pytest.mark.cuda
def test_autograd_functions_on_card(card):
    """The three differentiated routes against autograd of the plain
    versions, all operands bf16 on the card."""
    def grads(fn, *args):
        leaves = [a.clone().requires_grad_() if a is not None else None for a in args]
        out = fn(*leaves)
        out.float().square().sum().backward()
        return [a.grad for a in leaves if a is not None]

    q, k, v = (_bf16(card, 2, 1024, 640) for _ in range(3))
    for a, b in zip(grads(lambda *t: tk_attention.FlashAttention.apply(*t, 8, 80 ** -0.5), q, k, v),
                    grads(lambda *t: tk_attention.attention_kv_resident_plain(*t, 8), q, k, v)):
        assert _rel_l2(a, b) <= 2e-2
    x = _bf16(card, 2, 32, 32, 640, scale=2.0)
    gam = (1.0 + _bf16(card, 640, scale=0.2).float()).to(torch.bfloat16)
    bet, t = _bf16(card, 640, scale=0.2), _bf16(card, 2, 640)
    for a, b in zip(grads(lambda *z: GroupNormSiLU.apply(*z, 32, 1e-5, True, True), x, gam, bet, t),
                    grads(lambda *z: group_norm_silu_plain(*z, pad_output=True), x, gam, bet, t)):
        assert _rel_l2(a, b) <= 2e-2
    dim, inner = 320, 1280
    ff = [_bf16(card, 2, 256, dim), _bf16(card, 2, 256, dim),
          (1.0 + _bf16(card, dim, scale=0.2).float()).to(torch.bfloat16),
          _bf16(card, dim, scale=0.2), _bf16(card, 2 * inner, dim, scale=dim**-0.5),
          _bf16(card, 2 * inner, scale=0.1), _bf16(card, dim, inner, scale=inner**-0.5),
          _bf16(card, dim, scale=0.1)]
    for a, b in zip(grads(lambda *z: GegluFFLN.apply(*z, 1e-5), *ff),
                    grads(lambda *z: geglu_ff_ln_plain(*z), *ff)):
        assert _rel_l2(a, b) <= 2e-2


@pytest.mark.cuda
def test_train_step_on_card_accumulates_and_matches_plain(card):
    """The Stage-2 step on the card (the default device) at a small config
    whose head dim is the kernels' 40: the differentiated kernel routes
    launch, gradient accumulation moves the parameters on every second call
    only, EMA advances, and the kernels' loss and gradient agree with the
    plain versions' on the same inputs."""
    import dataclasses

    from gmdx_torch.kernels import reset_launch_counts
    from gmdx_torch.models import (
        TINY_CLIP_CONFIG, TINY_UNET_CONFIG, TINY_VAE_CONFIG, AutoencoderKL, CLIPTextModel,
        UNet2DConditionModel, set_use_kernels,
    )
    from gmdx_torch.schedulers import DDPMScheduler
    from gmdx_torch.train import (
        Stage2Config, init_state, make_ema_step, make_train_step, stage2_loss,
    )

    torch.manual_seed(0)
    cfg = dataclasses.replace(TINY_UNET_CONFIG, in_channels=8, block_out_channels=(320, 640),
                              num_attention_heads=8)
    with torch.device("cuda"):
        unet = UNet2DConditionModel(cfg, dtype=torch.bfloat16)
        vae = AutoencoderKL(TINY_VAE_CONFIG).to(torch.bfloat16)
        text = CLIPTextModel(TINY_CLIP_CONFIG).to(torch.bfloat16)
    config = Stage2Config(learning_rate=1e-4, gradient_accumulation_steps=2, use_ema=True)
    step = make_train_step(config, unet=unet, vae=vae, text_encoder=text)
    state = init_state(config, unet)
    ema = make_ema_step(config)
    ids = torch.randint(0, TINY_CLIP_CONFIG.vocab_size, (2, 7), generator=card, device="cuda")
    pixel = {"sdr": torch.rand(2, 3, 32, 32, generator=card, device="cuda") * 2 - 1,
             "gm": torch.rand(2, 3, 32, 32, generator=card, device="cuda") * 2 - 1,
             "input_ids": ids}
    reset_launch_counts()
    seen = [unet.conv_in.weight.detach().clone()]
    for _ in range(4):
        state, metrics = step(state, pixel, card)
        if state.optimizer.mini_step == 0:
            state = ema(state)
        assert torch.isfinite(metrics["loss"])
        seen.append(unet.conv_in.weight.detach().clone())
    assert [not torch.equal(a, b) for a, b in zip(seen, seen[1:])] == [False, True, False, True]
    assert state.ema.step == 2
    counts = launch_counts()
    for name in ("flash_attention_fwd", "flash_attention_bwd", "group_norm_silu_bwd",
                 "group_norm_silu", "geglu_ff_ln", "conv3x3"):
        assert counts[name] > 0, name

    lat = {k: torch.randn(2, 4, 16, 16, generator=card, device="cuda")
           for k in ("sdr_latents", "gm_latents", "noise")}
    ctx = torch.randn(2, 7, 32, generator=card, device="cuda")
    acp = torch.as_tensor(DDPMScheduler().alphas_cumprod, device="cuda")
    res = []
    for flag in (True, False):
        set_use_kernels(unet, flag)
        loss = stage2_loss(unet, **lat, encoder_hidden_states=ctx,
                           timesteps=torch.tensor([100, 700], device="cuda"),
                           alphas_cumprod=acp, config=config)
        grads = torch.autograd.grad(loss, list(unet.parameters()))
        res.append((float(loss.detach()), [g.float() for g in grads]))
    (lk, gk), (lp, gp) = res
    flat_k, flat_p = torch.cat([g.flatten() for g in gk]), torch.cat([g.flatten() for g in gp])
    # Per leaf, the gradients straight out of the attention and GroupNorm
    # backward kernels, so that one wrong kernel cannot hide in the cosine.
    watched = (".to_q.", ".to_k.", ".to_v.", "norm")
    leaf = {n: float((a - b).norm() / b.norm())
            for (n, _), a, b in zip(unet.named_parameters(), gk, gp)
            if any(k in n for k in watched)}
    cos = float(torch.dot(flat_k, flat_p) / (flat_k.norm() * flat_p.norm()))
    assert abs(lk - lp) <= 1e-3 * abs(lp)
    assert cos >= 0.9995
    assert max(leaf.values()) <= 5e-2, max(leaf.items(), key=lambda kv: kv[1])


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,c", [
    (16384, 16384, 320), (16384, 16300, 320), (16300, 16384, 320), (4000, 4096, 640),
    (1000, 1100, 1280), (300, 16300, 320),
])
def test_flash_bsc_kernel_on_card(card, sq, sk, c):
    """The 1024^2 UNet's first level (16384 tokens, 8 heads of 40), masked
    key counts and ragged query counts, and head dims 80 and 160; the launch
    is counted."""
    q = _bf16(card, 2, sq, c)
    k, v = _bf16(card, 2, sk, c), _bf16(card, 2, sk, c)
    before = launch_counts()["flash_attention_bsc"]
    out = flash_attention_bsc(q, k, v, 8)
    assert launch_counts()["flash_attention_bsc"] == before + 1
    ref = flash_attention_bsc_plain(q.float(), k.float(), v.float(), 8)
    assert _rel_l2(out, ref) <= 1e-2
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_bsc(q, k, v, 5)  # head dim 64: no instance


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,c", [(4096, 4096, 320), (1000, 1000, 640), (300, 256, 1280)])
def test_flash_bwd_repeat_is_bit_identical_on_card(card, sq, sk, c):
    """Two launches of the backward on the same operands give the same dq,
    dk and dv bit for bit: every gradient row has one writer, no atomics."""
    q, dout = _bf16(card, 2, sq, c), _bf16(card, 2, sq, c)
    k, v = _bf16(card, 2, sk, c), _bf16(card, 2, sk, c)
    out, lse = flash_attention_fwd(q, k, v, 8)
    first = flash_attention_bwd(q, k, v, out, lse, dout, 8)
    second = flash_attention_bwd(q, k, v, out, lse, dout, 8)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("s,c", [(4096, 320), (1000, 640), (300, 1280)])
def test_flash_bwd_dd_prepass_on_card(card, s, c):
    """The backward's dd pre-pass alone against (dO * O).sum(-1) in fp32."""
    out, dout = _bf16(card, 2, s, c), _bf16(card, 2, s, c)
    dd = flash_attention_bwd_dd(out, dout, 8)
    ref = flash_attention_bwd_dd_plain(out.float(), dout.float(), 8)
    assert dd.shape == (2, 8, s) and dd.dtype == torch.float32
    assert float((dd - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("b,sq,sk", [(2, 16384, 16384), (8, 4096, 4096), (1, 300, 16300),
                                     (16, 16300, 256), (16, 1024, 1024), (2, 256, 256)])
def test_attention_plans_match_kernels_on_card(card, d, b, sq, sk):
    """The Python plans are the C structs the Hopper attention kernels launch
    with, field for field: rows owned, tile rows, stages, shared-memory
    bytes, the grid and the box rows of the Q/dO and K/V maps."""
    import ctypes
    import dataclasses

    from gmdx_torch.kernels import _build

    lib = _build.library("attention")
    plans = (attention_fwd_plan(b, sq, sk, 8, d), *flash_bwd_plan(b, sq, sk, 8, d))
    for kind, plan in enumerate(plans):
        got = (ctypes.c_int * 9)()
        assert lib.gmdx_attention_sm90_plan(kind, b, sq, sk, 8, d, got) == 0
        mine = dataclasses.astuple(plan)
        assert list(got) == [*mine[:4], *mine[4], *mine[5]], (kind, plan)


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,c", [
    (4096, 4096, 320), (4000, 4096, 320), (4096, 4000, 320), (1000, 1100, 640),
    (300, 256, 1280),
])
def test_attention_sm90_lse_on_card(card, sq, sk, c):
    """attention_sm90.cuh's forward with the base-2 logsumexp, as the
    training forward (flash_attention_fwd) launches it: out and lse against
    the fp32 plain forward, ragged query and key counts included (an lse
    row written past Sq would land on the next head's rows)."""
    heads, d = 8, c // 8
    q = _bf16(card, 2, sq, c)
    k, v = _bf16(card, 2, sk, c), _bf16(card, 2, sk, c)
    before = launch_counts()["flash_attention_fwd"]
    out, lse = flash_attention_fwd(q, k, v, heads)
    assert launch_counts()["flash_attention_fwd"] == before + 1
    assert lse.shape == (2, heads, sq)
    ref_out, ref_lse = flash_attention_fwd_plain(q.float(), k.float(), v.float(), heads,
                                                 d**-0.5)
    assert _rel_l2(out, ref_out) <= 1e-2
    assert float((lse - ref_lse).abs().max()) <= 2e-2
    assert _rel_l2(lse, ref_lse) <= 1e-2


# The (batch, tokens, width) of every self-attention that reaches the
# KV-resident kernel on a path (the 512^2 UNet levels at the CFG batches 8
# and 16, the 1024^2 levels below the first at the up-conversion's 1 and 2)
# and of the training forward (the Stage-2 levels at batches 2 and 8).
KVRES_PATH = [(b, s, c) for b in (8, 16) for s, c in ((4096, 320), (1024, 640), (256, 1280))] + [
    (b, s, c) for b in (1, 2) for s, c in ((4096, 640), (1024, 1280), (256, 1280))]
TRAIN_PATH = [(b, s, c) for b in (2, 8) for s, c in ((4096, 320), (1024, 640), (256, 1280))]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,c", KVRES_PATH + [(3, 4000, 320), (2, 1000, 640), (1, 300, 1280)])
def test_kv_resident_path_shapes_on_card(card, b, s, c):
    """The KV-resident kernel at every path shape and at ragged ones,
    against its fp32 plain version; the launch is counted."""
    q, k, v = (_bf16(card, b, s, c) for _ in range(3))
    before = launch_counts()["attention_kv_resident"]
    out = tk_attention.attention_kv_resident(q, k, v, 8)
    assert launch_counts()["attention_kv_resident"] == before + 1
    ref = tk_attention.attention_kv_resident_plain(q.float(), k.float(), v.float(), 8)
    assert _rel_l2(out, ref) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,sk,c", [(b, s, s, c) for b, s, c in TRAIN_PATH]
                         + [(2, 4000, 4096, 320), (2, 1000, 900, 640), (2, 300, 257, 1280)])
def test_training_forward_path_shapes_on_card(card, b, s, sk, c):
    """The training forward at every Stage-2 shape and at ragged ones: out
    and lse within 1e-2 relative L2 of the fp32 plain version."""
    q = _bf16(card, b, s, c)
    k, v = _bf16(card, b, sk, c), _bf16(card, b, sk, c)
    out, lse = flash_attention_fwd(q, k, v, 8)
    ref_out, ref_lse = flash_attention_fwd_plain(q.float(), k.float(), v.float(), 8,
                                                 (c // 8) ** -0.5)
    assert _rel_l2(out, ref_out) <= 1e-2
    assert _rel_l2(lse, ref_lse) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("sk", [16384, 16300])
def test_flash_fwd_d512_kernel_on_card(card, sk):
    """The 1024^2 VAE mid block's single 512-wide head, output and
    logsumexp; the backward at 512 launches the wide kernels (their own
    tests check its gradients)."""
    q = _bf16(card, 2, 16384, 512)
    k, v = _bf16(card, 2, sk, 512), _bf16(card, 2, sk, 512)
    before = launch_counts()["flash_attention_fwd_d512"]
    out, lse = flash_attention_fwd(q, k, v, 1)
    assert launch_counts()["flash_attention_fwd_d512"] == before + 1
    ref, ref_lse = flash_attention_fwd_plain(q.float(), k.float(), v.float(), 1, 512**-0.5)
    assert _rel_l2(out, ref) <= 1e-2
    assert float((lse - ref_lse).abs().max()) <= 2e-2
    before = launch_counts()["flash_attention_bwd_d512"]
    grads = flash_attention_bwd(q, k, v, out, lse, q, 1)
    assert launch_counts()["flash_attention_bwd_d512"] == before + 1
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.cuda
def test_controlnet_upconvert_on_card(card):
    """SDR->HDRTV through the ControlNet pipeline at a small width whose
    shapes reach the long-sequence kernels (72^2 latents: 5184 tokens, 8
    heads of 40, and a 512-wide VAE head), 2 steps, kernels against plain
    versions on the same noise, with non-zero adapter convs."""
    import dataclasses

    from gmdx_torch.kernels import reset_launch_counts
    from gmdx_torch.models import (
        TINY_CONTROLNET_CONFIG, TINY_UNET_CONFIG, AutoencoderKL, ControlNetModel,
        UNet2DConditionModel, VAEConfig, set_use_kernels,
    )
    from gmdx_torch.pipelines import StableDiffusionControlNetHDRPipeline, upconvert_sdr_to_hdrtv
    from gmdx_torch.schedulers import PNDMScheduler

    torch.manual_seed(0)
    cfg = dataclasses.replace(TINY_UNET_CONFIG, block_out_channels=(320, 640),
                              num_attention_heads=8)
    with torch.device("cuda"):
        unet = UNet2DConditionModel(cfg)
        gm_unet = UNet2DConditionModel(dataclasses.replace(cfg, in_channels=8))
        vae = AutoencoderKL(VAEConfig(block_out_channels=(128, 512), layers_per_block=1))
        cnet = ControlNetModel(dataclasses.replace(TINY_CONTROLNET_CONFIG, unet=cfg))
        for name, p in cnet.named_parameters():
            if name.startswith(("controlnet_down_blocks", "controlnet_mid_block",
                                "controlnet_cond_embedding.conv_out")):
                p.data.normal_(0.0, 0.05)
    mods = [m.to(torch.bfloat16).eval() for m in (unet, vae, gm_unet, cnet)]
    pipe = StableDiffusionControlNetHDRPipeline(mods[0], mods[1], PNDMScheduler(), mods[2],
                                                mods[3])
    sdr = torch.rand(1, 3, 576, 576, generator=card, device="cuda")
    cond, uncond = (torch.randn(1, 7, 32, generator=card, device="cuda") for _ in range(2))
    outs = []
    for flag in (True, False):
        for m in mods:
            set_use_kernels(m, flag)
        reset_launch_counts()
        outs.append(upconvert_sdr_to_hdrtv(
            pipe, sdr, generator=torch.Generator(device="cuda").manual_seed(1),
            num_inference_steps=2, prompt_embeds=cond, negative_prompt_embeds=uncond))
        if flag:
            counts = launch_counts()
            for name in ("flash_attention_bsc", "flash_attention_fwd_d512",
                         "attention_kv_resident", "conv3x3", "group_norm_silu", "geglu_ff_ln"):
                assert counts[name] > 0, name
    for a, b in zip(outs[0], outs[1]):
        assert a.shape == b.shape
        assert np.isfinite(a).all()
    for i in (0, 1):  # decoded SDR and GM in [0, 1]
        mse = float(np.mean((outs[0][i].astype(np.float64) - outs[1][i]) ** 2))
        assert -10.0 * np.log10(max(mse, 1e-30)) >= 40.0


@pytest.mark.cuda
@pytest.mark.parametrize("sq,c", [(4096, 320), (1024, 640), (1000, 1280)])
def test_cross_attention_shortk_kernel_on_card(card, sq, c):
    """77 keys at head dims 40/80/160; a ragged query count at 160."""
    from gmdx_torch.kernels.flash_attention import (
        cross_attention_shortk, cross_attention_shortk_plain,
    )

    q = _bf16(card, 2, sq, c)
    k, v = _bf16(card, 2, 77, c), _bf16(card, 2, 77, c)
    out = cross_attention_shortk(q, k, v, 8)
    assert _rel_l2(out, cross_attention_shortk_plain(q, k, v, 8)) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("tokens,c", [(4096, 320), (1000, 640), (256, 1280), (64, 1280)])
def test_add_layer_norm_kernel_on_card(card, tokens, c):
    from gmdx_torch.kernels.geglu_ff import add_layer_norm, add_layer_norm_plain

    x, y = _bf16(card, 2, tokens, c), _bf16(card, 2, tokens, c)
    g = 1.0 + _bf16(card, c, scale=0.2).float()
    b = _bf16(card, c, scale=0.2).float()
    for out, ref in zip(add_layer_norm(x, y, g, b), add_layer_norm_plain(x, y, g, b)):
        assert _rel_l2(out, ref) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dim,tokens,residual", [(320, 4096, True), (640, 1000, True),
                                                 (320, 300, False), (640, 1000, False),
                                                 (320, 1000, True), (640, 4096, False)])
def test_geglu_ff_no_ln_kernel_on_card(card, dim, tokens, residual):
    from gmdx_torch.kernels.geglu_ff import geglu_ff, geglu_ff_plain

    inner = 4 * dim
    x = _bf16(card, 2, tokens, dim)
    res = _bf16(card, 2, tokens, dim) if residual else None
    ws = [_bf16(card, 2 * inner, dim, scale=dim ** -0.5), _bf16(card, 2 * inner, scale=0.1),
          _bf16(card, dim, inner, scale=inner ** -0.5), _bf16(card, dim, scale=0.1)]
    out = geglu_ff(x, res, *ws)
    ref = geglu_ff_plain(x.float(), None if res is None else res.float(), *(w.float() for w in ws))
    assert _rel_l2(out, ref) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("hw,c,o,pre", [(64, 320, 320, True), (32, 640, 1280, False),
                                        (16, 40, 24, True), (16, 2560, 1280, True)])
def test_winograd4_kernel_on_card(card, hw, c, o, pre):
    """F(4x4) against its plain version (U and V rounded to bf16 where the
    kernel rounds them), raw and pre-padded, with a ragged channel count."""
    from gmdx_torch.kernels.winograd import pack_weight4, winograd4_conv3x3, winograd4_conv3x3_plain

    x = _bf16(card, 2, hw, hw, c)
    if pre:
        x = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    u = pack_weight4(_bf16(card, o, c, 3, 3, scale=(9 * c) ** -0.5), torch.bfloat16)
    bias = _bf16(card, o, scale=0.1)
    out = winograd4_conv3x3(x, u, bias, pre_padded=pre)
    assert _rel_l2(out, winograd4_conv3x3_plain(x, u, bias, pre_padded=pre)) <= 1e-2


# F(4x4) on the card: ragged cases (T = 16 < one row tile, C = 8, O = 24,
# raw and pre-padded) and one path shape a level (the UNet's three at CFG
# batch 2, the VAE decoder's 512^2 x 128 at batch 2).
WINO4_CASES = [
    (1, 16, 8, 24, True), (1, 16, 8, 24, False), (2, 24, 72, 40, False), (1, 32, 16, 136, True),
    (2, 64, 320, 320, True), (2, 32, 640, 640, True), (2, 16, 1280, 1280, False),
    (2, 512, 128, 128, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,hw,c,o,pre", WINO4_CASES)
def test_winograd4_ragged_and_path_cases_on_card(card, b, hw, c, o, pre):
    """F(4x4) against its plain version at relative L2 <= 1e-2, and two
    calls bit-identical (no atomics; the fold sums in a fixed order)."""
    from gmdx_torch.kernels.winograd import pack_weight4, winograd4_conv3x3, winograd4_conv3x3_plain

    x = _bf16(card, b, hw, hw, c)
    if pre:
        x = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    u = pack_weight4(_bf16(card, o, c, 3, 3, scale=(9 * c) ** -0.5), torch.bfloat16)
    bias = _bf16(card, o, scale=0.1)
    out = winograd4_conv3x3(x, u, bias, pre_padded=pre)
    torch.cuda.synchronize()
    assert _rel_l2(out, winograd4_conv3x3_plain(x, u, bias, pre_padded=pre)) <= 1e-2
    assert torch.equal(out, winograd4_conv3x3(x, u, bias, pre_padded=pre))


@pytest.mark.cuda
@pytest.mark.parametrize("b,hw,c,o", [(b, hw, c, o) for b, hw, c, o, _ in WINO4_CASES]
                         + [(16, 64, 320, 320), (16, 16, 1280, 1280), (16, 512, 128, 128)])
def test_winograd4_plans_match_kernel_on_card(card, b, hw, c, o):
    """winograd4_plan field for field against gmdx_wino4_plan, the C plan
    the kernel launches with."""
    import ctypes

    from gmdx_torch.kernels import _build
    from gmdx_torch.kernels.winograd import winograd4_plan

    got = (ctypes.c_int * 12)()
    assert _build.library("winograd4").gmdx_wino4_plan(b, hw, hw, c, o, got) == 0
    assert list(got) == winograd4_plan(b, hw, hw, c, o).c_fields()


@pytest.mark.cuda
def test_opt_in_kernels_refuse_what_they_do_not_take(card):
    from gmdx_torch.kernels.flash_attention import cross_attention_shortk
    from gmdx_torch.kernels.geglu_ff import add_layer_norm
    from gmdx_torch.kernels.winograd import pack_weight4, winograd4_conv3x3

    q, k = _bf16(card, 1, 1024, 64), _bf16(card, 1, 77, 64)
    with pytest.raises(ValueError, match="head dim"):
        cross_attention_shortk(q, k, k, 2)  # d = 32: no instance
    q40 = _bf16(card, 1, 1024, 80)
    with pytest.raises(ValueError, match="keys"):
        cross_attention_shortk(q40, q40, q40, 2)  # 1024 keys
    x = _bf16(card, 1, 8, 2056)
    with pytest.raises(ValueError, match="C % 8"):
        add_layer_norm(x, x, torch.ones(2056, device="cuda"), torch.zeros(2056, device="cuda"))
    u = pack_weight4(_bf16(card, 8, 8, 3, 3), torch.bfloat16)
    with pytest.raises(ValueError, match="F\\(4x4\\)"):
        winograd4_conv3x3(_bf16(card, 1, 8, 8, 8), u, _bf16(card, 8))


@pytest.mark.cuda
def test_unet_with_options_launches_per_call_counts(card):
    """One full-width GM-UNet forward at 512^2 with the three options: the
    launches of each kernel per call that chip_smoke.py's sdr2hdr phase
    asserts over a run."""
    from gmdx_torch.kernels import reset_launch_counts
    from gmdx_torch.models import SD15_GM_UNET_CONFIG, UNet2DConditionModel, set_kernel_options

    with torch.device("cuda"):
        unet = UNet2DConditionModel(SD15_GM_UNET_CONFIG).to(torch.bfloat16).eval()
    set_kernel_options(unet, xattn_kernel=True, fused_addln=True, winograd_m=4)
    x = _bf16(card, 2, 64, 64, 8)
    ctx = _bf16(card, 2, 77, 768)
    reset_launch_counts()
    with torch.no_grad():
        out = unet(x, 500, ctx, channels_last=True)
    assert torch.isfinite(out).all()
    counts = launch_counts()
    want = {"cross_attention_shortk": 10, "add_layer_norm": 16, "winograd4_conv3x3": 30,
            "conv3x3": 14, "attention_kv_resident": 15, "geglu_ff_ln": 16, "geglu_ff": 0}
    assert {k: counts[k] for k in want} == want


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("sk", [1, 8, 77, 128])
def test_xattn_sm90_kernel_on_card(card, d, sk):
    """xattn_sm90_kernel at every key tile (32, 80, 128) and head dim, with
    ragged query counts: 1000 and 300 queries end in part-empty tiles, each
    head's tiles split into 8 and 5 runs of a block each."""
    from gmdx_torch.kernels.flash_attention import (
        cross_attention_shortk, cross_attention_shortk_plain,
    )

    for b, sq in ((2, 1000), (3, 300)):
        q = _bf16(card, b, sq, 8 * d)
        k, v = _bf16(card, b, sk, 8 * d), _bf16(card, b, sk, 8 * d)
        out = cross_attention_shortk(q, k, v, 8)
        assert _rel_l2(out, cross_attention_shortk_plain(q, k, v, 8)) <= 1e-2, (b, sq)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 80, 160])
@pytest.mark.parametrize("b,sq,sk", [(16, 4096, 77), (16, 1024, 77), (16, 256, 77), (2, 1000, 1),
                                     (3, 300, 128), (1, 64, 8)])
def test_xattn_plan_matches_kernel_on_card(card, d, b, sq, sk):
    """xattn_plan field for field against gmdx_xattn_plan, the C plan the
    short-K kernel launches with."""
    import ctypes

    from gmdx_torch.kernels import _build
    from gmdx_torch.kernels.flash_attention import xattn_plan

    got = (ctypes.c_int * 8)()
    assert _build.library("attention").gmdx_xattn_plan(b, sq, sk, 8, d, got) == 0
    assert list(got) == xattn_plan(b, sq, sk, 8, d).c_fields()


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,c,sk", [(16, 4096, 320, 77), (4, 4096, 320, 77),
                                      (16, 1024, 640, 77), (16, 300, 1280, 128)])
def test_xattn_repeat_is_bit_identical_on_card(card, b, sq, c, sk):
    """50 calls give the same bits: the Q ring's stages are handed to the
    consumers without a race (a stage read before its fill landed would
    change the output or fault)."""
    from gmdx_torch.kernels.flash_attention import cross_attention_shortk

    q = _bf16(card, b, sq, c)
    k, v = _bf16(card, b, sk, c), _bf16(card, b, sk, c)
    first = cross_attention_shortk(q, k, v, 8)
    for _ in range(49):
        assert torch.equal(cross_attention_shortk(q, k, v, 8), first)


# GroupNorm cases for each form and cluster size the plan takes: (B, H, W,
# C, form, cluster). Batches of tiny images reach n = 1 and 2; the small
# images of the 512^2 UNet run in one wave, at batch 16 of n = 4, at the
# Stage-2 batch 8 of n = 8; its larger ones take n = 16, and those that do
# not fit (64^2 x 640, 32^2 x 1920) the pair, as does a 128^2 x 320 image
# at batch 2 (the 1024^2 UNet's first level).
GN_FORM_CASES = [
    (132, 8, 8, 64, "resident", 1), (60, 8, 8, 64, "resident", 2),
    (16, 8, 8, 1280, "resident", 4), (16, 16, 16, 1280, "resident", 4),
    (8, 8, 8, 1280, "resident", 8), (8, 32, 32, 640, "resident", 8),
    (2, 64, 64, 320, "resident", 16), (16, 32, 32, 640, "resident", 16),
    (16, 64, 64, 640, "pair", 1), (16, 32, 32, 1920, "pair", 1),
    (2, 128, 128, 320, "pair", 1),
]


def _gn_inputs(gen, b, h, w, c):
    x = (_bf16(gen, b, h, w, c, scale=2.0).float() + 0.5).to(torch.bfloat16)
    g = (1.0 + _bf16(gen, c, scale=0.2).float()).to(torch.bfloat16)
    return x, g, _bf16(gen, c, scale=0.2), _bf16(gen, b, c)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,form,cluster", GN_FORM_CASES)
@pytest.mark.parametrize("temb,act,pad", [(False, True, True), (True, True, True),
                                          (True, False, False)])
def test_group_norm_forms_on_card(card, b, h, w, c, form, cluster, temb, act, pad):
    """Every form the plan takes against the plain version: output within
    1e-2 relative L2, the (mean, rstd) stats within 1e-3 relative."""
    from gmdx_torch.kernels.groupnorm import group_norm_plan

    plan = group_norm_plan(b, h, w, c)
    assert (plan.form, plan.cluster) == (form, cluster)
    x, g, be, t = _gn_inputs(card, b, h, w, c)
    t = t if temb else None
    out, stats = group_norm_silu(x, g, be, t, activate=act, pad_output=pad, return_stats=True)
    ref, ref_stats = group_norm_silu_plain(
        x.float(), g.float(), be.float(), t.float() if temb else None, activate=act,
        pad_output=pad, return_stats=True,
    )
    assert _rel_l2(out, ref) <= 1e-2
    for i in range(2):  # mean, then rstd
        assert _rel_l2(stats[:, i], ref_stats[:, i]) <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c", [(b, h, w, c) for b, h, w, c, _, _ in GN_FORM_CASES]
                         + [(16, 512, 512, 128), (2, 512, 512, 128), (8, 256, 256, 256),
                            (2, 1024, 1024, 128)])
def test_group_norm_plan_matches_kernel_on_card(card, b, h, w, c):
    """group_norm_plan field for field against gmdx_group_norm_plan, the C
    plan the forward launches with; the clusters resident at once
    (cudaOccupancyMaxActiveClusters) are those the plan counts its waves by."""
    import ctypes

    from gmdx_torch.kernels import _build
    from gmdx_torch.kernels.groupnorm import RESIDENT_CLUSTERS, group_norm_plan

    got = (ctypes.c_int * 8)()
    assert _build.library("groupnorm").gmdx_group_norm_plan(b, h, w, c, got) == 0
    plan = group_norm_plan(b, h, w, c)
    assert list(got)[:7] == plan.c_fields()
    assert got[7] == (RESIDENT_CLUSTERS[plan.cluster] if plan.form != "pair" else 0), list(got)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c", [(16, 64, 64, 320), (16, 64, 64, 640), (2, 128, 128, 320)])
def test_group_norm_repeat_is_bit_identical_on_card(card, b, h, w, c):
    """No atomics in the forward's sums: a repeated call gives the same
    bits, stats included (the cluster kernel and the pair)."""
    x, g, be, t = _gn_inputs(card, b, h, w, c)
    one = group_norm_silu(x, g, be, t, pad_output=True, return_stats=True)
    two = group_norm_silu(x, g, be, t, pad_output=True, return_stats=True)
    assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])


# The GroupNorm backward at the Stage-2 step's shapes, batch 8: (H = W, C,
# temb, activate, pad) of a resnet norm2 at each level (temb, SiLU, padded),
# the transformer's GN at 32^2 x 640 and the widest norm1 (16^2 x 2560).
GN_BWD_CASES = [(64, 320, True, True, True), (32, 640, True, True, True),
                (16, 1280, True, True, True), (8, 1280, True, True, True),
                (32, 640, False, False, False), (16, 2560, False, True, True)]


def _c_ints(n):
    import ctypes

    return (ctypes.c_int * n)()


def _gn_bwd_operands(gen, b, hw, c, temb, act, pad):
    x, gam, bet, t = _gn_inputs(gen, b, hw, hw, c)
    t = t if temb else None
    g = _bf16(gen, b, hw + 2 * pad, hw + 2 * pad, c)
    _, stats = group_norm_silu(x, gam, bet, t, activate=act, pad_output=pad, return_stats=True)
    return x, gam, bet, t, stats, g


@pytest.mark.cuda
@pytest.mark.parametrize("hw,c,temb,act,pad", GN_BWD_CASES)
def test_group_norm_bwd_repeat_is_bit_identical_on_card(card, hw, c, temb, act, pad):
    """50 calls give the same bits in all four outputs: every sum of the
    backward is folded in a fixed order (no atomics), and the grid barrier
    and the images' arrival counters are left zeroed for the next call."""
    ops = _gn_bwd_operands(card, 8, hw, c, temb, act, pad)
    first = group_norm_silu_bwd(*ops, activate=act, pad_output=pad)
    for _ in range(49):
        again = group_norm_silu_bwd(*ops, activate=act, pad_output=pad)
        for a, b in zip(first, again):
            assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("hw,c,temb,act,pad", GN_BWD_CASES)
def test_group_norm_bwd_outputs_and_dtemb_on_card(card, hw, c, temb, act, pad):
    """dx, dgamma, dbeta and, with a temb, dtemb (the kernel's own fold of
    dx over each image's pixels) against the fp32 plain version from the
    same statistics, relative L2 <= 1e-2; one device kernel a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x, gam, bet, t, stats, g = _gn_bwd_operands(card, 8, hw, c, temb, act, pad)
    got = group_norm_silu_bwd(x, gam, bet, t, stats, g, activate=act, pad_output=pad)
    ref = group_norm_silu_bwd_plain(
        x.float(), gam.float(), bet.float(), t.float() if temb else None, stats, g.float(),
        activate=act, pad_output=pad,
    )
    assert (got[3] is None) == (not temb)
    for a, b in zip(got, ref):
        if b is not None:
            assert _rel_l2(a, b) <= 1e-2
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        group_norm_silu_bwd(x, gam, bet, t, stats, g, activate=act, pad_output=pad)
        torch.cuda.synchronize()
    kernels = [ev.key for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    assert kernels and all("gn_bwd_kernel" in k for k in kernels), kernels
    assert len(kernels) == 1, kernels


@pytest.mark.cuda
def test_group_norm_bwd_channel_limit_on_card(card):
    """C <= 4096 (an 8-channel chunk a thread, 512 threads): the widest
    runs, one more chunk raises in the wrapper and the C entry refuses it
    (cudaErrorInvalidValue)."""
    from gmdx_torch.kernels import _build
    from gmdx_torch.kernels.groupnorm import MAX_CHANNELS

    assert MAX_CHANNELS == 4096
    x, gam, bet, t, stats, g = _gn_bwd_operands(card, 2, 4, MAX_CHANNELS, True, True, False)
    got = group_norm_silu_bwd(x, gam, bet, t, stats, g, activate=True)
    ref = group_norm_silu_bwd_plain(x.float(), gam.float(), bet.float(), t.float(), stats,
                                    g.float(), activate=True)
    for a, b in zip(got, ref):
        assert _rel_l2(a, b) <= 1e-2
    c = MAX_CHANNELS + 8
    wide = torch.zeros(2, 4, 4, c, dtype=torch.bfloat16, device="cuda")
    one = torch.ones(c, dtype=torch.bfloat16, device="cuda")
    st = torch.ones(2, 2, 8, device="cuda")
    with pytest.raises(ValueError, match="unsupported C"):
        group_norm_silu_bwd(wide, one, one, None, st, wide)
    lib = _build.library("groupnorm")
    assert lib.gmdx_group_norm_silu_bwd(*[None] * 13, 2, 4, 4, c, 8, 1, 2, 1, 0, None) == 1
    assert lib.gmdx_group_norm_bwd_plan(2, 4, 4, c, _c_ints(7)) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 2, 8])
def test_group_norm_bwd_plan_matches_kernel_on_card(card, b):
    """group_norm_bwd_plan field for field against gmdx_group_norm_bwd_plan
    at every GroupNorm shape of the Stage-2 step, and the blocks an SM the
    plan counts (from BWD_REGISTERS) against
    cudaOccupancyMaxActiveBlocksPerMultiprocessor, which the C plan takes."""
    from gmdx_torch.kernels import _build
    from gmdx_torch.kernels.groupnorm import group_norm_bwd_plan

    shapes = [(8, 8, 1280), (8, 8, 2560), (16, 16, 640), (16, 16, 1280), (16, 16, 1920),
              (16, 16, 2560), (32, 32, 320), (32, 32, 640), (32, 32, 960), (32, 32, 1280),
              (32, 32, 1920), (64, 64, 320), (64, 64, 640), (64, 64, 960), (8, 8, 4096)]
    lib = _build.library("groupnorm")
    for h, w, c in shapes:
        got = _c_ints(7)
        assert lib.gmdx_group_norm_bwd_plan(b, h, w, c, got) == 0
        assert list(got) == group_norm_bwd_plan(b, h, w, c).c_fields(), (h, w, c)


@pytest.mark.cuda
@pytest.mark.parametrize("m,c", [(65536, 320), (16384, 640), (4096, 1280), (1024, 1280),
                                 (1, 320), (15, 320), (1, 8), (639, 8), (3, 2048), (9, 24)])
def test_add_layer_norm_plan_matches_kernel_on_card(card, m, c):
    """add_layer_norm_plan field for field against gmdx_add_ln_plan; the card
    holds at least the blocks an SM the plan puts on it."""
    from gmdx_torch.kernels import _build
    from gmdx_torch.kernels.geglu_ff import add_layer_norm_plan

    got = _c_ints(7)
    assert _build.library("add_ln").gmdx_add_ln_plan(m, c, got) == 0
    plan = add_layer_norm_plan(m, c)
    assert list(got)[:6] == plan.c_fields() and got[6] >= plan.per_sm, list(got)


@pytest.mark.cuda
@pytest.mark.parametrize("m,c", [(1, 320), (15, 320), (17, 640), (3, 1280), (1, 8), (639, 8),
                                 (641, 8), (3, 2048), (9, 24), (1000, 1280), (5000, 640)])
def test_add_layer_norm_tails_on_card(card, m, c):
    """Short last tiles (one row, one short of a tile, one past), C = 8 and
    2048 and a generic C, a row count that leaves blocks one tile more than
    others; against the plain version, s bit for bit."""
    from gmdx_torch.kernels.geglu_ff import add_layer_norm, add_layer_norm_plain

    x, y = _bf16(card, 1, m, c), _bf16(card, 1, m, c)
    g = 1.0 + _bf16(card, c, scale=0.2).float()
    b = _bf16(card, c, scale=0.2).float()
    s, h = add_layer_norm(x, y, g, b)
    ref_s, ref_h = add_layer_norm_plain(x, y, g, b)
    assert torch.equal(s, ref_s)
    assert _rel_l2(h, ref_h) <= 1e-2


@pytest.mark.cuda
def test_add_layer_norm_refuses_a_misaligned_view_on_card(card):
    """The bulk copies need 16-byte aligned rows: a contiguous view two
    bytes into its buffer raises, and nothing falls back."""
    from gmdx_torch.kernels.geglu_ff import add_layer_norm

    x = torch.zeros(4 * 320 + 1, dtype=torch.bfloat16, device="cuda")[1:].view(1, 4, 320)
    y = torch.zeros(1, 4, 320, dtype=torch.bfloat16, device="cuda")
    one, zero = torch.ones(320, device="cuda"), torch.zeros(320, device="cuda")
    assert x.is_contiguous() and x.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        add_layer_norm(x, y, one, zero)
    with pytest.raises(ValueError, match="16-byte"):
        add_layer_norm(y, x, one, zero)


# The flash backward at the VAE's 512-wide head: Stage 1 at 1024^2, batch 1,
# and at 768^2, batch 4.
WIDE_BWD_SHAPES = [(1, 16384), (4, 9216)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", WIDE_BWD_SHAPES)
def test_flash_bwd_d512_on_card(card, b, s):
    """The 512-wide backward against the fp32 plain version (dq, dk, dv each
    within relative L2 1e-2), counted as flash_attention_bwd_d512, and 20
    repeats bit-identical to the first."""
    q, k, v, dout = (_bf16(card, b, s, 512) for _ in range(4))
    out, lse = flash_attention_fwd(q, k, v, 1)
    before = launch_counts()["flash_attention_bwd_d512"]
    grads = flash_attention_bwd(q, k, v, out, lse, dout, 1)
    assert launch_counts()["flash_attention_bwd_d512"] == before + 1
    refs = flash_attention_bwd_plain(q.float(), k.float(), v.float(), out.float(), lse,
                                     dout.float(), 1, 512 ** -0.5)
    for got, ref in zip(grads, refs):
        assert _rel_l2(got, ref) <= 1e-2
    del refs
    for _ in range(20):
        again = flash_attention_bwd(q, k, v, out, lse, dout, 1)
        assert all(torch.equal(a, g) for a, g in zip(again, grads))


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk", [(100, 77), (4096, 4000), (33, 16400)])
def test_flash_bwd_d512_ragged_on_card(card, sq, sk):
    """Query and key counts that leave ragged tiles and part-empty
    128-row clusters."""
    q, dout = _bf16(card, 2, sq, 512), _bf16(card, 2, sq, 512)
    k, v = _bf16(card, 2, sk, 512), _bf16(card, 2, sk, 512)
    out, lse = flash_attention_fwd(q, k, v, 1)
    grads = flash_attention_bwd(q, k, v, out, lse, dout, 1)
    refs = flash_attention_bwd_plain(q.float(), k.float(), v.float(), out.float(), lse,
                                     dout.float(), 1, 512 ** -0.5)
    for got, ref in zip(grads, refs):
        assert _rel_l2(got, ref) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("b,s", WIDE_BWD_SHAPES)
def test_flash_fwd_d512_stage1_shapes_on_card(card, b, s):
    """The 512-wide forward at Stage 1's shapes: out and lse against the
    fp32 plain version, counted as flash_attention_fwd_d512, and 20 repeats
    bit-identical to the first."""
    q, k, v = (_bf16(card, b, s, 512) for _ in range(3))
    before = launch_counts()["flash_attention_fwd_d512"]
    out, lse = flash_attention_fwd(q, k, v, 1)
    assert launch_counts()["flash_attention_fwd_d512"] == before + 1
    ref, ref_lse = flash_attention_fwd_plain(q.float(), k.float(), v.float(), 1, 512**-0.5)
    assert _rel_l2(out, ref) <= 1e-2 and _rel_l2(lse, ref_lse) <= 1e-2
    assert float((lse - ref_lse).abs().max()) <= 2e-2
    for _ in range(20):
        again, again_lse = flash_attention_fwd(q, k, v, 1)
        assert torch.equal(again, out) and torch.equal(again_lse, lse)


# The 512-wide kernels' path shapes (Stage 1 at 1024^2 and 768^2, the HDRTV
# decode) and ragged ones, one head.
WIDE_PLAN_SHAPES = [(1, 16384, 16384), (2, 16384, 16384), (4, 9216, 9216), (2, 100, 77),
                    (2, 33, 16400), (3, 129, 127)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk", WIDE_PLAN_SHAPES)
def test_wide_plans_match_kernels_on_card(card, b, sq, sk):
    """wide_fwd_plan and wide_bwd_plans are the WidePlan structs the 512-wide
    kernels launch with, field for field (gmdx_wide_plan)."""
    import ctypes

    from gmdx_torch.kernels import _build

    lib = _build.library("flash_attention")
    for kind, plan in enumerate((wide_fwd_plan(b, sq, sk, 1), *wide_bwd_plans(b, sq, sk, 1))):
        got = (ctypes.c_int * 8)()
        assert lib.gmdx_wide_plan(kind, b, sq, sk, 1, got) == 0
        assert list(got) == plan.c_fields(), (kind, plan)


def _old_convention_lse(q, k, scale):
    """The base-2 lse the 512-wide forward wrote before its rebuild, from
    Qs = bf16(Q * scale * log2 e) rounded in place; fp32, in query chunks."""
    qs = (q.float() * (scale / np.log(2.0))).to(torch.bfloat16).float()
    kf = k.float()
    return torch.cat([torch.logsumexp(torch.einsum("bqd,bkd->bqk", c, kf) * np.log(2.0), -1)
                      / np.log(2.0) for c in qs.split(1024, dim=1)], dim=1)[:, None]


# The dV column-sum identity's bar, between its sound reading (the kernels'
# own forward lse) and its control (an lse under the old Qs = bf16(Q c)
# convention).
WIDE_COLSUM_BAR = 1.2e-4


@pytest.mark.cuda
def test_flash_bwd_d512_dv_column_sums_on_card(card):
    """Each row of P sums to one, so the sum over keys of dV equals the sum
    over queries of dO. Held at 1x16384 with the kernels' own forward lse
    (forward and backward on one rounding convention); the control, an lse
    from the old convention's bf16-rounded Qs, must trip the same bar."""
    q, k, v, dout = (_bf16(card, 1, 16384, 512) for _ in range(4))
    out, lse = flash_attention_fwd(q, k, v, 1)
    want = dout.float().sum(dim=1)
    readings = {}
    for name, l in (("sound", lse), ("control", _old_convention_lse(q, k, 512**-0.5))):
        dv = flash_attention_bwd(q, k, v, out, l, dout, 1)[2]
        readings[name] = _rel_l2(dv.float().sum(dim=1), want)
    print("dv column sums, relative L2:", readings)
    assert readings["sound"] <= WIDE_COLSUM_BAR < readings["control"], readings


# The GroupNorm backward at the VAE's shapes under Stage 1 (eps 1e-6 for the
# conv_norm_out and attention norms; 1e-5 in the resnets), no temb: 512^2
# at batch 4, 1024^2 at batch 1.
VAE_GN_BWD_SHAPES = [(4, 512, 128), (4, 256, 256), (4, 128, 512), (4, 64, 512), (1, 1024, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("eps", [1e-6, 1e-5])
@pytest.mark.parametrize("b,hw,c", VAE_GN_BWD_SHAPES)
def test_group_norm_bwd_vae_shapes_on_card(card, b, hw, c, eps):
    x = _bf16(card, b, hw, hw, c, scale=2.0)
    gam = (1.0 + _bf16(card, c, scale=0.2).float()).to(torch.bfloat16)
    bet = _bf16(card, c, scale=0.2)
    g = _bf16(card, b, hw + 2, hw + 2, c)
    _, stats = group_norm_silu(x, gam, bet, None, eps=eps, pad_output=True, return_stats=True)
    _, ref_stats = group_norm_silu_plain(x.float(), gam.float(), bet.float(), None, eps=eps,
                                         pad_output=True, return_stats=True)
    got = group_norm_silu_bwd(x, gam, bet, None, stats, g, pad_output=True)
    ref = group_norm_silu_bwd_plain(x.float(), gam.float(), bet.float(), None, ref_stats,
                                    g.float(), pad_output=True)
    for a, r in zip(got, ref):
        if r is not None:
            assert _rel_l2(a, r) <= 1e-2
    again = group_norm_silu_bwd(x, gam, bet, None, stats, g, pad_output=True)
    assert all(a is r is None or torch.equal(a, r) for a, r in zip(again, got))


@pytest.mark.cuda
def test_stage1_steps_at_1024_on_card(card):
    """A Stage-1 gen step and disc step at full SD-1.5 VAE width, batch 1,
    1024^2, bf16 compute: finite losses, and the kernel path taken (the
    512-wide flash forward and backward, the GroupNorm backward, the conv
    in the disc step's no-grad VAE forward)."""
    from gmdx_torch.kernels import reset_launch_counts
    from gmdx_torch.models import SD15_VAE_CONFIG, AutoencoderKL
    from gmdx_torch.models.discriminator import Discriminator
    from gmdx_torch.models.vgg import VGG19Features
    from gmdx_torch.ops import fix_mulog_tmo
    from gmdx_torch.train import stage1

    torch.manual_seed(0)
    with torch.device("cuda"):
        vae = AutoencoderKL(SD15_VAE_CONFIG, dtype=torch.bfloat16)
        vgg = VGG19Features(dtype=torch.bfloat16)
        disc = Discriminator(dtype=torch.bfloat16)
    config = stage1.Stage1Config()
    trainables = stage1.init_trainables(card, vae, config)
    state = stage1.init_state(config, trainables, disc)
    gen = stage1.make_gen_step(config, vae=vae, discriminator=disc, vgg=vgg,
                               tmo_fn=fix_mulog_tmo)
    dstep = stage1.make_disc_step(config, vae=vae, discriminator=disc, tmo_fn=fix_mulog_tmo)
    batch = {k: torch.rand(1, 3, 1024, 1024, generator=card, device="cuda") * 2 - 1
             for k in ("pixel_values", "miss_pixel_values")}
    reset_launch_counts()
    state, gm = gen(state, batch, card)
    counts = launch_counts()
    state, dm = dstep(state, batch, card)
    both = launch_counts()
    for m in (gm, dm):
        for k, v in m.items():
            if k != "module_grad_norms":
                assert bool(torch.isfinite(v)), (k, v)
    assert counts["flash_attention_fwd_d512"] == 2 and counts["flash_attention_bwd_d512"] == 2
    assert counts["group_norm_silu_bwd"] > 0 and counts["conv3x3"] == 0
    assert both["flash_attention_fwd_d512"] == 4 and both["conv3x3"] > 0


def _sampler_cases():
    from gmdx_torch.schedulers import get_scheduler

    return [("ddim", dict(eta=0.0), get_scheduler("ddim"), 6),
            ("ddim_eta", dict(eta=0.7), get_scheduler("ddim"), 6),
            ("dpm++", {}, get_scheduler("dpm++"), 8),
            ("dpm_karras_order1", {}, get_scheduler("dpm++", use_karras_sigmas=True,
                                                    solver_order=1), 6),
            ("lcm", {}, get_scheduler("lcm"), 4)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(5), ids=lambda i: ["ddim", "ddim_eta", "dpm++",
                                                          "dpm_karras_order1", "lcm"][i])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_sampler_steps_on_card(card, case, dtype):
    """Each new sampler's steps on CUDA tensors against the same steps on CPU
    tensors (the same noise given as ``noise=``): the output keeps the
    input's dtype and device, and no step synchronises with the host."""
    name, kw, sched, steps = _sampler_cases()[case]
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 64, 64, 4, generator=g).to(dtype)
    eps = [torch.randn(2, 64, 64, 4, generator=g).to(dtype) for _ in range(steps)]
    noise = [torch.randn(2, 64, 64, 4, generator=g).to(dtype) for _ in range(steps)]
    takes_noise = "noise" in inspect.signature(sched.step).parameters
    s_cpu, s_gpu = sched.init_state(steps), sched.init_state(steps)
    x_cpu, x_gpu = x, x.cuda()
    eps_gpu, noise_gpu = [e.cuda() for e in eps], [n.cuda() for n in noise]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for i in range(steps):
            extra = {"noise": noise_gpu[i]} if takes_noise else {}
            x_gpu = sched.step(s_gpu, eps_gpu[i], x_gpu, **kw, **extra)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for i in range(steps):
        extra = {"noise": noise[i]} if takes_noise else {}
        x_cpu = sched.step(s_cpu, eps[i], x_cpu, **kw, **extra)
    assert x_gpu.dtype == dtype and x_gpu.is_cuda
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    peak = float(x_cpu.float().abs().max())
    err = float((x_gpu.cpu().float() - x_cpu.float()).abs().max())
    assert err <= tol * peak, f"{name}: {err} of peak {peak}"


@pytest.mark.cuda
def test_device_prefetch_waits_for_its_copies_on_card(card):
    """Batches copied on the prefetcher's side stream are read on the
    compute stream while it is still busy: every batch reads back as it was
    made (none stale or half copied), and neither thread synchronises with
    the host."""
    from gmdx_torch.data import device_prefetch

    n, size = 6, 1 << 24
    host = [{"x": np.full(size, i + 1, np.int32)} for i in range(n)]
    busy = torch.randn(4096, 4096, device="cuda")
    torch.cuda.synchronize()
    sums = []
    torch.cuda.set_sync_debug_mode("error")
    try:
        for batch in device_prefetch(iter(host), device="cuda", depth=2):
            for _ in range(4):  # keep the compute stream behind the copies
                busy = busy @ busy * 1e-3
            sums.append(batch["x"].sum())
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert [int(s) for s in sums] == [(i + 1) * size for i in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("ga,eight_bit", [(1, False), (2, True)])
def test_checkpoint_round_trip_of_cuda_tensors_on_card(card, tmp_path, ga, eight_bit):
    """A Stage-2 state on the card (AdamW, MultiSteps, bf16 mu, EMA) saved
    asynchronously and restored into a fresh state on the card, bit for
    bit, while the parameters move on in place."""
    import dataclasses

    from gmdx_torch.models import TINY_UNET_CONFIG, UNet2DConditionModel
    from gmdx_torch.train import (
        Stage2Config, init_state, make_ema_step, make_manager, restore_state, save_state,
    )
    from gmdx_torch.train.checkpoint import state_tensors

    def trained(seed, steps):
        torch.manual_seed(seed)
        with torch.device("cuda"):
            unet = UNet2DConditionModel(dataclasses.replace(TINY_UNET_CONFIG, in_channels=8))
        cfg = Stage2Config(learning_rate=1e-3, gradient_accumulation_steps=ga,
                           use_8bit_adam=eight_bit, use_ema=True)
        state = init_state(cfg, unet)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        for _ in range(steps):
            state.optimizer.step([torch.randn(p.shape, generator=gen, device="cuda")
                                  for p in state.optimizer.params])
            state.step += 1
            make_ema_step(cfg)(state)
        return state

    state = trained(0, 3)
    want = {k: v.clone() for k, v in state_tensors(state)[0].items()}
    manager = make_manager(str(tmp_path), async_checkpointing=True)
    save_state(manager, 3, state, wait=False)
    with torch.no_grad():
        for p in state.optimizer.params:
            p.add_(1.0)
    manager.wait_until_finished()
    fresh = trained(1, 1)
    restore_state(manager, 3, fresh)
    got, scalars = state_tensors(fresh)
    assert scalars == state_tensors(state)[1]
    for k, v in want.items():
        assert got[k].is_cuda and got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.cuda
def test_unet_remat_gradients_on_card(card):
    """A UNet whose attentions take the flash kernels (d = 40 at 1024
    tokens) and whose norms take the GroupNorm kernels: the loss under
    remat equals the plain backward's, every gradient is within 1e-3
    relative L2, the backward kernels launch as often, and the forward
    kernels run again in the recompute."""
    import dataclasses

    from gmdx_torch.kernels import reset_launch_counts
    from gmdx_torch.models import UNet2DConditionModel, UNetConfig

    cfg = UNetConfig(in_channels=8, block_out_channels=(320, 640), layers_per_block=1,
                     down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
                     up_block_types=("UpBlock2D", "CrossAttnUpBlock2D"))
    torch.manual_seed(0)
    with torch.device("cuda"):
        plain = UNet2DConditionModel(cfg, dtype=torch.bfloat16)
        remat = UNet2DConditionModel(dataclasses.replace(cfg, remat=True), dtype=torch.bfloat16)
    remat.load_state_dict(plain.state_dict())
    x = torch.randn(2, 8, 32, 32, generator=card, device="cuda")
    ctx = torch.randn(2, 77, 768, generator=card, device="cuda")
    t = torch.tensor([10, 700], device="cuda")
    out = {}
    for name, model in (("plain", plain), ("remat", remat)):
        model.train().zero_grad()
        reset_launch_counts()
        loss = (model(x, t, ctx) ** 2).mean()
        loss.backward()
        out[name] = (float(loss), [p.grad.clone() for p in model.parameters()], launch_counts())
    (lp, gp, cp), (lr, gr, cr) = out["plain"], out["remat"]
    assert lr == lp
    for a, b in zip(gr, gp):
        assert _rel_l2(a, b) <= 1e-3
    assert cr["flash_attention_bwd"] == cp["flash_attention_bwd"] > 0
    assert cr["group_norm_silu_bwd"] == cp["group_norm_silu_bwd"] > 0
    assert cr["flash_attention_fwd"] > cp["flash_attention_fwd"] > 0


def _sd15_controlnet_pair(gen, adapter_std: float = 0.05):
    """A seeded random SD-1.5 UNet frozen in bf16 and a ControlNet copied
    from it (float32 masters, bf16 compute, as the trainer CLI holds it),
    its adapters (zero convs, the embedder's conv_out) N(0, adapter_std^2)
    so that every parameter takes gradient."""
    from gmdx_torch.io.convert import controlnet_state_dict_from_unet
    from gmdx_torch.models import (
        SD15_CONTROLNET_CONFIG, SD15_UNET_CONFIG, ControlNetModel, UNet2DConditionModel,
    )

    torch.manual_seed(0)
    with torch.device("cuda"):
        unet = UNet2DConditionModel(SD15_UNET_CONFIG).to(torch.bfloat16).eval()
        cnet = ControlNetModel(SD15_CONTROLNET_CONFIG, dtype=torch.bfloat16)
    cnet.load_state_dict(controlnet_state_dict_from_unet(
        cnet.state_dict(), {k: v.float() for k, v in unet.state_dict().items()}))
    with torch.no_grad():
        for name, p in cnet.named_parameters():
            if name.startswith(("controlnet_down_blocks.", "controlnet_mid_block.",
                                "controlnet_cond_embedding.conv_out.")):
                p.copy_(torch.randn(p.shape, generator=gen, device="cuda") * adapter_std)
    return unet.requires_grad_(False), cnet.train()


@pytest.mark.cuda
def test_controlnet_step_kernels_against_plain_on_card(card):
    """One ControlNet loss and gradient at SD-1.5 width, batch 1, 512^2: the
    kernels against the plain versions (use_kernels=False) on the same
    inputs, loss within 1e-3 relative, the ControlNet's gradient at cosine
    >= 0.9995; the kernels' run launches as the route rule says (the frozen
    UNet's 6 down-block self-attentions on the KV-resident kernel, the 9
    up-block and 6 ControlNet ones on the flash forward and backward) and
    the UNet takes no gradient."""
    from gmdx_torch.kernels import reset_launch_counts
    from gmdx_torch.models import set_use_kernels
    from gmdx_torch.train import controlnet_loss

    unet, cnet = _sd15_controlnet_pair(card)
    inputs = {
        "noisy_latents": torch.randn(1, 4, 64, 64, generator=card, device="cuda"),
        "timesteps": torch.tensor([437], device="cuda"),
        "encoder_hidden_states": _bf16(card, 1, 77, 768),
        "control_image": torch.rand(1, 3, 512, 512, generator=card, device="cuda"),
        "noise": torch.randn(1, 4, 64, 64, generator=card, device="cuda"),
    }
    params = list(cnet.parameters())
    out = {}
    for use in (True, False):
        set_use_kernels(unet, use)
        set_use_kernels(cnet, use)
        reset_launch_counts()
        loss = controlnet_loss(cnet, unet, **inputs)
        grads = torch.autograd.grad(loss, params)
        out[use] = (float(loss.detach()), torch.cat([g.float().flatten() for g in grads]),
                    launch_counts())
    (lk, gk, ck), (lp, gp, _) = out[True], out[False]
    cos = float(torch.dot(gk, gp) / (gk.norm() * gp.norm()))
    print(f"controlnet step, kernels against plain: loss {lk} / {lp} "
          f"(rel {abs(lk - lp) / abs(lp):.3e}), gradient cosine {cos:.6f}")
    assert abs(lk - lp) <= 1e-3 * abs(lp), (lk, lp)
    assert cos >= 0.9995, cos
    assert (ck["attention_kv_resident"], ck["flash_attention_fwd"],
            ck["flash_attention_bwd"]) == (6, 15, 15), ck
    assert ck["group_norm_silu_bwd"] > 0 and ck["conv3x3"] > 0 and ck["geglu_ff_ln"] > 0
    assert ck["flash_attention_bsc"] == ck["flash_attention_fwd_d512"] == 0
    assert all(p.grad is None for p in unet.parameters())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["stage1", "controlnet"])
def test_stage1_and_controlnet_checkpoints_of_cuda_tensors_on_card(card, tmp_path, kind):
    """A Stage-1 state (LoRA trainables, both optimizers under accumulation,
    the discriminator's spectral-norm buffers, EMA) and a ControlNet state
    on the card, saved asynchronously and restored into fresh states on
    the card, bit for bit, while the originals move on in place."""
    from gmdx_torch.models import (
        TINY_CONTROLNET_CONFIG, TINY_VAE_CONFIG, AutoencoderKL, ControlNetModel, Discriminator,
        LoRAConfig,
    )
    from gmdx_torch.train import (
        ControlNetTrainConfig, init_controlnet_state, make_controlnet_ema_step, make_manager,
        restore_state, save_state, stage1,
    )
    from gmdx_torch.train.checkpoint import state_tensors

    def trained(seed):
        torch.manual_seed(seed)
        gen = torch.Generator(device="cuda").manual_seed(seed)
        if kind == "stage1":
            cfg = stage1.Stage1Config(lora=LoRAConfig(rank=2, alpha=2.0), use_ema=True)
            with torch.device("cuda"):
                vae, disc = AutoencoderKL(TINY_VAE_CONFIG), Discriminator(depth=4,
                                                                         hidden_channels=64)
            trainables = stage1.init_trainables(gen, vae, cfg)
            state = stage1.init_state(cfg, trainables, disc, stage1.make_optimizers(
                trainables, disc, gradient_accumulation_steps=2))
            opts, ema = (state.optimizer, state.disc_optimizer), stage1.make_ema_step(cfg)
            with torch.no_grad():
                for b in disc.buffers():
                    b.add_(torch.randn(b.shape, generator=gen, device="cuda"))
        else:
            cfg = ControlNetTrainConfig(learning_rate=1e-3, gradient_accumulation_steps=2,
                                        use_ema=True)
            with torch.device("cuda"):
                cnet = ControlNetModel(TINY_CONTROLNET_CONFIG)
            state = init_controlnet_state(cfg, cnet)
            opts, ema = (state.optimizer,), make_controlnet_ema_step(cfg)
        for _ in range(3):
            for opt in opts:
                opt.step([torch.randn(p.shape, generator=gen, device="cuda") for p in opt.params])
            state.step += 1
            ema(state)
        return state

    state = trained(0)
    want, scalars = state_tensors(state)
    want = {k: v.clone() for k, v in want.items()}
    manager = make_manager(str(tmp_path), async_checkpointing=True)
    save_state(manager, 3, state, wait=False)
    with torch.no_grad():
        for t in state_tensors(state)[0].values():
            t.add_(1.0)
    manager.wait_until_finished()
    fresh = trained(1)
    restore_state(manager, 3, fresh)
    got, got_scalars = state_tensors(fresh)
    assert got_scalars == scalars
    for k, v in want.items():
        assert got[k].is_cuda and got[k].dtype == v.dtype and torch.equal(got[k], v), k


@pytest.mark.cuda
def test_exposure_augmentation_on_card_does_not_sync(card):
    """The exposure chain on a CUDA batch draws its scalars on the host: no
    synchronisation (sync debug mode "error"), and the result equals the
    chain on the same batch on the CPU with the same draws (fp32, within
    1e-5 relative L2: the two devices' pow may differ by an ulp, which
    moves a uint16 level where it straddles a rounding boundary)."""
    from gmdx_torch.ops import random_exposure_adjust

    img = torch.rand(4, 3, 512, 512, generator=card, device="cuda")
    outs = []
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for seed in range(8):
            outs.append(random_exposure_adjust(torch.Generator().manual_seed(seed), img,
                                               prob=0.7))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    host = img.cpu()
    for seed, (out, meta) in enumerate(outs):
        want, want_meta = random_exposure_adjust(torch.Generator().manual_seed(seed), host,
                                                 prob=0.7)
        assert meta == want_meta and out.is_cuda
        assert _rel_l2(out.cpu(), want) <= 1e-5


@pytest.mark.cuda
def test_safety_checker_fp32_on_card_against_cpu(card):
    """The SD-1.5-width safety checker (ViT-L/14, 304 M parameters, seeded)
    in float32 on the card against the same weights on the CPU, batch 2 of
    512^2 images: projected embeddings at cosine >= 0.9999 per image, the
    flags equal wherever every score is beyond 1e-3 of 0. The thresholds
    sit 0.01 off the first image's cosines, below on odd concepts and above
    on the rest, so that its flag is decided and set."""
    from gmdx_torch.models import (
        CLIP_VIT_L_VISION_CONFIG, StableDiffusionSafetyChecker, make_safety_checker_fn,
        preprocess_for_clip,
    )

    torch.manual_seed(0)
    with torch.device("cuda"):
        gpu = StableDiffusionSafetyChecker(CLIP_VIT_L_VISION_CONFIG).eval()
    with torch.device("meta"):
        cpu = StableDiffusionSafetyChecker(CLIP_VIT_L_VISION_CONFIG).eval()
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()}, assign=True)
    imgs = torch.rand(2, 512, 512, 3, generator=card, device="cuda")
    with torch.no_grad():
        want = cpu.image_embeds(preprocess_for_clip(imgs.cpu()))
        for embeds, weights in ((cpu.concept_embeds, cpu.concept_embeds_weights),
                                (cpu.special_care_embeds, cpu.special_care_embeds_weights)):
            cos = torch.nn.functional.cosine_similarity(want[:1], embeds, dim=-1)
            odd = torch.arange(len(cos)) % 2 == 1
            offset = torch.where(odd & (embeds is cpu.concept_embeds), -0.01, 0.01)
            weights.copy_(cos + offset)
        for name in ("concept_embeds_weights", "special_care_embeds_weights"):
            getattr(gpu, name).copy_(getattr(cpu, name))
        got = gpu.image_embeds(preprocess_for_clip(imgs))
        cos = torch.nn.functional.cosine_similarity(got.cpu().double(), want.double(), dim=-1)
        assert got.dtype == torch.float32 and (cos >= 0.9999).all(), cos
        special, concept = cpu.scores(want)
        decided = torch.cat([special, concept], dim=1).abs().min(dim=1).values > 1e-3
    flags, want_flags = (make_safety_checker_fn(m)(imgs.cpu().numpy())[1] for m in (gpu, cpu))
    assert decided[0] and want_flags[0]
    assert np.array_equal(flags[decided.numpy()], want_flags[decided.numpy()])


def test_convert_tool_round_trip_without_jax(tmp_path):
    """The port's converter where JAX and ``safetensors`` are absent: a tiny
    pipeline directory with a safety checker, exported to diffusers' layout
    and imported back, holds the same tensors (dtype included), configs,
    tokenizer and scheduler."""
    import dataclasses
    import importlib.util
    import json
    import os

    from gmdx_torch.io.params import load_file
    from gmdx_torch.io.pipeline import save_pipeline
    from gmdx_torch.models import (
        TINY_CLIP_CONFIG, TINY_UNET_CONFIG, TINY_VAE_CONFIG, TINY_VISION_CONFIG, AutoencoderKL,
        CLIPTextModel, CLIPTokenizer, StableDiffusionSafetyChecker, UNet2DConditionModel,
    )
    from gmdx_torch.schedulers import get_scheduler

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "port_convert_tool", os.path.join(root, "scripts", "torch", "convert_torch_checkpoint.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    torch.manual_seed(0)
    mods = {"unet": UNet2DConditionModel(TINY_UNET_CONFIG),
            "gm_unet": UNet2DConditionModel(dataclasses.replace(TINY_UNET_CONFIG, in_channels=8)),
            "vae": AutoencoderKL(TINY_VAE_CONFIG), "text_encoder": CLIPTextModel(TINY_CLIP_CONFIG),
            "safety_checker": StableDiffusionSafetyChecker(TINY_VISION_CONFIG)}
    src, diff, back = (str(tmp_path / d) for d in ("src", "diff", "back"))
    save_pipeline(src, components=mods, tokenizer=CLIPTokenizer.tiny(),
                  scheduler=get_scheduler("lcm", original_inference_steps=40))
    tool.main(["export", "--src", src, "--dst", diff])
    tool.main(["import", "--src", diff, "--dst", back])

    def read(d, *rel):
        with open(os.path.join(d, *rel)) as f:
            return json.load(f)

    assert sorted(read(back, "model_index.json")["components"]) == \
        sorted(read(src, "model_index.json")["components"])
    for name in mods:
        assert read(back, name, "config.json") == read(src, name, "config.json"), name
        got, want = (load_file(os.path.join(d, name, "params.safetensors")) for d in (back, src))
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), (name, k)
    for rel in (("scheduler", "config.json"), ("tokenizer", "vocab.json")):
        assert read(back, *rel) == read(src, *rel)


@pytest.mark.cuda
def test_data_parallel_updates_of_two_gloo_ranks_on_card(card, tmp_path):
    """Two ranks under gloo on the one card (NCCL refuses two ranks on one
    device): a small model's updates under ddp, zero1 and fsdp, with and
    without accumulation, through the collectives on CUDA tensors, equal
    one rank's on the global batches (losses and parameters 1e-5)."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_dist_ranks

    setup = torch_dist_ranks.mlp_setup("cuda")
    ranks = torch_dist_ranks.Ranks("mlp", 2, tmp_path, setup)
    want = {k: torch_dist_ranks.mlp_run(setup, "ddp", k) for k in (1, 2)}
    for r in ranks.results():
        for (strategy, k), got in r.items():
            np.testing.assert_allclose(got["loss"], want[k]["loss"], rtol=1e-5,
                                       err_msg=f"{strategy} {k}")
            for g, w in zip(got["params"], want[k]["params"]):
                err = np.linalg.norm(g - w) / np.linalg.norm(w)
                assert err <= 1e-5, (strategy, k, err)


# --- the kernels at the shapes tensor and spatial parallelism give them ----

# (route, batch, queries, keys, width, heads): spatial parallelism's rank
# queries against the whole image's keys (sp = 2 and 4 at 512^2 and the
# 1024^2 frame, CFG batch 2), and tensor parallelism's heads / 2 and
# heads / 4 at head dims 40, 80 and 160.
PARALLEL_ATTENTION = [
    ("kv_resident", 2, 2048, 4096, 320, 8), ("kv_resident", 2, 1024, 4096, 320, 8),
    ("kv_resident", 2, 512, 1024, 640, 8), ("kv_resident", 2, 128, 256, 1280, 8),
    ("kv_resident", 2, 4096, 4096, 160, 4), ("kv_resident", 2, 4096, 4096, 80, 2),
    ("kv_resident", 2, 1024, 1024, 320, 4), ("kv_resident", 2, 1024, 1024, 160, 2),
    ("kv_resident", 2, 256, 256, 640, 4), ("kv_resident", 2, 256, 256, 320, 2),
    ("flash_bsc", 2, 8192, 16384, 320, 8), ("flash_bsc", 2, 4096, 16384, 320, 8),
    ("flash_bsc", 2, 16384, 16384, 160, 4), ("flash_bsc", 2, 16384, 16384, 80, 2),
    ("flash_d512", 1, 8192, 16384, 512, 1), ("flash_d512", 1, 4096, 16384, 512, 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("route,b,sq,sk,c,heads", PARALLEL_ATTENTION)
def test_attention_kernels_at_parallel_shapes_on_card(card, route, b, sq, sk, c, heads):
    """Each attention kernel at sq != sk (a rank's rows of queries, the
    gathered keys) and at a rank's share of the heads, against its plain
    version; the route rule sends the shape where the test calls it."""
    q = _bf16(card, b, sq, c)
    k, v = _bf16(card, b, sk, c), _bf16(card, b, sk, c)
    d = c // heads
    want = "flash" if route == "flash_d512" else route
    assert tk_attention.attention_route(sk, d, packed=d <= 160, sq=sq) == want
    if route == "kv_resident":
        out = tk_attention.attention_kv_resident(q, k, v, heads)
        ref = tk_attention.attention_kv_resident_plain(q.float(), k.float(), v.float(), heads)
    elif route == "flash_bsc":
        out = flash_attention_bsc(q, k, v, heads)
        ref = flash_attention_bsc_plain(q.float(), k.float(), v.float(), heads)
    else:
        out = flash_attention_fwd(q, k, v, heads)[0]
        ref = flash_attention_fwd_plain(q.float(), k.float(), v.float(), heads, d**-0.5)[0]
    assert _rel_l2(out, ref) <= 1e-2


def _split_group_norm(x, g, b, t, ranks, pad):
    """The split GroupNorm kernels over ``ranks`` row slices of ``x``, the
    merge between them as the ranks make it, the slices' outputs stacked."""
    from gmdx_torch.kernels.groupnorm import group_norm_apply, group_norm_moments, merge_moments

    parts = x.chunk(ranks, dim=1)
    moments = torch.stack([group_norm_moments(p.contiguous(), t) for p in parts])
    stats = merge_moments(moments, parts[0].shape[1] * x.shape[2] * (x.shape[3] // 32), 1e-5)
    outs = [group_norm_apply(p.contiguous(), g, b, t, stats, pad_output=pad) for p in parts]
    if pad:  # the interior rows of each slab
        outs = [o[:, 1:-1, 1:-1] for o in outs]
    return torch.cat(outs, dim=1)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hw,c,temb,pad,ranks", [
    (16, 64, 320, False, False, 2), (16, 64, 320, True, True, 2), (16, 64, 320, True, True, 4),
    (2, 1024, 128, False, True, 2),
])
def test_group_norm_split_kernels_on_card(card, b, hw, c, temb, pad, ranks):
    """The split GroupNorm entries (gmdx_group_norm_moments, then the merge,
    then gmdx_group_norm_apply), each rank's rows apart, against the plain
    GroupNorm of the whole image: 16 x 64^2 x 320, with temb and the padded
    output, and the 1024^2 frame's VAE at 2 x 1024^2 x 128; each launch
    counted."""
    x = _bf16(card, b, hw, hw, c, scale=2.0)
    g = (1.0 + _bf16(card, c, scale=0.2).float()).to(torch.bfloat16)
    bias = _bf16(card, c, scale=0.2)
    t = _bf16(card, b, c) if temb else None
    before = launch_counts()
    out = _split_group_norm(x, g, bias, t, ranks, pad)
    after = launch_counts()
    assert after["group_norm_moments"] - before["group_norm_moments"] == ranks
    assert after["group_norm_apply"] - before["group_norm_apply"] == ranks
    ref = group_norm_silu_plain(x.float(), g.float(), bias.float(),
                                t.float() if temb else None)
    assert _rel_l2(out, ref) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,temb", [(16, 32, 64, 320, True), (2, 512, 1024, 128, False)])
def test_group_norm_moments_on_card(card, b, h, w, c, temb):
    """gmdx_group_norm_moments against its plain version, the mean and the
    M2 column each on its own (M2 is ~1e5 times the mean: one norm over
    both would not see the mean)."""
    from gmdx_torch.kernels.groupnorm import group_norm_moments, group_norm_moments_plain

    x = (_bf16(card, b, h, w, c, scale=2.0).float() + 0.5).to(torch.bfloat16)
    t = _bf16(card, b, c) if temb else None
    got = group_norm_moments(x, t)
    want = group_norm_moments_plain(x.float(), t.float() if temb else None)
    for col in range(2):
        assert _rel_l2(got[..., col], want[..., col]) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("hw,c,o,ranks", [(64, 320, 320, 2), (64, 640, 320, 4),
                                          (128, 512, 512, 2)])
def test_conv3x3_on_halo_slabs_on_card(card, hw, c, o, ranks):
    """The conv kernel on each rank's slab (its rows, the neighbours' edge
    rows above and below, zeros past the image) against the plain conv of
    the whole image, row for row."""
    x = _bf16(card, 2, hw, hw, c)
    w = _bf16(card, o, c, 3, 3, scale=(9 * c) ** -0.5)
    bias = _bf16(card, o, scale=0.1)
    padded = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
    rows = hw // ranks
    outs = [conv3x3(padded[:, r * rows:(r + 1) * rows + 2].contiguous(), pack_weight(w), bias,
                    pre_padded=True) for r in range(ranks)]
    ref = conv3x3_plain(x.float(), pack_weight(w).float(), bias.float())
    assert _rel_l2(torch.cat(outs, dim=1), ref) <= 1e-2


# --- the kernels at the shapes of Stage-2 training under TP and SP ----------


@pytest.mark.cuda
@pytest.mark.parametrize("b,hw,c,temb,act,pad,ranks", [
    (8, 64, 320, True, True, True, 2), (8, 64, 320, True, True, True, 4),
    (8, 32, 640, False, False, False, 2),
])
def test_group_norm_bwd_split_kernels_on_card(card, b, hw, c, temb, act, pad, ranks):
    """gmdx_group_norm_bwd_sums and gmdx_group_norm_bwd_apply on each of
    ``ranks`` row slices (each slice's padded cotangent: its rows and a
    border), the sums summed over the slices between them as the ranks'
    all-reduce does, against their plain versions on the same slices: each
    sum column, dgamma, dbeta, dx and dtemb held apart."""
    from gmdx_torch.kernels.groupnorm import (
        group_norm_bwd_apply, group_norm_bwd_apply_plain, group_norm_bwd_sums,
        group_norm_bwd_sums_plain,
    )

    x = (_bf16(card, b, hw, hw, c, scale=2.0).float() + 0.5).to(torch.bfloat16)
    gam = (_bf16(card, c, scale=0.2).float() + 1.0).to(torch.bfloat16)
    bet = _bf16(card, c, scale=0.2)
    t = _bf16(card, b, c) if temb else None
    cot = _bf16(card, b, hw + 2 * pad, hw + 2 * pad, c)
    f32 = [u.float() if u is not None else None for u in (x, gam, bet, t)]
    _, stats = group_norm_silu_plain(*f32, activate=act, return_stats=True)
    rows = hw // ranks
    xs = [x[:, r * rows:(r + 1) * rows].contiguous() for r in range(ranks)]
    gs = [cot[:, r * rows:(r + 1) * rows + 2 * pad].contiguous() for r in range(ranks)]
    kw = dict(activate=act, pad_output=pad)
    got = [group_norm_bwd_sums(xr, gam, bet, t, stats, gr, **kw) for xr, gr in zip(xs, gs)]
    want = [group_norm_bwd_sums_plain(xr.float(), *f32[1:], stats, gr.float(), **kw)
            for xr, gr in zip(xs, gs)]
    for (s, ds, db), (ws, wds, wdb) in zip(got, want):
        for col in range(2):
            assert _rel_l2(s[:, col], ws[:, col]) <= 1e-2, ("sums", col)
        assert _rel_l2(ds, wds) <= 1e-2 and _rel_l2(db, wdb) <= 1e-2
    sums, wsums = sum(s for s, _, _ in got), sum(s for s, _, _ in want)
    for xr, gr in zip(xs, gs):
        dx, dt = group_norm_bwd_apply(xr, gam, bet, t, stats, gr, sums, hw * hw, **kw)
        wdx, wdt = group_norm_bwd_apply_plain(xr.float(), *f32[1:], stats, gr.float(), wsums,
                                              hw * hw, **kw)
        assert _rel_l2(dx, wdx) <= 1e-2
        if temb:
            assert _rel_l2(dt, wdt) <= 1e-2
        else:
            assert dt is None and wdt is None


# (batch, queries, keys, width, heads): Stage 2 at 512^2, global batch 8:
# an SP = 2 rank's queries against the whole image's keys at head dims 40,
# 80 and 160, and a TP rank's heads / 2 and heads / 4 at each.
TRAIN_PARALLEL_ATTENTION = [
    (8, 2048, 4096, 320, 8), (8, 512, 1024, 640, 8), (8, 128, 256, 1280, 8),
    (8, 4096, 4096, 160, 4), (8, 1024, 1024, 320, 4), (8, 256, 256, 640, 4),
    (8, 4096, 4096, 80, 2), (8, 1024, 1024, 160, 2), (8, 256, 256, 320, 2),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,c,heads", TRAIN_PARALLEL_ATTENTION)
def test_flash_attention_at_parallel_training_shapes_on_card(card, b, sq, sk, c, heads):
    """The flash forward and backward at the training step's TP and SP
    shapes (the dK/dV grid walks the keys, the dQ grid the queries), each
    output against the plain version's."""
    d = c // heads
    q = _bf16(card, b, sq, c)
    k, v = _bf16(card, b, sk, c), _bf16(card, b, sk, c)
    dout = _bf16(card, b, sq, c)
    qf, kf, vf = q.float(), k.float(), v.float()
    out, lse = flash_attention_fwd(q, k, v, heads)
    ref_out, ref_lse = flash_attention_fwd_plain(qf, kf, vf, heads, d**-0.5)
    assert _rel_l2(out, ref_out) <= 1e-2 and _rel_l2(lse, ref_lse) <= 1e-2
    got = flash_attention_bwd(q, k, v, out, lse, dout, heads)
    want = flash_attention_bwd_plain(qf, kf, vf, ref_out, ref_lse, dout.float(), heads, d**-0.5)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel_l2(g, w) <= 1e-2, name


# --- the kernels at the shapes of Stage-1 and ControlNet training under SP ---


@pytest.mark.cuda
def test_flash_bwd_d512_split_queries_on_card(card):
    """The 512-wide backward of a rank's 8192 queries against the whole
    1024^2 image's 16384 keys (SP = 2 of the VAE's mid block): dq, dk and dv
    each within relative L2 1e-2 of the fp32 plain version."""
    q, dout = _bf16(card, 1, 8192, 512), _bf16(card, 1, 8192, 512)
    k, v = _bf16(card, 1, 16384, 512), _bf16(card, 1, 16384, 512)
    out, lse = flash_attention_fwd(q, k, v, 1)
    before = launch_counts()["flash_attention_bwd_d512"]
    grads = flash_attention_bwd(q, k, v, out, lse, dout, 1)
    assert launch_counts()["flash_attention_bwd_d512"] == before + 1
    refs = flash_attention_bwd_plain(q.float(), k.float(), v.float(), out.float(), lse,
                                     dout.float(), 1, 512 ** -0.5)
    for got, ref in zip(grads, refs):
        assert _rel_l2(got, ref) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("hw,c", [(1024, 128), (256, 512)])
def test_group_norm_bwd_split_kernels_at_vae_shapes_on_card(card, hw, c):
    """The split GroupNorm backward on two row slices of a VAE level (eps
    1e-6, SiLU, the padded cotangent, no temb), the sums summed between the
    entries as the ranks' all-reduce does: each slice's sums, dgamma,
    dbeta and dx against the plain versions."""
    from gmdx_torch.kernels.groupnorm import (
        group_norm_bwd_apply, group_norm_bwd_apply_plain, group_norm_bwd_sums,
        group_norm_bwd_sums_plain,
    )

    x = (_bf16(card, 1, hw, hw, c, scale=2.0).float() + 0.5).to(torch.bfloat16)
    gam = (_bf16(card, c, scale=0.2).float() + 1.0).to(torch.bfloat16)
    bet = _bf16(card, c, scale=0.2)
    cot = _bf16(card, 1, hw + 2, hw + 2, c)
    f32 = [x.float(), gam.float(), bet.float(), None]
    _, stats = group_norm_silu_plain(*f32, eps=1e-6, activate=True, return_stats=True)
    rows = hw // 2
    kw = dict(activate=True, pad_output=True)
    xs = [x[:, r * rows:(r + 1) * rows].contiguous() for r in range(2)]
    gs = [cot[:, r * rows:(r + 1) * rows + 2].contiguous() for r in range(2)]
    got = [group_norm_bwd_sums(xr, gam, bet, None, stats, gr, **kw) for xr, gr in zip(xs, gs)]
    want = [group_norm_bwd_sums_plain(xr.float(), *f32[1:], stats, gr.float(), **kw)
            for xr, gr in zip(xs, gs)]
    for (s, ds, db), (ws, wds, wdb) in zip(got, want):
        for col in range(2):
            assert _rel_l2(s[:, col], ws[:, col]) <= 1e-2, ("sums", col)
        assert _rel_l2(ds, wds) <= 1e-2 and _rel_l2(db, wdb) <= 1e-2
    sums, wsums = sum(s for s, _, _ in got), sum(s for s, _, _ in want)
    for xr, gr in zip(xs, gs):
        dx, _ = group_norm_bwd_apply(xr, gam, bet, None, stats, gr, sums, hw * hw, **kw)
        wdx, _ = group_norm_bwd_apply_plain(xr.float(), *f32[1:], stats, gr.float(), wsums,
                                            hw * hw, **kw)
        assert _rel_l2(dx, wdx) <= 1e-2


@pytest.mark.cuda
def test_sp_discriminator_gradient_penalty_of_two_gloo_ranks_on_card(card, tmp_path):
    """The Paella discriminator (depth 6, 512 wide) on two gloo ranks of the
    one card, each its half of two 256^2 images' rows: the gradient penalty
    (its second derivative through the halo and moment collectives), the
    per-image input-gradient norms and the discriminator's gradients,
    summed over the ranks, against one process on the card (1e-9
    relative), the loss (its fp32 sigmoid head) within 1e-7. In float64:
    in float32 cuDNN picks other algorithms for a rank's half-height convs
    than for the whole image's, and the second derivative carries their
    rounding (3.9e-4 relative L2 on the gradients), which would hide the
    collectives' own arithmetic."""
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch_dist_ranks
    import torch_tp_ranks

    real = np.random.default_rng(4).uniform(0, 1, (2, 3, 256, 256)).astype(np.float32)
    setup = {"device": "cuda", "dtype": "float64", "seed": 3, "depth": 6, "hidden": 512,
             "real": real}
    ranks = torch_dist_ranks.Ranks("disc_gp", 2, tmp_path, setup)
    want = torch_tp_ranks.disc_gp_run(setup, None)
    for got in ranks.results():
        np.testing.assert_allclose(got["gp"], want["gp"], rtol=1e-9)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-7)
        np.testing.assert_allclose(got["norm"], want["norm"], rtol=1e-9)
        err = np.linalg.norm(got["grads"] - want["grads"]) / np.linalg.norm(want["grads"])
        assert err <= 1e-9, err


# --- training with the opt-in kernels -----------------------------------------

# The Stage-2 step's conv shapes at batch 8 (H = W, C, O): the levels, the
# decoder's concats and the 8^2 level; then the VAE's 4 x 512^2 x 128.
OPTIN_TRAIN_CONVS = [(8, 64, 320, 320), (8, 32, 640, 640), (8, 16, 1280, 1280),
                     (8, 8, 1280, 1280), (8, 64, 960, 320), (8, 32, 1920, 640),
                     (4, 512, 128, 128)]


def _autograd(fn, leaves, cots):
    """fn's outputs and the gradients of ``leaves`` for cotangents ``cots``."""
    outs = fn(*leaves)
    outs = outs if isinstance(outs, tuple) else (outs,)
    return outs, torch.autograd.grad(outs, leaves, cots)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("b,hw,c,o", OPTIN_TRAIN_CONVS)
def test_conv_training_forward_on_card(card, b, hw, c, o, m):
    """``Conv3x3`` under ``winograd_train`` (fp32 master weight, bf16
    activations, pre-padded input as the GroupNorm gives it): the route's
    kernel forward once, then cuDNN's dgrad and wgrad. The output against
    the route's plain version (F(4x4)'s with its bf16 V and U, as the
    kernel rounds them; the conv's in fp32), dx, dw and db against
    autograd through the fp32 direct conv: each within 1e-2."""
    from gmdx_torch.kernels import reset_launch_counts
    from gmdx_torch.kernels.winograd import (
        conv3x3_direct, conv_route, pack_weight4, winograd4_conv3x3_plain,
    )
    from gmdx_torch.models.layers import Conv3x3, set_kernel_options

    torch.manual_seed(0)
    conv = Conv3x3(c, o).cuda()
    set_kernel_options(conv, winograd_m=m, winograd_train=True)
    x = torch.nn.functional.pad(_bf16(card, b, hw, hw, c), (0, 0, 1, 1, 1, 1))
    cot = _bf16(card, b, hw, hw, o)
    route = conv_route(hw, hw, c, o, m)
    reset_launch_counts()
    (out,), grads = _autograd(lambda x_, w_, b_: conv(x_, pre_padded=True),
                              [x.requires_grad_(), conv.weight, conv.bias], [cot])
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["winograd4_conv3x3" if route == "wino4" else "conv3x3"] == 1, counts
    assert counts["conv3x3" if route == "wino4" else "winograd4_conv3x3"] == 0, counts
    (ref,), ref_grads = _autograd(
        lambda x_, w_, b_: conv3x3_direct(x_, w_, b_, pre_padded=True),
        [x.detach().float().requires_grad_(), conv.weight.detach().clone().requires_grad_(),
         conv.bias.detach().clone().requires_grad_()], [cot.float()])
    if route == "wino4":
        with torch.no_grad():
            ref = winograd4_conv3x3_plain(x.detach(), pack_weight4(conv.weight, torch.bfloat16),
                                          conv.bias.to(torch.bfloat16), pre_padded=True)
    assert _rel_l2(out, ref) <= 1e-2
    for got, want in zip(grads, ref_grads):
        assert _rel_l2(got, want) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("b,tokens,c", [(8, 4096, 320), (8, 64, 1280)])
def test_add_layer_norm_autograd_on_card(card, b, tokens, c):
    """``add_layer_norm`` under autograd: the kernel's s and h once, then the
    recomputed backward, against autograd through the fp32 plain version:
    both outputs and dx, dy, dgamma, dbeta within 1e-2."""
    from gmdx_torch.kernels import reset_launch_counts
    from gmdx_torch.kernels.geglu_ff import add_layer_norm, add_layer_norm_plain

    args = [_bf16(card, b, tokens, c), _bf16(card, b, tokens, c),
            1.0 + _bf16(card, c, scale=0.2).float(), _bf16(card, c, scale=0.2).float()]
    cots = [_bf16(card, b, tokens, c), _bf16(card, b, tokens, c)]
    reset_launch_counts()
    outs, grads = _autograd(add_layer_norm, [a.clone().requires_grad_() for a in args], cots)
    torch.cuda.synchronize()
    assert launch_counts()["add_layer_norm"] == 1
    refs, ref_grads = _autograd(add_layer_norm_plain,
                                [a.float().requires_grad_() for a in args],
                                [t.float() for t in cots])
    for got, want in zip([*outs, *grads], [*refs, *ref_grads]):
        assert _rel_l2(got, want) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 80, 160])
def test_flash_attention_at_77_keys_on_card(card, d):
    """The short-K route under autograd (``cross_attention_shortk`` ->
    FlashAttention) at 8 x 4096 queries x 77 keys, 8 heads: one partial key
    tile. Every score of a real key is strongly negative, so a padded zero
    key that took weight would move the output far off; out, lse and dq,
    dk, dv against the fp32 plain versions within 1e-2."""
    from gmdx_torch.kernels import reset_launch_counts
    from gmdx_torch.kernels.flash_attention import cross_attention_shortk

    heads, c = 8, 8 * d
    q = _bf16(card, 8, 4096, c).abs()
    k = -_bf16(card, 8, 77, c).abs() * 2.0
    v = _bf16(card, 8, 77, c)
    cot = _bf16(card, 8, 4096, c)
    reset_launch_counts()
    (out,), grads = _autograd(lambda *t: cross_attention_shortk(*t, heads),
                              [t.clone().requires_grad_() for t in (q, k, v)], [cot])
    torch.cuda.synchronize()
    counts = launch_counts()
    assert counts["flash_attention_fwd"] == 1 and counts["flash_attention_bwd"] == 1, counts
    assert counts["cross_attention_shortk"] == 0, counts
    f32 = [t.float() for t in (q, k, v)]
    ref_out, ref_lse = flash_attention_fwd_plain(*f32, heads, d ** -0.5)
    assert _rel_l2(out, ref_out) <= 1e-2
    _, lse = flash_attention_fwd(q, k, v, heads)
    assert float((lse - ref_lse).abs().max()) <= 2e-2
    refs = flash_attention_bwd_plain(*f32, ref_out, ref_lse, cot.float(), heads, d ** -0.5)
    for got, want in zip(grads, refs):
        assert torch.isfinite(got).all()
        assert _rel_l2(got, want) <= 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 80, 160])
def test_flash_bwd_writes_no_key_rows_past_77_on_card(card, d):
    """The backward's dK and dV of 77 keys written into the first 77 rows
    of 128-row buffers filled with NaN: rows 77 to 127 stay NaN."""
    from gmdx_torch.kernels import _build
    from gmdx_torch.kernels.flash_attention import _LOG2_E

    heads, c, sq = 8, 8 * d, 4096
    q, k, v, dout = _bf16(card, 1, sq, c), _bf16(card, 1, 77, c), _bf16(card, 1, 77, c), \
        _bf16(card, 1, sq, c)
    out, lse = flash_attention_fwd(q, k, v, heads)
    dd = flash_attention_bwd_dd(out, dout, heads)
    dq = torch.empty_like(q)
    dk_buf, dv_buf = (torch.full((1, 128, c), float("nan"), dtype=torch.bfloat16,
                                 device="cuda") for _ in range(2))
    scale = d ** -0.5
    _build.call("gmdx_flash_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
                lse.data_ptr(), dd.data_ptr(), dq.data_ptr(), dk_buf.data_ptr(),
                dv_buf.data_ptr(), 1, sq, 77, heads, d, float(scale), float(scale * _LOG2_E),
                torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert torch.isnan(dk_buf[:, 77:]).all() and torch.isnan(dv_buf[:, 77:]).all()
    assert torch.isfinite(dk_buf[:, :77]).all() and torch.isfinite(dv_buf[:, :77]).all()
    want = flash_attention_bwd(q, k, v, out, lse, dout, heads)
    for got, ref in zip((dq, dk_buf[:, :77], dv_buf[:, :77]), want):
        assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("channels_last", [False, True])
def test_captured_unet_fwd_equals_eager_on_card(card, channels_last):
    """scan_bench's unet_fwd body on an 8-channel UNet of two levels at the
    kernels' widths (320 / 640, head dims 40 / 80), bf16, batch 2, 16^2
    latents, chained 3 times: the CUDA graph's replay equals the eager
    chained loop bit for bit, and the capture counts 3 eager calls'
    launches."""
    import dataclasses
    import importlib.util
    import pathlib

    from gmdx_torch.models import TINY_UNET_CONFIG, UNet2DConditionModel

    path = pathlib.Path(__file__).resolve().parent.parent / "scripts" / "torch" / "scan_bench.py"
    spec = importlib.util.spec_from_file_location("scan_bench", path)
    sb = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sb)
    cfg = dataclasses.replace(TINY_UNET_CONFIG, in_channels=8, block_out_channels=(320, 640),
                              num_attention_heads=8)
    torch.manual_seed(0)
    with torch.device("cuda"):
        unet = UNet2DConditionModel(cfg).to(torch.bfloat16).eval()
    shape = (2, 16, 16, 8) if channels_last else (2, 8, 16, 16)
    x = torch.randn(shape, generator=card, device="cuda")
    ctx = _bf16(card, 2, 77, cfg.cross_attention_dim)
    t = torch.tensor(501, dtype=torch.int32, device="cuda")
    got = sb.time_scan(sb.unet_fwd_body(unet, t, ctx, channels_last), x, 3, 1, name="unet_fwd")
    assert got["graph_equals_eager"] and got["graph_output_finite"]
    for name in ("conv3x3", "group_norm_silu", "geglu_ff_ln", "attention_kv_resident"):
        assert got["launches_per_call"].get(name, 0) > 0, name
    assert got["captured_launches"] == {k: 3 * n for k, n in got["launches_per_call"].items()}
