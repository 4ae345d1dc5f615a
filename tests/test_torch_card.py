"""gmdx_torch's hand-written kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips without an sm_90 card. The file
imports neither JAX nor gmdx, so it runs on a machine with PyTorch for CUDA
alone; tests/conftest.py imports JAX, so run it there with

    python -m pytest --noconftest -q tests/test_torch_card.py

Inputs are seeded bf16 on the card; the plain versions run in fp32 with TF32
off; the bound is relative L2 <= 1e-2 (bf16 rounding of inputs and output).
"""

import pytest
import torch

from gmdx_torch.kernels import attention as tk_attention
from gmdx_torch.kernels import launch_counts
from gmdx_torch.kernels.geglu_ff import geglu_ff_ln, geglu_ff_ln_plain
from gmdx_torch.kernels.groupnorm import group_norm_silu, group_norm_silu_plain
from gmdx_torch.kernels.winograd import conv3x3, conv3x3_plain, pack_weight


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


@pytest.mark.cuda
@pytest.mark.parametrize("dim,tokens", [(320, 4096), (640, 1000), (1280, 256)])
def test_geglu_ff_kernel_on_card(card, dim, tokens):
    inner = 4 * dim
    args = [
        _bf16(card, 2, tokens, dim), _bf16(card, 2, tokens, dim),
        (1.0 + _bf16(card, dim, scale=0.2).float()).to(torch.bfloat16),
        _bf16(card, dim, scale=0.2), _bf16(card, 2 * inner, dim, scale=dim**-0.5),
        _bf16(card, 2 * inner, scale=0.1), _bf16(card, dim, inner, scale=inner**-0.5),
        _bf16(card, dim, scale=0.1),
    ]
    out = geglu_ff_ln(*args)
    ref = geglu_ff_ln_plain(*(a.float() for a in args))
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
