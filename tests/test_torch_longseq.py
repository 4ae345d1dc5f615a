"""The long-sequence attention of gmdx_torch against the JAX package on the CPU.

The plain versions of the two kernels of the 1024^2 path, ``flash_attention_bsc``
and the flash forward at head dim 512, are held to the Pallas kernels they
replace (``_flash_forward_bsc``, ``_flash_forward``) run in interpret mode on
the same numpy inputs in fp32: max-abs <= 1e-5. The dispatch is held to the
JAX package's at the SD-1.5 shapes of the 512^2 and 1024^2 paths. The
kernels themselves are held to these plain versions on the card by
tests/test_torch_card.py.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gmdx.kernels.flash_attention import _flash_forward, _flash_forward_bsc
from gmdx_torch.kernels import attention as tk_attention
from gmdx_torch.kernels.flash_attention import (
    PLAIN_CHUNK,
    flash_attention_bsc,
    flash_attention_bsc_plain,
    flash_attention_fwd,
    flash_attention_fwd_plain,
)

TOL = 1e-5  # fp32 on both sides; online against whole-row softmax


def _normal(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _max_abs(a, b):
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("sk,blkk", [(256, None), (200, None), (384, "128")],
                         ids=["aligned", "masked", "three_k_blocks"])
def test_flash_bsc_plain_matches_pallas(monkeypatch, sk, blkk):
    """Sk = 200 pads the key block and masks; Sk = 384 with 128-key blocks
    runs three k-blocks through the online rescale."""
    if blkk is not None:
        monkeypatch.setenv("GMDX_FLASH_BLKK_BSC", blkk)
    rng = np.random.default_rng(sk)
    b, sq, heads, d = 2, 256, 2, 40
    q = _normal(rng, b, sq, heads * d)
    k, v = _normal(rng, b, sk, heads * d), _normal(rng, b, sk, heads * d)
    scale = d**-0.5
    with jax.default_matmul_precision("highest"):
        want = _flash_forward_bsc(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), heads, scale,
                                  interpret=True)
    t = torch.from_numpy
    got = flash_attention_bsc_plain(t(q), t(k), t(v), heads, scale=scale)
    assert got.shape == q.shape
    assert _max_abs(got.numpy(), want) <= TOL
    # The wrapper takes the plain version for CPU tensors.
    assert torch.equal(flash_attention_bsc(t(q), t(k), t(v), heads), got)


@pytest.mark.parametrize("blkk", [None, "128"], ids=["one_k_block", "two_k_blocks"])
def test_flash_forward_d512_plain_matches_pallas(monkeypatch, blkk):
    """The VAE's single 512-wide head: output and base-2 logsumexp."""
    if blkk is not None:
        monkeypatch.setenv("GMDX_FLASH_BLKK", blkk)
    rng = np.random.default_rng(5)
    bh, s, d = 2, 256, 512
    q, k, v = (_normal(rng, bh, s, d) for _ in range(3))
    scale = d**-0.5
    with jax.default_matmul_precision("highest"):
        want, want_lse = _flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
                                        interpret=True)
    t = torch.from_numpy
    # (BH, S, D) is head-packed (B, S, H*D) with one head.
    got, lse = flash_attention_fwd_plain(t(q), t(k), t(v), 1, scale)
    assert _max_abs(got.numpy(), want) <= TOL
    assert _max_abs(lse[:, 0].numpy(), np.asarray(want_lse)[..., 0]) <= TOL
    out, _ = flash_attention_fwd(t(q), t(k), t(v), 1)
    assert torch.equal(out, got)


def test_plain_chunks_change_no_row():
    """Queries past one chunk: the chunked plain forward equals a one-shot
    softmax over the whole row."""
    rng = np.random.default_rng(6)
    sq = PLAIN_CHUNK + 37
    q = torch.from_numpy(_normal(rng, 1, sq, 16))
    k, v = (torch.from_numpy(_normal(rng, 1, 64, 16)) for _ in range(2))
    got = flash_attention_bsc_plain(q, k, v, 2)
    qh, kh, vh = (x.reshape(1, -1, 2, 8) for x in (q, k, v))
    p = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", qh, kh) * 8**-0.5, dim=-1)
    want = torch.einsum("bhqk,bkhd->bqhd", p, vh).reshape(1, sq, 16)
    assert float((got - want).abs().max()) <= TOL


# SD-1.5 self- and cross-attention shapes of the two paths: (keys, head dim).
# 512^2: UNet levels 4096/1024/256/64 tokens, 77 CLIP keys, the VAE's 4096.
# 1024^2: UNet levels 16384/4096/1024/256, the VAE's 16384.
@pytest.mark.parametrize("sk,d,want", [
    (16384, 40, "flash_bsc"), (4096, 40, "kv_resident"), (77, 40, "plain"),
    (16384, 512, "flash"), (4096, 512, "plain"),
    (1024, 80, "kv_resident"), (256, 160, "kv_resident"), (64, 160, "plain"),
    (77, 160, "plain"),
])
def test_route_matches_jax_rule(sk, d, want):
    assert tk_attention.attention_route(sk, d) == want


def test_long_key_dispatch_matches_jax():
    """Sk = 4160 takes flash_attention_bsc (here its plain version); the JAX
    package on the CPU takes XLA. The same function either way."""
    from gmdx.kernels.attention import attention_packed as jax_attention_packed

    rng = np.random.default_rng(7)
    q = _normal(rng, 1, 64, 8)
    k, v = _normal(rng, 1, 4160, 8), _normal(rng, 1, 4160, 8)
    with jax.default_matmul_precision("highest"):
        want = jax_attention_packed(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 1)
    assert tk_attention.attention_route(4160, 8) == "flash_bsc"
    t = torch.from_numpy
    got = tk_attention.attention_packed(t(q), t(k), t(v), 1)
    assert _max_abs(got.numpy(), want) <= TOL
    plain = tk_attention.attention_packed(t(q), t(k), t(v), 1, use_kernels=False)
    assert torch.equal(plain, got)


def test_vae_attention_long_sequence_matches_jax():
    """The (B, S, H, D) entry past 4096 keys at head dim 512, as the VAE's
    mid block calls it at 1024^2: the flash forward's plain version here,
    XLA in the JAX package."""
    from gmdx.kernels.attention import dot_product_attention as jax_dpa

    rng = np.random.default_rng(8)
    q = _normal(rng, 1, 32, 1, 512)
    k, v = _normal(rng, 1, 4100, 1, 512), _normal(rng, 1, 4100, 1, 512)
    with jax.default_matmul_precision("highest"):
        want = jax_dpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    t = torch.from_numpy
    got = tk_attention.dot_product_attention(t(q), t(k), t(v))
    assert got.shape == q.shape
    assert _max_abs(got.numpy(), want) <= TOL
