"""Attention dispatch: the KV-resident kernel, the long-sequence flash
kernels and the plain path.

Counterpart of ``gmdx/kernels/attention.py`` (dispatch) and
``gmdx/kernels/flash_attention.py:attention_kv_resident`` (kernel). The
dispatch rule is the JAX package's, in :func:`attention_route`:
  * head-packed self-attention (:func:`attention_packed`) with 256 <= Sk <=
    4096 keys and head dim <= 160 takes the KV-resident kernel;
  * failing that, Sk >= 1024 and head dim <= 160 takes
    :func:`flash_attention_bsc` (the UNet's first level at 1024^2);
  * failing that, with the ``xattn_kernel`` option (the JAX package's
    ``GMDX_XATTN_KERNEL=1``, off by default), Sk <= 128, Sq >= 1024 and a
    head dim <= 160 that is a multiple of 8 take
    :func:`cross_attention_shortk` (the 77-key cross-attention of the two
    widest UNet levels);
  * everything else goes to :func:`dot_product_attention`, where Sk >= 1024
    and (head dim <= 256 or Sk > 4096) take the flash forward (the VAE's
    single 512-wide head at 1024^2) and the rest (the 77-key
    cross-attention, the 64-token mid block, the VAE's head at 512^2) the
    einsum + fp32-softmax path the JAX package leaves to XLA.
A head dim with no kernel instance raises on the card; it never falls back.
The routes take the query and key counts apart: under spatial parallelism a
rank's queries meet the gathered keys of the whole image (``sq < sk``), and
the route follows the key count, as the JAX rule does. Under tensor
parallelism :func:`tp_route` says whether a layer runs head-parallel.

Under autograd the kernel shapes take :class:`FlashAttention`, the
counterpart of the ``_attn_kvres``, ``_flash_bsc`` and ``_xattn_bsc`` custom
VJPs (``flash_attention.py:653-667, 824-848, 996-1022``): its forward is the
flash forward, which also saves the logsumexp, and its backward the two
flash backward kernels; ``cross_attention_shortk`` takes it under autograd
too. Without grad, inference keeps the KV-resident, bsc and short-K
kernels.
``use_kernels=False`` sends each kernel shape to that kernel's plain
version.
"""

from __future__ import annotations

import torch

from gmdx_torch.kernels import LAUNCHES, check_kernel_operands, needs_grad
from gmdx_torch.kernels.flash_attention import (
    _KERNEL_HEAD_DIMS,
    _LOG2_E,
    XATTN_MAX_KEYS,
    cross_attention_shortk,
    cross_attention_shortk_plain,
    flash_attention_bsc,
    flash_attention_bsc_plain,
    flash_attention_bwd,
    flash_attention_fwd,
    flash_attention_fwd_plain,
)


def attention_route(
    sk: int, head_dim: int, *, packed: bool = True, sq: int = 0, xattn_kernel: bool = False,
) -> str:
    """Where the JAX package sends an attention call with ``sq`` queries and
    ``sk`` keys: ``"kv_resident"``, ``"flash_bsc"``, ``"xattn_shortk"``,
    ``"flash"`` or ``"plain"`` (``attention.py:148-188`` for head-packed
    calls, then ``:55-60``; ``packed=False`` is the (B, S, H, D) entry
    alone)."""
    if packed and head_dim <= 160:
        if 256 <= sk <= 4096:
            return "kv_resident"
        if sk >= 1024:
            return "flash_bsc"
        if xattn_kernel and sk <= XATTN_MAX_KEYS and sq >= 1024 and head_dim % 8 == 0:
            return "xattn_shortk"
    if sk >= 1024 and (head_dim <= 256 or sk > 4096):
        return "flash"
    return "plain"


# The calls that tensor parallelism sends to library calls, as the JAX
# package's dispatch does whenever a TP kernel context is active
# (``gmdx/models/layers.py:139-145``, ``:505-520``, ``geglu_ff.py:461``,
# ``:593``, ``:622``, ``winograd.py:1111``, ``:1175``); the layers of
# ``gmdx_torch.models.layers`` ask :func:`tp_route` for each.
TP_LIBRARY_OPS = ("group_norm", "conv3x3", "geglu_ff", "add_layer_norm")


def tp_route(op: str, tp: int, *, heads: int = 1, widths: tuple[int, int, int] = (0, 0, 0)) -> str:
    """Where a call goes under tensor parallelism over ``tp`` ranks (1: none).
    ``op="attention"`` with ``heads`` heads and full q/k/v ``widths``:
    ``"heads"``, head-parallel (``heads / tp`` heads a rank, on the
    attention kernels' own routes) where ``_tp_route`` gives the JAX
    package's ``shard_map`` (``gmdx/kernels/attention.py:70-130``: tp
    divides the heads and q's width, and k and v are as wide as q), else
    ``"whole"`` (the layer computed whole on every rank from its gathered
    weights: the VAE's single 512-wide head); ``"kernel"`` without TP. The
    ops of :data:`TP_LIBRARY_OPS` go to ``"library"`` calls in the working
    dtype under TP (``F.group_norm`` + SiLU, ``F.conv2d``, the torch GEGLU
    chain, the residual add and LayerNorm apart), to ``"kernel"`` without."""
    if op == "attention":
        q, k, v = widths
        if tp <= 1:
            return "kernel"
        return "heads" if heads % tp == 0 and q % tp == 0 and k == q and v == q else "whole"
    if op in TP_LIBRARY_OPS:
        return "library" if tp > 1 else "kernel"
    raise ValueError(f"unknown op {op!r}")


def _flash(q, k, v, heads: int, scale: float, use_kernels: bool) -> torch.Tensor:
    """The flash forward over head-packed operands (its plain version with
    ``use_kernels=False``, :class:`FlashAttention` under autograd)."""
    if not use_kernels:
        return flash_attention_fwd_plain(q, k, v, heads, scale)[0]
    if needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, heads, scale)
    return flash_attention_fwd(q, k, v, heads, scale=scale)[0]


def dot_product_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float | None = None,
    use_kernels: bool = True,
) -> torch.Tensor:
    """Attention over (B, S, H, D). Long keys take the flash forward;
    otherwise logits in the input dtype, softmax in fp32, weights cast back
    (``gmdx/kernels/attention.py:_xla_attention``)."""
    b, sq, heads, d = q.shape
    if scale is None:
        scale = d**-0.5
    if attention_route(k.shape[1], d, packed=False) == "flash":
        q3, k3, v3 = (t.reshape(t.shape[0], t.shape[1], heads * d) for t in (q, k, v))
        return _flash(q3, k3, v3, heads, scale, use_kernels).reshape(q.shape)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    weights = torch.softmax(logits.float(), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", weights, v)


def attention_kv_resident_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, *,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain version of the kernel over head-packed (B, S, H*D): fp32 scores
    and softmax, result in the input dtype."""
    b, sq, c = q.shape
    d = c // heads
    if scale is None:
        scale = d**-0.5
    qh = q.float().reshape(b, sq, heads, d)
    kh = k.float().reshape(b, k.shape[1], heads, d)
    vh = v.float().reshape(b, v.shape[1], heads, d)
    s = torch.einsum("bqhd,bkhd->bhqk", qh, kh) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vh).reshape(b, sq, c).to(q.dtype)


def attention_kv_resident(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, *,
    scale: float | None = None,
) -> torch.Tensor:
    """Exact-softmax attention over head-packed (B, S, H*D) q/k/v."""
    if q.ndim != 3 or k.shape != v.shape or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"bad attention shapes {q.shape} {k.shape} {v.shape}")
    b, sq, c = q.shape
    if c % heads:
        raise ValueError(f"width {c} does not split into {heads} heads")
    d = c // heads
    if scale is None:
        scale = d**-0.5
    if not q.is_cuda:
        return attention_kv_resident_plain(q, k, v, heads, scale=scale)
    if d not in _KERNEL_HEAD_DIMS:
        raise ValueError(f"attention kernel has no instance for head dim {d}")
    stream = check_kernel_operands("attention_kv_resident", q, k, v)
    from gmdx_torch.kernels import _build

    out = torch.empty_like(q)
    _build.call(
        "gmdx_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, sq, k.shape[1], heads, d, float(scale * _LOG2_E), stream,
    )
    LAUNCHES["attention_kv_resident"] += 1
    return out


def uses_kernel(sk: int, head_dim: int) -> bool:
    """The JAX package's KV-resident dispatch rule (attention.py:152-158)."""
    return attention_route(sk, head_dim) == "kv_resident"


class FlashAttention(torch.autograd.Function):
    """Differentiated self-attention over head-packed (B, S, H*D): the flash
    forward (saving out and lse) and the flash backward kernels. The
    cotangent from PyTorch is cast to q's dtype and made contiguous here,
    because the kernels take contiguous bf16."""

    @staticmethod
    def forward(ctx, q, k, v, heads: int, scale: float):
        out, lse = flash_attention_fwd(q, k, v, heads, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.heads, ctx.scale = heads, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dout = dout.to(q.dtype).contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, ctx.heads, scale=ctx.scale)
        return dq, dk, dv, None, None


# The head-packed routes: (kernel wrapper, plain version).
_PACKED_KERNELS = {
    "kv_resident": (attention_kv_resident, attention_kv_resident_plain),
    "flash_bsc": (flash_attention_bsc, flash_attention_bsc_plain),
    "xattn_shortk": (cross_attention_shortk, cross_attention_shortk_plain),
}


def attention_packed(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, *,
    scale: float | None = None, use_kernels: bool = True, xattn_kernel: bool = False,
) -> torch.Tensor:
    """Attention over head-packed (B, S, H*D) operands, dispatched as the
    JAX package does (:func:`attention_route`)."""
    b, sq, c = q.shape
    d = c // heads
    if scale is None:
        scale = d**-0.5
    route = attention_route(k.shape[1], d, sq=sq, xattn_kernel=xattn_kernel)
    if route in _PACKED_KERNELS:
        kernel, plain = _PACKED_KERNELS[route]
        if not use_kernels:
            return plain(q, k, v, heads, scale=scale)
        if needs_grad(q, k, v):
            return FlashAttention.apply(q, k, v, heads, scale)
        return kernel(q, k, v, heads, scale=scale)
    sk = k.shape[1]
    out = dot_product_attention(
        q.reshape(b, sq, heads, d), k.reshape(b, sk, heads, d),
        v.reshape(b, sk, heads, d), scale=scale, use_kernels=use_kernels,
    )
    return out.reshape(b, sq, c)


__all__ = [
    "TP_LIBRARY_OPS",
    "tp_route",
    "attention_route",
    "dot_product_attention",
    "attention_kv_resident",
    "attention_kv_resident_plain",
    "attention_packed",
    "uses_kernel",
    "FlashAttention",
]
