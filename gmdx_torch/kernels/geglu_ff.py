"""The transformer block's feed-forward tail and its fused add + LayerNorm.

* :func:`geglu_ff_ln`: LayerNorm -> GEGLU feed-forward -> residual, with a
  pending residual folded into the prologue. Counterpart of
  ``gmdx/kernels/geglu_ff.py:geglu_ff_ln`` with ``add=``; kernel
  ``csrc/geglu_ff.cu`` (``gmdx_geglu_ff_ln``: a row pre-pass for the
  LayerNorm, then two GEMMs on the Hopper core of ``csrc/gemm_sm90.cuh``,
  as :func:`geglu_ff_ln_plan` lays them out).
* :func:`geglu_ff`: the same FF + residual without the LayerNorm, the
  counterpart of ``geglu_ff`` (``_ff_pallas``), which ``GEGLUFeedForward``
  reaches when called without LayerNorm parameters. Kernel
  ``gmdx_geglu_ff`` in the same source: the two GEMMs on the same core,
  with the same plan, and no pre-pass. The JAX package's rule gives it
  dims 320 and 640 (:func:`geglu_ff_uses_kernel`); other dims take
  :func:`geglu_ff_reference`, as the JAX package takes jnp.
* :func:`add_layer_norm`: (x + y, LayerNorm(x + y)), the counterpart of
  ``add_layer_norm`` (``_add_ln_pallas``), the attn1-residual / norm2 pair
  of the transformer block under the ``fused_addln`` option. Kernel
  ``csrc/add_ln.cu``: persistent blocks over tiles of whole rows, fed and
  drained by 1-D bulk copies through a shared-memory ring, as
  :func:`add_layer_norm_plan` lays them out.

Weights are the torch Linear layouts: ``w1`` (2*inner, dim) with rows
``[hidden | gate]``, ``w2`` (dim, inner).

Under autograd, :class:`GegluFFLN` and :class:`GegluFF` run the kernel
forward and, like ``_ff_ln_bwd``/``_ff_add_ln_bwd``/``_ff_bwd``
(``geglu_ff.py:195-208, 385-428``), differentiate a recompute of the
reference in their backward: the JAX package has no backward kernel here,
so the port writes none. :class:`AddLayerNorm` does the same for
:func:`add_layer_norm` (``_add_ln_bwd``, ``geglu_ff.py:549-575``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from gmdx_torch.kernels import (
    LAUNCHES, NUM_SMS, SM_SMEM, check_fp32, check_kernel_operands, needs_grad,
)

_SQRT_HALF = 0.7071067811865476
# ``_TOKEN_BLOCK``: the dims the JAX package gives its LN-free FF kernel.
GEGLU_FF_KERNEL_DIMS = (320, 640)
# csrc/add_ln.cu: a lane keeps up to 8 chunks of 8 channels of a row; four
# consumer warps and a producer warp a block; a ring of 3 input stages (an x
# and a y tile each) and 2 output stages (s and h); tiles of about
# ADD_LN_TILE_BYTES a tensor; two blocks an SM where shared memory holds them.
ADD_LN_MAX_DIM = 2048
ADD_LN_WARPS = 4
ADD_LN_STAGES, ADD_LN_OUT_STAGES = 3, 2
ADD_LN_TILE_BYTES = 10240
ADD_LN_BLOCKS_PER_SM = 2
# csrc/gemm_sm90.cuh's row tile and K slice; GEMM1's tile holds 64 hidden
# and their 64 gate columns.
FF_BLOCK_M = 128
FF_BLOCK_K = 64
FF_GEMM1_COLS = 64


def geglu_ff_ln_plan(m: int, dim: int, inner: int) -> dict:
    """The launch layout of both FF kernels (``gmdx_geglu_ff_ln`` and the
    LN-free ``gmdx_geglu_ff``) for ``m`` tokens: GEMM2's tile width
    (160 where it divides dim, as at 320/640/1280, so no tile is padding;
    else 128) and each GEMM's (row tiles, column tiles, K slices)."""
    bn2 = 160 if dim % 160 == 0 else 128
    m_tiles = -(-m // FF_BLOCK_M)
    return {
        "bn2": bn2,
        "gemm1_tiles": (m_tiles, -(-inner // FF_GEMM1_COLS), -(-dim // FF_BLOCK_K)),
        "gemm2_tiles": (m_tiles, -(-dim // bn2), -(-inner // FF_BLOCK_K)),
    }


def geglu_ff_ln_plain(
    x: torch.Tensor,
    add: torch.Tensor | None,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    *,
    eps: float = 1e-5,
) -> torch.Tensor:
    """Plain version in fp32: s = x + add (rounded to x's dtype),
    s + GEGLU(LN(s)) @ w2^T + b2, result in x's dtype."""
    s = x if add is None else (x.float() + add.float()).to(x.dtype)
    sf = s.float()
    h = F.layer_norm(sf, (sf.shape[-1],), gamma.float(), beta.float(), eps)
    return geglu_ff_plain(h, sf, w1, b1, w2, b2).to(x.dtype)


def geglu_ff_ln(
    x: torch.Tensor,
    add: torch.Tensor | None,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    *,
    eps: float = 1e-5,
) -> torch.Tensor:
    """(x + add) + proj_out(GEGLU(proj_in(LN(x + add)))) over (B, S, dim)."""
    dim = x.shape[-1]
    inner = _check_ff_weights(dim, w1, w2)
    if add is not None and add.shape != x.shape:
        raise ValueError(f"add {tuple(add.shape)} vs x {tuple(x.shape)}")
    if not x.is_cuda:
        return geglu_ff_ln_plain(x, add, gamma, beta, w1, b1, w2, b2, eps=eps)
    if dim % 8 or inner % 8:
        raise ValueError(f"geglu_ff_ln kernel needs dim, inner % 8 == 0, got {dim}, {inner}")
    stream = check_kernel_operands("geglu_ff_ln", x, add, gamma, beta, w1, b1, w2, b2)
    if any(t is not None and t.data_ptr() % 16 for t in (x, add, w1, w2)):
        raise ValueError("geglu_ff_ln kernel needs 16-byte aligned operands")
    from gmdx_torch.kernels import _build

    m = x.numel() // dim
    plan = geglu_ff_ln_plan(m, dim, inner)
    h = torch.empty((m, dim), dtype=x.dtype, device=x.device)
    s = torch.empty((m, dim), dtype=x.dtype, device=x.device) if add is not None else None
    act = torch.empty((m, inner), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    _build.call(
        "gmdx_geglu_ff_ln", x.data_ptr(), add.data_ptr() if add is not None else None,
        gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), h.data_ptr(), None if s is None else s.data_ptr(),
        act.data_ptr(), out.data_ptr(), m, dim, inner, float(eps), plan["bn2"], stream,
    )
    LAUNCHES["geglu_ff_ln"] += 1
    return out


def geglu_ff_ln_reference(x, add, gamma, beta, w1, b1, w2, b2, *, eps: float = 1e-5):
    """The JAX package's backward recompute target (``_ff_add_ln_reference``):
    the same function as :func:`geglu_ff_ln_plain`, but LN with fp32
    statistics rounded to x's dtype and the two products in x's dtype (bf16
    GEMMs on the card, where the plain version's fp32 ones would be slow)."""
    s = x if add is None else (x.float() + add.float()).to(x.dtype)
    y = F.layer_norm(s.float(), (s.shape[-1],), gamma.float(), beta.float(), eps).to(s.dtype)
    return geglu_ff_reference(y, s, w1, b1, w2, b2)


class GegluFFLN(torch.autograd.Function):
    """Differentiated :func:`geglu_ff_ln`: kernel forward, backward by
    autograd through a recompute of :func:`geglu_ff_ln_reference`."""

    @staticmethod
    def forward(ctx, x, add, gamma, beta, w1, b1, w2, b2, eps: float):
        ctx.save_for_backward(x, add, gamma, beta, w1, b1, w2, b2)
        ctx.eps = eps
        return geglu_ff_ln(x, add, gamma, beta, w1, b1, w2, b2, eps=eps)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() if t is not None else None for t in saved]
            out = geglu_ff_ln_reference(*leaves, eps=ctx.eps)
            live = [t for t in leaves if t is not None]
            grads = iter(torch.autograd.grad(out, live, g))
        return (*(next(grads) if t is not None else None for t in leaves), None)


def _check_ff_weights(dim: int, w1: torch.Tensor, w2: torch.Tensor) -> int:
    inner = w2.shape[1]
    if w1.shape != (2 * inner, dim) or w2.shape != (dim, inner):
        raise ValueError(f"FF weights {tuple(w1.shape)}, {tuple(w2.shape)} vs dim {dim}")
    return inner


def geglu_ff_uses_kernel(dim: int, inner: int) -> bool:
    """The JAX package's rule for its LN-free FF kernel
    (``geglu_ff.py:619-626``): dims 320/640, 2*inner a multiple of 256."""
    return dim in GEGLU_FF_KERNEL_DIMS and (2 * inner) % 256 == 0


def geglu_ff_plain(
    x: torch.Tensor, residual: torch.Tensor | None, w1: torch.Tensor, b1: torch.Tensor,
    w2: torch.Tensor, b2: torch.Tensor,
) -> torch.Tensor:
    """Plain version of :func:`geglu_ff` in fp32: residual + GEGLU(x) @
    w2^T + b2 (no residual when it is None), result in x's dtype."""
    xf = x.float()
    hidden, gate = (xf @ w1.float().t() + b1.float()).chunk(2, dim=-1)
    act = hidden * 0.5 * gate * (1.0 + torch.erf(gate * _SQRT_HALF))
    out = act @ w2.float().t() + b2.float()
    if residual is not None:
        out = out + residual.float()
    return out.to(x.dtype)


def geglu_ff_reference(x, residual, w1, b1, w2, b2):
    """``_ff_reference``: the two products in x's dtype, then + residual.
    The route for dims without the kernel, and the backward's recompute."""
    hidden, gate = F.linear(x, w1.to(x.dtype), b1.to(x.dtype)).chunk(2, dim=-1)
    out = F.linear(hidden * F.gelu(gate), w2.to(x.dtype), b2.to(x.dtype))
    return out if residual is None else residual + out


def geglu_ff(
    x: torch.Tensor, residual: torch.Tensor | None, w1: torch.Tensor, b1: torch.Tensor,
    w2: torch.Tensor, b2: torch.Tensor,
) -> torch.Tensor:
    """residual + proj_out(GEGLU(proj_in(x))) over (B, S, dim); ``residual``
    None adds nothing."""
    dim = x.shape[-1]
    inner = _check_ff_weights(dim, w1, w2)
    if residual is not None and residual.shape != x.shape:
        raise ValueError(f"residual {tuple(residual.shape)} vs x {tuple(x.shape)}")
    if not x.is_cuda:
        return geglu_ff_plain(x, residual, w1, b1, w2, b2)
    if dim % 8 or inner % 8:
        raise ValueError(f"geglu_ff kernel needs dim, inner % 8 == 0, got {dim}, {inner}")
    stream = check_kernel_operands("geglu_ff", x, residual, w1, b1, w2, b2)
    from gmdx_torch.kernels import _build

    if any(t.data_ptr() % 16 for t in (x, w1, w2)):
        raise ValueError("geglu_ff kernel needs 16-byte aligned operands")
    m = x.numel() // dim
    act = torch.empty((m, inner), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    _build.call(
        "gmdx_geglu_ff", x.data_ptr(), residual.data_ptr() if residual is not None else None,
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), act.data_ptr(),
        out.data_ptr(), m, dim, inner, geglu_ff_ln_plan(m, dim, inner)["bn2"], stream,
    )
    LAUNCHES["geglu_ff"] += 1
    return out


class GegluFF(torch.autograd.Function):
    """Differentiated :func:`geglu_ff`: kernel forward, backward by autograd
    through a recompute of :func:`geglu_ff_reference`."""

    @staticmethod
    def forward(ctx, x, residual, w1, b1, w2, b2):
        ctx.save_for_backward(x, residual, w1, b1, w2, b2)
        return geglu_ff(x, residual, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() if t is not None else None for t in saved]
            out = geglu_ff_reference(*leaves)
            live = [t for t in leaves if t is not None]
            grads = iter(torch.autograd.grad(out, live, g))
        return tuple(next(grads) if t is not None else None for t in leaves)


@dataclass(frozen=True)
class AddLayerNormPlan:
    """``add_ln_plan`` in ``csrc/add_ln.cu``: ``rows`` a tile, the input
    ring's ``stages``, persistent ``blocks``, ``threads`` a block and
    ``smem_bytes`` of dynamic shared memory; ``per_sm`` blocks an SM."""

    rows: int
    stages: int
    blocks: int
    threads: int
    smem_bytes: int
    per_sm: int

    def c_fields(self) -> list[int]:
        """The first six fields of ``gmdx_add_ln_plan``'s report."""
        return [self.rows, self.stages, self.blocks, self.threads, self.smem_bytes, NUM_SMS]


def add_layer_norm_plan(m: int, c: int) -> AddLayerNormPlan:
    """The kernel's launch for ``m`` rows of ``c`` channels: tiles of
    ``rows`` = 4 * max(1, 1280 // c) whole rows (a row a consumer warp at
    least, ``ADD_LN_TILE_BYTES`` a tensor at c = 320, 640, 1280), over as
    many persistent blocks as the tiles need and shared memory holds, two an
    SM at most."""
    rows = ADD_LN_WARPS * max(1, ADD_LN_TILE_BYTES // (ADD_LN_WARPS * c * 2))
    tile = rows * c * 2
    smem = (2 * (ADD_LN_STAGES + ADD_LN_OUT_STAGES) * tile + 2 * c * 4
            + (2 * ADD_LN_STAGES + 1) * 8)
    per_sm = min(ADD_LN_BLOCKS_PER_SM, SM_SMEM // (smem + 1024))
    return AddLayerNormPlan(rows, ADD_LN_STAGES, min(-(-m // rows), per_sm * NUM_SMS),
                            (ADD_LN_WARPS + 1) * 32, smem, per_sm)


def add_layer_norm_plain(
    x: torch.Tensor, y: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
    eps: float = 1e-5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`add_layer_norm`: s = x + y rounded to x's
    dtype, then LayerNorm of the rounded s with fp32 statistics."""
    s = (x.float() + y.float()).to(x.dtype)
    sf = s.float()
    mean = sf.mean(dim=-1, keepdim=True)
    c = sf - mean
    h = c * torch.rsqrt((c * c).mean(dim=-1, keepdim=True) + eps)
    return s, (h * gamma.float() + beta.float()).to(x.dtype)


class AddLayerNorm(torch.autograd.Function):
    """Differentiated :func:`add_layer_norm`, the counterpart of
    ``_add_ln_fused``'s custom VJP: the kernel forward; the backward
    recomputes :func:`add_layer_norm_plain` (fp32 arithmetic) from the saved
    (x, y, gamma, beta) and differentiates it, as ``_add_ln_bwd`` takes the
    VJP of ``_add_ln_reference``. Both outputs, s and h, carry gradients."""

    @staticmethod
    def forward(ctx, x, y, gamma, beta, eps: float):
        ctx.save_for_backward(x, y, gamma, beta)
        ctx.eps = eps
        return add_layer_norm(x, y, gamma, beta, eps=eps)

    @staticmethod
    def backward(ctx, gs, gh):
        leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = add_layer_norm_plain(*leaves, eps=ctx.eps)
            grads = torch.autograd.grad(outs, leaves, (gs, gh))
        return (*grads, None)


def add_layer_norm(
    x: torch.Tensor, y: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
    eps: float = 1e-5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(x + y, LayerNorm(x + y)) over (B, S, C): the residual stream and
    the next sublayer's input in one pass. ``gamma``/``beta`` are fp32 on
    the card, as the JAX kernel takes them. Under autograd it is the
    forward of :class:`AddLayerNorm`."""
    c = x.shape[-1]
    if y.shape != x.shape or gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError(f"add_layer_norm: x {tuple(x.shape)}, y {tuple(y.shape)}, "
                         f"gamma {tuple(gamma.shape)}, beta {tuple(beta.shape)}")
    if needs_grad(x, y, gamma, beta):
        return AddLayerNorm.apply(x, y, gamma, beta, eps)
    if not x.is_cuda:
        return add_layer_norm_plain(x, y, gamma, beta, eps=eps)
    if c % 8 or c > ADD_LN_MAX_DIM:
        raise ValueError(f"add_layer_norm kernel needs C % 8 == 0 and C <= {ADD_LN_MAX_DIM}, "
                         f"got {c}")
    stream = check_kernel_operands("add_layer_norm", x, y)
    check_fp32("add_layer_norm", gamma, beta)
    if any(t.data_ptr() % 16 for t in (x, y, gamma, beta)):
        raise ValueError("add_layer_norm kernel needs 16-byte aligned operands (bulk copies)")
    from gmdx_torch.kernels import _build

    s, h = torch.empty_like(x), torch.empty_like(x)
    _build.call(
        "gmdx_add_ln", x.data_ptr(), y.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        s.data_ptr(), h.data_ptr(), x.numel() // c, c, float(eps), stream,
    )
    LAUNCHES["add_layer_norm"] += 1
    return s, h


__all__ = [
    "GEGLU_FF_KERNEL_DIMS",
    "geglu_ff_ln", "geglu_ff_ln_plain", "geglu_ff_ln_reference", "geglu_ff_ln_plan", "GegluFFLN",
    "geglu_ff", "geglu_ff_plain", "geglu_ff_reference", "geglu_ff_uses_kernel", "GegluFF",
    "add_layer_norm", "add_layer_norm_plain", "add_layer_norm_plan", "AddLayerNormPlan",
    "AddLayerNorm",
]
