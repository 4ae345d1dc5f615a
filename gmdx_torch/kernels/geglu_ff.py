"""LayerNorm -> GEGLU feed-forward -> residual, with a pending residual folded
into the prologue.

Counterpart of ``gmdx/kernels/geglu_ff.py:geglu_ff_ln`` with ``add=``.
Kernel: ``csrc/geglu_ff.cu`` (two launches of the shared tile GEMM).
Weights are the torch Linear layouts: ``w1`` (2*inner, dim) with rows
``[hidden | gate]``, ``w2`` (dim, inner).

Under autograd, :class:`GegluFFLN` runs the kernel forward and, like
``_ff_ln_bwd``/``_ff_add_ln_bwd`` (``geglu_ff.py:385-428``), differentiates
a recompute of :func:`geglu_ff_ln_reference` in its backward: the JAX
package has no backward kernel here, so the port writes none.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from gmdx_torch.kernels import LAUNCHES, check_kernel_operands


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
    proj = h @ w1.float().t() + b1.float()
    hidden, gate = proj.chunk(2, dim=-1)
    act = hidden * 0.5 * gate * (1.0 + torch.erf(gate * 0.7071067811865476))
    out = act @ w2.float().t() + b2.float() + sf
    return out.to(x.dtype)


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
    inner = w2.shape[1]
    if w1.shape != (2 * inner, dim) or w2.shape != (dim, inner):
        raise ValueError(f"FF weights {tuple(w1.shape)}, {tuple(w2.shape)} vs dim {dim}")
    if add is not None and add.shape != x.shape:
        raise ValueError(f"add {tuple(add.shape)} vs x {tuple(x.shape)}")
    if not x.is_cuda:
        return geglu_ff_ln_plain(x, add, gamma, beta, w1, b1, w2, b2, eps=eps)
    if dim % 8 or inner % 8:
        raise ValueError(f"geglu_ff_ln kernel needs dim, inner % 8 == 0, got {dim}, {inner}")
    stream = check_kernel_operands("geglu_ff_ln", x, add, gamma, beta, w1, b1, w2, b2)
    from gmdx_torch.kernels import _build

    m = x.numel() // dim
    act = torch.empty((m, inner), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    _build.call(
        "gmdx_geglu_ff_ln", x.data_ptr(), add.data_ptr() if add is not None else None,
        gamma.data_ptr(), beta.data_ptr(), w1.data_ptr(), b1.data_ptr(),
        w2.data_ptr(), b2.data_ptr(), act.data_ptr(), out.data_ptr(),
        m, dim, inner, float(eps), stream,
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
    hidden, gate = F.linear(y, w1.to(y.dtype), b1.to(y.dtype)).chunk(2, dim=-1)
    return s + F.linear(hidden * F.gelu(gate), w2.to(y.dtype), b2.to(y.dtype))


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


__all__ = ["geglu_ff_ln", "geglu_ff_ln_plain", "geglu_ff_ln_reference", "GegluFFLN"]
