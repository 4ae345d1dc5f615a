"""Shared UNet/VAE building blocks, NHWC activations, diffusers parameter names.

Counterpart of ``gmdx/models/layers.py``. Activations stay (B, H, W, C) inside
the models so that the kernels see contiguous channels; parameters keep the
diffusers module tree (``norm1.weight``, ``attn1.to_out.0.weight``, ...) so a
diffusers SD-1.5 state dict loads with ``strict=True``.

Four kinds of call go to hand-written kernels (``gmdx_torch.kernels``) by
default: every 4-D GroupNorm (with its SiLU, temb pre-add and padded
output), the resnet 3x3 convs, the self-attention of 256 keys and more (the
VAE's past 4096), and the transformer block's LN -> GEGLU FF -> residual
tail. :func:`set_kernel_options` switches on the JAX package's three opt-in
kernels (its ``GMDX_XATTN_KERNEL``, ``GMDX_FUSED_ADDLN`` and
``GMDX_WINOGRAD_M`` toggles): the short-K cross-attention, the fused
attn1-residual + norm2, and Winograd F(4x4) for the convs it tiles. A
``GEGLUFeedForward`` called without LayerNorm parameters takes the LN-free
FF kernel. A module with ``use_kernels=False`` calls the same functions'
plain versions instead. Everything else (the projections, conv_in/conv_out,
the 1x1 convs, down/upsampling, LayerNorm, and cross-attention unless
opted in) is plain PyTorch, as the JAX package leaves it to XLA.

Parameters may be kept in another dtype than the activations (fp32 master
weights, bf16 compute: flax's ``dtype=``): every layer casts its weights to
the activations' dtype at use, inside the autograd graph, so gradients land
on the parameters in their own dtype. Under autograd
(:func:`gmdx_torch.kernels.needs_grad`) the kernel calls take their
differentiated routes: the flash-attention and GroupNorm
``autograd.Function``s, the GEGLU FF's kernel forward with a recomputed
backward, and ``F.conv2d`` for the 3x3 conv (the JAX package's direct conv
under AD).

Inside a ``gmdx_torch.dist.tpctx`` context the layers split over the ranks
of a process group, for serving and under autograd for training. Tensor
parallelism ("tp"): a layer whose weights are this rank's slices
(``gmdx_torch.dist.tp``) computes its slice of the output
(column-parallel: its input's gradient summed over the ranks,
``copy_to_model``) or its share of a sum (row-parallel: ``to_out``,
``ff.net.2``, ``linear_2``, ``conv2``, ``reduce_from_model``, the bias
added once after); attention runs head-parallel on the kernels, the
second GroupNorm of a resnet normalises the rank's ``C / tp`` channels as
``32 / tp`` whole groups (the affine slices' gradients summed back into
the whole), and GroupNorm, the conv and the FF take library calls
(:func:`gmdx_torch.kernels.attention.tp_route`). Spatial parallelism
("sp"): activations are the rank's rows of the image; GroupNorm merges
every rank's statistics and, backward, sums every rank's group sums
(:class:`SpatialGroupNorm`), the 3x3 convs read their neighbours' halo
rows (the padded GroupNorm output's border, or
:func:`gmdx_torch.dist.mesh.halo_rows`), self-attention gathers K and V;
the halo rows' and K/V's gradients go back to the ranks whose rows they
are.
"""

from __future__ import annotations

import math
import weakref

import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from gmdx_torch.dist import tpctx
from gmdx_torch.dist.mesh import all_gather_stacked, fill_halo, gather_rows, halo_rows
from gmdx_torch.dist.tp import copy_to_model, gather_full, reduce_from_model
from gmdx_torch.kernels import needs_grad
from gmdx_torch.kernels.attention import attention_packed, dot_product_attention, tp_route
from gmdx_torch.kernels.geglu_ff import (
    GegluFF,
    GegluFFLN,
    add_layer_norm,
    add_layer_norm_plain,
    geglu_ff,
    geglu_ff_ln,
    geglu_ff_ln_plain,
    geglu_ff_plain,
    geglu_ff_reference,
    geglu_ff_uses_kernel,
)
from gmdx_torch.kernels.groupnorm import (
    GroupNormSiLU,
    group_norm_apply,
    group_norm_apply_plain,
    group_norm_bwd_apply,
    group_norm_bwd_apply_plain,
    group_norm_bwd_sums,
    group_norm_bwd_sums_plain,
    group_norm_moments,
    group_norm_moments_plain,
    group_norm_silu,
    group_norm_silu_plain,
    merge_moments,
)
from gmdx_torch.kernels.winograd import (
    conv3x3,
    conv3x3_direct,
    conv3x3_plain,
    conv_route,
    pack_weight,
    pack_weight4,
    winograd4_conv3x3,
    winograd4_conv3x3_plain,
)


def set_use_kernels(module: nn.Module, flag: bool) -> None:
    """Route every kernel call under ``module`` to the kernels (True) or to
    their plain versions (False)."""
    for m in module.modules():
        if hasattr(m, "use_kernels"):
            m.use_kernels = flag


def set_kernel_options(
    module: nn.Module, *, xattn_kernel: bool = False, fused_addln: bool = False,
    winograd_m: int = 2,
) -> None:
    """The JAX package's opt-in kernels for every module under ``module``;
    the defaults are its defaults. ``xattn_kernel``: the short-K
    cross-attention (``GMDX_XATTN_KERNEL=1``); ``fused_addln``: the
    transformer block's attn1 residual and norm2 in one call
    (``GMDX_FUSED_ADDLN=1``); ``winograd_m=4``: F(4x4) Winograd for the 3x3
    convs :func:`conv_route` gives it (``GMDX_WINOGRAD_M=4``)."""
    if winograd_m not in (2, 4):
        raise ValueError(f"winograd_m is 2 or 4, got {winograd_m}")
    for m in module.modules():
        for name, value in (("xattn_kernel", xattn_kernel), ("fused_addln", fused_addln),
                            ("winograd_m", winograd_m)):
            if hasattr(m, name):
                setattr(m, name, value)


def remat_call(module: nn.Module, enabled: bool, *args):
    """``module(*args)``; with ``enabled`` and while a graph is being built,
    its activations are not kept but recomputed in the backward pass
    (``torch.utils.checkpoint``, non-reentrant): the counterpart of flax's
    ``nn.remat`` on a block. The recompute runs the block's forward again,
    its kernels included. The blocks draw no random numbers, so the RNG
    state is not stashed. Inside a model-parallel context the recompute
    enters the same context (autograd may run it on another thread), so it
    issues the forward's collectives again, in the same order on every
    rank."""
    if enabled and torch.is_grad_enabled():
        ctx = tpctx.active()
        if ctx is not None:  # the recompute, in autograd's thread, splits as the forward did
            def run(*a):
                with tpctx.entered(ctx):
                    return module(*a)
        else:
            run = module
        return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False,
                                                 preserve_rng_state=False)
    return module(*args)


def timestep_embedding(
    timesteps: torch.Tensor,
    dim: int,
    *,
    flip_sin_to_cos: bool = True,
    downscale_freq_shift: float = 0.0,
    max_period: float = 10000.0,
) -> torch.Tensor:
    """Sinusoidal timestep embedding (diffusers convention for SD-1.5)."""
    timesteps = torch.atleast_1d(timesteps).float()
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device
    )
    exponent = exponent / (half - downscale_freq_shift)
    emb = timesteps[:, None] * torch.exp(exponent)[None, :]
    sin, cos = torch.sin(emb), torch.cos(emb)
    out = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        out = F.pad(out, (0, 1))
    return out


def _cast(t: torch.Tensor | None, x: torch.Tensor) -> torch.Tensor | None:
    """A parameter in the activations' dtype (a no-op when it already is)."""
    return None if t is None else t.to(x.dtype)


def linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    return F.linear(x, _cast(lin.weight, x), _cast(lin.bias, x))


def _tp_ctx(what: str):
    """The tensor-parallel context a layer holding weight slices needs."""
    ctx = tpctx.tp_active()
    if ctx is None:
        raise RuntimeError(f"{what} holds tensor-parallel weight slices: call it inside "
                           "gmdx_torch.dist.tpctx.parallel_context(\"tp\")")
    return ctx


def _tp_library(op: str) -> bool:
    """Whether ``op`` takes its library call: :func:`tp_route` under the
    active tensor-parallel context (none: the kernels)."""
    ctx = tpctx.tp_active()
    return tp_route(op, 1 if ctx is None else ctx.size) == "library"


def _row_split(lin: nn.Linear) -> bool:
    """Whether ``lin`` holds a row-parallel slice (its input dimension)."""
    return lin.weight.shape[1] != lin.in_features


def linear_row(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """:func:`linear`; with a row-parallel slice, the rank's partial product
    summed over the ranks, then the bias, once."""
    if not _row_split(lin):
        return linear(x, lin)
    y = reduce_from_model(F.linear(x, _cast(lin.weight, x)), _tp_ctx("a row-parallel Linear"))
    return y if lin.bias is None else y + _cast(lin.bias, x)


def linear_col(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """:func:`linear`; with a column-parallel slice (its output dimension),
    the rank's slice of the output, ``x``'s gradient summed over the ranks."""
    if lin.weight.shape[0] != lin.out_features:
        x = copy_to_model(x, _tp_ctx("a column-parallel Linear"))
    return linear(x, lin)


def linear_whole(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """:func:`linear` with the whole weights, gathered from the ranks'
    slices where the layer holds slices."""
    w, b = lin.weight, lin.bias
    if w.shape != (lin.out_features, lin.in_features):
        ctx = _tp_ctx("a Linear")
        w = gather_full(w, (lin.out_features, lin.in_features), ctx)
        b = None if b is None else gather_full(b, (lin.out_features,), ctx)
    return F.linear(x, _cast(w, x), _cast(b, x))


class TimestepEmbedding(nn.Module):
    """Two-layer SiLU MLP lifting the sinusoid to the UNet's temb width."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear_row(F.silu(linear_col(x, self.linear_1)), self.linear_2)


def layer_norm(x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
    """LayerNorm with fp32 statistics, result in x's dtype."""
    return F.layer_norm(
        x.float(), norm.normalized_shape, norm.weight.float(), norm.bias.float(), norm.eps
    ).to(x.dtype)


def conv2d_nhwc(x: torch.Tensor, conv: nn.Conv2d, *, pad_rows: bool = True) -> torch.Tensor:
    """A conv left to PyTorch, applied to NHWC ``x`` (a channels-last view).
    Under spatial parallelism ``x`` is the rank's rows: a conv taller than
    a row reads the rows above and below that its output rows need from
    the neighbouring ranks (its own zero padding past the image's edges,
    unless ``pad_rows`` is False: the caller's), and a stride-2 conv needs
    even local rows."""
    ctx = tpctx.sp_active()
    kh, sh, ph = conv.kernel_size[0], conv.stride[0], conv.padding[0]
    if ctx is None or kh == 1:
        y = F.conv2d(x.permute(0, 3, 1, 2), _cast(conv.weight, x), _cast(conv.bias, x),
                     conv.stride, conv.padding)
        return y.permute(0, 2, 3, 1).contiguous()
    h = x.shape[1]
    if h % sh:
        raise ValueError(f"the {h * ctx.size}-row level: {h} rows a rank do not split into "
                         f"stride-{sh} rows over {ctx.size} ranks")
    ph = ph if pad_rows else 0
    xh = halo_rows(x, ph, kh - sh - ph, ctx)
    y = F.conv2d(xh.permute(0, 3, 1, 2), _cast(conv.weight, x), _cast(conv.bias, x),
                 conv.stride, (0, conv.padding[1]))
    return y.permute(0, 2, 3, 1).contiguous()


def conv1x1_nhwc(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """A 1x1 conv as a Linear over NHWC. Under tensor parallelism the
    transformer's ``proj_in`` holds its bias's slice (the JAX rule shards
    it, not the weight): gathered here."""
    w, b = conv.weight.view(conv.out_channels, conv.in_channels), conv.bias
    if b is not None and b.shape[0] != conv.out_channels:
        b = gather_full(b, (conv.out_channels,), _tp_ctx("a 1x1 conv"))
    return F.linear(x, _cast(w, x), _cast(b, x))


class SpatialGroupNorm(torch.autograd.Function):
    """The image's GroupNorm over this rank's rows ``x`` under spatial
    parallelism (``ctx``, a ``tpctx.ParallelContext``). Forward: the rows'
    (mean, M2), one all-gather of every rank's, the merge, then the rows
    normalised with the image's statistics (padded: its top and bottom
    border rows left zero for :func:`fill_halo`). Backward, from the saved
    statistics: the rows' sums of ``dy * scale`` and ``dy * scale * xhat``
    per group, one all-reduce of every rank's in place of the one-rank
    kernel's grid barrier, then dx of the rows; the affine parameters' and
    the temb's gradients are this rank's share (summed over the ranks with
    every replicated leaf's). Whole activations never cross ranks. The
    kernels, or with ``use_kernels=False`` their plain versions."""

    @staticmethod
    def forward(fctx, x, w, b, temb, groups: int, eps: float, activate: bool, pad_output: bool,
                use_kernels: bool, ctx):
        _, h, wd, c = x.shape
        moments = (group_norm_moments if use_kernels else group_norm_moments_plain)(
            x, temb, num_groups=groups)
        stats = merge_moments(all_gather_stacked(moments, ctx), h * wd * (c // groups), eps)
        fctx.save_for_backward(x, w, b, temb, stats)
        fctx.args = (activate, pad_output, use_kernels, ctx)
        return (group_norm_apply if use_kernels else group_norm_apply_plain)(
            x, w, b, temb, stats, activate=activate, pad_output=pad_output)

    @staticmethod
    def backward(fctx, g):
        x, w, b, temb, stats = fctx.saved_tensors
        activate, pad_output, use_kernels, ctx = fctx.args
        g = g.to(x.dtype).contiguous()
        kw = {"activate": activate, "pad_output": pad_output}
        sums, dw, db = (group_norm_bwd_sums if use_kernels else group_norm_bwd_sums_plain)(
            x, w, b, temb, stats, g, **kw)
        dist.all_reduce(sums, group=ctx.group)
        dx, dtemb = (group_norm_bwd_apply if use_kernels else group_norm_bwd_apply_plain)(
            x, w, b, temb, stats, g, sums, x.shape[1] * x.shape[2] * ctx.size, **kw)
        return (dx, dw.to(w.dtype), db.to(b.dtype),
                dtemb.to(temb.dtype) if temb is not None else None,
                None, None, None, None, None, None)


class GroupNorm(nn.GroupNorm):
    """GroupNorm with fp32 statistics over NHWC, always through the
    GroupNorm kernel (under autograd :class:`GroupNormSiLU`, whose backward
    is the GN-backward kernel): ``activate`` fuses the SiLU, ``temb`` (B, C)
    is added before the statistics, ``pad_output`` emits the 1-px zero
    border the conv kernel takes."""

    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-5):
        super().__init__(num_groups, num_channels, eps=eps)
        self.use_kernels = True

    def forward(
        self,
        x: torch.Tensor,
        activate: bool = False,
        pad_output: bool = False,
        temb: torch.Tensor | None = None,
    ) -> torch.Tensor:
        w, b = _cast(self.weight, x), _cast(self.bias, x)
        if _tp_library("group_norm"):
            return self._tensor_parallel(x, w, b, temb, activate, pad_output)
        ctx = tpctx.sp_active()
        if ctx is not None:
            y = SpatialGroupNorm.apply(x, w, b, temb, self.num_groups, self.eps, activate,
                                       pad_output, self.use_kernels, ctx)
            return fill_halo(y, ctx) if pad_output else y
        if self.use_kernels and needs_grad(x, w, b, temb):
            return GroupNormSiLU.apply(
                x, w, b, temb, self.num_groups, self.eps, activate, pad_output
            )
        fn = group_norm_silu if self.use_kernels else group_norm_silu_plain
        return fn(
            x, w, b, temb, num_groups=self.num_groups, eps=self.eps,
            activate=activate, pad_output=pad_output,
        )

    def _tensor_parallel(self, x, w, b, temb, activate, pad_output) -> torch.Tensor:
        """The library call under tensor parallelism; on the rank's ``C / tp``
        channels (after a column-parallel conv1) as ``G / tp`` whole
        groups, with the rank's slice of the affine parameters."""
        c, groups = x.shape[-1], self.num_groups
        if c != self.num_channels:
            ctx = _tp_ctx("GroupNorm")
            n = self.num_channels // c
            if self.num_channels % c or groups % n:
                raise ValueError(f"GroupNorm({groups}, {self.num_channels}): {c} channels a "
                                 f"rank are not whole groups")
            # The rank's slice of the whole affine parameters: their
            # gradient is summed over the ranks, so that each rank's is whole.
            wb = copy_to_model(torch.stack([w, b]), ctx).narrow(1, ctx.rank * c, c)
            w, b, groups = wb[0], wb[1], groups // n
        h = x if temb is None else x + temb.to(x.dtype)[:, None, None, :]
        y = F.group_norm(h.permute(0, 3, 1, 2), groups, w, b, self.eps).permute(0, 2, 3, 1)
        y = (F.silu(y) if activate else y).contiguous()
        return F.pad(y, (0, 0, 1, 1, 1, 1)) if pad_output else y


class Conv3x3(nn.Conv2d):
    """3x3 stride-1 SAME conv over NHWC through the conv kernel, or with
    ``winograd_m=4`` through the F(4x4) kernel where :func:`conv_route`
    says so. Each kernel's weight operand (the (O, 9*C) packing, the
    transformed (36, O, C) U) is made from ``weight`` on first use and again
    whenever the weight changes: an optimizer's in-place update bumps the
    weight's version, and a weight swapped in for the call is another
    tensor object; the caches are keyed on both. Under autograd the
    conv is :func:`conv3x3_direct` with the weight itself."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__(in_ch, out_ch, 3, padding=1)
        if in_ch % 8 or out_ch % 8:
            raise ValueError(f"conv kernel needs widths % 8 == 0, got {in_ch}, {out_ch}")
        self.use_kernels = True
        self.winograd_m = 2
        self._cached: dict[str, tuple] = {}

    def _weight_operand(self, kind: str, dtype: torch.dtype, make) -> torch.Tensor:
        # A hit needs the same live tensor object at the same version: a
        # weight swapped in by torch.func.functional_call (the merged LoRA
        # weights of Stage 1, new tensors every step) never matches a freed
        # one whose storage the allocator handed on.
        w = self.weight
        hit = self._cached.get(kind)
        if hit is None or hit[0]() is not w or hit[1] != (w._version, dtype):
            hit = self._cached[kind] = (weakref.ref(w), (w._version, dtype), make(w.detach(), dtype))
        return hit[2]

    def packed_weight(self, dtype: torch.dtype) -> torch.Tensor:
        return self._weight_operand("packed", dtype, lambda w, dt: pack_weight(w.to(dt)))

    def wino4_weight(self, dtype: torch.dtype) -> torch.Tensor:
        """U in ``dtype``, transformed in fp32 from the parameter's dtype."""
        return self._weight_operand("wino4", dtype, pack_weight4)

    def forward(self, x: torch.Tensor, pre_padded: bool = False) -> torch.Tensor:
        bias = _cast(self.bias, x)
        if _tp_library("conv3x3"):
            return self._tensor_parallel(x, bias, pre_padded)
        ctx = tpctx.sp_active()
        if ctx is not None and not pre_padded:  # the halo rows, then the slab
            x, pre_padded = F.pad(halo_rows(x, 1, 1, ctx), (0, 0, 1, 1)), True
        if needs_grad(x, self.weight, self.bias):
            return conv3x3_direct(x, _cast(self.weight, x), bias, pre_padded=pre_padded)
        h, w = x.shape[1] - 2 * pre_padded, x.shape[2] - 2 * pre_padded
        if conv_route(h, w, self.in_channels, self.out_channels, self.winograd_m,
                      x.element_size()) == "wino4":
            fn = winograd4_conv3x3 if self.use_kernels else winograd4_conv3x3_plain
            return fn(x, self.wino4_weight(x.dtype), bias, pre_padded=pre_padded)
        fn = conv3x3 if self.use_kernels else conv3x3_plain
        return fn(x, self.packed_weight(x.dtype), bias, pre_padded=pre_padded)

    def _tensor_parallel(self, x, bias, pre_padded) -> torch.Tensor:
        """``F.conv2d`` on the rank's slice of the weight: conv1's output
        channels (its bias's slice), or conv2's input channels (a partial
        sum over the ranks, then the bias)."""
        w = _cast(self.weight, x)
        row = w.shape[1] != self.in_channels
        if w.shape[0] != self.out_channels:  # conv1's output channels
            x = copy_to_model(x, _tp_ctx("conv1"))
        y = conv3x3_direct(x, w, None if row else bias, pre_padded=pre_padded)
        if not row:
            return y
        return reduce_from_model(y, _tp_ctx("conv2")) + bias


class Attention(nn.Module):
    """Multi-head attention over (B, S, C); cross-attention when ``context``
    is given. No-bias q/k/v, bias on ``to_out.0``; q/k/v stay head-packed
    (B, S, H*D) into :func:`attention_packed`, with the ``xattn_kernel``
    option."""

    def __init__(self, query_dim: int, heads: int, head_dim: int, context_dim: int | None = None):
        super().__init__()
        inner = heads * head_dim
        ctx = query_dim if context_dim is None else context_dim
        self.heads = heads
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(ctx, inner, bias=False)
        self.to_v = nn.Linear(ctx, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim), nn.Dropout(0.0)])
        self.use_kernels = True
        self.xattn_kernel = False

    def forward(self, x: torch.Tensor, context: torch.Tensor | None = None) -> torch.Tensor:
        src = x if context is None else context
        heads, qkv, out = self.heads, linear, linear
        if self.to_q.weight.shape[0] != self.to_q.out_features:  # tensor-parallel slices
            ctx = _tp_ctx("Attention")
            widths = (self.to_q.out_features, self.to_k.out_features, self.to_v.out_features)
            if tp_route("attention", ctx.size, heads=heads, widths=widths) == "heads":
                # Column-parallel q/k/v: one gradient sum an input.
                heads, out = heads // ctx.size, linear_row
                x = copy_to_model(x, ctx)
                src = x if context is None else copy_to_model(context, ctx)
            else:
                qkv = out = linear_whole
        q, k, v = qkv(x, self.to_q), qkv(src, self.to_k), qkv(src, self.to_v)
        ctx = tpctx.sp_active()
        if ctx is not None and context is None:  # the rank's queries, every rank's keys
            k, v = gather_rows(k, ctx, 1), gather_rows(v, ctx, 1)
        a = attention_packed(q, k, v, heads, use_kernels=self.use_kernels,
                             xattn_kernel=self.xattn_kernel)
        return out(a, self.to_out[0])


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)


class GEGLUFeedForward(nn.Module):
    """GEGLU MLP (mult 4, exact erf GELU). Given the preceding LayerNorm
    ``norm`` and a pending residual ``add``, the whole (x + add) -> LN -> FF
    -> + residual tail is one kernel call (the transformer block's). Without
    ``norm`` it is the JAX module's LN-free branch: ``residual`` + FF(x)
    (nothing added when it is None), through the LN-free FF kernel at the
    dims the JAX rule gives it and :func:`geglu_ff_reference` at others."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([GEGLU(dim, inner), nn.Dropout(0.0), nn.Linear(inner, dim)])
        self.use_kernels = True

    def forward(
        self, x: torch.Tensor, add: torch.Tensor | None = None, norm: nn.LayerNorm | None = None,
        *, residual: torch.Tensor | None = None,
    ) -> torch.Tensor:
        proj_in, proj_out = self.net[0].proj, self.net[2]
        if _tp_library("geglu_ff"):
            if norm is not None:
                x = x + add
                residual, x = x, layer_norm(x, norm)
            return self._tensor_parallel(x, _cast(residual, x), proj_in, proj_out)
        if norm is None:
            return self._forward_no_ln(x, _cast(residual, x), proj_in, proj_out)
        args = [x, add] + [
            _cast(p, x) for p in (norm.weight, norm.bias, proj_in.weight, proj_in.bias,
                                  proj_out.weight, proj_out.bias)
        ]
        if not self.use_kernels:
            return geglu_ff_ln_plain(*args, eps=norm.eps)
        if needs_grad(*args):
            return GegluFFLN.apply(*args, norm.eps)
        return geglu_ff_ln(*args, eps=norm.eps)

    def _tensor_parallel(self, x, residual, proj_in, proj_out) -> torch.Tensor:
        """The torch GEGLU chain in x's dtype under tensor parallelism: the
        rank's hidden and gate columns (``gmdx_torch.dist.tp`` slices each
        half by rank), its rows of ``ff.net.2``, the partial sums
        all-reduced, then the bias and the residual."""
        w1, b1, w2, b2 = (_cast(p, x) for p in (proj_in.weight, proj_in.bias, proj_out.weight,
                                                 proj_out.bias))
        if not _row_split(proj_out):
            return geglu_ff_reference(x, residual, w1, b1, w2, b2)
        ctx = _tp_ctx("the FF")
        hidden, gate = F.linear(copy_to_model(x, ctx), w1, b1).chunk(2, dim=-1)
        out = reduce_from_model(F.linear(hidden * F.gelu(gate), w2), ctx) + b2
        return out if residual is None else residual + out

    def _forward_no_ln(self, x, residual, proj_in, proj_out) -> torch.Tensor:
        args = [x, residual] + [
            _cast(p, x) for p in (proj_in.weight, proj_in.bias, proj_out.weight, proj_out.bias)
        ]
        if not self.use_kernels:
            return geglu_ff_plain(*args)
        if not geglu_ff_uses_kernel(x.shape[-1], proj_out.in_features):
            return geglu_ff_reference(*args)
        if needs_grad(*args):
            return GegluFF.apply(*args)
        return geglu_ff(*args)


class BasicTransformerBlock(nn.Module):
    """LN -> self-attn -> LN -> cross-attn -> LN -> GEGLU FF (pre-norm,
    LayerNorm eps 1e-5). attn2's output folds into the FF kernel's prologue;
    norm3's parameters feed that kernel. With ``fused_addln`` the attn1
    residual and norm2 are one :func:`add_layer_norm` call
    (``gmdx/models/layers.py:368-383``); the parameters are the same."""

    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = Attention(dim, heads, head_dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = Attention(dim, heads, head_dim, context_dim=context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = GEGLUFeedForward(dim)
        self.use_kernels = True
        self.fused_addln = False

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        a1 = self.attn1(layer_norm(x, self.norm1))
        if self.fused_addln and not _tp_library("add_layer_norm"):
            fn = add_layer_norm if self.use_kernels else add_layer_norm_plain
            x, h = fn(x, a1, self.norm2.weight.float(), self.norm2.bias.float(),
                      eps=self.norm2.eps)
        else:
            x = x + a1
            h = layer_norm(x, self.norm2)
        a2 = self.attn2(h, context)
        return self.ff(x, a2, self.norm3)


class Transformer2D(nn.Module):
    """Spatial transformer: GN -> 1x1 conv in -> blocks over the flattened
    grid -> 1x1 conv out -> residual."""

    def __init__(self, channels: int, heads: int, head_dim: int, context_dim: int, depth: int = 1):
        super().__init__()
        self.norm = GroupNorm(channels, 32, eps=1e-6)
        self.proj_in = nn.Conv2d(channels, channels, 1)
        self.transformer_blocks = nn.ModuleList(
            [BasicTransformerBlock(channels, heads, head_dim, context_dim) for _ in range(depth)]
        )
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        residual = x
        x = conv1x1_nhwc(self.norm(x), self.proj_in).reshape(b, h * w, c)
        for block in self.transformer_blocks:
            x = block(x, context)
        x = conv1x1_nhwc(x.reshape(b, h, w, c), self.proj_out)
        return x + residual


class ResnetBlock2D(nn.Module):
    """GN -> SiLU -> conv -> (+temb, inside the next GN) -> GN -> SiLU ->
    conv, residual. Each GN emits the padded image its conv takes."""

    def __init__(self, in_ch: int, out_ch: int, temb_dim: int | None = None):
        super().__init__()
        self.norm1 = GroupNorm(in_ch, 32, eps=1e-5)
        self.conv1 = Conv3x3(in_ch, out_ch)
        if temb_dim is not None:
            self.time_emb_proj = nn.Linear(temb_dim, out_ch)
        self.norm2 = GroupNorm(out_ch, 32, eps=1e-5)
        self.conv2 = Conv3x3(out_ch, out_ch)
        self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor, temb: torch.Tensor | None = None) -> torch.Tensor:
        h = self.norm1(x, activate=True, pad_output=True)
        h = self.conv1(h, pre_padded=True)
        t = None
        if temb is not None and hasattr(self, "time_emb_proj"):
            t = linear_col(F.silu(temb), self.time_emb_proj)
        h = self.norm2(h, activate=True, pad_output=True, temb=t)
        h = self.conv2(h, pre_padded=True)
        if self.conv_shortcut is not None:
            x = conv1x1_nhwc(x, self.conv_shortcut)
        return x + h


class Downsample2D(nn.Module):
    """Strided 3x3 conv. The UNet pads 1 on every side; the VAE encoder pads
    (0, 1) x (0, 1), which ``asymmetric_pad`` selects."""

    def __init__(self, channels: int, asymmetric_pad: bool = False):
        super().__init__()
        self.asymmetric_pad = asymmetric_pad
        self.conv = nn.Conv2d(channels, channels, 3, stride=2, padding=0 if asymmetric_pad else 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.asymmetric_pad:
            if tpctx.sp_active() is not None:  # the bottom row is the next rank's
                return conv2d_nhwc(F.pad(x, (0, 0, 0, 1)), self.conv, pad_rows=False)
            x = F.pad(x, (0, 0, 0, 1, 0, 1))
        return conv2d_nhwc(x, self.conv)


class Upsample2D(nn.Module):
    """Nearest 2x upsample + 3x3 conv (the same math as the JAX package's
    sub-pixel fold)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2.0, mode="nearest")
        if tpctx.sp_active() is not None:
            return conv2d_nhwc(up.permute(0, 2, 3, 1), self.conv)
        y = F.conv2d(up, _cast(self.conv.weight, x), _cast(self.conv.bias, x), padding=1)
        return y.permute(0, 2, 3, 1).contiguous()


class VAEAttention(nn.Module):
    """Single-head spatial self-attention of the VAE mid block, through
    :func:`dot_product_attention`: its 512-wide head takes the plain path up
    to 4096 tokens (512^2) and the flash forward past them (1024^2)."""

    def __init__(self, channels: int):
        super().__init__()
        self.group_norm = GroupNorm(channels, 32, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels), nn.Dropout(0.0)])
        self.use_kernels = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        residual = x
        y = self.group_norm(x).reshape(b, h * w, c)
        # One head: tensor parallelism computes it whole (tp_route's
        # "whole"), from weights gathered where the rank holds slices.
        lin = linear_whole if tpctx.tp_active() is not None else linear
        q, k, v = lin(y, self.to_q), lin(y, self.to_k), lin(y, self.to_v)
        ctx = tpctx.sp_active()
        if ctx is not None:
            k, v = gather_rows(k, ctx, 1), gather_rows(v, ctx, 1)
        out = dot_product_attention(q[:, :, None], k[:, :, None], v[:, :, None],
                                    use_kernels=self.use_kernels)[:, :, 0]
        return lin(out, self.to_out[0]).reshape(b, h, w, c) + residual


__all__ = [
    "set_use_kernels",
    "set_kernel_options",
    "linear",
    "linear_row",
    "linear_whole",
    "layer_norm",
    "timestep_embedding",
    "TimestepEmbedding",
    "GroupNorm",
    "Conv3x3",
    "Attention",
    "GEGLUFeedForward",
    "BasicTransformerBlock",
    "Transformer2D",
    "ResnetBlock2D",
    "Downsample2D",
    "Upsample2D",
    "VAEAttention",
]
