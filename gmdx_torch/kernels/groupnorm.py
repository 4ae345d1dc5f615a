"""GroupNorm (+temb pre-add) (+SiLU) (+1-px padded output) over NHWC.

Counterpart of ``gmdx/kernels/groupnorm.py``: one function covers both
``fused_group_norm_silu`` (plain, optionally padded) and
``parity_gn_pad_silu`` (temb added before the statistics), without the
Winograd parity layout. Kernel: ``csrc/groupnorm.cu``: the forward is one
launch of ``gn_cluster_kernel``, one thread-block cluster an image whose
slices are resident in shared memory, wherever :func:`group_norm_plan` finds
that they fit, and the stats + apply pair elsewhere.

The backward (``_gn_backward``: the sums, then dx, from the statistics the
forward saved) is :func:`group_norm_silu_bwd`, one cooperative launch of
``gn_bwd_kernel`` as :func:`group_norm_bwd_plan` lays it out, which also
folds dgamma, dbeta and dtemb; :class:`GroupNormSiLU` ties the two together
for autograd, as ``_gn_silu_pallas``'s custom VJP does. Statistics are
(B, 2, G) fp32: each group's mean (of ``x + temb``) and rstd.

Under spatial parallelism an image's rows lie on several ranks and its
statistics span all of them: the split form is the JAX forward's stats and
apply passes with a reduction between them. :func:`group_norm_moments`
takes each group's (mean, M2) over a rank's rows, :func:`merge_moments`
merges every rank's into the image's (mean, rstd), and
:func:`group_norm_apply` normalises the rows with them (the collective
between them is the caller's: ``gmdx_torch.models.layers.GroupNorm``). The
backward splits the same way, at the one-rank kernel's grid barrier:
:func:`group_norm_bwd_sums` takes each group's sums of ``dy * scale`` and
``dy * scale * xhat`` over a rank's rows (and the rows' parameter
gradients), the caller all-reduces them, and :func:`group_norm_bwd_apply`
writes the rows' dx (and dtemb's share) from the image's sums
(``gmdx_torch.models.layers.SpatialGroupNorm``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from gmdx_torch.kernels import (
    LAUNCHES, NUM_SMS, SM_BLOCKS, SM_REGISTERS, SM_SMEM, SM_WARPS, check_fp32,
    check_kernel_operands,
)

_TARGET_BLOCKS = 528  # the pair's blocks: about four an SM of 132
# csrc/groupnorm.cu's plan constants: the dynamic shared memory a block may
# use, the most groups, the resident slice's bulk copies (an mbarrier each),
# the cluster sizes and, for each, the clusters the H100 holds resident at
# once (one CTA an SM; cudaOccupancyMaxActiveClusters, which
# gmdx_group_norm_plan reports and the card tests hold to this table).
SMEM_BUDGET = 232448
MAX_GROUPS = 64
LOAD_PIECES = 4
CLUSTERS = (1, 2, 4, 8, 16)
RESIDENT_CLUSTERS = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}
# A wave's fixed cost (the fold and the cluster barriers, about 4 us on the
# H100) as the slice bytes a CTA loads and stores in that time (about 17 GB/s
# each way, PERF.md).
WAVE_BYTES = 32768
# The plan's forms, as gmdx_group_norm_plan numbers them: the stats + apply
# pair and the cluster kernel, each image's slices resident.
FORMS = ("pair", "resident")
# Both kernels take an 8-channel chunk a thread, at most 512 threads.
MAX_CHANNELS = 4096
# Registers a thread of gn_bwd_kernel as ptxas builds it for sm_90a (the
# build phase of chip_smoke.py prints them): with the threads and shared
# memory of a plan they give the blocks an SM holds at once, which the card
# tests hold to cudaOccupancyMaxActiveBlocksPerMultiprocessor.
BWD_REGISTERS = 128


@dataclass(frozen=True)
class GroupNormPlan:
    """The forward's launch (``gn_plan`` in ``csrc/groupnorm.cu``): its
    ``form``, ``cluster`` CTAs an image (1 for the pair), the ``pixels`` a
    CTA (a pair block) takes, ``smem_bytes`` of dynamic shared memory (the
    slice and the fold's scratch; the pair's stats kernel's scratch),
    ``grid`` (x, images) and ``threads`` a block."""

    form: str
    cluster: int
    pixels: int
    smem_bytes: int
    grid: tuple[int, int]
    threads: int

    def c_fields(self) -> list[int]:
        """The first seven fields of ``gmdx_group_norm_plan``'s report."""
        return [FORMS.index(self.form), self.cluster, self.pixels, self.smem_bytes, *self.grid,
                self.threads]


@dataclass(frozen=True)
class GroupNormBwdPlan:
    """The backward's launch (``gn_bwd_plan`` in ``csrc/groupnorm.cu``):
    ``grid`` (splits an image, image rows; a block row takes images y,
    y + rows, ...), the ``pixels`` of a block's contiguous range,
    ``threads`` a block, ``smem_bytes`` of dynamic shared memory and the
    blocks ``resident`` on an SM at once."""

    grid: tuple[int, int]
    pixels: int
    threads: int
    smem_bytes: int
    resident: int

    def c_fields(self) -> list[int]:
        """``gmdx_group_norm_bwd_plan``'s report."""
        return [*self.grid, self.pixels, self.threads, self.smem_bytes, self.resident, NUM_SMS]


def group_norm_silu_plain(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    temb: torch.Tensor | None = None,
    *,
    num_groups: int = 32,
    eps: float = 1e-5,
    activate: bool = True,
    pad_output: bool = False,
    return_stats: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Plain version: fp32 statistics (two-pass variance), result in x's
    dtype. ``temb`` is (B, C), added before the statistics. With
    ``return_stats`` also the (B, 2, G) (mean, rstd)."""
    b, h, w, c = x.shape
    xf = x.float()
    if temb is not None:
        xf = xf + temb.float()[:, None, None, :]
    xg = xf.reshape(b, h * w, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = xg.var(dim=(1, 3), unbiased=False, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    y = ((xg - mean) * rstd).reshape(b, h, w, c)
    y = y * scale.float() + bias.float()
    if activate:
        y = F.silu(y)
    y = y.to(x.dtype)
    if pad_output:
        y = F.pad(y, (0, 0, 1, 1, 1, 1))
    if return_stats:
        return y, torch.stack([mean.reshape(b, num_groups), rstd.reshape(b, num_groups)], 1)
    return y


def _splits(b: int, hw: int, c: int) -> int:
    """Blocks per image of the pair: about _TARGET_BLOCKS
    in all, and no more than a block's walk of ``rows`` pixels each."""
    rows = max(1, 512 // (c // 8))  # pixels a block walks in parallel
    return max(1, min(-(-_TARGET_BLOCKS // b), -(-hw // rows)))


def _threads(c: int) -> int:
    """(C / 8) * R threads: an 8-channel chunk each, R pixel rows in parallel."""
    chunks = c // 8
    return chunks * max(1, 512 // chunks)


def _pair_plan(b: int, hw: int, c: int) -> GroupNormPlan:
    """The stats + apply pair: grid (splits, b), the stats kernel's fold
    scratch as its dynamic shared memory."""
    splits, threads = _splits(b, hw, c), _threads(c)
    return GroupNormPlan("pair", 1, -(-hw // splits), 64 * threads, (splits, b), threads)


def group_norm_plan(b: int, h: int, w: int, c: int) -> GroupNormPlan:
    """The forward's plan for ``b`` images of (h, w, c): the cluster kernel
    (each CTA's slice of ceil(HW / n) pixels resident in shared memory
    beside ``64 * threads + 4 * MAX_GROUPS * 4 + LOAD_PIECES * 8`` bytes of
    scratch) at the cluster size n of :data:`CLUSTERS` whose slice fits and
    whose cost ``ceil(b / RESIDENT_CLUSTERS[n]) * (slice bytes + WAVE_BYTES)``
    is least, the smaller n on a tie: the waves of clusters the card holds
    at once, each as long as a CTA takes over its slice plus the wave's
    fixed cost. The pair where no slice fits."""
    hw, threads = h * w, _threads(c)
    fixed = 64 * threads + 4 * MAX_GROUPS * 4 + LOAD_PIECES * 8
    fit, best = 0, 0
    for n in CLUSTERS:
        pixels = -(-hw // n)
        if n > hw or pixels * c * 2 + fixed > SMEM_BUDGET:
            continue
        cost = -(-b // RESIDENT_CLUSTERS[n]) * (pixels * c * 2 + WAVE_BYTES)
        if not fit or cost < best:
            fit, best = n, cost
    if not fit:
        return _pair_plan(b, hw, c)
    pixels = -(-hw // fit)
    return GroupNormPlan("resident", fit, pixels, fixed + pixels * c * 2, (fit, b), threads)


def _bwd_resident(threads: int) -> int:
    """Blocks of ``threads`` threads of ``gn_bwd_kernel`` one SM holds:
    registers (allocated 256 a warp), warps, shared memory and blocks."""
    warps = -(-threads // 32)
    warp_regs = -(-BWD_REGISTERS * 32 // 256) * 256
    smem = 64 * threads + 2 * MAX_GROUPS * 4
    return min(SM_REGISTERS // warp_regs // warps, SM_WARPS // warps,
               SM_SMEM // (smem + 1024), SM_BLOCKS)


def group_norm_bwd_plan(b: int, h: int, w: int, c: int) -> GroupNormBwdPlan:
    """The backward's plan for ``b`` images of (h, w, c): every block the
    card holds at once (``resident`` an SM on :data:`NUM_SMS`), shared out
    over the images as equal contiguous pixel ranges of at least a pixel a
    row of threads, none empty; beyond that many images a block row takes
    several. The threads are the forward's (an 8-channel chunk each, R pixel
    rows in parallel); the shared memory the fold's [2][R][C] fp32 sums and
    the image's (2, G) group means."""
    threads = _threads(c)
    rows = threads // (c // 8)
    hw = h * w
    resident = _bwd_resident(threads)
    cap = resident * NUM_SMS
    splits = min(cap // b if b else cap, -(-hw // rows))
    pixels = -(-hw // splits) if splits > 1 else hw
    splits = -(-hw // pixels) if pixels else 1
    return GroupNormBwdPlan((splits, min(b, cap // splits)), pixels, threads,
                            64 * threads + 2 * MAX_GROUPS * 4, resident)


def group_norm_silu(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    temb: torch.Tensor | None = None,
    *,
    num_groups: int = 32,
    eps: float = 1e-5,
    activate: bool = True,
    pad_output: bool = False,
    return_stats: bool = False,
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """GN(num_groups) over NHWC ``x`` (B, H, W, C) with affine ``scale``/
    ``bias`` (C,), optional ``temb`` (B, C) added before the statistics,
    optional SiLU, and with ``pad_output`` the 1-px zero-bordered result
    (B, H+2, W+2, C) that :func:`gmdx_torch.kernels.winograd.conv3x3` takes
    with ``pre_padded=True``. ``return_stats`` also returns the kernel's own
    final (B, 2, G) (mean, rstd), which the backward needs."""
    if x.ndim != 4:
        raise ValueError(f"expected NHWC, got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if c % num_groups:
        raise ValueError(f"{c} channels do not split into {num_groups} groups")
    if not x.is_cuda:
        return group_norm_silu_plain(
            x, scale, bias, temb, num_groups=num_groups, eps=eps,
            activate=activate, pad_output=pad_output, return_stats=return_stats,
        )
    if c % 8 or c > MAX_CHANNELS or num_groups > MAX_GROUPS:
        raise ValueError(f"group_norm_silu kernel: unsupported C={c}, G={num_groups}")
    if temb is not None and temb.shape != (b, c):
        raise ValueError(f"temb must be ({b}, {c}), got {tuple(temb.shape)}")
    stream = check_kernel_operands("group_norm_silu", x, scale, bias, temb)
    from gmdx_torch.kernels import _build

    plan = group_norm_plan(b, h, w, c)
    pad = 1 if pad_output else 0
    out = torch.empty((b, h + 2 * pad, w + 2 * pad, c), dtype=x.dtype, device=x.device)
    partials = (torch.empty((b, plan.grid[0], num_groups, 2), dtype=torch.float32,
                            device=x.device) if plan.form == "pair" else None)
    stats = (torch.empty((b, 2, num_groups), dtype=torch.float32, device=x.device)
             if return_stats else None)
    _build.call(
        "gmdx_group_norm_silu", x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        temb.data_ptr() if temb is not None else None, out.data_ptr(),
        partials.data_ptr() if partials is not None else None,
        stats.data_ptr() if stats is not None else None,
        b, h, w, c, num_groups, float(eps), int(activate), pad, stream,
    )
    LAUNCHES["group_norm_silu"] += 1
    return (out, stats) if return_stats else out


# --- the split form: an image whose rows lie on several ranks ---------------


def group_norm_moments_plain(
    x: torch.Tensor, temb: torch.Tensor | None = None, *, num_groups: int = 32,
) -> torch.Tensor:
    """Each group's (mean, M2) of ``x + temb`` over x's pixels (M2 the sum of
    squared deviations from that mean): (B, G, 2) fp32, taken in fp64."""
    b, h, w, c = x.shape
    xf = x.double()
    if temb is not None:
        xf = xf + temb.double()[:, None, None, :]
    xg = xf.reshape(b, h * w, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    m2 = ((xg - mean) ** 2).sum(dim=(1, 3))
    return torch.stack([mean.reshape(b, num_groups), m2], -1).float()


def group_norm_moments(
    x: torch.Tensor, temb: torch.Tensor | None = None, *, num_groups: int = 32,
) -> torch.Tensor:
    """:func:`group_norm_moments_plain` by ``gmdx_group_norm_moments``: the
    pair's stats kernel over x's pixels, folded per group in fp64."""
    b, h, w, c = x.shape
    if not x.is_cuda:
        return group_norm_moments_plain(x, temb, num_groups=num_groups)
    if c % 8 or c % num_groups or c > MAX_CHANNELS or num_groups > MAX_GROUPS:
        raise ValueError(f"group_norm_moments kernel: unsupported C={c}, G={num_groups}")
    stream = check_kernel_operands("group_norm_moments", x, temb)
    from gmdx_torch.kernels import _build

    splits = _pair_plan(b, h * w, c).grid[0]
    partials = torch.empty((b, splits, num_groups, 2), dtype=torch.float32, device=x.device)
    moments = torch.empty((b, num_groups, 2), dtype=torch.float32, device=x.device)
    _build.call("gmdx_group_norm_moments", x.data_ptr(),
                temb.data_ptr() if temb is not None else None, partials.data_ptr(),
                moments.data_ptr(), b, h, w, c, num_groups, stream)
    LAUNCHES["group_norm_moments"] += 1
    return moments


def merge_moments(moments: torch.Tensor, count: int, eps: float) -> torch.Tensor:
    """The whole image's (B, 2, G) fp32 (mean, rstd) from every rank's
    (n, B, G, 2) (mean, M2) over ``count`` elements a group each (Chan's
    merge, in fp64, in rank order)."""
    m = moments.double()
    mean = m[..., 0].mean(0)
    m2 = m[..., 1].sum(0) + count * ((m[..., 0] - mean) ** 2).sum(0)
    rstd = torch.rsqrt(m2 / (count * m.shape[0]) + eps)
    return torch.stack([mean, rstd], 1).float()


def group_norm_apply_plain(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, temb: torch.Tensor | None,
    stats: torch.Tensor, *, activate: bool = True, pad_output: bool = False,
) -> torch.Tensor:
    """Plain version of the split form's apply: x normalised with the given
    (B, 2, G) (mean, rstd), affine, SiLU, in x's dtype, padded on request."""
    c = x.shape[-1]
    xf = x.float()
    if temb is not None:
        xf = xf + temb.float()[:, None, None, :]
    y = (xf - _expand(stats[:, 0].float(), c)) * _expand(stats[:, 1].float(), c)
    y = y * scale.float() + bias.float()
    if activate:
        y = F.silu(y)
    y = y.to(x.dtype)
    return F.pad(y, (0, 0, 1, 1, 1, 1)) if pad_output else y


def group_norm_apply(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, temb: torch.Tensor | None,
    stats: torch.Tensor, *, activate: bool = True, pad_output: bool = False,
) -> torch.Tensor:
    """:func:`group_norm_apply_plain` by ``gmdx_group_norm_apply`` (the
    pair's apply kernel reading the given statistics)."""
    if not x.is_cuda:
        return group_norm_apply_plain(x, scale, bias, temb, stats, activate=activate,
                                      pad_output=pad_output)
    b, h, w, c = x.shape
    groups = stats.shape[-1]
    if c % 8 or c % groups or c > MAX_CHANNELS or groups > MAX_GROUPS:
        raise ValueError(f"group_norm_apply kernel: unsupported C={c}, G={groups}")
    if stats.shape != (b, 2, groups):
        raise ValueError(f"stats must be ({b}, 2, {groups}), got {tuple(stats.shape)}")
    stream = check_kernel_operands("group_norm_apply", x, scale, bias, temb)
    check_fp32("group_norm_apply", stats)
    from gmdx_torch.kernels import _build

    pad = 1 if pad_output else 0
    out = torch.empty((b, h + 2 * pad, w + 2 * pad, c), dtype=x.dtype, device=x.device)
    _build.call("gmdx_group_norm_apply", x.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                temb.data_ptr() if temb is not None else None, stats.data_ptr(),
                out.data_ptr(), b, h, w, c, groups, int(activate), pad, stream)
    LAUNCHES["group_norm_apply"] += 1
    return out


def _expand(t: torch.Tensor, c: int) -> torch.Tensor:
    """(B, G) per-group values -> (B, 1, 1, C) per-channel."""
    return t.repeat_interleave(c // t.shape[1], dim=1)[:, None, None, :]


def _bwd_terms(x, scale, bias, temb, stats, g, activate, pad_output):
    """The backward's per-element terms in fp32: (xhat, dy through the SiLU
    derivative, rstd per channel); the padded cotangent's border dropped."""
    if pad_output:
        g = g[:, 1:-1, 1:-1, :]
    c = x.shape[-1]
    xf = x.float()
    if temb is not None:
        xf = xf + temb.float()[:, None, None, :]
    rstd = _expand(stats[:, 1].float(), c)
    xhat = (xf - _expand(stats[:, 0].float(), c)) * rstd
    dy = g.float()
    if activate:
        y = xhat * scale.float() + bias.float()
        sig = torch.sigmoid(y)
        dy = dy * sig * (1.0 + y * (1.0 - sig))
    return xhat, dy, rstd


def _group_sum(t: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, G): the sum over each group's pixels and channels."""
    b, h, w, c = t.shape
    return t.reshape(b, h * w, groups, c // groups).sum(dim=(1, 3))


def group_norm_silu_bwd_plain(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    temb: torch.Tensor | None,
    stats: torch.Tensor,
    g: torch.Tensor,
    *,
    activate: bool = True,
    pad_output: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Plain version of the backward in fp32: ``xhat`` from the saved
    (mean, rstd), dy through the SiLU derivative, then
    ``dx = rstd * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat))`` per
    group. Returns (dx in x's dtype, dscale, dbias, dtemb) with the last
    three fp32 (dtemb None without temb)."""
    sums, dscale, dbias = group_norm_bwd_sums_plain(
        x, scale, bias, temb, stats, g, activate=activate, pad_output=pad_output)
    dx, dtemb = group_norm_bwd_apply_plain(
        x, scale, bias, temb, stats, g, sums, x.shape[1] * x.shape[2], activate=activate,
        pad_output=pad_output)
    return dx, dscale, dbias, dtemb


# --- the split backward: an image whose rows lie on several ranks -----------


def group_norm_bwd_sums_plain(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, temb: torch.Tensor | None,
    stats: torch.Tensor, g: torch.Tensor, *, activate: bool = True, pad_output: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward's sums over x's pixels (a rank's rows of the image whose
    (B, 2, G) ``stats`` are given): (sums, dscale, dbias), sums (B, 2, G)
    fp32 holding each group's sum of ``dy * scale`` and of
    ``dy * scale * xhat``, and the parameters' gradients over these pixels,
    fp32."""
    xhat, dy, _ = _bwd_terms(x, scale, bias, temb, stats, g, activate, pad_output)
    groups = stats.shape[-1]
    dxhat = dy * scale.float()
    sums = torch.stack([_group_sum(dxhat, groups), _group_sum(dxhat * xhat, groups)], 1)
    return sums, (dy * xhat).sum(dim=(0, 1, 2)), dy.sum(dim=(0, 1, 2))


def group_norm_bwd_apply_plain(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, temb: torch.Tensor | None,
    stats: torch.Tensor, g: torch.Tensor, sums: torch.Tensor, count: int, *,
    activate: bool = True, pad_output: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """dx over x's pixels from the whole image's ``sums`` (every rank's
    :func:`group_norm_bwd_sums_plain`, summed) over its ``count`` pixels:
    ``dx = rstd * (dxhat - m1 - xhat * m2)``, m1 and m2 the sums over
    ``count * C / G``. Returns (dx in x's dtype, dtemb: dx summed over these
    pixels, fp32, or None without temb)."""
    xhat, dy, rstd = _bwd_terms(x, scale, bias, temb, stats, g, activate, pad_output)
    c = x.shape[-1]
    m = sums.float() / (count * (c // stats.shape[-1]))
    dx = rstd * (dy * scale.float() - _expand(m[:, 0], c) - xhat * _expand(m[:, 1], c))
    dtemb = dx.sum(dim=(1, 2)) if temb is not None else None
    return dx.to(x.dtype), dtemb


def _split_bwd_checks(name, x, g, stats, pad_output) -> tuple[int, int]:
    """(groups, pad) of a split-backward call on the card, its shapes checked."""
    b, h, w, c = x.shape
    groups = stats.shape[-1]
    pad = 1 if pad_output else 0
    if g.shape != (b, h + 2 * pad, w + 2 * pad, c) or stats.shape != (b, 2, groups):
        raise ValueError(f"{name}: g {tuple(g.shape)}, stats {tuple(stats.shape)} vs x "
                         f"{tuple(x.shape)}")
    if c % 8 or c > MAX_CHANNELS or groups > MAX_GROUPS or c % groups:
        raise ValueError(f"{name} kernel: unsupported C={c}, G={groups}")
    return groups, pad


def group_norm_bwd_sums(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, temb: torch.Tensor | None,
    stats: torch.Tensor, g: torch.Tensor, *, activate: bool = True, pad_output: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`group_norm_bwd_sums_plain` by ``gmdx_group_norm_bwd_sums``:
    the GN-backward kernel's phase before its grid barrier over x's pixels,
    over :func:`group_norm_bwd_plan`'s pixel ranges of each image (its grid
    (splits, B)), then its folds over the tiles."""
    if not x.is_cuda:
        return group_norm_bwd_sums_plain(x, scale, bias, temb, stats, g, activate=activate,
                                         pad_output=pad_output)
    groups, pad = _split_bwd_checks("group_norm_bwd_sums", x, g, stats, pad_output)
    stream = check_kernel_operands("group_norm_bwd_sums", x, g, scale, bias, temb)
    check_fp32("group_norm_bwd_sums", stats)
    from gmdx_torch.kernels import _build

    b, h, w, c = x.shape
    tiles = b * group_norm_bwd_plan(b, h, w, c).grid[0]
    f32 = {"dtype": torch.float32, "device": x.device}
    sums = torch.empty((b, 2, groups), **f32)
    dparams = torch.empty((2, c), **f32)  # dbias, dscale
    chpart, grpart = torch.empty((tiles, 2, c), **f32), torch.empty((tiles, 2, groups), **f32)
    _build.call("gmdx_group_norm_bwd_sums", x.data_ptr(), g.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), temb.data_ptr() if temb is not None else None,
                stats.data_ptr(), sums.data_ptr(), dparams.data_ptr(), chpart.data_ptr(),
                grpart.data_ptr(), b, h, w, c, groups, int(activate), pad, stream)
    LAUNCHES["group_norm_bwd_sums"] += 1
    return sums, dparams[1], dparams[0]


def group_norm_bwd_apply(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, temb: torch.Tensor | None,
    stats: torch.Tensor, g: torch.Tensor, sums: torch.Tensor, count: int, *,
    activate: bool = True, pad_output: bool = False,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """:func:`group_norm_bwd_apply_plain` by ``gmdx_group_norm_bwd_apply``:
    the GN-backward kernel's phase after its grid barrier over x's pixels,
    then dtemb's fold over the tiles."""
    if not x.is_cuda:
        return group_norm_bwd_apply_plain(x, scale, bias, temb, stats, g, sums, count,
                                          activate=activate, pad_output=pad_output)
    groups, pad = _split_bwd_checks("group_norm_bwd_apply", x, g, stats, pad_output)
    b, h, w, c = x.shape
    if sums.shape != (b, 2, groups) or count < h * w:
        raise ValueError(f"group_norm_bwd_apply: sums {tuple(sums.shape)}, count {count} vs x "
                         f"{tuple(x.shape)}")
    stream = check_kernel_operands("group_norm_bwd_apply", x, g, scale, bias, temb)
    check_fp32("group_norm_bwd_apply", stats, sums)
    from gmdx_torch.kernels import _build

    f32 = {"dtype": torch.float32, "device": x.device}
    dx = torch.empty_like(x)
    dtemb = tpart = None
    if temb is not None:
        dtemb = torch.empty((b, c), **f32)
        tpart = torch.empty((b * group_norm_bwd_plan(b, h, w, c).grid[0], c), **f32)
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    _build.call("gmdx_group_norm_bwd_apply", x.data_ptr(), g.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), ptr(temb), stats.data_ptr(), sums.data_ptr(), dx.data_ptr(),
                ptr(dtemb), ptr(tpart), b, h, w, c, groups, count, int(activate), pad, stream)
    LAUNCHES["group_norm_bwd_apply"] += 1
    return dx, dtemb


# Per device: the backward's grid barrier and per-image arrival counters
# (uint32, zeroed once; each launch leaves them zeroed, so that a call needs
# no memset launch). Calls on one stream share it.
_SYNC: dict[torch.device, torch.Tensor] = {}


def _sync_counters(device: torch.device, b: int) -> torch.Tensor:
    buf = _SYNC.get(device)
    if buf is None or buf.numel() < 1 + b:
        buf = _SYNC[device] = torch.zeros(1 + b, dtype=torch.int32, device=device)
    return buf


def group_norm_silu_bwd(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    temb: torch.Tensor | None,
    stats: torch.Tensor,
    g: torch.Tensor,
    *,
    activate: bool = True,
    pad_output: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """Backward of :func:`group_norm_silu` for the cotangent ``g`` of its
    output (padded when ``pad_output``; its border carries no gradient), from
    the forward's ``stats``. Returns (dx, dscale, dbias, dtemb) as
    :func:`group_norm_silu_bwd_plain` does; on the card all four come from
    the one launch."""
    if not x.is_cuda:
        return group_norm_silu_bwd_plain(
            x, scale, bias, temb, stats, g, activate=activate, pad_output=pad_output,
        )
    b, h, w, c = x.shape
    groups = stats.shape[-1]
    pad = 1 if pad_output else 0
    if g.shape != (b, h + 2 * pad, w + 2 * pad, c) or stats.shape != (b, 2, groups):
        raise ValueError(f"GN backward: g {tuple(g.shape)}, stats {tuple(stats.shape)} vs x {tuple(x.shape)}")
    if c % 8 or c > MAX_CHANNELS or groups > MAX_GROUPS or c % groups:
        raise ValueError(f"group_norm_silu_bwd kernel: unsupported C={c}, G={groups}")
    stream = check_kernel_operands("group_norm_silu_bwd", x, g, scale, bias, temb)
    check_fp32("group_norm_silu_bwd", stats)
    f32 = {"dtype": torch.float32, "device": x.device}
    if x.numel() == 0:
        return (torch.empty_like(x), torch.zeros(c, **f32), torch.zeros(c, **f32),
                torch.zeros((b, c), **f32) if temb is not None else None)
    from gmdx_torch.kernels import _build

    plan = group_norm_bwd_plan(b, h, w, c)
    tiles = b * plan.grid[0]
    dx = torch.empty_like(x)
    dparams = torch.empty((2, c), **f32)  # dbias, dscale
    dtemb = torch.empty((b, c), **f32) if temb is not None else None
    chpart = torch.empty((tiles, 2, c), **f32)
    grpart = torch.empty((tiles, 2, groups), **f32)
    tpart = torch.empty((tiles, c), **f32) if temb is not None else None
    ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
    _build.call(
        "gmdx_group_norm_silu_bwd", x.data_ptr(), g.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), ptr(temb), stats.data_ptr(), dx.data_ptr(), dparams.data_ptr(),
        ptr(dtemb), chpart.data_ptr(), grpart.data_ptr(), ptr(tpart),
        _sync_counters(x.device, b).data_ptr(), b, h, w, c, groups, *plan.grid,
        int(activate), pad, stream,
    )
    LAUNCHES["group_norm_silu_bwd"] += 1
    return dx, dparams[1], dparams[0], dtemb


class GroupNormSiLU(torch.autograd.Function):
    """Differentiated :func:`group_norm_silu`: the forward kernel saves its
    statistics, the backward kernel reads them. The cotangent from PyTorch
    is cast to x's dtype and made contiguous here (the conv's backward may
    hand over another layout); the fp32 parameter gradients are cast to the
    dtypes the parameters were used in."""

    @staticmethod
    def forward(ctx, x, scale, bias, temb, num_groups: int, eps: float, activate: bool,
                pad_output: bool):
        out, stats = group_norm_silu(
            x, scale, bias, temb, num_groups=num_groups, eps=eps, activate=activate,
            pad_output=pad_output, return_stats=True,
        )
        ctx.save_for_backward(x, scale, bias, temb, stats)
        ctx.activate, ctx.pad_output = activate, pad_output
        return out

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, temb, stats = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx, dscale, dbias, dtemb = group_norm_silu_bwd(
            x, scale, bias, temb, stats, g, activate=ctx.activate, pad_output=ctx.pad_output,
        )
        return (dx, dscale.to(scale.dtype), dbias.to(bias.dtype),
                dtemb.to(temb.dtype) if temb is not None else None, None, None, None, None)


__all__ = [
    "GroupNormPlan",
    "group_norm_plan",
    "GroupNormBwdPlan",
    "group_norm_bwd_plan",
    "group_norm_silu",
    "group_norm_silu_plain",
    "group_norm_moments",
    "group_norm_moments_plain",
    "merge_moments",
    "group_norm_apply",
    "group_norm_apply_plain",
    "group_norm_silu_bwd",
    "group_norm_silu_bwd_plain",
    "group_norm_bwd_sums",
    "group_norm_bwd_sums_plain",
    "group_norm_bwd_apply",
    "group_norm_bwd_apply_plain",
    "GroupNormSiLU",
]
