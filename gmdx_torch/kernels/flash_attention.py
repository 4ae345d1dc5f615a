"""Flash attention: forward with the base-2 logsumexp, backward, the
long-sequence inference forward and the short-K cross-attention.

Counterpart of ``gmdx/kernels/flash_attention.py:_flash_forward``,
``_flash_backward``, ``flash_attention_bsc`` (``_flash_forward_bsc``) and
``cross_attention_shortk`` (``_xattn_forward_bsc``), over the port's
head-packed (B, S, H*D) layout instead of the JAX package's (B*H, S, D).
Kernels: ``csrc/flash_attention.cu`` (the forward at head dims 40/80/160
on ``csrc/attention_sm90.cuh``'s Hopper forward; the backward: a dd
pre-pass, then the dK/dV and dQ kernels, on the same core; at the VAE's
512-wide head the forward and the dV, dK and dQ kernels of
``csrc/attention_wide_sm90.cuh``, the head dim split over a 2-CTA cluster)
and ``csrc/attention.cu`` (``gmdx_flash_bsc`` on the same Hopper forward,
and ``gmdx_xattn`` from ``csrc/attention_xattn.cuh``, built from the same
core's pieces). :func:`attention_fwd_plan`, :func:`flash_bwd_plan`,
:func:`xattn_plan`, :func:`wide_fwd_plan` and :func:`wide_bwd_plans` lay
out the Hopper kernels' launches as their ``*Plan`` structs do.

The plain versions take the queries in chunks of :data:`PLAIN_CHUNK` rows:
at 16384 tokens the whole fp32 score matrix of one call would take tens of
GB. Chunking changes no row's arithmetic.

``lse`` is (B, H, Sq) fp32: the base-2 logsumexp of the logits pre-scaled by
``scale * log2(e)``, exactly as the TPU kernel's ``_finish`` defines it. The
backward recomputes the softmax from (Q, K, lse) with
``dd = rowsum(dO * O)``, and applies ``dK *= 1 / log2(e)``, ``dQ *= scale``.
Every kernel, the 512-wide ones included, keeps Q as loaded and folds the
scale into exp2 (``P = exp2(S c - lse)``), forward and backward alike, so
that the recomputed P's rows sum to one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from gmdx_torch.kernels import LAUNCHES, check_fp32, check_kernel_operands, needs_grad

_LOG2_E = 1.0 / math.log(2.0)
# SD-1.5's head dims: the instances of csrc/attention_sm90.cuh's forward and
# backward kernels.
_KERNEL_HEAD_DIMS = (40, 80, 160)
# The flash forward and backward also have the VAE's single 512-wide head.
_FWD_HEAD_DIMS = _KERNEL_HEAD_DIMS + (512,)
PLAIN_CHUNK = 1024
# The short-K kernel holds every key of a head in shared memory.
XATTN_MAX_KEYS = 128

# csrc/attention_sm90.cuh's constants: the dynamic shared memory a block may
# use, the bf16 columns of one 128-byte swizzled TMA box and the deepest ring.
SMEM_BUDGET = 232448
BOX_COLS = 64
MAX_STAGES = 4
# The H100's SMs: the persistent forward runs one block on each at most.
SMS = 132


@dataclass(frozen=True)
class AttentionPlan:
    """The launch of one Hopper attention kernel (``csrc/attention_sm90.cuh``),
    field for field what ``gmdx_attention_sm90_plan`` reports of its plan.

    A block owns ``owned`` rows (queries, or keys for the dK/dV kernel), 64
    for each consumer warpgroup, beside one producer warpgroup, and streams
    tiles of ``tile`` rows through a ring of ``stages``, in ``smem_bytes`` of
    dynamic shared memory, over ``grid``. Every operand is read through a
    4-D TMA map (D, H, S, B) in boxes of (64, 1, rows, 1); ``boxes`` are the
    rows of the Q (and dO) boxes and of the K (and V) boxes. Columns past D
    and rows past S arrive as zeros."""

    owned: int
    tile: int
    stages: int
    smem_bytes: int
    grid: tuple[int, int, int]
    boxes: tuple[int, int]


def _chunks(d: int) -> int:
    return -(-d // BOX_COLS)


def _stages(fixed: int, stage: int) -> int:
    return min(MAX_STAGES, (SMEM_BUDGET - 1024 - fixed - 256) // stage)


def attention_fwd_plan(b: int, sq: int, sk: int, heads: int, d: int) -> AttentionPlan:
    """The forward's plan (``FwdPlan``) for ``attention_kv_resident``,
    ``flash_attention_fwd`` and ``flash_attention_bsc`` at head dims
    40/80/160: 64 queries for each consumer warpgroup, three at d = 40 (the
    loop is bound by each warpgroup's latency chain, so a third gained 22 %)
    and two above, whose accumulators need more registers; key tiles of 128
    rows (64 at d = 160, where a 128-key stage would leave room for one); as
    many stages as fit, then the epilogue's staging tiles (64 x (d + 8) bf16
    a consumer) where they fit too (d = 40); a persistent grid of one block
    an SM at most over the (query tile, head, batch) tiles."""
    nch, bq = _chunks(d), 192 if d == 40 else 128
    bkv = 64 if d > 80 else 128
    q_bytes, stage = nch * bq * 128, 2 * nch * bkv * 128
    stages = _stages(q_bytes, stage)
    smem = 1024 + q_bytes + stages * stage + 256
    staging = bq * (d + 8) * 2
    if smem + staging <= SMEM_BUDGET:
        smem += staging
    tiles = -(-sq // bq) * heads * b
    return AttentionPlan(
        owned=bq, tile=bkv, stages=stages, smem_bytes=smem,
        grid=(min(tiles, SMS), 1, 1), boxes=(bq, bkv),
    )


def flash_bwd_plan(
    b: int, sq: int, sk: int, heads: int, d: int
) -> tuple[AttentionPlan, AttentionPlan]:
    """The backward's plans (``DkvPlan``, ``DqPlan``): dK/dV owns 128 keys
    and streams (Q, dO) tiles of 64 queries (32 at d = 160, where dK and dV
    alone hold 160 fp32 a thread) with their lse and dd rows; dQ owns 128
    queries and streams (K, V) tiles of 128 keys (64 at d = 160)."""
    nch = _chunks(d)
    nq = 32 if d > 80 else 64
    kv_bytes, rows_bytes, stage = 2 * nch * 128 * 128, MAX_STAGES * nq * 8, 2 * nch * nq * 128
    stages = _stages(kv_bytes + rows_bytes, stage)
    dkv = AttentionPlan(
        owned=128, tile=nq, stages=stages,
        smem_bytes=1024 + kv_bytes + stages * stage + rows_bytes + 256,
        grid=(-(-sk // 128), heads, b), boxes=(nq, 128),
    )
    nk = 64 if d > 80 else 128
    qd_bytes, stage = 2 * nch * 128 * 128, 2 * nch * nk * 128
    stages = _stages(qd_bytes, stage)
    dq = AttentionPlan(
        owned=128, tile=nk, stages=stages, smem_bytes=1024 + qd_bytes + stages * stage + 256,
        grid=(-(-sq // 128), heads, b), boxes=(128, nk),
    )
    return dkv, dq


# csrc/attention_wide_sm90.cuh's constants: the CTAs of a cluster (each holds
# 256 of the head's 512 columns), the rows a cluster owns (64 for each of a
# CTA's two consumer warpgroups), the fp32 partial-product values a consumer
# thread exchanges with its peer.
WIDE_D = 512
WIDE_CLUSTER = 2
WIDE_OWNED = 128
WIDE_XFLOATS = 32
# The kinds of gmdx_wide_plan, in its order.
WIDE_KINDS = ("fwd", "dv", "dk", "dq")


@dataclass(frozen=True)
class WidePlan:
    """The launch of one of ``csrc/attention_wide_sm90.cuh``'s kernels,
    field for field what ``gmdx_wide_plan`` reports of its ``WidePlan``.

    A ``cluster`` of CTAs splits the 512-wide head into 256-column halves;
    both CTAs hold the same ``owned`` rows (queries, or keys for dV and dK)
    and stream the other side's half tiles of ``tile`` rows through a ring
    of ``stages``, in ``smem_bytes`` of dynamic shared memory each, over
    ``grid`` (x = cluster size times the clusters of one (head, batch))."""

    cluster: int
    owned: int
    tile: int
    stages: int
    smem_bytes: int
    grid: tuple[int, int, int]

    def c_fields(self) -> list[int]:
        return [self.cluster, self.owned, self.tile, self.stages, self.smem_bytes, *self.grid]


def _wide_plan(kind: str, b: int, sq: int, sk: int, heads: int) -> WidePlan:
    """One kind's plan: the resident half tiles (Q for the forward and dQ,
    K for dV and dK; dQ also dO, dK also V) of the owned rows, ring stages
    of two streamed half tiles with their queries' lse (dV, dK) and dd (dK)
    rows, the two consumers' exchange buffers (16 KB each), 1024 bytes of
    alignment slack and 256 of mbarriers. Tiles of 64 rows, 32 for dK and
    dQ, which hold two resident operands and exchange two partials."""
    two = kind in ("dk", "dq")
    tile = 32 if two else 64
    nch = WIDE_D // WIDE_CLUSTER // BOX_COLS
    res_bytes = (2 if two else 1) * nch * WIDE_OWNED * 128
    stage_bytes = 2 * nch * tile * 128
    row_bytes = {"dv": 1, "dk": 2}.get(kind, 0) * tile * 4
    xbuf = 2 * 128 * WIDE_XFLOATS * 4
    stages = min(MAX_STAGES,
                 (SMEM_BUDGET - 1024 - res_bytes - xbuf - 256) // (stage_bytes + row_bytes))
    rows = sk if kind in ("dv", "dk") else sq
    return WidePlan(
        cluster=WIDE_CLUSTER, owned=WIDE_OWNED, tile=tile, stages=stages,
        smem_bytes=1024 + res_bytes + stages * (stage_bytes + row_bytes) + xbuf + 256,
        grid=(WIDE_CLUSTER * -(-rows // WIDE_OWNED), heads, b),
    )


def wide_fwd_plan(b: int, sq: int, sk: int, heads: int) -> WidePlan:
    """The 512-wide forward's plan: a cluster owns 128 queries, Q resident,
    (K, V) half tiles of 64 keys streamed."""
    return _wide_plan("fwd", b, sq, sk, heads)


def wide_bwd_plans(
    b: int, sq: int, sk: int, heads: int
) -> tuple[WidePlan, WidePlan, WidePlan]:
    """The 512-wide backward's plans, in launch order: dV (128 keys, K
    resident, (Q, dO) tiles of 64 queries), dK (128 keys, K and V resident,
    tiles of 32 queries) and dQ (128 queries, Q and dO resident, (K, V)
    tiles of 32 keys)."""
    return tuple(_wide_plan(kind, b, sq, sk, heads) for kind in WIDE_KINDS[1:])


@dataclass(frozen=True)
class XattnPlan:
    """The short-K kernel's launch (``XattnPlan`` in
    ``csrc/attention_xattn.cuh``), field for field what ``gmdx_xattn_plan``
    reports: ``grid`` = B * H * ``splits`` blocks, each one (batch, head)'s
    K and V resident in ``key_tile`` rows (TMA's zeros past Sk) and one of
    its ``splits`` contiguous runs of at most ``tiles_per_block`` 64-query
    tiles; S over ``ksteps`` k16 steps of D; a ring of ``stages`` Q tiles
    feeding ``consumers`` warpgroups; ``smem_bytes`` of dynamic shared
    memory."""

    grid: int
    key_tile: int
    ksteps: int
    stages: int
    smem_bytes: int
    splits: int
    consumers: int
    tiles_per_block: int

    def c_fields(self) -> list[int]:
        return [self.grid, self.key_tile, self.ksteps, self.stages, self.smem_bytes,
                self.splits, self.consumers, self.tiles_per_block]


def xattn_key_tile(sk: int) -> int:
    """The S product's N: the key count rounded up to an instance (32, 80 or
    128; 80 for the 77 CLIP tokens)."""
    return 32 if sk <= 32 else 80 if sk <= 80 else 128


def xattn_plan(b: int, sq: int, sk: int, heads: int, d: int) -> XattnPlan:
    """The plan of :func:`cross_attention_shortk` at head dims 40/80/160:
    three consumer warpgroups at d = 40 and two above (as the long-key
    forward); one head's K and V and two 64-row Q stages a consumer (one
    where two do not fit), so that each stage serves one consumer, beside
    the staging tiles (64 x (d + 8) bf16 a consumer), 1024 bytes of
    alignment slack and 256 of mbarriers; each
    head's query tiles split into ``SMS // (b * heads)`` runs (at least one,
    at most the tiles), a block each."""
    nch, kt = _chunks(d), xattn_key_tile(sk)
    nc = 3 if d == 40 else 2
    q_stage = nch * 64 * 128
    fixed = 1024 + 2 * nch * kt * 128 + nc * 64 * (d + 8) * 2 + 256
    stages = nc * min(2, (SMEM_BUDGET - fixed) // q_stage // nc)
    q_tiles = -(-sq // 64)
    splits = max(1, min(SMS // (b * heads), q_tiles))
    return XattnPlan(grid=b * heads * splits, key_tile=kt, ksteps=-(-d // 16), stages=stages,
                     smem_bytes=fixed + stages * q_stage, splits=splits, consumers=nc,
                     tiles_per_block=-(-q_tiles // splits))


def _split(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, c = x.shape
    return x.float().reshape(b, s, heads, c // heads)


def flash_attention_fwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, scale: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version in fp32: (out in q's dtype, lse (B, H, Sq) fp32)."""
    kf, vf = _split(k, heads), _split(v, heads)
    outs, lses = [], []
    for qc in (_split(q, heads) * (scale * _LOG2_E)).split(PLAIN_CHUNK, dim=1):
        s2 = torch.einsum("bqhd,bkhd->bhqk", qc, kf)
        m = s2.amax(dim=-1, keepdim=True)
        lse = m + torch.log2(torch.exp2(s2 - m).sum(dim=-1, keepdim=True))
        outs.append(torch.einsum("bhqk,bkhd->bqhd", torch.exp2(s2 - lse), vf))
        lses.append(lse[..., 0])
    return torch.cat(outs, dim=1).reshape(q.shape).to(q.dtype), torch.cat(lses, dim=-1)


def flash_attention_bsc_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, *,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain version of :func:`flash_attention_bsc` in fp32 (the forward
    without its logsumexp), result in q's dtype."""
    if scale is None:
        scale = (q.shape[-1] // heads) ** -0.5
    return flash_attention_fwd_plain(q, k, v, heads, scale)[0]


def flash_attention_bwd_dd_plain(
    out: torch.Tensor, dout: torch.Tensor, heads: int
) -> torch.Tensor:
    """dd (B, H, Sq) fp32 = rowsum(dout * out) over each head's columns."""
    return (_split(dout, heads) * _split(out, heads)).sum(dim=-1).transpose(1, 2).contiguous()


def flash_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, heads: int, scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the two backward kernels in fp32: the same formula,
    P = exp2(Qs K^T - lse) recomputed from the saved lse, over whole rows
    instead of tiles. Returns (dq, dk, dv) in the operands' dtypes."""
    qs = _split(q, heads) * (scale * _LOG2_E)
    kf, vf, g = _split(k, heads), _split(v, heads), _split(dout, heads)
    dd = flash_attention_bwd_dd_plain(out, dout, heads)
    p = torch.exp2(torch.einsum("bqhd,bkhd->bhqk", qs, kf) - lse.float()[..., None])
    dv = torch.einsum("bhqk,bqhd->bkhd", p, g)
    dp = torch.einsum("bqhd,bkhd->bhqk", g, vf)
    ds = p * (dp - dd[..., None])
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qs) * (1.0 / _LOG2_E)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    return (dq.reshape(q.shape).to(q.dtype), dk.reshape(k.shape).to(k.dtype),
            dv.reshape(v.shape).to(v.dtype))


def _check_shapes(q, k, v, heads, head_dims=_KERNEL_HEAD_DIMS) -> int:
    if q.ndim != 3 or k.shape != v.shape or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"bad attention shapes {q.shape} {k.shape} {v.shape}")
    if q.shape[-1] % heads:
        raise ValueError(f"width {q.shape[-1]} does not split into {heads} heads")
    d = q.shape[-1] // heads
    if q.is_cuda and d not in head_dims:
        raise ValueError(f"flash attention kernel has no instance for head dim {d}")
    return d


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, *,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact-softmax attention over head-packed (B, S, H*D) q/k/v, and the
    base-2 logsumexp (B, H, Sq) the backward needs. Head dim 512 takes the
    wide kernel (``csrc/attention_wide_sm90.cuh``), counted as
    ``flash_attention_fwd_d512``."""
    d = _check_shapes(q, k, v, heads, _FWD_HEAD_DIMS)
    if scale is None:
        scale = d**-0.5
    if not q.is_cuda:
        return flash_attention_fwd_plain(q, k, v, heads, scale)
    stream = check_kernel_operands("flash_attention_fwd", q, k, v)
    from gmdx_torch.kernels import _build

    b, sq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, heads, sq), dtype=torch.float32, device=q.device)
    _build.call(
        "gmdx_flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, sq, k.shape[1], heads, d, float(scale * _LOG2_E), stream,
    )
    LAUNCHES["flash_attention_fwd_d512" if d == 512 else "flash_attention_fwd"] += 1
    return out, lse


def flash_attention_bsc(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, *,
    scale: float | None = None,
) -> torch.Tensor:
    """Exact-softmax attention over head-packed (B, S, H*D) q/k/v for any
    key count, without the logsumexp: the inference route past 4096 keys."""
    d = _check_shapes(q, k, v, heads)
    if scale is None:
        scale = d**-0.5
    if not q.is_cuda:
        return flash_attention_bsc_plain(q, k, v, heads, scale=scale)
    stream = check_kernel_operands("flash_attention_bsc", q, k, v)
    from gmdx_torch.kernels import _build

    b, sq, _ = q.shape
    out = torch.empty_like(q)
    _build.call(
        "gmdx_flash_bsc", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, sq, k.shape[1], heads, d, float(scale * _LOG2_E), stream,
    )
    LAUNCHES["flash_attention_bsc"] += 1
    return out


def flash_attention_bwd_dd(out: torch.Tensor, dout: torch.Tensor, heads: int) -> torch.Tensor:
    """The backward's pre-pass, dd = rowsum(dout * out), (B, H, Sq) fp32:
    one kernel on the card (``gmdx_flash_bwd_dd``), counted with the
    backward that launches it."""
    if not out.is_cuda:
        return flash_attention_bwd_dd_plain(out, dout, heads)
    stream = check_kernel_operands("flash_attention_bwd_dd", out, dout)
    b, sq, c = out.shape
    if dout.shape != out.shape or c % heads or (c // heads) % 8:
        raise ValueError(f"dd pre-pass: out {out.shape}, dout {dout.shape}, {heads} heads")
    from gmdx_torch.kernels import _build

    dd = torch.empty((b, heads, sq), dtype=torch.float32, device=out.device)
    _build.call("gmdx_flash_bwd_dd", out.data_ptr(), dout.data_ptr(), dd.data_ptr(),
                b, sq, heads, c // heads, stream)
    return dd


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, dout: torch.Tensor, heads: int, *, scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`flash_attention_fwd` for the cotangent
    ``dout`` of ``out``. On the card: a pre-pass kernel computes
    dd = rowsum(dout * out), then the dK/dV and the dQ kernels run. Head dim
    512 takes the wide dV, dK and dQ kernels
    (``csrc/attention_wide_sm90.cuh``), counted as
    ``flash_attention_bwd_d512``."""
    d = _check_shapes(q, k, v, heads, _FWD_HEAD_DIMS)
    if scale is None:
        scale = d**-0.5
    if not q.is_cuda:
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, heads, scale)
    stream = check_kernel_operands("flash_attention_bwd", q, k, v, out, dout)
    b, sq, _ = q.shape
    if out.shape != q.shape or dout.shape != q.shape or lse.shape != (b, heads, sq):
        raise ValueError(f"flash backward: out {out.shape}, dout {dout.shape}, lse {lse.shape}")
    check_fp32("flash_attention_bwd", lse)
    from gmdx_torch.kernels import _build

    dd = flash_attention_bwd_dd(out, dout, heads)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _build.call(
        "gmdx_flash_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), dd.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        b, sq, k.shape[1], heads, d, float(scale), float(scale * _LOG2_E), stream,
    )
    LAUNCHES["flash_attention_bwd_d512" if d == 512 else "flash_attention_bwd"] += 1
    return dq, dk, dv


def cross_attention_shortk_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, *,
    scale: float | None = None,
) -> torch.Tensor:
    """Plain version of :func:`cross_attention_shortk` in fp32, with the
    kernel's two roundings to q's dtype (``_xattn_kernel``): Q after its
    scale by ``scale * log2(e)``, and the softmax numerator before the PV
    product, whose sum is taken unrounded. No-ops for fp32 operands."""
    if scale is None:
        scale = (q.shape[-1] // heads) ** -0.5
    dt = q.dtype
    qs = (_split(q, heads) * (scale * _LOG2_E)).to(dt).float()
    s2 = torch.einsum("bqhd,bkhd->bhqk", qs, _split(k, heads))
    p = torch.exp2(s2 - s2.amax(dim=-1, keepdim=True))
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(dt).float(), _split(v, heads))
    out = acc / p.sum(dim=-1).transpose(1, 2)[..., None]
    return out.reshape(q.shape).to(dt)


def cross_attention_shortk(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int, *,
    scale: float | None = None,
) -> torch.Tensor:
    """Exact-softmax attention over head-packed (B, S, H*D) q/k/v with at
    most :data:`XATTN_MAX_KEYS` keys (the 77 CLIP tokens): every key of a
    head is resident at once, so nothing is online. The kernel scales the
    fp32 scores by ``scale * log2(e)`` where the plain version rounds the
    pre-scaled Q to bf16 (the TPU kernel's rounding). Under autograd it is
    :class:`gmdx_torch.kernels.attention.FlashAttention` (the flash forward
    and backward, any key count: at 77 keys one partial key tile, the keys
    past it masked, their dK and dV rows not written), as ``_xattn_bsc``'s
    VJP takes them (``flash_attention.py:996-1022``)."""
    d = _check_shapes(q, k, v, heads)
    if not 1 <= k.shape[1] <= XATTN_MAX_KEYS:
        raise ValueError(f"short-K attention takes 1 to {XATTN_MAX_KEYS} keys, got {k.shape[1]}")
    if scale is None:
        scale = d**-0.5
    if needs_grad(q, k, v):
        from gmdx_torch.kernels.attention import FlashAttention  # it imports this module

        return FlashAttention.apply(q, k, v, heads, scale)
    if not q.is_cuda:
        return cross_attention_shortk_plain(q, k, v, heads, scale=scale)
    stream = check_kernel_operands("cross_attention_shortk", q, k, v)
    from gmdx_torch.kernels import _build

    b, sq, _ = q.shape
    out = torch.empty_like(q)
    _build.call(
        "gmdx_xattn", q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, sq, k.shape[1], heads, d, float(scale * _LOG2_E), stream,
    )
    LAUNCHES["cross_attention_shortk"] += 1
    return out


__all__ = [
    "AttentionPlan",
    "PLAIN_CHUNK",
    "XATTN_MAX_KEYS",
    "XattnPlan",
    "cross_attention_shortk",
    "cross_attention_shortk_plain",
    "flash_attention_bsc",
    "flash_attention_bsc_plain",
    "flash_attention_fwd",
    "flash_attention_fwd_plain",
    "flash_attention_bwd",
    "flash_attention_bwd_dd",
    "flash_attention_bwd_dd_plain",
    "flash_attention_bwd_plain",
    "attention_fwd_plan",
    "flash_bwd_plan",
    "WidePlan",
    "wide_bwd_plans",
    "wide_fwd_plan",
    "xattn_key_tile",
    "xattn_plan",
]
