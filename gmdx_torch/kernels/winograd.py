"""3x3 stride-1 SAME convolution + bias over NHWC: the implicit-GEMM kernel
and Winograd F(4x4, 3x3).

Counterpart of ``gmdx/kernels/winograd.py:winograd_conv3x3``.
* :func:`conv3x3` (``csrc/conv3x3.cu``) stands in for the JAX package's
  default F(2x2) kernel. It is an implicit GEMM, not a Winograd transform;
  the source says why. Its weight operand is the (O, 9*C) repacking of the
  OIHW conv weight made by :func:`pack_weight`, once per weight. Every
  launch follows :func:`conv3x3_plan`: which producer feeds the GEMM core
  its A tiles (a TMA box of whole pixel rows, or a cp.async gather), the
  box, the tile width and the K split.
* :func:`winograd4_conv3x3` (``csrc/winograd4.cu``) is the F(4x4, 3x3)
  kernel the JAX package runs under ``GMDX_WINOGRAD_M=4`` (``_wino4_forward``),
  with its Cook-Toom matrices over the points {0, 1, -1, 2, -1/2}. Its
  weight operand is the transformed weight U (36, O, C) made by
  :func:`pack_weight4`, once per weight. Its three launches (input
  transform; the 36 products on the GEMM core with the xi half of the
  output transform folded in; output transform) are laid out as
  :func:`winograd4_plan` says; the C side computes the same plan and
  reports it (``gmdx_wino4_plan``).
:func:`conv_route` says which of the two a conv takes.

Under autograd the conv is :func:`conv3x3_direct`, ``F.conv2d`` in both
directions, as the JAX package's ``_wino_fwd`` takes the direct XLA conv for
training by default (``winograd.py:1028-1048``, ``GMDX_WINOGRAD_TRAIN=0``):
a computation the JAX package leaves outside Pallas. With the layers'
``winograd_train`` option (``GMDX_WINOGRAD_TRAIN=1``) the training forward is
the kernel :func:`conv_route` gives, through :class:`ConvKernelTrain`, whose
backward is the direct conv's gradients (``_wino_bwd``, ``:1051-1059``).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from gmdx_torch.kernels import LAUNCHES, check_kernel_operands, needs_grad

# The H100 SXM's SMs, which a launch's work units should fill.
SMS = 132
# csrc/gemm_sm90.cuh: the output tile's rows (pixels), the K slice, and the
# tile widths it has a wgmma instance for.
CONV_BLOCK_M = 128
CONV_BLOCK_K = 64
CONV_BLOCK_NS = (128, 160)
CONV_MAX_SPLIT = 8
# H100 SXM peaks (data sheet): the plan's time estimates.
BF16_FLOPS = 989e12
HBM_BYTES_S = 3.35e12

# B^T, G, A^T of F(4x4, 3x3) (``gmdx/kernels/winograd.py:_BT4/_G4/_AT4``).
BT4 = (
    (1.0, 1.5, -2.0, -1.5, 1.0, 0.0),
    (0.0, -1.0, -2.5, -0.5, 1.0, 0.0),
    (0.0, 1.0, 0.5, -2.5, 1.0, 0.0),
    (0.0, -0.5, -1.0, 0.5, 1.0, 0.0),
    (0.0, 2.0, -1.0, -2.0, 1.0, 0.0),
    (0.0, 1.0, 1.5, -2.0, -1.5, 1.0),
)
G4 = (
    (1.0, 0.0, 0.0),
    (-1 / 3, -1 / 3, -1 / 3),
    (1 / 3, -1 / 3, 1 / 3),
    (1 / 15, 2 / 15, 4 / 15),
    (-16 / 15, 8 / 15, -4 / 15),
    (0.0, 0.0, 1.0),
)
AT4 = (
    (1.0, 1.0, 1.0, 1.0, 1.0, 0.0),
    (0.0, 1.0, -1.0, 2.0, -0.5, 0.0),
    (0.0, 1.0, 1.0, 4.0, 0.25, 0.0),
    (0.0, 1.0, -1.0, 8.0, -0.125, 1.0),
)


# The JAX package's F(4x4) tiling budget (``winograd.py:126``, ``:157``):
# a working-set estimate times Mosaic's measured overshoot must stay under
# 100 MB of VMEM.
_VMEM_CAP = 100 * 1024 * 1024
_MOSAIC_FUDGE = 1.7


def _vmem_estimate4(h: int, w: int, c: int, o: int, itemsize: int, split: int,
                    g_itemsize: int) -> int:
    """``gmdx/kernels/winograd.py:_vmem_estimate4``: the bytes one grid step
    of the TPU's F(4x4) kernel holds, for 1/``split`` of the tile rows and
    ``o`` output channels."""
    t = (h // 4) * (w // 4) // split
    trs = h // 4 // split
    hp = h + 4
    return (hp * hp * c * itemsize + 5 * (trs + 1) * hp * c * itemsize
            + 36 * t * c * itemsize + 8 * t * c * 4 + 24 * t * o * 4 + 2 * t * o * 4
            + 36 * c * o * itemsize + 9 * c * o * g_itemsize + 16 * t * o * itemsize)


def _pick_tiling4(h: int, w: int, c: int, o: int, itemsize: int,
                  g_itemsize: int) -> tuple[int, int]:
    """``gmdx/kernels/winograd.py:_pick_tiling4``: (tile-row split, output
    chunks) of the first tiling whose estimate fits the budget, or (0, 0)."""
    t_rows = h // 4
    for ochunks in (1, 2, 4, 5, 8, 10):
        if o % ochunks or (ochunks > 1 and (o // ochunks) % 128):
            continue
        for split in (1, 2, 4, 8):
            if t_rows % split:
                continue
            if t_rows // split < 4:
                break
            est = _vmem_estimate4(h, w, c, o // ochunks, itemsize, split, g_itemsize)
            if est * _MOSAIC_FUDGE <= _VMEM_CAP:
                return split, ochunks
    return 0, 0


def _wino4_shape_ok(h: int, w: int, c: int, o: int) -> bool:
    """The shapes the F(4x4) kernel takes: square, H % 4 == 0, H >= 16, C
    and O multiples of 8."""
    return h == w and h % 4 == 0 and h >= 16 and c % 8 == 0 and o % 8 == 0


def conv_route(h: int, w: int, c: int, o: int, winograd_m: int = 2, itemsize: int = 2) -> str:
    """``"wino4"`` exactly where the JAX package takes F(4x4) under
    ``GMDX_WINOGRAD_M=4``: ``winograd_conv3x3``'s shape gate, then
    ``_select_tiling`` (``winograd.py:1078-1082``) with its tiling budget
    (``_pick_tiling4``); else ``"conv3x3"``, the port's counterpart of both
    F(2x2) and the direct conv. ``itemsize`` is the activations' (2 for
    bf16): the JAX package decides m from ``tiling_x``, where the image and
    the weights both count at the activations' itemsize (``:1204-1215``;
    the weights' own dtype only decides a cast)."""
    if winograd_m == 4 and _wino4_shape_ok(h, w, c, o) \
            and _pick_tiling4(h, w, c, o, itemsize, itemsize)[0]:
        return "wino4"
    return "conv3x3"


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """How ``csrc/conv3x3.cu`` runs one conv: the A producer (``"tma"``: one
    box (block_k, bw, bh, bb) of whole pixel rows a slice; ``"gather"``:
    cp.async, 16 bytes at a time), the tile width ``bn``, and K cut into
    ``split`` runs of ``slices_per_split`` slices of ``block_k``."""

    b: int
    h: int
    w: int
    c: int
    o: int
    halo: int
    route: str
    box: tuple[int, int, int] | None
    bn: int
    split: int
    slices: int
    slices_per_split: int
    m_tiles: int
    n_tiles: int
    block_m: int
    block_k: int

    @property
    def units(self) -> int:
        """Work units (row tile, column tile, split): the blocks' work."""
        return self.m_tiles * self.n_tiles * self.split

    def box_origin(self, mt: int, s: int) -> tuple[int, int, int, int]:
        """The TMA box origin (c0, x, y, b) of row tile ``mt`` and K slice
        ``s``: the arithmetic of ``ConvOp::load``. Slice s is channels
        [c0, c0 + block_k) of tap s // (C / block_k)."""
        m0 = mt * self.block_m
        b0, r = divmod(m0, self.h * self.w)
        y0, x0 = divmod(r, self.w)
        tap, cs = divmod(s, self.c // self.block_k)
        ky, kx = divmod(tap, 3)
        return cs * self.block_k, x0 + kx - self.halo, y0 + ky - self.halo, b0


def conv3x3_box(h: int, w: int, block_m: int = CONV_BLOCK_M) -> tuple[int, int, int] | None:
    """(bw, bh, bb): a box of ``block_m`` output pixels in M order that is
    whole image rows, or None. 128 | W: part of one row; W | 128: whole rows
    of one image, or whole images."""
    if w >= block_m:
        return (block_m, 1, 1) if w % block_m == 0 else None
    if block_m % w:
        return None
    rows = block_m // w
    if h % rows == 0:
        return (w, rows, 1)
    if rows % h == 0:
        return (w, h, rows // h)
    return None


def conv3x3_plan(
    b: int, h: int, w: int, c: int, o: int, pre_padded: bool = False, *,
    block_m: int = CONV_BLOCK_M, block_k: int = CONV_BLOCK_K, sms: int = SMS,
) -> ConvPlan:
    """The launch plan of a (B, H, W, C) -> O conv. The TMA route takes
    C % block_k == 0 and a :func:`conv3x3_box`; other shapes gather.

    K is split only where the unsplit tiles would leave SMs idle. Among the
    tile widths and splits, a plan whose units fill every SM comes first,
    then the least estimated time: the busiest SM's tile products at the
    bf16 peak plus the split's fp32 partials written and read back at the
    memory rate; then fewer splits, then the wider tile. K splits at slice
    boundaries; with C % block_k == 0 a slice never straddles a tap."""
    box = conv3x3_box(h, w, block_m) if c % block_k == 0 else None
    m = b * h * w
    m_tiles = -(-m // block_m)
    slices = -(-9 * c // block_k)
    best = None
    for bn in CONV_BLOCK_NS:
        n_tiles = -(-o // bn)
        splits = range(1, min(CONV_MAX_SPLIT, slices) + 1) if m_tiles * n_tiles < sms else (1,)
        for split in splits:
            per = -(-slices // split)
            if -(-slices // per) != split:  # a split would be empty
                continue
            units = m_tiles * n_tiles * split
            t_tiles = math.ceil(units / sms) * per * 2.0 * block_m * block_k * bn / (BF16_FLOPS / sms)
            t_partials = (2.0 * split * m * o * 4 / HBM_BYTES_S) if split > 1 else 0.0
            key = (units < sms, t_tiles + t_partials, split, -bn)
            if best is None or key < best[0]:
                best = (key, bn, n_tiles, split, per)
    _, bn, n_tiles, split, per = best
    return ConvPlan(
        b=b, h=h, w=w, c=c, o=o, halo=0 if pre_padded else 1,
        route="tma" if box is not None else "gather", box=box, bn=bn, split=split,
        slices=slices, slices_per_split=per, m_tiles=m_tiles, n_tiles=n_tiles,
        block_m=block_m, block_k=block_k,
    )


def pack_weight(weight: torch.Tensor) -> torch.Tensor:
    """OIHW (O, C, 3, 3) -> (O, 9*C) with k = (ky*3 + kx)*C + c."""
    o, c = weight.shape[:2]
    return weight.permute(0, 2, 3, 1).reshape(o, 9 * c).contiguous()


def conv3x3_plain(
    x: torch.Tensor, wpacked: torch.Tensor, bias: torch.Tensor, *,
    pre_padded: bool = False,
) -> torch.Tensor:
    """Plain version, the kernel's arithmetic in fp32: gather the nine taps
    into (pixels, 9*C) and multiply by the packed weight."""
    xp = x if pre_padded else F.pad(x, (0, 0, 1, 1, 1, 1))
    b, hp, wp, c = xp.shape
    h, w = hp - 2, wp - 2
    xf = xp.float()
    cols = torch.cat(
        [xf[:, ky:ky + h, kx:kx + w, :] for ky in range(3) for kx in range(3)], dim=-1
    )
    out = cols.reshape(b * h * w, 9 * c) @ wpacked.float().t() + bias.float()
    return out.reshape(b, h, w, -1).to(x.dtype)


def _train_route(name, x, operand, bias, weight, wino4: bool, pre_padded: bool):
    """Under autograd, :class:`ConvKernelTrain` on the OIHW ``weight`` the
    ``operand`` was made from; None where nothing is differentiated."""
    if not needs_grad(x, operand, bias, weight):
        return None
    if weight is None or operand.requires_grad:
        raise ValueError(f"{name} under autograd differentiates the OIHW conv weight: pass "
                         "weight=, the tensor its operand was made from without grad")
    return ConvKernelTrain.apply(x, weight, bias, operand, wino4, pre_padded)


def conv3x3(
    x: torch.Tensor, wpacked: torch.Tensor, bias: torch.Tensor, *,
    pre_padded: bool = False, weight: torch.Tensor | None = None,
) -> torch.Tensor:
    """3x3 SAME conv of NHWC ``x`` (B, H, W, C), or of its 1-px zero-bordered
    form (B, H+2, W+2, C) with ``pre_padded``, by the packed weight
    (O, 9*C) plus ``bias`` (O,). Returns (B, H, W, O). Under autograd it is
    the forward of :class:`ConvKernelTrain`, with ``weight`` the OIHW conv
    weight that ``wpacked`` was made from."""
    if x.ndim != 4:
        raise ValueError(f"expected NHWC, got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if pre_padded:
        h, w = h - 2, w - 2
    o = wpacked.shape[0]
    if wpacked.shape != (o, 9 * c) or bias.shape != (o,):
        raise ValueError(f"weight {tuple(wpacked.shape)} does not match C={c}")
    y = _train_route("conv3x3", x, wpacked, bias, weight, False, pre_padded)
    if y is not None:
        return y
    if not x.is_cuda:
        return conv3x3_plain(x, wpacked, bias, pre_padded=pre_padded)
    if c % 8 or o % 8:
        raise ValueError(f"conv3x3 kernel needs C % 8 == O % 8 == 0, got {c}, {o}")
    stream = check_kernel_operands("conv3x3", x, wpacked, bias)
    for t in (x, wpacked, bias):
        if t.data_ptr() % 16:
            raise ValueError("conv3x3 kernel needs 16-byte aligned operands")
    from gmdx_torch.kernels import _build

    plan = conv3x3_plan(b, h, w, c, o, pre_padded)
    out = torch.empty((b, h, w, o), dtype=x.dtype, device=x.device)
    partial = (torch.empty((plan.split, b * h * w, o), dtype=torch.float32, device=x.device)
               if plan.split > 1 else None)
    bw, bh, bb = plan.box or (0, 0, 0)
    _build.call(
        "gmdx_conv3x3", x.data_ptr(), wpacked.data_ptr(), bias.data_ptr(),
        out.data_ptr(), None if partial is None else partial.data_ptr(),
        b, h, w, c, o, int(pre_padded), int(plan.route == "gather"), bw, bh, bb,
        plan.bn, plan.split, plan.slices_per_split, stream,
    )
    LAUNCHES["conv3x3"] += 1
    return out


def conv3x3_direct(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *, pre_padded: bool = False,
) -> torch.Tensor:
    """The same conv by ``F.conv2d`` on a channels-last view, with the OIHW
    ``weight``: the differentiated route. A channels-last input gives a
    channels-last result, so the final ``contiguous`` copies nothing."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, padding=0 if pre_padded else 1)
    return y.permute(0, 2, 3, 1).contiguous()


class ConvKernelTrain(torch.autograd.Function):
    """The conv kernel as the training forward: the counterpart of
    ``_wino_conv``'s custom VJP under ``GMDX_WINOGRAD_TRAIN=1``
    (``gmdx/kernels/winograd.py:994-1059``). The forward launches
    :func:`winograd4_conv3x3` (``wino4``) or :func:`conv3x3` on ``operand``,
    the weight's packing for that kernel, which the caller makes without
    grad. The backward is :func:`conv3x3_direct`'s gradients for x, the OIHW
    ``weight`` and the bias, cuDNN's dgrad and wgrad in one
    ``convolution_backward`` call, as ``_wino_bwd`` takes the VJP of the
    direct conv. The wrappers enter it under autograd. It saves (x, weight,
    bias), as gmdx's residuals are: the bytes the direct conv's graph keeps,
    not the packed operand."""

    @staticmethod
    def forward(ctx, x, weight, bias, operand, wino4: bool, pre_padded: bool):
        ctx.save_for_backward(x, weight, bias)
        ctx.pre_padded = pre_padded
        fn = winograd4_conv3x3 if wino4 else conv3x3
        return fn(x, operand, bias, pre_padded=pre_padded)

    @staticmethod
    def backward(ctx, g):
        x, weight, bias = ctx.saved_tensors
        pad = 0 if ctx.pre_padded else 1
        gx, gw, gb = torch.ops.aten.convolution_backward(
            g.to(x.dtype).permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), weight,
            [bias.shape[0]], [1, 1], [pad, pad], [1, 1], False, [0, 0], 1,
            list(ctx.needs_input_grad[:3]))
        return None if gx is None else gx.permute(0, 2, 3, 1), gw, gb, None, None, None


@functools.lru_cache(maxsize=None)
def _wino4_constants(device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """F(4x4)'s G, B^T and A^T in fp32 on ``device``, copied there once: a
    copy from host memory at every call would wait for the card's queue
    (training packs U at every step) and cannot be captured into a CUDA
    graph."""
    return tuple(torch.tensor(m, dtype=torch.float32, device=device) for m in (G4, BT4, AT4))


def pack_weight4(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """OIHW (O, C, 3, 3) -> U (36, O, C), U[6*xi + nu] = G g G^T at (xi, nu),
    taken in fp32 from the weight's own dtype and rounded to ``dtype``, as
    ``_wino4_kernel`` fills its ``u_scr``."""
    g4 = _wino4_constants(weight.device)[0]
    u = torch.einsum("ak,bl,ockl->aboc", g4, g4, weight.detach().float())
    return u.reshape(36, *weight.shape[:2]).to(dtype).contiguous()


def _wino4_pad(x: torch.Tensor, pre_padded: bool) -> torch.Tensor:
    """The image with a 1-px top/left and 3-px bottom/right zero border."""
    return F.pad(x, (0, 0, 0, 2, 0, 2) if pre_padded else (0, 0, 1, 3, 1, 3))


def winograd4_conv3x3_plain(
    x: torch.Tensor, u: torch.Tensor, bias: torch.Tensor, *, pre_padded: bool = False,
) -> torch.Tensor:
    """Plain version, the kernel's three stages in fp32 with the JAX
    kernel's rounding: V = B^T d B per 6x6 patch (rows first, then columns)
    rounded to x's dtype, M[p] = V[p] U[p]^T, Y = A^T M A + bias."""
    b, hp, wp, c = x.shape
    h, w = (hp - 2, wp - 2) if pre_padded else (hp, wp)
    o = u.shape[1]
    xp = _wino4_pad(x, pre_padded).float()
    _, bt, at = _wino4_constants(x.device)
    # d[i, j] = xpad[4ty + i, 4tx + j]: (6, 6, B, H/4, W/4, C).
    d = torch.stack([torch.stack([xp[:, i:i + h:4, j:j + w:4] for j in range(6)])
                     for i in range(6)])
    rowt = torch.einsum("xi,ij...->xj...", bt, d)
    v = torch.einsum("nj,xj...->xn...", bt, rowt).to(x.dtype).float()
    m = torch.einsum("pbyxc,poc->pbyxo", v.reshape(36, b, h // 4, w // 4, c), u.float())
    z = torch.einsum("rx,xnbyzo->rnbyzo", at, m.reshape(6, 6, b, h // 4, w // 4, o))
    y = torch.einsum("qn,rnbyzo->byrzqo", at, z) + bias.float()
    return y.reshape(b, h, w, o).to(x.dtype)


# csrc/winograd4.cu: threads of a transform block, the products' tile
# width, and the staging width its GEMM instance is built with.
WINO4_THREADS = 128
WINO4_BLOCK_N = 64
WINO4_OUTW = 8
SMEM_BUDGET = 232448


def gemm_smem(bn: int, outw: int, block_m: int = CONV_BLOCK_M,
              block_k: int = CONV_BLOCK_K) -> tuple[int, int]:
    """(stages, bytes) of ``gemm_sm90.cuh``'s ``Smem<BN, OUTW>``: the ring
    of A and B stages, the epilogue's staging tiles and the mbarriers."""
    stage = (block_m + bn) * block_k * 2
    staging = 2 * 64 * (outw + 8) * 2
    stages = min(6, (SMEM_BUDGET - 1024 - staging - 256) // stage)
    return stages, 1024 + stages * stage + staging + (2 * stages + 2) * 8


@dataclasses.dataclass(frozen=True)
class Wino4Plan:
    """How ``csrc/winograd4.cu`` runs one F(4x4) conv of T = B*H/4*W/4
    tiles. The input transform: blocks of ``in_ty`` x ``in_tx`` tiles and
    8 * ``in_cgt`` channels, ``in_grid`` blocks. The products: units (nu,
    row tile, ``bn``-wide column tile), each a K loop over 6 * C / block_k
    slices (xi, then channels), the xi half of the output transform folded
    in, writing 24 fp32 planes z. The output transform: one thread per tile
    and 8 channels, ``out_grid`` blocks."""

    b: int
    h: int
    w: int
    c: int
    o: int
    halo: int
    tiles: int
    t_tiles: int
    c_slices: int
    n_tiles: int
    stages: int
    smem_bytes: int
    in_cgt: int
    in_tx: int
    in_ty: int
    in_smem: int
    in_grid: tuple[int, int]
    out_grid: int
    bn: int = WINO4_BLOCK_N
    block_m: int = CONV_BLOCK_M
    block_k: int = CONV_BLOCK_K

    @property
    def units(self) -> int:
        return 6 * self.t_tiles * self.n_tiles

    @property
    def slices(self) -> int:
        return 6 * self.c_slices

    @property
    def grid(self) -> int:
        return min(self.units, SMS)

    @property
    def v_box(self) -> tuple[int, int, int]:
        """TMA box of V, whose map is (C, T, 36)."""
        return (self.block_k, self.block_m, 1)

    @property
    def u_box(self) -> tuple[int, int, int]:
        """TMA box of U, whose map is (C, O, 36)."""
        return (self.block_k, self.bn, 1)

    def c_fields(self) -> list[int]:
        """The fields ``gmdx_wino4_plan`` reports, in its order."""
        return [self.units, self.grid, self.stages, self.smem_bytes, self.in_cgt, self.in_tx,
                self.in_ty, self.in_smem, *self.in_grid, self.out_grid, self.bn]

    def unit(self, u: int) -> tuple[int, int, int]:
        """Unit ``u``'s (nu, row tile, column tile): ``Units::decode``,
        column tile fastest."""
        mt, nt = divmod(u, self.n_tiles)
        nu, tt = divmod(mt, self.t_tiles)
        return nu, tt, nt

    def slice(self, nu: int, s: int) -> tuple[int, int]:
        """Slice ``s`` of a unit on ``nu``: (p = 6 xi + nu, first channel),
        as ``Wino4Op::load`` places its TMA boxes."""
        xi, cs = divmod(s, self.c_slices)
        return 6 * xi + nu, cs * self.block_k


def winograd4_plan(b: int, h: int, w: int, c: int, o: int,
                   pre_padded: bool = False) -> Wino4Plan:
    """The launch plan of a (B, H, W, C) -> O F(4x4) conv."""
    th, tw = h // 4, w // 4
    tiles = b * th * tw
    stages, smem = gemm_smem(WINO4_BLOCK_N, WINO4_OUTW)
    cgt = next(k for k in (8, 4, 2, 1) if (c // 8) % k == 0)
    in_tx = 8 if tw >= 8 else 4
    in_ty = WINO4_THREADS // cgt // in_tx
    return Wino4Plan(
        b=b, h=h, w=w, c=c, o=o, halo=0 if pre_padded else 1, tiles=tiles,
        t_tiles=-(-tiles // CONV_BLOCK_M), c_slices=-(-c // CONV_BLOCK_K),
        n_tiles=-(-o // WINO4_BLOCK_N), stages=stages, smem_bytes=smem,
        in_cgt=cgt, in_tx=in_tx, in_ty=in_ty,
        in_smem=(4 * in_ty + 2) * (4 * in_tx + 2) * cgt * 16,
        in_grid=(b * -(-th // in_ty) * -(-tw // in_tx), c // (8 * cgt)),
        out_grid=-(-tiles * (o // 8) // WINO4_THREADS),
    )


def winograd4_conv3x3(
    x: torch.Tensor, u: torch.Tensor, bias: torch.Tensor, *, pre_padded: bool = False,
    weight: torch.Tensor | None = None,
) -> torch.Tensor:
    """3x3 SAME conv of NHWC ``x`` (B, H, W, C), or of its 1-px zero-bordered
    form (B, H+2, W+2, C) with ``pre_padded``, by Winograd F(4x4, 3x3) with
    the transformed weight ``u`` (36, O, C) plus ``bias`` (O,); H == W, a
    multiple of 4. Returns (B, H, W, O). Under autograd it is the forward
    of :class:`ConvKernelTrain`, with ``weight`` the OIHW conv weight that
    ``u`` was made from."""
    if x.ndim != 4:
        raise ValueError(f"expected NHWC, got {tuple(x.shape)}")
    b, h, w, c = x.shape
    if pre_padded:
        h, w = h - 2, w - 2
    o = u.shape[1]
    if u.shape != (36, o, c) or bias.shape != (o,):
        raise ValueError(f"transformed weight {tuple(u.shape)} does not match C={c}")
    if not _wino4_shape_ok(h, w, c, o):
        raise ValueError(f"F(4x4) takes square H % 4 == 0 >= 16 and C, O % 8 == 0, "
                         f"got {h}x{w}, {c} -> {o}")
    y = _train_route("winograd4_conv3x3", x, u, bias, weight, True, pre_padded)
    if y is not None:
        return y
    if not x.is_cuda:
        return winograd4_conv3x3_plain(x, u, bias, pre_padded=pre_padded)
    stream = check_kernel_operands("winograd4_conv3x3", x, u, bias)
    if x.data_ptr() % 16 or u.data_ptr() % 16:
        raise ValueError("winograd4_conv3x3 kernel needs 16-byte aligned operands")
    from gmdx_torch.kernels import _build

    tiles = b * (h // 4) * (w // 4)
    v = torch.empty((36, tiles, c), dtype=x.dtype, device=x.device)
    z = torch.empty((24, tiles, o), dtype=torch.float32, device=x.device)
    out = torch.empty((b, h, w, o), dtype=x.dtype, device=x.device)
    _build.call(
        "gmdx_wino4", x.data_ptr(), u.data_ptr(), bias.data_ptr(), v.data_ptr(),
        z.data_ptr(), out.data_ptr(), b, h, w, c, o, int(pre_padded), stream,
    )
    LAUNCHES["winograd4_conv3x3"] += 1
    return out


__all__ = [
    "conv3x3", "conv3x3_plain", "conv3x3_direct", "ConvKernelTrain", "pack_weight",
    "conv_route",
    "ConvPlan", "conv3x3_box", "conv3x3_plan",
    "pack_weight4", "winograd4_conv3x3", "winograd4_conv3x3_plain",
    "Wino4Plan", "winograd4_plan",
]
