"""PNG decode and encode, and PIL's BICUBIC resize, in numpy and ``zlib``.

The port reads and writes PNGs itself: the card's machine has no PIL. The
reader takes bit depth 8 grey, grey + alpha, RGB, RGBA and palette images
and 16-bit RGB and RGBA, with all five scanline filters, and returns RGB
with PIL's ``convert("RGB")`` semantics: alpha dropped (not composited),
grey replicated, palette looked up, and of a 16-bit sample the high byte (as
PIL's ``RGB;16B`` unpacker keeps it), plain or Adam7-interlaced. The writer
writes 8-bit RGB, each scanline unfiltered.

:func:`resize_bicubic` is PIL's ``Image.resize(..., BICUBIC)`` on uint8
images, bit for bit: separable with a = -0.5, the support widened by the
downscale factor, coefficients normalised per output sample and held in
fixed point with 22 fraction bits, each pass rounded and clipped to uint8,
the horizontal pass first.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Adam7's seven passes: (first column, first row, column step, row step).
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _chunks(data: bytes, path: str):
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: truncated PNG (no IEND)")


def _unfilter(raw: np.ndarray, height: int, width: int, bpp: int) -> np.ndarray:
    """Undo the scanline filters: (H, 1 + W * bpp) bytes -> (H, W, bpp)
    uint8. Each byte depends on its left, upper and upper-left neighbours,
    so the rows are walked as anti-diagonal wavefronts of pixels, each
    wavefront one vector step whatever its rows' filters."""
    ftype = raw[:, 0].astype(np.int64)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {int(ftype.max())}")
    filt = raw[:, 1:].reshape(height, width, bpp).astype(np.int64)
    if not ftype.any():
        return filt.astype(np.uint8)
    rec = np.zeros((height + 1, width + 1, bpp), np.int64)  # zero row 0, column 0
    for d in range(height + width - 1):
        ys = np.arange(max(0, d - width + 1), min(height, d + 1))
        xs = d - ys
        a, b, c = rec[ys + 1, xs], rec[ys, xs + 1], rec[ys, xs]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = ftype[ys][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        rec[ys + 1, xs + 1] = (filt[ys, xs] + pred) & 0xFF
    return rec[1:, 1:].astype(np.uint8)


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """PNG bytes -> uint8 RGB (H, W, 3), as PIL's ``convert("RGB")``."""
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, color, _, _, interlace = header
    if interlace not in (0, 1):
        raise ValueError(f"{path}: unknown PNG interlace method {interlace}")
    if color not in _CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {color}")
    if depth != 8 and not (depth == 16 and color in (2, 6)):
        raise NotImplementedError(
            f"{path}: PNG bit depth {depth} with colour type {color} is not read "
            f"(depth 8, and 16 for RGB and RGBA)")
    ch = _CHANNELS[color]
    bpp = ch * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    # (first column, first row, column step, row step) of each pass: the
    # whole image, or Adam7's seven sub-images, each filtered on its own.
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    sizes = [(-(-(height - y0) // dy), -(-(width - x0) // dx)) for x0, y0, dx, dy in passes]
    want = sum(h * (1 + w * bpp) for h, w in sizes if h and w)
    if raw.size != want:
        raise ValueError(f"{path}: PNG image data of {raw.size} bytes, expected {want}")
    px = np.zeros((height, width, bpp), np.uint8)
    pos = 0
    for (x0, y0, dx, dy), (h, w) in zip(passes, sizes):
        if h and w:
            n = h * (1 + w * bpp)
            px[y0::dy, x0::dx] = _unfilter(raw[pos:pos + n].reshape(h, 1 + w * bpp), h, w, bpp)
            pos += n
    if depth == 16:
        px = px[:, :, 0::2]  # big-endian samples: keep the high byte
    if color == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        return palette[px[:, :, 0]]
    if color in (0, 4):
        return np.repeat(px[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(px[:, :, :3])


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def encode_png(rgb: np.ndarray) -> bytes:
    """uint8 RGB (H, W, 3) -> PNG bytes (8-bit RGB, filter 0)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, got {rgb.shape}")
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def write_png(path: str, rgb: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(rgb))


_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """PIL's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for BICUBIC:
    (first input index (out,), fixed-point weights (out, ksize)), the
    weights past each sample's span 0."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(np.int64) - xmin
    k = np.zeros((out_size, ksize))
    ww = np.zeros(out_size)
    for x in range(ksize):  # a running sum in tap order, as PIL's loop
        w = np.where(x < xmax, _bicubic(((x + xmin) - center + 0.5) * ss), 0.0)
        k[:, x] = w
        ww = ww + w
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0.0, 1.0, ww)[:, None], k)
    fixed = np.trunc(np.where(k < 0, -0.5 + k * (1 << _PRECISION_BITS),
                              0.5 + k * (1 << _PRECISION_BITS)))
    return xmin, fixed.astype(np.int64)


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One 8-bit pass along ``axis`` (0 rows, 1 columns) of uint8 (H, W, C)."""
    in_size = img.shape[axis]
    xmin, k = _coeffs(in_size, out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int64)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    tail = (1,) * (src.ndim - 1)
    for x in range(k.shape[1]):
        idx = np.minimum(xmin + x, in_size - 1)
        acc += src[idx] * k[:, x].reshape((out_size,) + tail)
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize_bicubic(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """uint8 (H, W, C) -> (height, width, C), as PIL's BICUBIC resize."""
    img = np.asarray(img, np.uint8)
    if img.shape[1] != width:
        img = _resample_axis(img, width, 1)
    if img.shape[0] != height:
        img = _resample_axis(img, height, 0)
    return img


__all__ = ["decode_png", "read_png", "encode_png", "write_png", "resize_bicubic"]
