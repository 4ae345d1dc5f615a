"""Radiance RGBE (.hdr) codec in numpy, and the HDR frame export.

A copy of ``gmdx/io/rgbe.py`` (writer with adaptive-RLE scanlines, reader of
RLE and flat scanlines) and ``gmdx/io/image.py:save_hdr_image``, without the
JAX package's optional C++ codec. Files read back with cv2 or imageio.
"""

from __future__ import annotations

import numpy as np

_HEADER = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n"


def rgbe_encode(rgb: np.ndarray) -> np.ndarray:
    """Float RGB (..., 3) -> uint8 RGBE (..., 4), shared exponent, mantissa
    rounded to nearest."""
    rgb = np.maximum(np.asarray(rgb, dtype=np.float32), 0.0)
    maxc = rgb.max(axis=-1)
    rgbe = np.zeros(rgb.shape[:-1] + (4,), dtype=np.uint8)
    nz = maxc >= 1e-32
    frac, exp = np.frexp(maxc[nz])
    scale = frac * 256.0 / maxc[nz]
    mant = rgb[nz] * scale[..., None] + 0.5
    rgbe[nz, :3] = np.minimum(mant, 255.0).astype(np.uint8)
    rgbe[nz, 3] = (exp + 128).astype(np.uint8)
    return rgbe


def rgbe_decode(rgbe: np.ndarray) -> np.ndarray:
    """uint8 RGBE (..., 4) -> float32 RGB (..., 3)."""
    rgbe = np.asarray(rgbe, dtype=np.uint8)
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136))
    return rgbe[..., :3].astype(np.float32) * scale[..., None].astype(np.float32)


def _rle_encode_channel(ch: np.ndarray) -> bytes:
    """Adaptive RLE of one channel of one scanline (Radiance 'new' RLE)."""
    out = bytearray()
    n = len(ch)
    i = 0
    while i < n:
        run_end = i + 1
        while run_end < n and run_end - i < 127 and ch[run_end] == ch[i]:
            run_end += 1
        if run_end - i >= 4:
            out.append(128 + run_end - i)
            out.append(int(ch[i]))
            i = run_end
            continue
        lit_end = i
        while lit_end < n and lit_end - i < 128:
            re = lit_end + 1
            while re < n and re - lit_end < 4 and ch[re] == ch[lit_end]:
                re += 1
            if re - lit_end >= 4:
                break
            lit_end += 1
        if lit_end == i:
            lit_end = min(i + 128, n)
        out.append(lit_end - i)
        out.extend(ch[i:lit_end].tobytes())
        i = lit_end
    return bytes(out)


def write_hdr(path: str, rgb: np.ndarray) -> None:
    """Write a float RGB (H, W, 3) image as a Radiance .hdr (RLE scanlines)."""
    rgb = np.asarray(rgb, dtype=np.float32)
    if rgb.ndim != 3 or rgb.shape[-1] != 3:
        raise ValueError(f"expected (H, W, 3) RGB image, got {rgb.shape}")
    h, w = rgb.shape[:2]
    rgbe = rgbe_encode(rgb)
    with open(path, "wb") as f:
        f.write(_HEADER)
        f.write(f"-Y {h} +X {w}\n".encode())
        if not 8 <= w < 32768:
            f.write(rgbe.tobytes())
            return
        for y in range(h):
            f.write(bytes((2, 2, (w >> 8) & 0xFF, w & 0xFF)))
            for c in range(4):
                f.write(_rle_encode_channel(np.ascontiguousarray(rgbe[y, :, c])))


def _read_rle_scanline(buf: memoryview, pos: int, w: int) -> tuple[np.ndarray, int]:
    line = np.empty((w, 4), dtype=np.uint8)
    for c in range(4):
        x = 0
        while x < w:
            code = buf[pos]
            pos += 1
            if code > 128:
                line[x:x + code - 128, c] = buf[pos]
                pos += 1
                x += code - 128
            else:
                line[x:x + code, c] = np.frombuffer(buf[pos:pos + code], dtype=np.uint8)
                pos += code
                x += code
    return line, pos


def read_hdr(path: str) -> np.ndarray:
    """Read a Radiance .hdr file -> float32 RGB (H, W, 3)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"#?"):
        raise ValueError(f"{path}: not a Radiance file")
    hdr_end = data.index(b"\n\n") + 2
    res_end = data.index(b"\n", hdr_end)
    res = data[hdr_end:res_end].split()
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported orientation {res}")
    h, w = int(res[1]), int(res[3])
    buf = memoryview(data)
    pos = res_end + 1
    rgbe = np.empty((h, w, 4), dtype=np.uint8)
    for y in range(h):
        # New-RLE scanline header (2, 2, hi, lo) with hi < 0x80 and
        # (hi << 8) | lo == width; anything else is a flat scanline.
        if (
            8 <= w < 32768
            and buf[pos] == 2
            and buf[pos + 1] == 2
            and buf[pos + 2] & 0x80 == 0
            and ((buf[pos + 2] << 8) | buf[pos + 3]) == w
        ):
            rgbe[y], pos = _read_rle_scanline(buf, pos + 4, w)
        else:
            rgbe[y] = np.frombuffer(buf[pos:pos + 4 * w], dtype=np.uint8).reshape(w, 4)
            pos += 4 * w
    return rgbe_decode(rgbe)


def save_hdr_image(path: str, hdr_rgb: np.ndarray, qmax: float | None = None) -> None:
    """Write an HDR frame (H, W, 3) as .hdr, divided by ``qmax + 1`` when
    ``qmax`` is given (the reference's export convention)."""
    hdr = np.asarray(hdr_rgb, dtype=np.float32)
    if qmax is not None:
        hdr = hdr / (qmax + 1.0)
    write_hdr(path, np.maximum(hdr, 0.0))


__all__ = ["rgbe_encode", "rgbe_decode", "write_hdr", "read_hdr", "save_hdr_image"]
