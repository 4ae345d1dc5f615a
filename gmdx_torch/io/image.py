"""Host image helpers: PNG in and out, model-range conversion.

Counterpart of ``gmdx/io/image.py`` (the reference's host preprocessing:
normalise to [-1, 1]; .hdr export through ``gmdx_torch.io.hdr``), on the
port's own PNG codec and BICUBIC resize (``gmdx_torch.io.png``) instead of
PIL.
"""

from __future__ import annotations

import numpy as np

from gmdx_torch.io.hdr import save_hdr_image
from gmdx_torch.io.png import read_png, resize_bicubic, write_png


def load_image(path: str, size: tuple[int, int] | None = None) -> np.ndarray:
    """A PNG file -> float32 RGB (H, W, 3) in [0, 1]; ``size`` = (height,
    width) resizes it first (PIL's BICUBIC on the 8-bit image)."""
    img = read_png(path)
    if size is not None and img.shape[:2] != tuple(size):
        img = resize_bicubic(img, size[0], size[1])
    return img.astype(np.float32) / 255.0


def save_image(path: str, rgb: np.ndarray) -> None:
    """Float RGB (H, W, 3) in [0, 1] -> an 8-bit RGB PNG."""
    arr = np.clip(np.asarray(rgb), 0.0, 1.0)
    write_png(path, (arr * 255.0 + 0.5).astype(np.uint8))


def to_model_range(img: np.ndarray) -> np.ndarray:
    """uint8 [0, 255] or float [0, 1] HWC -> float32 [-1, 1] CHW. The range
    follows the dtype, not the pixel maximum (a near-black uint8 image
    stays near -1)."""
    arr = np.asarray(img)
    if np.issubdtype(arr.dtype, np.integer):
        x = arr.astype(np.float32) / float(np.iinfo(arr.dtype).max)
    else:
        x = arr.astype(np.float32)
    x = x * 2.0 - 1.0
    return np.transpose(x, (2, 0, 1))


def to_model_input(rgb: np.ndarray) -> np.ndarray:
    """[0, 1]-float or uint8 HWC (or a stack of them) -> [-1, 1] NCHW
    float32, the VAE's range and layout."""
    x = np.asarray(rgb)
    if x.ndim == 3:
        return to_model_range(x)[None]
    return np.stack([to_model_range(im) for im in x])


def from_model_output(x: np.ndarray) -> np.ndarray:
    """[-1, 1] NCHW -> [0, 1] NHWC float32."""
    x = np.asarray(x, dtype=np.float32)
    x = np.clip(x / 2.0 + 0.5, 0.0, 1.0)
    return np.transpose(x, (0, 2, 3, 1))


__all__ = [
    "load_image",
    "save_image",
    "to_model_range",
    "to_model_input",
    "from_model_output",
    "save_hdr_image",
]
