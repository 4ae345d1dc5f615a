"""Host-side paired image transforms, in numpy.

Counterpart of ``gmdx/data/transforms.py`` without PIL (the card's machine
has none): the images arrive decoded by ``gmdx_torch.io.png`` (uint8 RGB,
PIL's ``convert("RGB")``), the shorter side is resized by PIL's BILINEAR
(``gmdx_torch.io.png.resize_bilinear``, bit for bit), then one crop window
and one flip draw are applied to both images of the pair, as in the JAX
package (the reference draws them per image and misaligns the pair).
"""

from __future__ import annotations

import numpy as np

from gmdx_torch.io.image import to_model_range
from gmdx_torch.io.png import resize_bilinear


def resized_dims(w: int, h: int, size: int) -> tuple[int, int]:
    """(new_w, new_h) of a shorter-side resize to ``size``."""
    if w <= h:
        return size, max(1, round(h * size / w))
    return max(1, round(w * size / h)), size


def resize_shorter_side(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 (H, W, C): BILINEAR resize so that the shorter side is ``size``
    (torchvision ``Resize(int)``)."""
    new_w, new_h = resized_dims(img.shape[1], img.shape[0], size)
    return resize_bilinear(img, new_h, new_w)


def paired_crop(
    a: np.ndarray,
    b: np.ndarray,
    size: int,
    rng: np.random.Generator | None = None,
    center: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Crop the SAME (size, size) window from two (H, W, C) arrays: the
    center, or top then left drawn from ``rng``."""
    h, w = a.shape[:2]
    if a.shape[:2] != b.shape[:2]:
        raise ValueError(f"paired images disagree on shape: {a.shape} vs {b.shape}")
    if h < size or w < size:
        raise ValueError(f"image {h}x{w} smaller than crop {size}")
    if center or rng is None:
        top, left = (h - size) // 2, (w - size) // 2
    else:
        top = int(rng.integers(0, h - size + 1))
        left = int(rng.integers(0, w - size + 1))
    return a[top:top + size, left:left + size], b[top:top + size, left:left + size]


def crop_pair(
    sdr: np.ndarray,
    gm: np.ndarray,
    resolution: int,
    *,
    center_crop: bool = False,
    random_flip: bool = False,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """The draws of :func:`preprocess_pair` on an already resized pair: one
    crop window, then one flip draw, for both; float32 CHW in [-1, 1]."""
    a, b = paired_crop(sdr, gm, resolution, rng=rng, center=center_crop)
    if random_flip and rng is not None and rng.random() < 0.5:
        a, b = a[:, ::-1], b[:, ::-1]
    return to_model_range(a), to_model_range(b)


def preprocess_pair(
    sdr: np.ndarray,
    gm: np.ndarray,
    resolution: int,
    *,
    center_crop: bool = False,
    random_flip: bool = False,
    rng: np.random.Generator | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Two uint8 RGB (H, W, 3) images -> two (3, resolution, resolution)
    float32 in [-1, 1]: resize, one crop window, then one flip draw (after
    the crop's draws) for both."""
    return crop_pair(resize_shorter_side(sdr, resolution), resize_shorter_side(gm, resolution),
                     resolution, center_crop=center_crop, random_flip=random_flip, rng=rng)


__all__ = [
    "resized_dims",
    "resize_shorter_side",
    "paired_crop",
    "crop_pair",
    "to_model_range",
    "preprocess_pair",
]
