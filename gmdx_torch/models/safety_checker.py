"""Stable Diffusion safety checker: the CLIP ViT-L/14 vision tower and the
concept thresholds that black out flagged images.

Counterpart of ``gmdx/models/safety_checker.py``. The module tree is
transformers' and diffusers' ``StableDiffusionSafetyChecker``
(``vision_model.vision_model.embeddings.patch_embedding``,
``pre_layrnorm`` with transformers' spelling, ``encoder.layers.N``,
``post_layernorm``, ``visual_projection`` without a bias and the four concept
tensors at the top), so a real checker's state dict loads with
``strict=True`` once its ``position_ids`` buffer is dropped. The encoder
layers are ``models/clip_text.py``'s with an all-true mask, as the JAX
package reuses its text layer; 257 tokens need no kernel, so attention is
the plain einsum with an fp32 softmax. The pooled class embedding, the
projection and the cosines run in float32, the flags are strict ``> 0``.

``preprocess_for_clip`` resizes as ``jax.image.resize(..., "bicubic")``
does: Keys' cubic (a = -0.5), widened by 1 / scale when it downscales
(antialiased), each output's weights renormalised over the taps inside the
image, applied as one product per axis. ``F.interpolate``'s bicubic (a =
-0.75, clamped border) and PIL's are other functions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gmdx_torch.models.clip_text import CLIPTextConfig, _EncoderLayer
from gmdx_torch.models.layers import layer_norm

# OpenAI CLIP preprocessing constants (transformers' CLIPImageProcessor).
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    projection_dim: int = 768
    layer_norm_eps: float = 1e-5
    num_concepts: int = 17
    num_special_concepts: int = 3


CLIP_VIT_L_VISION_CONFIG = CLIPVisionConfig()
TINY_VISION_CONFIG = CLIPVisionConfig(
    image_size=32,
    patch_size=8,
    hidden_size=32,
    num_layers=2,
    num_heads=2,
    intermediate_size=64,
    projection_dim=16,
    num_concepts=4,
    num_special_concepts=2,
)


def _text_cfg(cfg: CLIPVisionConfig) -> CLIPTextConfig:
    """The encoder layers' view of the config: the ViT blocks are the text
    tower's (pre-LN, quick-GELU MLP), without the causal mask."""
    return CLIPTextConfig(hidden_size=cfg.hidden_size, num_layers=cfg.num_layers,
                          num_heads=cfg.num_heads, intermediate_size=cfg.intermediate_size,
                          layer_norm_eps=cfg.layer_norm_eps)


class _VisionEmbeddings(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.patch_size = cfg.patch_size
        n = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.class_embedding = nn.Parameter(torch.randn(cfg.hidden_size) * 0.02)
        self.patch_embedding = nn.Conv2d(3, cfg.hidden_size, cfg.patch_size, cfg.patch_size,
                                         bias=False)
        self.position_embedding = nn.Embedding(n, cfg.hidden_size)

    def forward(self, pixel_values: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        """(B, 3, H, W) -> (B, 1 + patches, hidden): the patch conv (stride
        = kernel) as one product over the unfolded patches, so that it runs
        at the matmul precision and not cuDNN's TF32."""
        b, c, h, w = pixel_values.shape
        p = self.patch_size
        patches = (pixel_values.to(dtype).reshape(b, c, h // p, p, w // p, p)
                   .permute(0, 2, 4, 1, 3, 5).reshape(b, (h // p) * (w // p), c * p * p))
        weight = self.patch_embedding.weight
        x = F.linear(patches, weight.reshape(weight.shape[0], -1).to(dtype))
        cls = self.class_embedding.to(dtype).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1)
        pos = torch.arange(x.shape[1], device=x.device)
        return x + self.position_embedding(pos)[None].to(dtype)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        tcfg = _text_cfg(cfg)
        self.layers = nn.ModuleList([_EncoderLayer(tcfg) for _ in range(cfg.num_layers)])


class _VisionTransformer(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.embeddings = _VisionEmbeddings(cfg)
        self.pre_layrnorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.encoder = _Encoder(cfg)
        self.post_layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class CLIPVisionModel(nn.Module):
    """CLIP ViT vision tower; returns the post-LN pooled class embedding."""

    def __init__(self, config: CLIPVisionConfig = CLIP_VIT_L_VISION_CONFIG):
        super().__init__()
        self.config = config
        self.vision_model = _VisionTransformer(config)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) CLIP-normalised pixels -> (B, hidden) float32,
        computed in the weights' dtype."""
        vm = self.vision_model
        dtype = vm.post_layernorm.weight.dtype
        h = layer_norm(vm.embeddings(pixel_values, dtype), vm.pre_layrnorm)
        full = torch.ones(h.shape[1], h.shape[1], dtype=torch.bool, device=h.device)
        for layer in vm.encoder.layers:
            h = layer(h, full)
        return layer_norm(h[:, 0], vm.post_layernorm).float()


def _cosine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Row-normalised cosine similarity, (B, D) x (N, D) -> (B, N)."""
    an = a / torch.linalg.vector_norm(a, dim=-1, keepdim=True)
    bn = b / torch.linalg.vector_norm(b, dim=-1, keepdim=True)
    return an @ bn.T


class StableDiffusionSafetyChecker(nn.Module):
    """Flags images by cosine similarity to fixed concept embeddings.

    diffusers' threshold logic: when any special-care concept fires, every
    concept threshold drops by 0.01; an image is flagged when any concept
    fires."""

    def __init__(self, config: CLIPVisionConfig = CLIP_VIT_L_VISION_CONFIG):
        super().__init__()
        self.config = config
        self.vision_model = CLIPVisionModel(config)
        self.visual_projection = nn.Linear(config.hidden_size, config.projection_dim, bias=False)
        p = config.projection_dim
        self.concept_embeds = nn.Parameter(torch.randn(config.num_concepts, p) * 0.02)
        self.special_care_embeds = nn.Parameter(torch.randn(config.num_special_concepts, p) * 0.02)
        self.concept_embeds_weights = nn.Parameter(torch.ones(config.num_concepts))
        self.special_care_embeds_weights = nn.Parameter(torch.ones(config.num_special_concepts))

    def image_embeds(self, clip_input: torch.Tensor) -> torch.Tensor:
        """(B, 3, S, S) CLIP-normalised -> (B, projection_dim) float32."""
        pooled = self.vision_model(clip_input)
        return F.linear(pooled, self.visual_projection.weight.float())

    def scores(self, embeds: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Projected embeddings -> (special-care scores (B, S), concept
        scores (B, N)), the latter with the special-care adjustment; a score
        above 0 fires."""
        special = _cosine(embeds, self.special_care_embeds.float()) \
            - self.special_care_embeds_weights.float()[None, :]
        adjustment = (special > 0.0).any(dim=-1).float() * 0.01
        concept = (_cosine(embeds, self.concept_embeds.float())
                   - self.concept_embeds_weights.float()[None, :] + adjustment[:, None])
        return special, concept

    def forward(self, clip_input: torch.Tensor) -> torch.Tensor:
        """(B, 3, S, S) CLIP-normalised -> (B,) bool flags."""
        _, concept = self.scores(self.image_embeds(clip_input))
        return (concept > 0.0).any(dim=-1)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel, a = -0.5, of |x| (``jax.image``'s)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """(n_in, n_out) float32 weights of ``jax.image.resize``'s bicubic along
    one axis (``compute_weight_mat`` with translation 0, antialiased). As
    there, the scale's inverse is taken in double precision, then rounded."""
    inv_scale = torch.tensor(1.0 / (n_out / n_in), dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / kernel_scale
    w = _keys_cubic(x)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps, w / torch.where(total != 0, total, 1.0),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def _resize_bicubic(images: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """(B, H, W, C) float32 -> (B, height, width, C) as
    ``jax.image.resize(..., method="bicubic")``: an axis whose size does not
    change is left as it is."""
    b, h, w, c = images.shape
    x = images.float()
    if h != height:
        x = torch.einsum("bhwc,ho->bowc", x, _resize_weights(h, height, x.device))
    if w != width:
        x = torch.einsum("bhwc,wo->bhoc", x, _resize_weights(w, width, x.device))
    return x


def preprocess_for_clip(images01: torch.Tensor, image_size: int = 224) -> torch.Tensor:
    """(B, H, W, 3) images in [0, 1] -> (B, 3, S, S) CLIP-normalised input:
    the shortest edge resized to ``image_size`` (bicubic), the long edge
    centre-cropped, as transformers' CLIPImageProcessor."""
    b, h, w, c = images01.shape
    if h <= w:
        nh, nw = image_size, max(image_size, round(w * image_size / h))
    else:
        nh, nw = max(image_size, round(h * image_size / w)), image_size
    resized = _resize_bicubic(images01, nh, nw)
    top, left = (nh - image_size) // 2, (nw - image_size) // 2
    cropped = resized[:, top:top + image_size, left:left + image_size]
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=torch.float32, device=cropped.device)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=torch.float32, device=cropped.device)
    return ((cropped.clamp(0.0, 1.0) - mean) / std).permute(0, 3, 1, 2)


@torch.no_grad()
def run_safety_checker(checker: StableDiffusionSafetyChecker, images01: torch.Tensor):
    """(images with the flagged ones blacked out, (B,) bool flags), as the
    reference's run_safety_checker (stable_diffusion_gm.py:585-597)."""
    has_nsfw = checker(preprocess_for_clip(images01, image_size=checker.config.image_size))
    keep = (~has_nsfw).to(images01.dtype)[:, None, None, None]
    return images01 * keep, has_nsfw


def make_safety_checker_fn(checker: StableDiffusionSafetyChecker):
    """The callable the pipelines' ``safety_checker=`` takes: NHWC numpy
    images in [0, 1] -> (filtered images, flags), numpy, computed on the
    checker's device."""
    device = checker.concept_embeds.device

    def fn(images01):
        x = torch.as_tensor(np.asarray(images01), dtype=torch.float32).to(device)
        out, flags = run_safety_checker(checker, x)
        return out.cpu().numpy(), flags.cpu().numpy()

    return fn


__all__ = [
    "CLIPVisionConfig",
    "CLIPVisionModel",
    "StableDiffusionSafetyChecker",
    "CLIP_VIT_L_VISION_CONFIG",
    "TINY_VISION_CONFIG",
    "preprocess_for_clip",
    "run_safety_checker",
    "make_safety_checker_fn",
    "CLIP_IMAGE_MEAN",
    "CLIP_IMAGE_STD",
]
