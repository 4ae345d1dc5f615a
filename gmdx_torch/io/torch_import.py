"""Diffusers / transformers state dicts into the port's state dicts.

Counterpart of the import half of ``gmdx/io/torch_import.py``
(``convert_unet_state_dict``, ``convert_vae_state_dict``,
``convert_clip_text_state_dict``, ``convert_safety_checker_state_dict``,
``load_torch_checkpoint``, ``load_torch_safetensors``). The port's modules
already use diffusers' and transformers' key names, so nothing is renamed
wholesale: each function normalises what SD-1.5 checkpoints write in older
or other forms, then checks the result against the module's own key space
for ``config`` (built on the meta device):

  * the VAE's legacy attention names ``query``, ``key``, ``value`` and
    ``proj_attn`` become ``to_q``, ``to_k``, ``to_v`` and ``to_out.0``, and
    its 1x1-conv attention weights (4-D) become Linear weights (2-D);
  * a UNet's linear ``proj_in`` / ``proj_out`` (2-D) become the 1x1 convs
    (4-D) of SD-1.5's layout;
  * the ``position_ids`` buffers of the CLIP text and vision towers are
    dropped, and CLIP text keys without ``text_model.`` get it;
  * a key the module does not have raises ``KeyError`` naming it, as a
    missing key does; a shape the config does not give raises
    ``ValueError``. Nothing is dropped silently.

Values come back as numpy arrays in their stored dtype (BF16 files upcast
to float32, as the JAX package reads them). Files are read with the port's
own safetensors reader: the card's machine has neither ``safetensors`` nor
``ml_dtypes``.
"""

from __future__ import annotations

import re

import numpy as np
import torch

from gmdx_torch.io.params import load_file
from gmdx_torch.models import (
    AutoencoderKL, CLIPTextConfig, CLIPTextModel, CLIPVisionConfig, StableDiffusionSafetyChecker,
    UNet2DConditionModel, UNetConfig, VAEConfig,
)


def load_torch_safetensors(path: str) -> dict[str, np.ndarray]:
    """A torch-saved ``.safetensors`` as numpy: BF16 upcast to float32, F16
    and F32 as stored."""
    return {k: v.float().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in load_file(path).items()}


def load_torch_checkpoint(path: str) -> dict[str, np.ndarray]:
    """A torch checkpoint (``.safetensors``, ``.pth``, ``.pt`` or ``.bin``;
    a nested ``state_dict`` unwrapped) as numpy; a pickled one is read with
    ``weights_only=True`` and comes back in float32, as the JAX package
    reads it."""
    if path.endswith(".safetensors"):
        return load_torch_safetensors(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: v.float().numpy() for k, v in sd.items()}


def _check(sd: dict, module_cls, config, what: str) -> dict[str, np.ndarray]:
    """``sd`` as it is, once its keys are exactly those of ``module_cls``
    (``config``) and each shape is the module's."""
    with torch.device("meta"):
        want = {k: tuple(v.shape) for k, v in module_cls(config).state_dict().items()}
    unknown = [k for k in sd if k not in want]
    if unknown:
        raise KeyError(f"unhandled {what} key: {unknown[0]}"
                       + (f" (and {len(unknown) - 1} more)" if len(unknown) > 1 else ""))
    missing = sorted(set(want) - set(sd))
    if missing:
        raise KeyError(f"{what} checkpoint lacks {len(missing)} keys, first {missing[0]}")
    bad = [(k, tuple(v.shape), want[k]) for k, v in sd.items() if tuple(v.shape) != want[k]]
    if bad:
        raise ValueError(f"{what} shapes differ from its config: {bad[:4]}")
    return sd


_UNET_PROJ = re.compile(r"(down_blocks\.\d+\.|up_blocks\.\d+\.|mid_block\.)attentions\.\d+\."
                        r"proj_(in|out)\.weight$")


def convert_unet_state_dict(sd: dict, config: UNetConfig) -> dict[str, np.ndarray]:
    """A diffusers ``UNet2DConditionModel`` state dict -> the port's."""
    out = {}
    for key, value in sd.items():
        value = np.asarray(value)
        if _UNET_PROJ.search(key) and value.ndim == 2:
            value = value[:, :, None, None]
        out[key] = value
    return _check(out, UNet2DConditionModel, config, "UNet")


_VAE_LEGACY = {"query": "to_q", "key": "to_k", "value": "to_v", "proj_attn": "to_out.0"}
_VAE_ATTENTION = re.compile(r"^((?:encoder|decoder)\.mid_block\.attentions\.0\.)"
                            r"(query|key|value|proj_attn|to_q|to_k|to_v|to_out\.0)\.(weight|bias)$")


def convert_vae_state_dict(sd: dict, config: VAEConfig) -> dict[str, np.ndarray]:
    """A diffusers ``AutoencoderKL`` state dict -> the port's, legacy
    attention names and 4-D attention weights included."""
    out = {}
    for key, value in sd.items():
        value = np.asarray(value)
        m = _VAE_ATTENTION.match(key)
        if m:
            prefix, proj, param = m.groups()
            key = f"{prefix}{_VAE_LEGACY.get(proj, proj)}.{param}"
            if param == "weight" and value.ndim == 4:
                value = value[:, :, 0, 0]
        out[key] = value
    return _check(out, AutoencoderKL, config, "VAE")


def convert_clip_text_state_dict(sd: dict, config: CLIPTextConfig) -> dict[str, np.ndarray]:
    """A transformers ``CLIPTextModel`` state dict -> the port's."""
    out = {}
    for key, value in sd.items():
        key = "text_model." + key.removeprefix("text_model.")
        if key != "text_model.embeddings.position_ids":
            out[key] = np.asarray(value)
    return _check(out, CLIPTextModel, config, "CLIP")


def convert_safety_checker_state_dict(sd: dict,
                                      config: CLIPVisionConfig) -> dict[str, np.ndarray]:
    """A diffusers ``StableDiffusionSafetyChecker`` state dict -> the
    port's."""
    out = {k: np.asarray(v) for k, v in sd.items()
           if k != "vision_model.vision_model.embeddings.position_ids"}
    return _check(out, StableDiffusionSafetyChecker, config, "safety-checker")


__all__ = [
    "load_torch_safetensors",
    "load_torch_checkpoint",
    "convert_unet_state_dict",
    "convert_vae_state_dict",
    "convert_clip_text_state_dict",
    "convert_safety_checker_state_dict",
]
