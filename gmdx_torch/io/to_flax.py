"""Carry weights back: the port's state dicts -> the JAX package's param trees.

A port-local copy of the import mapping of ``gmdx/io/torch_import.py``
(``convert_unet_state_dict``, ``convert_vae_state_dict``,
``convert_clip_text_state_dict``): diffusers/transformers-named state dicts
become Flax param trees (nested dicts of numpy arrays) with Linear weights
transposed to (in, out) and OIHW conv weights to HWIO, norms' ``weight`` as
``scale``. Values may be numpy arrays or torch tensors on any device (the
layout changes run there). It is the inverse of ``gmdx_torch.io.convert``'s ``*_from_flax``,
which the pipeline directories use to write what the JAX package reads.
The ControlNet's mapping is the port's own (the inverse of
``controlnet_state_dict_from_flax``). Unknown keys raise. (The
Discriminator's and the safety checker's maps are one table each in
``gmdx_torch.io.convert``, which gives both directions.)
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _array(value):
    """Torch tensors (on any device) as they are, anything else as numpy:
    the layout changes below then run where the tensor lives."""
    return value if isinstance(value, torch.Tensor) else np.asarray(value)


def _linear(w: np.ndarray) -> np.ndarray:
    if w.ndim == 4:  # 1x1-conv-as-linear in old VAE attention checkpoints
        w = w[:, :, 0, 0]
    if isinstance(w, torch.Tensor):
        return w.t().contiguous()
    return np.ascontiguousarray(w.T)


def _conv(w: np.ndarray) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        return w.permute(2, 3, 1, 0).contiguous()
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def _set(tree: Dict, path: str, value: np.ndarray) -> None:
    parts = path.split("/")
    node = tree
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = value


_NORM_PARAM = {"weight": "scale", "bias": "bias"}
_LINEAR_PARAM = {"weight": "kernel", "bias": "bias"}


def _convert_resnet(rest: str, value: np.ndarray, out: Dict, prefix: str) -> bool:
    """diffusers resnet subkeys -> gmdx ResnetBlock2D names."""
    mod, _, param = rest.partition(".")
    if mod in ("norm1", "norm2"):
        _set(out, f"{prefix}/{mod}/norm/{_NORM_PARAM[param]}", value)
    elif mod in ("conv1", "conv2", "conv_shortcut"):
        v = _conv(value) if param == "weight" else value
        _set(out, f"{prefix}/{mod}/{_LINEAR_PARAM[param]}", v)
    elif mod == "time_emb_proj":
        v = _linear(value) if param == "weight" else value
        _set(out, f"{prefix}/time_emb_proj/{_LINEAR_PARAM[param]}", v)
    else:
        return False
    return True


def _convert_transformer2d(rest: str, value: np.ndarray, out: Dict, prefix: str) -> bool:
    """diffusers Transformer2DModel subkeys -> gmdx Transformer2D names."""
    if rest.startswith("norm."):
        param = rest.split(".")[-1]
        _set(out, f"{prefix}/norm/norm/{_NORM_PARAM[param]}", value)
        return True
    for proj in ("proj_in", "proj_out"):
        if rest.startswith(proj + "."):
            param = rest.split(".")[-1]
            # SD-1.5 uses 1x1 convs for the spatial projections.
            v = value
            if param == "weight":
                v = _conv(value) if value.ndim == 4 else _linear(value).reshape(
                    1, 1, *value.T.shape
                )
            _set(out, f"{prefix}/{proj}/{_LINEAR_PARAM[param]}", v)
            return True
    if rest.startswith("transformer_blocks."):
        _, d, sub = rest.split(".", 2)
        bp = f"{prefix}/blocks_{d}"
        mod, _, tail = sub.partition(".")
        if mod in ("norm1", "norm2", "norm3"):
            _set(out, f"{bp}/{mod}/{_NORM_PARAM[tail]}", value)
            return True
        if mod in ("attn1", "attn2"):
            proj, _, param = tail.partition(".")
            if proj == "to_out":
                param = param.split(".")[-1]  # to_out.0.weight
                v = _linear(value) if param == "weight" else value
                _set(out, f"{bp}/{mod}/to_out/{_LINEAR_PARAM[param]}", v)
            else:  # to_q/to_k/to_v, no bias
                v = _linear(value) if param == "weight" else value
                _set(out, f"{bp}/{mod}/{proj}/{_LINEAR_PARAM[param]}", v)
            return True
        if mod == "ff":
            # ff.net.0.proj -> proj_in (GEGLU), ff.net.2 -> proj_out
            parts = tail.split(".")
            param = parts[-1]
            name = "proj_in" if parts[1] == "0" else "proj_out"
            v = _linear(value) if param == "weight" else value
            _set(out, f"{bp}/ff/{name}/{_LINEAR_PARAM[param]}", v)
            return True
    return False


def convert_unet_state_dict(sd: Dict[str, np.ndarray]) -> Dict:
    """diffusers UNet2DConditionModel state dict -> gmdx UNet param tree."""
    out: Dict = {}
    for key, value in sd.items():
        value = _array(value)
        param = key.split(".")[-1]
        if key.startswith("conv_in.") or key.startswith("conv_out."):
            name = key.split(".")[0]
            v = _conv(value) if param == "weight" else value
            _set(out, f"{name}/{_LINEAR_PARAM[param]}", v)
        elif key.startswith("time_embedding."):
            _, lin, param = key.split(".")
            v = _linear(value) if param == "weight" else value
            _set(out, f"time_embedding/{lin}/{_LINEAR_PARAM[param]}", v)
        elif key.startswith("conv_norm_out."):
            _set(out, f"conv_norm_out/norm/{_NORM_PARAM[param]}", value)
        elif key.startswith(("down_blocks.", "up_blocks.")):
            side = "down" if key.startswith("down") else "up"
            _, i, kind, rest = key.split(".", 3)
            if kind == "resnets":
                j, rest2 = rest.split(".", 1)
                ok = _convert_resnet(rest2, value, out, f"{side}_{i}_resnet_{j}")
            elif kind == "attentions":
                j, rest2 = rest.split(".", 1)
                ok = _convert_transformer2d(
                    rest2, value, out, f"{side}_{i}_attn_{j}"
                )
            elif kind in ("downsamplers", "upsamplers"):
                # downsamplers.0.conv.weight
                tag = "downsample" if kind == "downsamplers" else "upsample"
                v = _conv(value) if param == "weight" else value
                _set(out, f"{side}_{i}_{tag}/conv/{_LINEAR_PARAM[param]}", v)
                ok = True
            else:
                ok = False
            if not ok:
                raise KeyError(f"unhandled UNet key: {key}")
        elif key.startswith("mid_block."):
            _, kind, j, rest = key.split(".", 3)
            if kind == "resnets":
                ok = _convert_resnet(rest, value, out, f"mid_resnet_{j}")
            else:
                ok = _convert_transformer2d(rest, value, out, "mid_attn")
            if not ok:
                raise KeyError(f"unhandled UNet key: {key}")
        else:
            raise KeyError(f"unhandled UNet key: {key}")
    return out


def _convert_vae_attention(rest: str, value: np.ndarray, out: Dict, prefix: str) -> bool:
    if rest.startswith("group_norm."):
        param = rest.split(".")[-1]
        _set(out, f"{prefix}/group_norm/norm/{_NORM_PARAM[param]}", value)
        return True
    for proj in ("to_q", "to_k", "to_v", "to_out", "query", "key", "value",
                 "proj_attn"):
        if rest.startswith(proj + "."):
            param = rest.split(".")[-1]
            name = {
                "query": "to_q", "key": "to_k", "value": "to_v",
                "proj_attn": "to_out",
            }.get(proj, proj)
            v = _linear(value) if param == "weight" else value
            _set(out, f"{prefix}/{name}/{_LINEAR_PARAM[param]}", v)
            return True
    return False


def convert_vae_state_dict(sd: Dict[str, np.ndarray]) -> Dict:
    """diffusers AutoencoderKL state dict -> gmdx VAE param tree."""
    out: Dict = {}
    for key, value in sd.items():
        value = _array(value)
        param = key.split(".")[-1]
        if key.startswith(("quant_conv.", "post_quant_conv.")):
            name = key.split(".")[0]
            v = _conv(value) if param == "weight" else value
            _set(out, f"{name}/{_LINEAR_PARAM[param]}", v)
            continue
        half, rest = key.split(".", 1)  # encoder | decoder
        if half not in ("encoder", "decoder"):
            raise KeyError(f"unhandled VAE key: {key}")
        if rest.startswith(("conv_in.", "conv_out.")):
            name = rest.split(".")[0]
            v = _conv(value) if param == "weight" else value
            _set(out, f"{half}/{name}/{_LINEAR_PARAM[param]}", v)
        elif rest.startswith("conv_norm_out."):
            _set(out, f"{half}/conv_norm_out/norm/{_NORM_PARAM[param]}", value)
        elif rest.startswith(("down_blocks.", "up_blocks.")):
            side = "down" if rest.startswith("down") else "up"
            _, i, kind, rest2 = rest.split(".", 3)
            if kind == "resnets":
                j, rest3 = rest2.split(".", 1)
                ok = _convert_resnet(
                    rest3, value, out, f"{half}/{side}_{i}_resnet_{j}"
                )
            elif kind in ("downsamplers", "upsamplers"):
                tag = "downsample" if kind == "downsamplers" else "upsample"
                v = _conv(value) if param == "weight" else value
                _set(out, f"{half}/{side}_{i}_{tag}/conv/{_LINEAR_PARAM[param]}", v)
                ok = True
            else:
                ok = False
            if not ok:
                raise KeyError(f"unhandled VAE key: {key}")
        elif rest.startswith("mid_block."):
            _, kind, j, rest2 = rest.split(".", 3)
            if kind == "resnets":
                ok = _convert_resnet(rest2, value, out, f"{half}/mid_resnet_{j}")
            else:
                ok = _convert_vae_attention(rest2, value, out, f"{half}/mid_attn")
            if not ok:
                raise KeyError(f"unhandled VAE key: {key}")
        else:
            raise KeyError(f"unhandled VAE key: {key}")
    return out


def convert_clip_text_state_dict(sd: Dict[str, np.ndarray]) -> Dict:
    """transformers CLIPTextModel state dict -> gmdx CLIPTextModel tree."""
    out: Dict = {}
    for key, value in sd.items():
        value = _array(value)
        key = key.removeprefix("text_model.")
        param = key.split(".")[-1]
        if key == "embeddings.token_embedding.weight":
            _set(out, "token_embedding/embedding", value)
        elif key == "embeddings.position_embedding.weight":
            _set(out, "position_embedding/embedding", value)
        elif key == "embeddings.position_ids":
            continue  # buffer, not a param
        elif key.startswith("final_layer_norm."):
            _set(out, f"final_layer_norm/{_NORM_PARAM[param]}", value)
        elif key.startswith("encoder.layers."):
            _, _, i, rest = key.split(".", 3)
            lp = f"layers_{i}"
            if rest.startswith("layer_norm1."):
                _set(out, f"{lp}/norm1/{_NORM_PARAM[param]}", value)
            elif rest.startswith("layer_norm2."):
                _set(out, f"{lp}/norm2/{_NORM_PARAM[param]}", value)
            elif rest.startswith("self_attn."):
                proj = rest.split(".")[1]  # q_proj/k_proj/v_proj/out_proj
                v = _linear(value) if param == "weight" else value
                _set(out, f"{lp}/attn/{proj}/{_LINEAR_PARAM[param]}", v)
            elif rest.startswith("mlp."):
                fc = rest.split(".")[1]
                v = _linear(value) if param == "weight" else value
                _set(out, f"{lp}/{fc}/{_LINEAR_PARAM[param]}", v)
            else:
                raise KeyError(f"unhandled CLIP key: {key}")
        else:
            raise KeyError(f"unhandled CLIP key: {key}")
    return out


def convert_controlnet_state_dict(sd: Dict[str, np.ndarray]) -> Dict:
    """The port's ``ControlNetModel`` state dict -> the gmdx ControlNet tree:
    the shared encoder by the UNet's rules,
    ``controlnet_cond_embedding.{conv_in,blocks.k,conv_out}`` ->
    ``cond_embedding/{conv_in,blocks_k,conv_out}``,
    ``controlnet_down_blocks.k`` -> ``controlnet_down_k`` and
    ``controlnet_mid_block`` -> ``controlnet_mid``."""
    out: Dict = {}
    shared = {}
    for key, value in sd.items():
        value = _array(value)
        param = key.split(".")[-1]
        v = _conv(value) if param == "weight" and value.ndim == 4 else value
        if key.startswith("controlnet_cond_embedding."):
            mod = key.split(".")[1]
            name = f"blocks_{key.split('.')[2]}" if mod == "blocks" else mod
            _set(out, f"cond_embedding/{name}/{_LINEAR_PARAM[param]}", v)
        elif key.startswith("controlnet_down_blocks."):
            _set(out, f"controlnet_down_{key.split('.')[1]}/{_LINEAR_PARAM[param]}", v)
        elif key.startswith("controlnet_mid_block."):
            _set(out, f"controlnet_mid/{_LINEAR_PARAM[param]}", v)
        else:
            shared[key] = value
    out.update(convert_unet_state_dict(shared))
    return out


__all__ = [
    "convert_unet_state_dict",
    "convert_vae_state_dict",
    "convert_clip_text_state_dict",
    "convert_controlnet_state_dict",
]
