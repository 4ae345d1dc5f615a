"""Carry weights across: the JAX package's param trees -> the port's modules.

A port-local copy of the export mapping of ``gmdx/io/torch_import.py``
(``export_unet_state_dict``, ``export_vae_state_dict``,
``export_clip_text_state_dict``, ``export_vgg19_state_dict``): Flax param trees
(nested dicts of numpy arrays) become state dicts in diffusers key naming,
with Dense kernels transposed to (out, in) and HWIO conv kernels to OIHW
(numpy leaves, or torch tensors, whose layout changes then run on their
device).
Because the naming is diffusers', real SD-1.5 torch checkpoints load into the
same modules unchanged. The ControlNet's mapping is the port's own (the JAX
package exports none): the UNet's rules for the shared encoder, diffusers'
names for the embedder and the zero convs. So are the Stage-1
discriminator's (its parameters and spectral-norm state) and the LoRA
factors' (keyed by the diffusers name of the weight they adapt).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from gmdx_torch import resolve_device
from gmdx_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from gmdx_torch.models.controlnet import ControlNetConfig, ControlNetModel
from gmdx_torch.models.unet2d import UNet2DConditionModel, UNetConfig
from gmdx_torch.models.vae import AutoencoderKL, VAEConfig


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flatten(v, p))
        else:
            out[p] = v if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def _inv_linear(w: np.ndarray) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        return w.t().contiguous()
    return np.ascontiguousarray(w.T)


def _inv_conv(w: np.ndarray) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        return w.permute(3, 2, 0, 1).contiguous()
    return np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))


def _param(kernel_name: str, value: np.ndarray, inv) -> tuple[str, np.ndarray]:
    """('weight', inv(value)) for a kernel, ('bias', value) otherwise."""
    return ("weight", inv(value)) if kernel_name == "kernel" else ("bias", value)


def _norm_param(name: str) -> str:
    return {"scale": "weight", "bias": "bias"}[name]


def _resnet(rest: str, value: np.ndarray, prefix: str) -> tuple[str, np.ndarray]:
    mod, sub = rest.split("/", 1)
    if mod in ("norm1", "norm2"):
        return f"{prefix}.{mod}.{_norm_param(sub.split('/')[-1])}", value
    if mod in ("conv1", "conv2", "conv_shortcut"):
        p, v = _param(sub, value, _inv_conv)
        return f"{prefix}.{mod}.{p}", v
    if mod == "time_emb_proj":
        p, v = _param(sub, value, _inv_linear)
        return f"{prefix}.{mod}.{p}", v
    raise KeyError(f"unhandled resnet path {rest}")


def _transformer2d(rest: str, value: np.ndarray, prefix: str) -> tuple[str, np.ndarray]:
    parts = rest.split("/")
    if parts[0] == "norm":
        return f"{prefix}.norm.{_norm_param(parts[-1])}", value
    if parts[0] in ("proj_in", "proj_out"):
        p, v = _param(parts[-1], value, _inv_conv)
        return f"{prefix}.{parts[0]}.{p}", v
    if parts[0].startswith("blocks_"):
        bp = f"{prefix}.transformer_blocks.{parts[0].split('_')[1]}"
        mod = parts[1]
        if mod in ("norm1", "norm2", "norm3"):
            return f"{bp}.{mod}.{_norm_param(parts[-1])}", value
        if mod in ("attn1", "attn2"):
            tail = "to_out.0" if parts[2] == "to_out" else parts[2]
            p, v = _param(parts[-1], value, _inv_linear)
            return f"{bp}.{mod}.{tail}.{p}", v
        if mod == "ff":
            name = "net.0.proj" if parts[2] == "proj_in" else "net.2"
            p, v = _param(parts[-1], value, _inv_linear)
            return f"{bp}.ff.{name}.{p}", v
    raise KeyError(f"unhandled transformer path {rest}")


def unet_state_dict_from_flax(params: dict) -> dict[str, np.ndarray]:
    """gmdx ``UNet2DConditionModel`` params -> diffusers-named state dict."""
    out = {}
    for path, value in _flatten(params).items():
        top, rest = path.split("/", 1)
        last = rest.split("/")[-1]
        if top in ("conv_in", "conv_out"):
            p, v = _param(last, value, _inv_conv)
            out[f"{top}.{p}"] = v
        elif top == "time_embedding":
            p, v = _param(last, value, _inv_linear)
            out[f"time_embedding.{rest.split('/')[0]}.{p}"] = v
        elif top == "conv_norm_out":
            out[f"conv_norm_out.{_norm_param(last)}"] = value
        elif top.startswith(("down_", "up_")):
            side, i, kind, *j = top.split("_")  # down_0_resnet_1 / down_0_downsample
            tp = f"{side}_blocks.{i}"
            if kind == "resnet":
                k, v = _resnet(rest, value, f"{tp}.resnets.{j[0]}")
            elif kind == "attn":
                k, v = _transformer2d(rest, value, f"{tp}.attentions.{j[0]}")
            else:
                samp = "downsamplers" if kind == "downsample" else "upsamplers"
                p, v = _param(last, value, _inv_conv)
                k = f"{tp}.{samp}.0.conv.{p}"
            out[k] = v
        elif top.startswith("mid_resnet_"):
            k, v = _resnet(rest, value, f"mid_block.resnets.{top.split('_')[-1]}")
            out[k] = v
        elif top == "mid_attn":
            k, v = _transformer2d(rest, value, "mid_block.attentions.0")
            out[k] = v
        else:
            raise KeyError(f"unhandled UNet path {path}")
    return out


def controlnet_state_dict_from_flax(params: dict) -> dict[str, np.ndarray]:
    """gmdx ``ControlNetModel`` params -> the port's state dict: the shared
    encoder (``conv_in``, ``time_embedding``, ``down_*``, ``mid_*``) by the
    UNet's rules, ``cond_embedding/{conv_in,blocks_k,conv_out}`` ->
    ``controlnet_cond_embedding.{conv_in,blocks.k,conv_out}``,
    ``controlnet_down_k`` -> ``controlnet_down_blocks.k`` and
    ``controlnet_mid`` -> ``controlnet_mid_block``."""
    out, shared = {}, {}
    for top, sub in params.items():
        if top == "cond_embedding":
            for path, value in _flatten(sub).items():
                mod, last = path.split("/")
                name = f"blocks.{mod.split('_')[1]}" if mod.startswith("blocks_") else mod
                p, v = _param(last, value, _inv_conv)
                out[f"controlnet_cond_embedding.{name}.{p}"] = v
        elif top == "controlnet_mid" or top.startswith("controlnet_down_"):
            name = ("controlnet_mid_block" if top == "controlnet_mid"
                    else f"controlnet_down_blocks.{top.rsplit('_', 1)[1]}")
            for last, value in _flatten(sub).items():
                p, v = _param(last, value, _inv_conv)
                out[f"{name}.{p}"] = v
        else:
            shared[top] = sub
    out.update(unet_state_dict_from_flax(shared))
    return out


def controlnet_state_dict_from_unet(controlnet_state_dict: dict, unet_state_dict: dict) -> dict:
    """The standard ControlNet start (``gmdx/models/controlnet.py:187-199``):
    every entry of ``controlnet_state_dict`` that the UNet shares
    (``conv_in``, ``time_embedding``, ``down_blocks``, ``mid_block``) taken
    from ``unet_state_dict``; the embedder and the zero convs keep their own.
    Returns a new dict."""
    out = dict(controlnet_state_dict)
    for k, v in unet_state_dict.items():
        if k in out and k.startswith(("conv_in.", "time_embedding.", "down_blocks.", "mid_block.")):
            out[k] = v
    return out


def _vae_attention(rest: str, value: np.ndarray, prefix: str) -> tuple[str, np.ndarray]:
    parts = rest.split("/")
    if parts[0] == "group_norm":
        return f"{prefix}.group_norm.{_norm_param(parts[-1])}", value
    tail = "to_out.0" if parts[0] == "to_out" else parts[0]
    p, v = _param(parts[-1], value, _inv_linear)
    return f"{prefix}.{tail}.{p}", v


def _vae_key(path: str, value: np.ndarray) -> tuple[str, np.ndarray]:
    """One gmdx ``AutoencoderKL`` param (``/``-joined path) -> its diffusers
    name and value."""
    top, rest = path.split("/", 1)
    last = rest.split("/")[-1]
    if top in ("quant_conv", "post_quant_conv"):
        p, v = _param(last, value, _inv_conv)
        return f"{top}.{p}", v
    if top not in ("encoder", "decoder"):
        raise KeyError(f"unhandled VAE path {path}")
    sub, rest2 = rest.split("/", 1)
    if sub in ("conv_in", "conv_out"):
        p, v = _param(last, value, _inv_conv)
        return f"{top}.{sub}.{p}", v
    if sub == "conv_norm_out":
        return f"{top}.conv_norm_out.{_norm_param(last)}", value
    if sub.startswith(("down_", "up_")):
        side, i, kind, *j = sub.split("_")  # down_0_resnet_1 / up_0_upsample
        tp = f"{top}.{side}_blocks.{i}"
        if kind == "resnet":
            return _resnet(rest2, value, f"{tp}.resnets.{j[0]}")
        samp = "downsamplers" if kind == "downsample" else "upsamplers"
        p, v = _param(last, value, _inv_conv)
        return f"{tp}.{samp}.0.conv.{p}", v
    if sub.startswith("mid_resnet_"):
        return _resnet(rest2, value, f"{top}.mid_block.resnets.{sub.split('_')[-1]}")
    if sub == "mid_attn":
        return _vae_attention(rest2, value, f"{top}.mid_block.attentions.0")
    raise KeyError(f"unhandled VAE path {path}")


def vae_state_dict_from_flax(params: dict) -> dict[str, np.ndarray]:
    """gmdx ``AutoencoderKL`` params -> diffusers-named state dict
    (``encoder.*``, ``quant_conv``, ``decoder.*``, ``post_quant_conv``)."""
    return dict(_vae_key(path, value) for path, value in _flatten(params).items())


# torchvision's VGG19 ``features`` index of each of the 16 convs.
_VGG19_CONV_INDICES = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34)


def vgg19_state_dict_from_flax(params: dict) -> dict[str, np.ndarray]:
    """gmdx ``VGG19Features`` params (``conv_<i>``) -> torchvision names
    (``features.<idx>.weight|bias``), as ``export_vgg19_state_dict``."""
    out = {}
    for path, value in _flatten(params).items():
        name, last = path.split("/")
        idx = _VGG19_CONV_INDICES[int(name.split("_")[1])]
        p, v = _param(last, value, _inv_conv)
        out[f"features.{idx}.{p}"] = v
    return out


def discriminator_state_dict_from_flax(params: dict, batch_stats: dict) -> dict[str, np.ndarray]:
    """gmdx ``Discriminator`` params and spectral-norm state (its variables
    but ``params``, or their ``batch_stats`` collection) -> the
    port's own names (the JAX package exports none): ``convs.<i>.weight|
    bias`` for ``conv_<i>``, ``convs.<i>.u|sigma`` from
    ``SpectralNorm_*/conv_<i>/kernel/{u,sigma}``, ``shuffle.weight|bias``."""
    out = {}
    for path, value in _flatten(params).items():
        name, last = path.split("/")
        p, v = _param(last, value, _inv_conv)
        prefix = "shuffle" if name == "shuffle" else f"convs.{name.split('_')[1]}"
        out[f"{prefix}.{p}"] = v
    for path, value in _flatten(batch_stats).items():
        parts = path.split("/")  # [batch_stats/]SpectralNorm_<j>/conv_<i>/kernel/{u,sigma}
        out[f"convs.{parts[-3].split('_')[1]}.{parts[-1]}"] = value
    return out


def lora_from_flax(lora: dict) -> dict[str, dict[str, np.ndarray]]:
    """gmdx VAE LoRA factors {(path...): {"a", "b"}} -> the port's
    {diffusers weight name: {"a", "b"}} (``gmdx_torch.models.lora``'s
    layout: each factor transposed as the kernel it adapts)."""
    out = {}
    for path, f in lora.items():
        key, a = _vae_key("/".join(path), f["a"])
        _, b = _vae_key("/".join(path), f["b"])
        out[key] = {"a": a, "b": b}
    return out


def unet_lora_from_flax(lora: dict) -> dict[str, dict[str, np.ndarray]]:
    """gmdx UNet LoRA factors {(path...): {"a", "b"}} (``init_lora_params``
    over a UNet's params) -> the port's {diffusers weight name: {"a", "b"}},
    each factor laid out as the kernel it adapts."""
    out = {}
    for path, f in lora.items():
        pair = {}
        for ab in ("a", "b"):
            tree = leaf = {}
            for p in path[:-1]:
                leaf = leaf.setdefault(p, {})
            leaf[path[-1]] = f[ab]
            (key, pair[ab]), = unet_state_dict_from_flax(tree).items()
        out[key] = pair
    return out


def stage1_trainables_from_flax(trainables: dict) -> dict:
    """gmdx ``Stage1State.trainables`` {"lora", "conv_out": {"kernel",
    "bias"}} -> the port's {"lora", "conv_out": {"weight", "bias"}}."""
    co = trainables["conv_out"]
    return {
        "lora": lora_from_flax(trainables["lora"]),
        "conv_out": {"weight": _inv_conv(np.asarray(co["kernel"])),
                     "bias": np.asarray(co["bias"])},
    }


def clip_text_state_dict_from_flax(params: dict) -> dict[str, np.ndarray]:
    """gmdx ``CLIPTextModel`` params -> transformers-named state dict."""
    out = {}
    for path, value in _flatten(params).items():
        parts = path.split("/")
        last = parts[-1]
        if parts[0] in ("token_embedding", "position_embedding"):
            out[f"text_model.embeddings.{parts[0]}.weight"] = value
        elif parts[0] == "final_layer_norm":
            out[f"text_model.final_layer_norm.{_norm_param(last)}"] = value
        elif parts[0].startswith("layers_"):
            lp = f"text_model.encoder.layers.{parts[0].split('_')[1]}"
            if parts[1] in ("norm1", "norm2"):
                out[f"{lp}.layer_{parts[1]}.{_norm_param(last)}"] = value
            elif parts[1] == "attn":
                p, v = _param(last, value, _inv_linear)
                out[f"{lp}.self_attn.{parts[2]}.{p}"] = v
            elif parts[1] in ("fc1", "fc2"):
                p, v = _param(last, value, _inv_linear)
                out[f"{lp}.mlp.{parts[1]}.{p}"] = v
            else:
                raise KeyError(f"unhandled CLIP path {path}")
        else:
            raise KeyError(f"unhandled CLIP path {path}")
    return out


def _load(module_cls, config, state_dict: dict, device, dtype) -> nn.Module:
    dev = resolve_device(device)
    with torch.device("meta"):
        model = module_cls(config)
    sd = {k: torch.tensor(np.asarray(v)) for k, v in state_dict.items()}
    model.load_state_dict(sd, strict=True, assign=True)
    return model.to(device=dev, dtype=dtype).eval()


def load_unet(
    state_dict: dict, config: UNetConfig, *, device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.bfloat16,
) -> UNet2DConditionModel:
    """A UNet holding ``state_dict`` (diffusers naming, ``strict=True``)."""
    return _load(UNet2DConditionModel, config, state_dict, device, dtype)


def load_vae(
    state_dict: dict, config: VAEConfig, *, device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.bfloat16,
) -> AutoencoderKL:
    """A VAE holding ``state_dict`` (diffusers naming, ``strict=True``)."""
    return _load(AutoencoderKL, config, state_dict, device, dtype)


def load_controlnet(
    state_dict: dict, config: ControlNetConfig, *, device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.bfloat16,
) -> ControlNetModel:
    """A ControlNet holding ``state_dict`` (``strict=True``)."""
    return _load(ControlNetModel, config, state_dict, device, dtype)


def load_clip_text(
    state_dict: dict, config: CLIPTextConfig, *, device: str | torch.device = "cuda",
    dtype: torch.dtype = torch.bfloat16,
) -> CLIPTextModel:
    """A CLIP text encoder holding ``state_dict`` (transformers naming,
    ``strict=True``)."""
    return _load(CLIPTextModel, config, state_dict, device, dtype)


__all__ = [
    "discriminator_state_dict_from_flax",
    "lora_from_flax",
    "unet_lora_from_flax",
    "stage1_trainables_from_flax",
    "vgg19_state_dict_from_flax",
    "controlnet_state_dict_from_flax",
    "controlnet_state_dict_from_unet",
    "load_controlnet",
    "unet_state_dict_from_flax",
    "vae_state_dict_from_flax",
    "clip_text_state_dict_from_flax",
    "load_unet",
    "load_vae",
    "load_clip_text",
]
