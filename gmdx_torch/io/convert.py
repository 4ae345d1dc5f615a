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
discriminator's (its parameters and spectral-norm state; one table gives
both directions) and the LoRA factors' (keyed by the diffusers name of the
weight they adapt). A torchvision or timm VGG19 checkpoint loads into the
perceptual loss's ``VGG19Features`` under its own names.
"""

from __future__ import annotations

import re

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


# The Discriminator's whole mapping, one row a leaf kind: (Flax path, port
# key, transform). ``{i}`` is the conv's index on both sides; "conv" rows
# change the kernel's layout (HWIO <-> OIHW), the others carry the value as
# it is. Both directions derive from it.
_DISCRIMINATOR_TABLE = (
    ("params/conv_{i}/kernel", "convs.{i}.weight", "conv"),
    ("params/conv_{i}/bias", "convs.{i}.bias", None),
    ("params/shuffle/kernel", "shuffle.weight", "conv"),
    ("params/shuffle/bias", "shuffle.bias", None),
    ("batch_stats/SpectralNorm_{i}/conv_{i}/kernel/u", "convs.{i}.u", None),
    ("batch_stats/SpectralNorm_{i}/conv_{i}/kernel/sigma", "convs.{i}.sigma", None),
)


def _template_regex(template: str) -> re.Pattern:
    """``{i}`` as a group of digits (one group per place), the rest literal."""
    head, *rest = template.split("{i}")
    body = re.escape(head) + "".join(f"(?P<i{k}>\\d+)" + re.escape(p) for k, p in enumerate(rest))
    return re.compile(body + "$")


def _hwio(w):
    """An OIHW conv weight in Flax's HWIO layout (the inverse of
    ``_inv_conv``)."""
    if isinstance(w, torch.Tensor):
        return w.permute(2, 3, 1, 0).contiguous()
    return np.ascontiguousarray(np.transpose(np.asarray(w), (2, 3, 1, 0)))


# Each transform of a table row: (Flax -> port, port -> Flax).
_TRANSFORMS = {"conv": (_inv_conv, _hwio), "linear": (_inv_linear, _inv_linear)}


def _table_map(table, flat: dict, src: int, what: str = "Discriminator") -> dict:
    """Map ``flat``'s keys from column ``src`` of ``table`` (0: Flax, 1: the
    port) to the other column, each value through the row's transform in
    that direction; a key no row matches, or a ``{i}`` that differs
    between its places, raises (naming ``what``)."""
    rows = [(_template_regex(row[src]), row) for row in table]
    out = {}
    for key, value in flat.items():
        for rx, row in rows:
            m = rx.match(key)
            if m is None:
                continue
            idx = set(m.groupdict().values())
            if len(idx) > 1:
                raise KeyError(f"{key}: indices {sorted(idx)} differ")
            target = row[1 - src].format(i=idx.pop() if idx else "")
            out[target] = value if row[2] is None else _TRANSFORMS[row[2]][src](value)
            break
        else:
            raise KeyError(f"unhandled {what} key {key}")
    return out


def discriminator_state_dict_from_flax(params: dict, batch_stats: dict) -> dict[str, np.ndarray]:
    """gmdx ``Discriminator`` params and spectral-norm state (its variables
    but ``params``, or their ``batch_stats`` collection; either may be
    empty) -> the port's names (the JAX package exports none), by
    ``_DISCRIMINATOR_TABLE``: ``convs.<i>.weight|bias|u|sigma``,
    ``shuffle.weight|bias``."""
    stats = dict(batch_stats)
    stats = stats.get("batch_stats", stats)
    flat = {f"params/{k}": v for k, v in _flatten(params).items()}
    flat.update({f"batch_stats/{k}": v for k, v in _flatten(stats).items()})
    return _table_map(_DISCRIMINATOR_TABLE, flat, 0)


def _nest(flat: dict) -> dict:
    """{'/'-joined path: leaf} -> nested dicts."""
    out: dict = {}
    for path, value in flat.items():
        node = out
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out


def discriminator_flax_from_state_dict(state_dict: dict) -> dict:
    """The port's ``Discriminator`` state dict (parameters and the ``u`` /
    ``sigma`` buffers) -> gmdx's variables ``{"params": ...,
    "batch_stats": ...}``, the inverse of
    :func:`discriminator_state_dict_from_flax` (the same table)."""
    return _nest(_table_map(_DISCRIMINATOR_TABLE, dict(state_dict), 1))


# The safety checker's whole mapping (``gmdx/io/torch_import.py:549``
# ``convert_safety_checker_state_dict`` and ``:608``
# ``export_safety_checker_state_dict``), in the Discriminator's form: the
# port's keys are transformers', ``pre_layrnorm`` spelled as there; "linear"
# rows transpose a Dense kernel, "conv" rows change HWIO <-> OIHW.
_VISION = "vision_model.vision_model"
_CLIP_LAYER = "vision_model/layers_{i}"
_SAFETY_CHECKER_TABLE = (
    *((name, name, None) for name in ("concept_embeds", "special_care_embeds",
                                      "concept_embeds_weights", "special_care_embeds_weights")),
    ("visual_projection/kernel", "visual_projection.weight", "linear"),
    ("vision_model/class_embedding", f"{_VISION}.embeddings.class_embedding", None),
    ("vision_model/patch_embedding/kernel", f"{_VISION}.embeddings.patch_embedding.weight",
     "conv"),
    ("vision_model/position_embedding/embedding",
     f"{_VISION}.embeddings.position_embedding.weight", None),
    *((f"vision_model/{flax}/{fp}", f"{_VISION}.{port}.{tp}", None)
      for flax, port in (("pre_layernorm", "pre_layrnorm"), ("post_layernorm", "post_layernorm"))
      for fp, tp in (("scale", "weight"), ("bias", "bias"))),
    *((f"{_CLIP_LAYER}/{flax}/{fp}", f"{_VISION}.encoder.layers.{{i}}.{port}.{tp}", None)
      for flax, port in (("norm1", "layer_norm1"), ("norm2", "layer_norm2"))
      for fp, tp in (("scale", "weight"), ("bias", "bias"))),
    *((f"{_CLIP_LAYER}/{flax}/{fp}", f"{_VISION}.encoder.layers.{{i}}.{port}.{tp}", t)
      for flax, port in (*((f"attn/{p}", f"self_attn.{p}")
                           for p in ("q_proj", "k_proj", "v_proj", "out_proj")),
                         ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2"))
      for fp, tp, t in (("kernel", "weight", "linear"), ("bias", "bias", None))),
)


def safety_checker_state_dict_from_flax(params: dict) -> dict[str, np.ndarray]:
    """gmdx ``StableDiffusionSafetyChecker`` params -> the port's (and
    transformers') names, by ``_SAFETY_CHECKER_TABLE``."""
    return _table_map(_SAFETY_CHECKER_TABLE, _flatten(params), 0, "safety-checker")


def safety_checker_flax_from_state_dict(state_dict: dict) -> dict:
    """The port's ``StableDiffusionSafetyChecker`` state dict -> gmdx's
    params, the inverse of :func:`safety_checker_state_dict_from_flax` (the
    same table)."""
    return _nest(_table_map(_SAFETY_CHECKER_TABLE, dict(state_dict), 1, "safety-checker"))


_VGG19_SKIPPED = ("classifier.", "head.", "pre_logits.")


def vgg19_state_dict_from_checkpoint(state_dict: dict) -> dict[str, torch.Tensor]:
    """A torchvision or timm VGG19 state dict -> the port's
    ``VGG19Features`` state dict (float32 tensors): both name the conv
    stack ``features.<idx>.weight|bias``, the port's names too; the
    classifier (``classifier.*``, ``head.*``, ``pre_logits.*``) is left
    out, as ``gmdx/io/torch_import.py:convert_vgg19_state_dict`` leaves it.
    Any other key, or a missing conv, raises."""
    out = {}
    for key, value in state_dict.items():
        if key.startswith(_VGG19_SKIPPED):
            continue
        parts = key.split(".")
        if (len(parts) != 3 or parts[0] != "features" or parts[2] not in ("weight", "bias")
                or not parts[1].isdigit()):
            raise KeyError(f"unhandled VGG19 key: {key}")
        if int(parts[1]) not in _VGG19_CONV_INDICES:
            raise KeyError(f"non-conv VGG19 features index in key: {key}")
        t = value if isinstance(value, torch.Tensor) else torch.from_numpy(np.array(value))
        out[key] = t.float()
    missing = [i for i in _VGG19_CONV_INDICES if f"features.{i}.weight" not in out]
    if missing:
        raise KeyError(f"VGG19 checkpoint missing conv layers at features indices {missing}")
    return out


def load_vgg19_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """Read a torchvision / timm VGG19 checkpoint (``--perceptual_ckpt``):
    ``.safetensors`` through the port's reader, ``.pth`` / ``.pt`` /
    ``.bin`` through ``torch.load(weights_only=True)`` (a ``state_dict``
    entry unwrapped). Returns :func:`vgg19_state_dict_from_checkpoint` of
    it."""
    if path.endswith(".safetensors"):
        from gmdx_torch.io.params import load_file

        sd = load_file(path)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
    return vgg19_state_dict_from_checkpoint(sd)


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
    "discriminator_flax_from_state_dict",
    "safety_checker_state_dict_from_flax",
    "safety_checker_flax_from_state_dict",
    "vgg19_state_dict_from_checkpoint",
    "load_vgg19_checkpoint",
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
