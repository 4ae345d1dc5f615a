"""Pipeline directories: the JAX package's checkpoint layout, read and
written by the port.

Counterpart of ``gmdx/io/pipeline.py``. A directory holds

    model_index.json                      which components exist
    <component>/config.json               the config dataclass + _class_name
    <component>/params.safetensors        the Flax param tree, '/'-joined keys
    tokenizer/vocab.json + merges.txt
    scheduler/config.json                 SchedulerConfig + constructor extras

Weights cross between the layouts through ``gmdx_torch.io.convert``
(Flax tree -> the port's state dict) and ``gmdx_torch.io.to_flax`` (back),
so a directory either package writes loads in the other with the same
weights. Components load onto the card in bfloat16 unless the caller asks
for the CPU (float32 there).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import torch
from torch import nn

from gmdx_torch import resolve_device
from gmdx_torch.io import convert, to_flax
from gmdx_torch.io.params import load_params, save_params
from gmdx_torch.models import (
    AutoencoderKL,
    CLIPTextConfig,
    CLIPTextModel,
    CLIPTokenizer,
    ControlNetConfig,
    ControlNetModel,
    UNet2DConditionModel,
    UNetConfig,
    VAEConfig,
)
from gmdx_torch.schedulers import get_scheduler

# class name -> (module class, config class, Flax tree -> state dict,
# state dict -> Flax tree)
_COMPONENTS = {
    "UNet2DConditionModel": (UNet2DConditionModel, UNetConfig,
                             convert.unet_state_dict_from_flax,
                             to_flax.convert_unet_state_dict),
    "AutoencoderKL": (AutoencoderKL, VAEConfig, convert.vae_state_dict_from_flax,
                      to_flax.convert_vae_state_dict),
    "CLIPTextModel": (CLIPTextModel, CLIPTextConfig, convert.clip_text_state_dict_from_flax,
                      to_flax.convert_clip_text_state_dict),
    "ControlNetModel": (ControlNetModel, ControlNetConfig,
                        convert.controlnet_state_dict_from_flax,
                        to_flax.convert_controlnet_state_dict),
}
# Config fields of the JAX package's dataclasses that the port's lack and
# that inference does not read (gradient checkpointing).
_IGNORED_FIELDS = ("remat",)
_SCHEDULER_NAMES = {
    "DDPMScheduler": "ddpm",
    "DDIMScheduler": "ddim",
    "PNDMScheduler": "pndm",
    "DPMSolverMultistepScheduler": "dpm++",
    "LCMScheduler": "lcm",
}
# Scheduler constructor arguments outside SchedulerConfig.
_SCHEDULER_EXTRAS = (
    "variance_type", "solver_order", "lower_order_final", "use_karras_sigmas",
    "final_sigmas_type", "original_inference_steps", "timestep_scaling", "sigma_data",
)


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def _read_json(path: str):
    with open(path) as f:
        return json.load(f)


def _config(cls, cfg: dict):
    """A config dataclass from its JSON: lists become tuples, the JAX-only
    fields go."""
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(cfg) - fields - set(_IGNORED_FIELDS)
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown config fields {sorted(unknown)}")
    kw = {}
    for k, v in cfg.items():
        if k not in fields:
            continue
        if k == "unet":
            v = _config(UNetConfig, v)
        kw[k] = tuple(v) if isinstance(v, list) else v
    return cls(**kw)


def _to_device(tree, device: torch.device, dtype: torch.dtype):
    """Every leaf as a torch tensor on ``device``, floating ones in
    ``dtype``: the layout changes to the port's then run there."""
    if isinstance(tree, dict):
        return {k: _to_device(v, device, dtype) for k, v in tree.items()}
    t = tree if isinstance(tree, torch.Tensor) else torch.from_numpy(tree)
    return t.to(device, dtype) if t.is_floating_point() else t.to(device)


def save_component(dirpath: str, module: nn.Module) -> None:
    """``config.json`` and ``params.safetensors`` (float32 Flax tree) of one
    of the port's models."""
    name = type(module).__name__
    if name not in _COMPONENTS:
        raise ValueError(f"no pipeline-directory layout for {name}")
    os.makedirs(dirpath, exist_ok=True)
    cfg = dataclasses.asdict(module.config)
    cfg["_class_name"] = name
    _write_json(os.path.join(dirpath, "config.json"), cfg)
    sd = {k: v.detach().float() for k, v in module.state_dict().items()}
    save_params(os.path.join(dirpath, "params.safetensors"), _COMPONENTS[name][3](sd))


def save_tokenizer(dirpath: str, tokenizer: CLIPTokenizer) -> None:
    os.makedirs(dirpath, exist_ok=True)
    _write_json(os.path.join(dirpath, "vocab.json"), tokenizer.encoder)
    merges = sorted(tokenizer.bpe_ranks.items(), key=lambda kv: kv[1])
    with open(os.path.join(dirpath, "merges.txt"), "w", encoding="utf-8") as f:
        f.write("#version: gmdx\n")
        for (a, b), _rank in merges:
            f.write(f"{a} {b}\n")


def save_scheduler(dirpath: str, scheduler) -> None:
    """The scheduler's config fields and constructor extras, as the JAX
    package writes them."""
    os.makedirs(dirpath, exist_ok=True)
    cfg = dataclasses.asdict(scheduler.config)
    for extra in _SCHEDULER_EXTRAS:
        if hasattr(scheduler, extra):
            cfg[extra] = getattr(scheduler, extra)
    cfg["_class_name"] = type(scheduler).__name__
    _write_json(os.path.join(dirpath, "config.json"), cfg)


def save_pipeline(
    path: str, *, components: dict[str, nn.Module], tokenizer: CLIPTokenizer | None = None,
    scheduler=None,
) -> None:
    """``components`` maps a subdirectory name ("unet", "gm_unet", "vae",
    "text_encoder", "controlnet") to one of the port's models."""
    os.makedirs(path, exist_ok=True)
    index = {"components": sorted(components)}
    for name, module in components.items():
        save_component(os.path.join(path, name), module)
    if tokenizer is not None:
        save_tokenizer(os.path.join(path, "tokenizer"), tokenizer)
        index["components"].append("tokenizer")
    if scheduler is not None:
        save_scheduler(os.path.join(path, "scheduler"), scheduler)
        index["components"].append("scheduler")
    _write_json(os.path.join(path, "model_index.json"), index)


def load_component(dirpath: str, *, device: str | torch.device = "cuda") -> nn.Module:
    """The model of one component directory, its weights carried from the
    Flax tree (``strict=True``), in eval mode on ``device``: bfloat16 on the
    card (the kernels' type), float32 on the CPU."""
    dev = resolve_device(device)
    cfg = _read_json(os.path.join(dirpath, "config.json"))
    name = cfg.pop("_class_name")
    if name == "StableDiffusionSafetyChecker":
        raise NotImplementedError(
            "the safety checker is not ported yet (ROADMAP Queue 1 item 10: "
            "`gmdx/models/safety_checker.py`, then `gmdx/pipelines/pp.py`)")
    if name not in _COMPONENTS:
        raise ValueError(f"unknown component class {name!r}")
    module_cls, config_cls, to_state_dict, _ = _COMPONENTS[name]
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    tree = load_params(os.path.join(dirpath, "params.safetensors"))
    sd = to_state_dict(_to_device(tree, dev, dtype))
    with torch.device("meta"):
        model = module_cls(_config(config_cls, cfg))
    model.load_state_dict(sd, strict=True, assign=True)
    return model.to(device=dev, dtype=dtype).eval()


def load_scheduler(dirpath: str):
    cfg = _read_json(os.path.join(dirpath, "config.json"))
    return get_scheduler(_SCHEDULER_NAMES[cfg.pop("_class_name")], **cfg)


def load_pipeline(path: str, *, device: str | torch.device = "cuda") -> dict[str, Any]:
    """Every component present: {"modules": {name: model}, "tokenizer":
    ..., "scheduler": ...} (None where absent)."""
    index = _read_json(os.path.join(path, "model_index.json"))
    out: dict[str, Any] = {"modules": {}, "tokenizer": None, "scheduler": None}
    for name in index["components"]:
        sub = os.path.join(path, name)
        if name == "tokenizer":
            out["tokenizer"] = CLIPTokenizer.from_pretrained(sub)
        elif name == "scheduler":
            out["scheduler"] = load_scheduler(sub)
        else:
            out["modules"][name] = load_component(sub, device=device)
    return out


__all__ = [
    "save_pipeline",
    "load_pipeline",
    "save_component",
    "load_component",
    "save_tokenizer",
    "save_scheduler",
    "load_scheduler",
]
