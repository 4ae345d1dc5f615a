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
for the CPU (float32 there). A Stage-1 ``Discriminator`` is a component
too, in the JAX trainer's layout: ``config.json`` holds ``depth`` and
``hidden_channels``, ``params.safetensors`` its ``params`` and the
spectral-norm ``batch_stats``; it loads in float32 (the power-iteration
state is float32 in both packages). So does a ``StableDiffusionSafetyChecker``
(its ``CLIPVisionConfig`` in ``config.json``): both packages compute it in
float32, and its flags are thresholds on cosines.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
from typing import Any, Sequence

import torch
from torch import nn

from gmdx_torch import resolve_device
from gmdx_torch.dist.tp import assign_state_dict, tp_shard_state_dict
from gmdx_torch.io import convert, to_flax
from gmdx_torch.io.params import load_params, save_params
from gmdx_torch.models import (
    AutoencoderKL,
    CLIPTextConfig,
    CLIPTextModel,
    CLIPTokenizer,
    CLIPVisionConfig,
    ControlNetConfig,
    ControlNetModel,
    Discriminator,
    StableDiffusionSafetyChecker,
    UNet2DConditionModel,
    UNetConfig,
    VAEConfig,
)
from gmdx_torch.schedulers import get_scheduler

# class name -> (module class, config class (None: keyword arguments),
# Flax tree -> state dict, state dict -> Flax tree)
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
    "Discriminator": (Discriminator, None,
                      lambda tree: convert.discriminator_state_dict_from_flax(
                          tree.get("params", {}), tree.get("batch_stats", {})),
                      convert.discriminator_flax_from_state_dict),
    "StableDiffusionSafetyChecker": (StableDiffusionSafetyChecker, CLIPVisionConfig,
                                     convert.safety_checker_state_dict_from_flax,
                                     convert.safety_checker_flax_from_state_dict),
}
# Components that load in float32 on the card too.
_FLOAT32_COMPONENTS = ("Discriminator", "StableDiffusionSafetyChecker")
SCHEDULER_NAMES = {
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
    """A config dataclass from its JSON: lists become tuples."""
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(cfg) - fields
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown config fields {sorted(unknown)}")
    kw = {}
    for k, v in cfg.items():
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
    if name == "Discriminator":
        cfg = {"depth": module.depth, "hidden_channels": module.hidden_channels}
    else:
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


def scheduler_config(scheduler) -> dict:
    """The scheduler's config fields, constructor extras and
    ``_class_name``, as the JAX package writes them."""
    cfg = dataclasses.asdict(scheduler.config)
    for extra in _SCHEDULER_EXTRAS:
        if hasattr(scheduler, extra):
            cfg[extra] = getattr(scheduler, extra)
    cfg["_class_name"] = type(scheduler).__name__
    return cfg


def save_scheduler(dirpath: str, scheduler) -> None:
    os.makedirs(dirpath, exist_ok=True)
    _write_json(os.path.join(dirpath, "config.json"), scheduler_config(scheduler))


def save_pipeline(
    path: str, *, components: dict[str, nn.Module], tokenizer: CLIPTokenizer | None = None,
    scheduler=None, copy_from: dict[str, str] | None = None,
) -> None:
    """``components`` maps a subdirectory name ("unet", "gm_unet", "vae",
    "text_encoder", "safety_checker", "controlnet") to one of the port's
    models;
    ``copy_from`` maps further names to component directories copied as
    they are (a frozen component keeps its stored float32 weights, which a
    copy on the card holds only in bfloat16)."""
    os.makedirs(path, exist_ok=True)
    copy_from = dict(copy_from or {})
    index = {"components": sorted(set(components) | set(copy_from))}
    for name, module in components.items():
        save_component(os.path.join(path, name), module)
    for name, src in copy_from.items():
        dst = os.path.join(path, name)
        shutil.rmtree(dst, ignore_errors=True)
        shutil.copytree(src, dst)
    if tokenizer is not None:
        save_tokenizer(os.path.join(path, "tokenizer"), tokenizer)
        index["components"].append("tokenizer")
    if scheduler is not None:
        save_scheduler(os.path.join(path, "scheduler"), scheduler)
        index["components"].append("scheduler")
    _write_json(os.path.join(path, "model_index.json"), index)


def component_config(dirpath: str) -> tuple[str, Any]:
    """(class name, config) of a component directory: its config dataclass,
    or the keyword arguments of a class that takes none (the
    Discriminator). An unknown class raises."""
    cfg = _read_json(os.path.join(dirpath, "config.json"))
    name = cfg.pop("_class_name")
    if name not in _COMPONENTS:
        raise ValueError(f"unknown component class {name!r}")
    config_cls = _COMPONENTS[name][1]
    return name, cfg if config_cls is None else _config(config_cls, cfg)


def load_component(dirpath: str, *, device: str | torch.device = "cuda",
                   dtype: torch.dtype | None = None,
                   tp: tuple[int, int] | None = None) -> nn.Module:
    """The model of one component directory, its weights carried from the
    Flax tree (``strict=True``), in eval mode on ``device``: bfloat16 on the
    card (the kernels' type), float32 on the CPU, and float32 everywhere
    for a Discriminator and a safety checker (the JAX package's checker
    computes in float32, and its output is a threshold on a cosine),
    unless ``dtype`` says otherwise (a trainer's float32 master weights).
    With ``tp = (rank, size)`` the module holds rank ``rank``'s tensor-parallel
    slices of its weights (``gmdx_torch.dist.tp``), cut from the one load."""
    dev = resolve_device(device)
    name, config = component_config(dirpath)
    module_cls, _, to_state_dict, _ = _COMPONENTS[name]
    if dtype is None:
        bf16 = dev.type == "cuda" and name not in _FLOAT32_COMPONENTS
        dtype = torch.bfloat16 if bf16 else torch.float32
    tree = load_params(os.path.join(dirpath, "params.safetensors"))
    sd = to_state_dict(_to_device(tree, dev, dtype))
    with torch.device("meta"):
        model = module_cls(**config) if isinstance(config, dict) else module_cls(config)
    if tp is not None and tp[1] > 1:
        assign_state_dict(model, tp_shard_state_dict(sd, *tp))
    else:
        model.load_state_dict(sd, strict=True, assign=True)
    return model.to(device=dev, dtype=dtype).eval()


def load_scheduler(dirpath: str):
    cfg = _read_json(os.path.join(dirpath, "config.json"))
    return get_scheduler(SCHEDULER_NAMES[cfg.pop("_class_name")], **cfg)


def load_pipeline(path: str, *, device: str | torch.device = "cuda",
                  components: Sequence[str] | None = None,
                  tp: tuple[int, int] | None = None) -> dict[str, Any]:
    """Every component present, or those named in ``components``:
    {"modules": {name: model}, "tokenizer": ..., "scheduler": ...} (None
    where absent or not asked for); with ``tp = (rank, size)`` each model
    holds that rank's tensor-parallel slices (:func:`load_component`)."""
    index = _read_json(os.path.join(path, "model_index.json"))
    out: dict[str, Any] = {"modules": {}, "tokenizer": None, "scheduler": None}
    for name in index["components"]:
        if components is not None and name not in components:
            continue
        sub = os.path.join(path, name)
        if name == "tokenizer":
            out["tokenizer"] = CLIPTokenizer.from_pretrained(sub)
        elif name == "scheduler":
            out["scheduler"] = load_scheduler(sub)
        else:
            out["modules"][name] = load_component(sub, device=device, tp=tp)
    return out


__all__ = [
    "save_pipeline",
    "load_pipeline",
    "save_component",
    "load_component",
    "save_tokenizer",
    "save_scheduler",
    "scheduler_config",
    "component_config",
    "load_scheduler",
]
