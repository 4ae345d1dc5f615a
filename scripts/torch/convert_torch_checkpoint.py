"""Convert checkpoints between diffusers / transformers and the pipeline
directory layout, from the port.

The counterpart of ``scripts/tools/convert_torch_checkpoint.py`` (the same
directions, flags, printed lines and files) on a machine without JAX,
``safetensors`` or ``ml_dtypes``. Import: a diffusers SD-1.5 pipeline
directory (``unet``, ``vae``, ``text_encoder``, optional ``gm_unet`` and
``safety_checker`` subdirectories of ``*.safetensors`` + ``config.json``, a
tokenizer and a scheduler config) becomes a pipeline directory that either
package loads; the component and scheduler configs are translated, not
assumed. Export: a pipeline directory becomes a diffusers-layout directory
(per-component ``config.json``, ``model_index.json``, the scheduler's
``scheduler_config.json``, the tokenizer) that diffusers'
``from_pretrained`` reads. Both are host-only numpy work: the weights go as
stored (float32 stays float32), through ``gmdx_torch.io.torch_import`` and
``to_flax`` (``convert``'s table for the safety checker) on import,
``io/params.py``'s ``load_params`` and ``convert.*_from_flax`` on export.

    python scripts/torch/convert_torch_checkpoint.py import \\
        --src /path/to/sd15-diffusers --dst ./pipe
    python scripts/torch/convert_torch_checkpoint.py export \\
        --src ./pipe --dst ./sd15-diffusers
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import shutil
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def _find_safetensors(subdir: str):
    """The full-precision weight file: ``.fp16.``, ``.bf16.`` and
    ``.non_ema.`` variants sort before the plain name and must not shadow
    it; one of them is taken only where no plain file exists."""
    cands = sorted(glob.glob(os.path.join(subdir, "*.safetensors")))
    if not cands:
        return None
    plain = [c for c in cands if ".fp16." not in c and ".bf16." not in c
             and ".non_ema." not in c]
    return (plain or cands)[0]


def _read_json(path: str):
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _write_json(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def _pick(src: dict, mapping: dict) -> dict:
    """{diffusers key: config field} for every key present in ``src``."""
    out = {}
    for k, field in mapping.items():
        if src and k in src and src[k] is not None:
            v = src[k]
            out[field] = tuple(v) if isinstance(v, list) else v
    return out


def _unet_config(src_cfg: dict | None, sd: dict):
    from gmdx_torch.models import UNetConfig

    kw = _pick(src_cfg or {}, {
        "out_channels": "out_channels",
        "block_out_channels": "block_out_channels",
        "layers_per_block": "layers_per_block",
        "cross_attention_dim": "cross_attention_dim",
        "down_block_types": "down_block_types",
        "up_block_types": "up_block_types",
        "sample_size": "sample_size",
    })
    # SD-1.5's config stores the head COUNT under attention_head_dim (the
    # diffusers quirk the reference's config surgery works around,
    # generate_hdr.py:99-113); num_attention_heads wins where it is set.
    heads = (src_cfg or {}).get("num_attention_heads") or (src_cfg or {}).get("attention_head_dim")
    if isinstance(heads, int):
        kw["num_attention_heads"] = heads
    # in_channels from the stored conv_in weight (OIHW): what the weights
    # are (8 channels for a GM UNet).
    kw["in_channels"] = int(sd["conv_in.weight"].shape[1])
    return UNetConfig(**kw)


def _vae_config(src_cfg: dict | None, sd: dict):
    from gmdx_torch.models import VAEConfig

    return VAEConfig(**_pick(src_cfg or {}, {
        "in_channels": "in_channels",
        "out_channels": "out_channels",
        "block_out_channels": "block_out_channels",
        "layers_per_block": "layers_per_block",
        "latent_channels": "latent_channels",
        "scaling_factor": "scaling_factor",
        "sample_size": "sample_size",
    }))


def _clip_config(src_cfg: dict | None, sd: dict):
    from gmdx_torch.models import CLIPTextConfig

    return CLIPTextConfig(**_pick(src_cfg or {}, {
        "vocab_size": "vocab_size",
        "hidden_size": "hidden_size",
        "num_hidden_layers": "num_layers",
        "num_attention_heads": "num_heads",
        "intermediate_size": "intermediate_size",
        "max_position_embeddings": "max_position_embeddings",
        "layer_norm_eps": "layer_norm_eps",
    }))


def _vision_config(src_cfg: dict | None, sd: dict):
    """The checker's config from transformers' ``vision_config``; the concept
    counts from the stored concept tensors (transformers' config has no
    field for them: diffusers fixes 17 and 3)."""
    from gmdx_torch.models import CLIPVisionConfig

    vision = (src_cfg or {}).get("vision_config") or {}
    kw = _pick(vision, {
        "image_size": "image_size",
        "patch_size": "patch_size",
        "hidden_size": "hidden_size",
        "num_hidden_layers": "num_layers",
        "num_attention_heads": "num_heads",
        "intermediate_size": "intermediate_size",
        "projection_dim": "projection_dim",
        "layer_norm_eps": "layer_norm_eps",
    })
    if "projection_dim" not in kw and src_cfg and "projection_dim" in src_cfg:
        kw["projection_dim"] = src_cfg["projection_dim"]
    for key, field in (("concept_embeds", "num_concepts"),
                       ("special_care_embeds", "num_special_concepts")):
        if key in sd:
            kw[field] = int(sd[key].shape[0])
    return CLIPVisionConfig(**kw)


# Scheduler constructor arguments by class, beyond SchedulerConfig's fields.
_SCHEDULER_EXTRAS_BY_CLASS = {
    "DDPMScheduler": {"variance_type"},
    "DPMSolverMultistepScheduler": {
        "solver_order", "lower_order_final", "use_karras_sigmas", "final_sigmas_type",
    },
    "LCMScheduler": {"original_inference_steps", "timestep_scaling", "sigma_data"},
}


def _import_scheduler(src: str):
    """The source's scheduler config translated; an unknown class, or none,
    defaults to PNDM (on the base fields), with a warning."""
    from gmdx_torch.io.pipeline import SCHEDULER_NAMES
    from gmdx_torch.schedulers import SchedulerConfig, get_scheduler

    cfg = _read_json(os.path.join(src, "scheduler", "scheduler_config.json"))
    if cfg is None:
        cfg = _read_json(os.path.join(src, "scheduler", "config.json"))
    if cfg is None:
        print("scheduler: no config in source, defaulting to PNDM")
        return get_scheduler("pndm")
    cls = cfg.get("_class_name", "PNDMScheduler")
    base_fields = {f.name for f in dataclasses.fields(SchedulerConfig)}
    if cls not in SCHEDULER_NAMES:
        print(f"scheduler: unknown class {cls!r}, defaulting to PNDM "
              "(re-check prediction_type/beta schedule manually)")
        return get_scheduler("pndm", **{k: v for k, v in cfg.items() if k in base_fields})
    allowed = base_fields | _SCHEDULER_EXTRAS_BY_CLASS.get(cls, set())
    return get_scheduler(SCHEDULER_NAMES[cls], **{k: v for k, v in cfg.items() if k in allowed})


def do_import(src: str, dst: str) -> None:
    from gmdx_torch.io import convert, to_flax, torch_import
    from gmdx_torch.io.params import flatten_tree, save_params
    from gmdx_torch.io.pipeline import save_scheduler, save_tokenizer
    from gmdx_torch.models import CLIPTokenizer

    os.makedirs(dst, exist_ok=True)
    components = []
    for name, normalise, to_tree, make_cfg, cls in (
        ("unet", torch_import.convert_unet_state_dict, to_flax.convert_unet_state_dict,
         _unet_config, "UNet2DConditionModel"),
        ("gm_unet", torch_import.convert_unet_state_dict, to_flax.convert_unet_state_dict,
         _unet_config, "UNet2DConditionModel"),
        ("vae", torch_import.convert_vae_state_dict, to_flax.convert_vae_state_dict,
         _vae_config, "AutoencoderKL"),
        ("text_encoder", torch_import.convert_clip_text_state_dict,
         to_flax.convert_clip_text_state_dict, _clip_config, "CLIPTextModel"),
        ("safety_checker", torch_import.convert_safety_checker_state_dict,
         convert.safety_checker_flax_from_state_dict, _vision_config,
         "StableDiffusionSafetyChecker"),
    ):
        sub = os.path.join(src, name)
        st_path = _find_safetensors(sub) if os.path.isdir(sub) else None
        if st_path is None:
            if name not in ("gm_unet", "safety_checker"):
                print(f"{name}: not found in {src}, skipped")
            continue
        sd = torch_import.load_torch_safetensors(st_path)
        config = make_cfg(_read_json(os.path.join(sub, "config.json")), sd)
        tree = to_tree(normalise(sd, config))
        out = os.path.join(dst, name)
        os.makedirs(out, exist_ok=True)
        _write_json(os.path.join(out, "config.json"),
                    {**dataclasses.asdict(config), "_class_name": cls})
        save_params(os.path.join(out, "params.safetensors"), tree)
        components.append(name)
        n = sum(v.size for v in flatten_tree(tree).values())
        print(f"{name}: {n / 1e6:.1f}M params")

    tok_src = os.path.join(src, "tokenizer")
    if os.path.isdir(tok_src):
        save_tokenizer(os.path.join(dst, "tokenizer"), CLIPTokenizer.from_pretrained(tok_src))
        components.append("tokenizer")
    save_scheduler(os.path.join(dst, "scheduler"), _import_scheduler(src))
    components.append("scheduler")
    _write_json(os.path.join(dst, "model_index.json"), {"components": sorted(components)})
    print(f"imported -> {dst} ({sorted(components)})")


# ---------------------------------------------------------------------------
# Export: pipeline directory -> diffusers layout
# ---------------------------------------------------------------------------


def _unet_diffusers_config(cfg) -> dict:
    return {
        "_class_name": "UNet2DConditionModel",
        "in_channels": cfg.in_channels,
        "out_channels": cfg.out_channels,
        "block_out_channels": list(cfg.block_out_channels),
        "layers_per_block": cfg.layers_per_block,
        # SD-1.5's quirk kept: the head count under attention_head_dim.
        "attention_head_dim": cfg.num_attention_heads,
        "cross_attention_dim": cfg.cross_attention_dim,
        "down_block_types": list(cfg.down_block_types),
        "up_block_types": list(cfg.up_block_types),
        "sample_size": cfg.sample_size,
        "act_fn": "silu",
        "norm_num_groups": 32,
        "norm_eps": 1e-05,
        "center_input_sample": False,
        "downsample_padding": 1,
        "flip_sin_to_cos": True,
        "freq_shift": 0,
        "mid_block_scale_factor": 1,
    }


def _vae_diffusers_config(cfg) -> dict:
    n = len(cfg.block_out_channels)
    return {
        "_class_name": "AutoencoderKL",
        "in_channels": cfg.in_channels,
        "out_channels": cfg.out_channels,
        "block_out_channels": list(cfg.block_out_channels),
        "layers_per_block": cfg.layers_per_block,
        "latent_channels": cfg.latent_channels,
        "scaling_factor": cfg.scaling_factor,
        "sample_size": cfg.sample_size,
        "down_block_types": ["DownEncoderBlock2D"] * n,
        "up_block_types": ["UpDecoderBlock2D"] * n,
        "act_fn": "silu",
        "norm_num_groups": 32,
    }


def _clip_transformers_config(cfg) -> dict:
    return {
        "architectures": ["CLIPTextModel"],
        "model_type": "clip_text_model",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "num_hidden_layers": cfg.num_layers,
        "num_attention_heads": cfg.num_heads,
        "intermediate_size": cfg.intermediate_size,
        "max_position_embeddings": cfg.max_position_embeddings,
        "layer_norm_eps": cfg.layer_norm_eps,
        "hidden_act": "quick_gelu",
    }


def _checker_transformers_config(cfg) -> dict:
    return {
        "architectures": ["StableDiffusionSafetyChecker"],
        "model_type": "clip",
        "projection_dim": cfg.projection_dim,
        "vision_config": {
            "model_type": "clip_vision_model",
            "image_size": cfg.image_size,
            "patch_size": cfg.patch_size,
            "hidden_size": cfg.hidden_size,
            "num_hidden_layers": cfg.num_layers,
            "num_attention_heads": cfg.num_heads,
            "intermediate_size": cfg.intermediate_size,
            "projection_dim": cfg.projection_dim,
            "layer_norm_eps": cfg.layer_norm_eps,
            "hidden_act": "quick_gelu",
        },
    }


def do_export(src: str, dst: str) -> None:
    from gmdx_torch.io import convert
    from gmdx_torch.io.params import load_params, save_file
    from gmdx_torch.io.pipeline import component_config, load_scheduler, scheduler_config

    # name -> (Flax tree -> state dict, weight file, config, (library, class))
    exporters = {
        "unet": (convert.unet_state_dict_from_flax, "diffusion_pytorch_model.safetensors",
                 _unet_diffusers_config, ("diffusers", "UNet2DConditionModel")),
        "gm_unet": (convert.unet_state_dict_from_flax, "diffusion_pytorch_model.safetensors",
                    _unet_diffusers_config, ("diffusers", "UNet2DConditionModel")),
        "vae": (convert.vae_state_dict_from_flax, "diffusion_pytorch_model.safetensors",
                _vae_diffusers_config, ("diffusers", "AutoencoderKL")),
        "text_encoder": (convert.clip_text_state_dict_from_flax, "model.safetensors",
                         _clip_transformers_config, ("transformers", "CLIPTextModel")),
        "safety_checker": (convert.safety_checker_state_dict_from_flax, "model.safetensors",
                           _checker_transformers_config,
                           ("transformers", "StableDiffusionSafetyChecker")),
    }
    index = {"_class_name": "StableDiffusionPipeline", "_diffusers_version": "0.27.0"}
    names = _read_json(os.path.join(src, "model_index.json"))["components"]
    for name in names:
        if name in ("tokenizer", "scheduler"):
            continue
        if name not in exporters:
            print(f"{name}: no exporter, skipped")
            continue
        to_state_dict, fname, cfg_fn, lib_cls = exporters[name]
        sub, out = os.path.join(src, name), os.path.join(dst, name)
        os.makedirs(out, exist_ok=True)
        # The stored trees as they are, on the host: never through the
        # card's bfloat16 copies of load_pipeline.
        tree = load_params(os.path.join(sub, "params.safetensors"))
        save_file(to_state_dict(tree), os.path.join(out, fname))
        _write_json(os.path.join(out, "config.json"), cfg_fn(component_config(sub)[1]))
        index[name] = list(lib_cls)
        print(f"{name} -> {out}/{fname}")
    if "scheduler" in names:
        sched = load_scheduler(os.path.join(src, "scheduler"))
        out = os.path.join(dst, "scheduler")
        os.makedirs(out, exist_ok=True)
        _write_json(os.path.join(out, "scheduler_config.json"), scheduler_config(sched))
        index["scheduler"] = ["diffusers", type(sched).__name__]
        print(f"scheduler -> {out}/scheduler_config.json")
    tok_src = os.path.join(src, "tokenizer")
    if os.path.isdir(tok_src):
        out = os.path.join(dst, "tokenizer")
        os.makedirs(out, exist_ok=True)
        for fn in ("vocab.json", "merges.txt"):
            p = os.path.join(tok_src, fn)
            if os.path.exists(p):
                shutil.copy(p, os.path.join(out, fn))
        index["tokenizer"] = ["transformers", "CLIPTokenizer"]
        print(f"tokenizer -> {out}")
    _write_json(os.path.join(dst, "model_index.json"), index)
    print(f"exported -> {dst}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("direction", choices=["import", "export"])
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    args = p.parse_args(argv)
    if args.direction == "import":
        do_import(args.src, args.dst)
    else:
        do_export(args.src, args.dst)


if __name__ == "__main__":
    main()
