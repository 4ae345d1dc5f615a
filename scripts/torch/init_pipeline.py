"""Write a pipeline directory with seeded random weights, from the port.

The counterpart of ``scripts/tools/init_pipeline.py`` (the same flags and the
same layout, ``gmdx_torch/io/pipeline.py``) on a machine without JAX: the
port's models are built with PyTorch's default initialisation under
``torch.manual_seed(--seed)``, at SD-1.5 width (``--size sd15``: two UNets of
~860 M parameters, the VAE and CLIP ViT-L: 7.70 GB of float32 with
``--dual``) or test scale (``--size tiny``), and written as float32 Flax
trees that either package loads.

    python scripts/torch/init_pipeline.py --output_dir DIR --size tiny --dual \\
        --scheduler dpm++ --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--size", choices=["sd15", "tiny"], default="tiny")
    p.add_argument("--dual", action="store_true",
                   help="also write the 8-channel gm_unet (dual-UNet pipelines)")
    p.add_argument("--gm_only", action="store_true",
                   help="write the 8-channel UNet as 'unet' (single-UNet GM pipeline)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--scheduler", default="pndm", choices=["pndm", "ddpm", "ddim", "dpm++", "lcm"])
    p.add_argument("--device", default="cuda",
                   help="where the weights are drawn (cuda, or cpu)")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)

    import torch

    from gmdx_torch import resolve_device
    from gmdx_torch.io.pipeline import save_pipeline
    from gmdx_torch.models import (
        CLIP_VIT_L_CONFIG, SD15_GM_UNET_CONFIG, SD15_UNET_CONFIG, SD15_VAE_CONFIG,
        TINY_CLIP_CONFIG, TINY_UNET_CONFIG, TINY_VAE_CONFIG, AutoencoderKL, CLIPTextModel,
        CLIPTokenizer, UNet2DConditionModel,
    )
    from gmdx_torch.schedulers import get_scheduler

    dev = resolve_device(args.device)
    if args.size == "sd15":
        unet_cfg, gm_cfg = SD15_UNET_CONFIG, SD15_GM_UNET_CONFIG
        vae_cfg, clip_cfg = SD15_VAE_CONFIG, CLIP_VIT_L_CONFIG
    else:
        unet_cfg, gm_cfg = TINY_UNET_CONFIG, dataclasses.replace(TINY_UNET_CONFIG, in_channels=8)
        vae_cfg, clip_cfg = TINY_VAE_CONFIG, TINY_CLIP_CONFIG

    torch.manual_seed(args.seed)
    components = {}
    with torch.device(dev):
        print(f"init unet ({args.size}, in={8 if args.gm_only else unet_cfg.in_channels})...",
              flush=True)
        components["unet"] = UNet2DConditionModel(gm_cfg if args.gm_only else unet_cfg)
        if args.dual:
            print("init gm_unet...", flush=True)
            components["gm_unet"] = UNet2DConditionModel(gm_cfg)
        print("init vae...", flush=True)
        components["vae"] = AutoencoderKL(vae_cfg)
        print("init text_encoder...", flush=True)
        components["text_encoder"] = CLIPTextModel(clip_cfg)
    save_pipeline(args.output_dir, components=components, tokenizer=CLIPTokenizer.tiny(),
                  scheduler=get_scheduler(args.scheduler))
    print(f"wrote pipeline to {args.output_dir}")


if __name__ == "__main__":
    main()
