"""SDR->HDRTV up-conversion CLI of the port with ControlNet conditioning (the
counterpart of ``scripts/inference/upconvert_hdrtv.py``, the same flags plus
``--device``).

The input SDR frame conditions the SDR branch through the ControlNet while
the GM branch synthesises the gain map jointly; each frame goes out as
sdr_*.png, gm_*.png and a Radiance hdrtv_*.hdr (Eq. (1) from the input
frame, values over qmax + 1). Without --controlnet_ckpt the ControlNet is
the zero adapter: the pipeline UNet's encoder copied, its output convs zero.
Frame i's generator is seeded from (--seed, i); the draws are torch's, not
the JAX package's.

    python scripts/torch/upconvert_hdrtv.py --pretrained_model_name_or_path DIR \\
        --sdr_input_path PNGS --output_dir OUT [--device cpu]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--pretrained_model_name_or_path", required=True,
                   help="dual pipeline dir (unet/gm_unet/vae/text_encoder)")
    p.add_argument("--controlnet_ckpt", default=None,
                   help="controlnet component dir; default = encoder copy of the pipeline's "
                        "unet (zero adapter)")
    p.add_argument("--sdr_input_path", required=True)
    p.add_argument("--output_dir", default="hdrtv_outputs")
    p.add_argument("--resolution", type=int, default=1024)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--guidance_scale", type=float, default=7.5)
    p.add_argument("--conditioning_scale", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--qmax", type=float, default=99.0)
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--prompt", default="high dynamic range, HDR10, 4000 nits peak brightness")
    p.add_argument("--sp_size", type=int, default=1,
                   help="spatial-parallel width; only 1 (the port has no distribution yet)")
    p.add_argument("--low_memory", action="store_true",
                   help="sequential CFG: the uncond and cond ControlNet + UNet passes one "
                        "after the other")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    if args.sp_size > 1:
        raise NotImplementedError(
            "--sp_size > 1: the port has no spatial parallelism yet (ROADMAP Queue 1 item 9: "
            "`gmdx/dist/{tp,tpctx}.py` -> torch.distributed)")

    import numpy as np
    import torch

    from gmdx_torch import resolve_device
    from gmdx_torch.io import (
        controlnet_state_dict_from_unet, load_component, load_image, load_pipeline,
        save_hdr_image, save_image,
    )
    from gmdx_torch.models import ControlNetConfig, ControlNetModel
    from gmdx_torch.pipelines import StableDiffusionControlNetHDRPipeline, upconvert_sdr_to_hdrtv

    dev = resolve_device(args.device)
    bundle = load_pipeline(args.pretrained_model_name_or_path, device=dev)
    mods = bundle["modules"]
    if args.controlnet_ckpt:
        cnet = load_component(args.controlnet_ckpt, device=dev)
    else:
        unet = mods["unet"]
        with torch.device(dev):
            cnet = ControlNetModel(ControlNetConfig(unet=unet.config))
        cnet = cnet.to(next(unet.parameters()).dtype).eval()
        cnet.load_state_dict(controlnet_state_dict_from_unet(cnet.state_dict(),
                                                             unet.state_dict()))
        print("no --controlnet_ckpt: using zero adapter from UNet encoder")
    pipe = StableDiffusionControlNetHDRPipeline(
        mods["unet"], mods["vae"], bundle["scheduler"], mods["gm_unet"], cnet,
        text_encoder=mods["text_encoder"], tokenizer=bundle["tokenizer"], device=dev)

    os.makedirs(args.output_dir, exist_ok=True)
    pngs = sorted(glob.glob(os.path.join(args.sdr_input_path, "*.png")))[: args.max_images]
    for i, path in enumerate(pngs):
        name = os.path.splitext(os.path.basename(path))[0]
        sdr01 = load_image(path, size=(args.resolution, args.resolution))
        sdr_in = torch.from_numpy(np.ascontiguousarray(sdr01.transpose(2, 0, 1)))[None]
        sdr_out, gm_out, hdr = upconvert_sdr_to_hdrtv(
            pipe, sdr_in, args.prompt,
            generator=torch.Generator(device=dev).manual_seed(args.seed * 2**20 + i),
            num_inference_steps=args.num_inference_steps, guidance_scale=args.guidance_scale,
            conditioning_scale=args.conditioning_scale, qmax=args.qmax,
            low_memory=args.low_memory,
        )
        save_image(os.path.join(args.output_dir, f"sdr_{name}.png"), sdr_out[0])
        save_image(os.path.join(args.output_dir, f"gm_{name}.png"), gm_out[0])
        save_hdr_image(os.path.join(args.output_dir, f"hdrtv_{name}.hdr"),
                       hdr[0].transpose(1, 2, 0), qmax=args.qmax)
        print(f"[{i + 1}/{len(pngs)}] {name}")


if __name__ == "__main__":
    main()
