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

Each frame's rows split over S cards, a process a card (the JAX script's
--sp_size over its devices):

    torchrun --nproc_per_node S scripts/torch/upconvert_hdrtv.py ... --sp_size S

Every rank computes the same frames; rank 0 alone writes them. main()
returns what it wrote, as float arrays by file name.

--xattn_kernel, --fused_addln and --winograd_m {2,4} stand for the JAX
package's GMDX_XATTN_KERNEL, GMDX_FUSED_ADDLN and GMDX_WINOGRAD_M toggles
(``gmdx_torch.kernel_flags``), set on every module.
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
                   help="spatial-parallel width: split each frame's rows over this many ranks "
                        "(conv halos, K/V gathers, merged GroupNorm statistics), the weights "
                        "whole on each; run under torchrun with exactly this world size (the JAX "
                        "script takes its first sp devices; a rank cannot sit out, so any other "
                        "world size raises). 1 = one process (default)")
    p.add_argument("--low_memory", action="store_true",
                   help="sequential CFG: the uncond and cond ControlNet + UNet passes one "
                        "after the other")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    from gmdx_torch.kernel_flags import add_kernel_flags

    add_kernel_flags(p, train=False)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from gmdx_torch.dist.tpctx import join_model_parallel, parallel_context

    par = join_model_parallel(1, args.sp_size)

    import contextlib

    import numpy as np
    import torch

    from gmdx_torch import dist, resolve_device
    from gmdx_torch.io import (
        controlnet_state_dict_from_unet, load_component, load_image, load_pipeline,
        save_hdr_image, save_image,
    )
    from gmdx_torch.kernel_flags import apply_kernel_flags
    from gmdx_torch.models import ControlNetConfig, ControlNetModel
    from gmdx_torch.pipelines import StableDiffusionControlNetHDRPipeline, upconvert_sdr_to_hdrtv

    dev = dist.device(resolve_device(args.device))
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
    apply_kernel_flags(args, cnet, *mods.values())
    pipe = StableDiffusionControlNetHDRPipeline(
        mods["unet"], mods["vae"], bundle["scheduler"], mods["gm_unet"], cnet,
        text_encoder=mods["text_encoder"], tokenizer=bundle["tokenizer"], device=dev)

    writes = dist.is_main_process()
    if writes:
        os.makedirs(args.output_dir, exist_ok=True)
    written = {}

    def save(fname, arr, hdr=False):
        written[fname] = arr
        if writes:
            path = os.path.join(args.output_dir, fname)
            save_hdr_image(path, arr, qmax=args.qmax) if hdr else save_image(path, arr)

    pngs = sorted(glob.glob(os.path.join(args.sdr_input_path, "*.png")))[: args.max_images]
    # Under --sp_size each rank conditions on, samples and decodes its rows
    # of every frame (upconvert_sdr_to_hdrtv splits the whole frame).
    with parallel_context(par[0], par[1]) if par else contextlib.nullcontext():
        for i, path in enumerate(pngs):
            name = os.path.splitext(os.path.basename(path))[0]
            sdr01 = load_image(path, size=(args.resolution, args.resolution))
            sdr_in = torch.from_numpy(np.ascontiguousarray(sdr01.transpose(2, 0, 1)))[None]
            sdr_out, gm_out, hdr = upconvert_sdr_to_hdrtv(
                pipe, sdr_in, args.prompt,
                generator=torch.Generator(device=dev).manual_seed(args.seed * 2**20 + i),
                num_inference_steps=args.num_inference_steps,
                guidance_scale=args.guidance_scale,
                conditioning_scale=args.conditioning_scale, qmax=args.qmax,
                low_memory=args.low_memory,
            )
            save(f"sdr_{name}.png", sdr_out[0])
            save(f"gm_{name}.png", gm_out[0])
            save(f"hdrtv_{name}.hdr", hdr[0].transpose(1, 2, 0), hdr=True)
            print(f"[{i + 1}/{len(pngs)}] {name}")
    return written


if __name__ == "__main__":
    main()
