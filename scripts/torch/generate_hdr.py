"""SDR->HDR up-conversion CLI of the port (the counterpart of
``scripts/inference/generate_hdr.py``, the same flag surface plus
``--device``).

For each PNG under --sdr_input_path: resize to --resolution (PIL's BICUBIC),
normalise to [-1, 1], VAE-encode (x scaling factor), run the single-UNet GM
pipeline with the directory's sampler, decode the SDR round trip and the
gain map, save sdr_*.png and gm_*.png, and reconstruct HDR by Eq. (1)
(qmax) from both the decoded and the original SDR into hdr_decoded_*.hdr and
hdr_original_*.hdr (Radiance, values over qmax + 1).

Per-image seeds come from zlib.crc32 of the file's name, as in the JAX
script; the draws are torch generators', so they differ from the JAX
package's, and the flow is the same: one generator per image for the
encode, and the chunk's first image's second stream for the sampling loop.

    python scripts/torch/generate_hdr.py --pretrained_model_name_or_path DIR \\
        --unet_ckpt DIR/gm_unet --sdr_input_path PNGS --output_dir OUT [--device cpu]

Split over several cards, a process a card under torchrun (the JAX script's
--tp_size/--sp_size over its devices):

    torchrun --nproc_per_node N scripts/torch/generate_hdr.py ... --tp_size T
    torchrun --nproc_per_node S scripts/torch/generate_hdr.py ... --sp_size S

--tp_size T splits every layer over groups of T ranks (N a multiple of T;
the groups beyond the first repeat its work, as the JAX script's replicated
data axis does); --sp_size S splits each image's rows over the S ranks, with
the whole weights on each. Every rank computes the same images; rank 0
alone writes them. main() returns what it wrote, as float arrays by file
name.

--xattn_kernel, --fused_addln and --winograd_m {2,4} stand for the JAX
package's GMDX_XATTN_KERNEL, GMDX_FUSED_ADDLN and GMDX_WINOGRAD_M toggles
(``gmdx_torch.kernel_flags``), set on every module.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import os
import sys
import zlib

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Test the trained model.")
    p.add_argument("--pretrained_model_name_or_path", type=str, required=True,
                   help="Path to the pipeline directory (vae/text_encoder/tokenizer/scheduler).")
    p.add_argument("--unet_ckpt", type=str, required=True,
                   help="Path to the trained GM UNet component (or pipeline dir).")
    p.add_argument("--sdr_input_path", type=str, required=True,
                   help="Path to the input SDR image directory.")
    p.add_argument("--output_dir", type=str, default="test_outputs")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--qmax", type=float, default=99.0)
    p.add_argument("--prompt", type=str, default="high quality, high dynamic range, 8k resolution")
    p.add_argument("--tp_size", type=int, default=1,
                   help="tensor-parallel width: split every layer over this many ranks "
                        "(gmdx_torch.dist.tp's Megatron-style slices); run under torchrun with "
                        "a multiple of it as the world size. 1 = one process (default)")
    p.add_argument("--batch_size", type=int, default=1,
                   help="frames per sampling-loop call; batch > 1 draws the sampling noise "
                        "per chunk (different draws, same model)")
    p.add_argument("--sp_size", type=int, default=1,
                   help="spatial-parallel width: split each image's rows over this many ranks "
                        "(conv halos, K/V gathers, merged GroupNorm statistics), the weights "
                        "whole on each; run under torchrun with exactly this world size (the JAX "
                        "script takes its first sp devices; a rank cannot sit out, so any other "
                        "world size raises). Mutually exclusive with --tp_size. 1 = one process "
                        "(default)")
    p.add_argument("--low_memory", action="store_true",
                   help="sequential CFG: the uncond and cond UNet passes one after the other")
    p.add_argument("--aot_cache", action="store_true",
                   help="the JAX package's export cache; refused by the port")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    from gmdx_torch.kernel_flags import add_kernel_flags

    add_kernel_flags(p, train=False)
    return p.parse_args(argv)


def image_seed(seed: int, name: str, stream: int) -> int:
    """The seed of one image's stream (0 encode, 1 sampling), from --seed and
    zlib.crc32 of its name (stable across processes, unlike hash())."""
    return ((seed * 2**31 + zlib.crc32(name.encode()) % 2**31) * 2 + stream) % 2**63


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.aot_cache:
        raise NotImplementedError("--aot_cache is the JAX package's export cache "
                                  "(.cache/jax_export/); the port has none")
    from gmdx_torch.dist.tpctx import join_model_parallel

    par = join_model_parallel(args.tp_size, args.sp_size)

    import numpy as np
    import torch

    from gmdx_torch import dist, resolve_device
    from gmdx_torch.dist import tpctx
    from gmdx_torch.dist.mesh import shard_rows
    from gmdx_torch.io import (
        load_component, load_image, load_pipeline, save_hdr_image, save_image, to_model_input,
    )
    from gmdx_torch.kernel_flags import apply_kernel_flags
    from gmdx_torch.ops import apply_gm_to_sdr
    from gmdx_torch.pipelines import StableDiffusionGMPipeline

    dev = dist.device(resolve_device(args.device))
    writes = dist.is_main_process()
    if writes:
        os.makedirs(args.output_dir, exist_ok=True)
    tp = par[2:] if par is not None and par[0] == "tp" else None
    # The GM UNet comes from --unet_ckpt: the directory's UNets (and any
    # safety checker, which this CLI does not apply) stay on disk.
    bundle = load_pipeline(args.pretrained_model_name_or_path, device=dev, tp=tp,
                           components=("vae", "text_encoder", "tokenizer", "scheduler"))
    unet_dir = args.unet_ckpt
    if os.path.isdir(os.path.join(unet_dir, "unet")):
        unet_dir = os.path.join(unet_dir, "unet")
    unet = load_component(unet_dir, device=dev, tp=tp)
    if unet.config.in_channels != 8:
        raise ValueError(f"--unet_ckpt must be the 8-channel GM UNet, got "
                         f"in_channels={unet.config.in_channels}")
    mods = bundle["modules"]
    apply_kernel_flags(args, unet, *mods.values())
    pipe = StableDiffusionGMPipeline(unet, mods["vae"], bundle["scheduler"],
                                     text_encoder=mods["text_encoder"],
                                     tokenizer=bundle["tokenizer"], device=dev)

    pngs = sorted(glob.glob(os.path.join(args.sdr_input_path, "*.png")))
    if not pngs:
        raise FileNotFoundError(f"no .png files under {args.sdr_input_path}")
    print(f"found {len(pngs)} SDR images")

    def generator(name, stream):
        return torch.Generator(device=dev).manual_seed(image_seed(args.seed, name, stream))

    written = {}

    def save(fname, arr, hdr=False):
        written[fname] = arr
        if writes:
            path = os.path.join(args.output_dir, fname)
            save_hdr_image(path, arr, qmax=args.qmax) if hdr else save_image(path, arr)

    bs = max(1, args.batch_size)
    with (tpctx.parallel_context(par[0], par[1]) if par else contextlib.nullcontext()) as ctx:
        sp = ctx if par is not None and par[0] == "sp" else None
        for start in range(0, len(pngs), bs):
            names, origs, latents = [], [], []
            for path in pngs[start:start + bs]:
                name = os.path.splitext(os.path.basename(path))[0]
                sdr01 = load_image(path, size=(args.resolution, args.resolution))
                names.append(name)
                origs.append(torch.from_numpy(np.ascontiguousarray(sdr01.transpose(2, 0, 1))))
                sdr_in = torch.from_numpy(to_model_input(sdr01))
                if sp is not None:  # this rank's rows of the image
                    sdr_in = shard_rows(sdr_in, sp)
                latents.append(pipe.encode_sdr(sdr_in, generator(name, 0)))
            sdr_latent = torch.cat(latents)
            gm_latent = pipe(sdr_latent, [args.prompt] * len(names),
                             generator=generator(names[0], 1),
                             num_inference_steps=args.num_inference_steps,
                             output_type="latent", low_memory=args.low_memory)
            dec_sdr01 = (pipe.decode_latents(sdr_latent) / 2 + 0.5).clamp(0, 1).float().cpu()
            gm01 = (pipe.decode_latents(gm_latent) / 2 + 0.5).clamp(0, 1).float().cpu()
            for b, name in enumerate(names):
                save(f"sdr_{name}.png", dec_sdr01[b].permute(1, 2, 0).numpy())
                save(f"gm_{name}.png", gm01[b].permute(1, 2, 0).numpy())
                for tag, base in (("decoded", dec_sdr01[b]), ("original", origs[b])):
                    hdr = apply_gm_to_sdr(gm01[b], base, qmax=args.qmax, clip_output=False)
                    save(f"hdr_{tag}_{name}.hdr", hdr.permute(1, 2, 0).numpy(), hdr=True)
                print(f"{name}: done")
    return written


if __name__ == "__main__":
    main()
