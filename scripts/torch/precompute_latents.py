"""Precompute the frozen VAE's posterior latents of a Stage-2 parquet, with
the port (the counterpart of ``scripts/tools/precompute_latents.py``: the
same flags, plus ``--device``, and the same ``.npz``).

One pass decodes every pair (center crop, no flip), encodes both images by
the frozen VAE on the card, and writes the posterior (mean, std) in float16
with the tokenized captions, the resolution and the dataset/VAE
fingerprint; ``train_gm_unet.py --cache_latents --latent_cache_path`` of
either package then trains from it without decoding or encoding.

    python scripts/torch/precompute_latents.py --train_metadata data.parquet \\
        --pretrained_model_name_or_path PIPE_DIR --resolution 512 --out latents_512.npz

Launched on several ranks (torchrun), rank 0 alone builds and writes the
cache, under ``gmdx_torch.dist.main_process_first``; the others wait for it.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--train_metadata", required=True)
    ap.add_argument("--pretrained_model_name_or_path", required=True)
    ap.add_argument("--resolution", type=int, default=512)
    ap.add_argument("--out", required=True, help="output .npz path")
    ap.add_argument("--batch", type=int, default=16, help="device encode chunk")
    ap.add_argument("--num_workers", type=int, default=4)
    ap.add_argument("--max_train_samples", type=int, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Writes the cache; returns {"samples", "seconds", "mb", "out"}."""
    args = parse_args(argv)

    from gmdx_torch import dist, resolve_device

    joined = not dist.is_initialized() and dist.initialize()
    try:
        with dist.main_process_first():
            if dist.is_main_process():
                return _build(args, dist.device(resolve_device(args.device)))
        return {"samples": None, "seconds": 0.0, "mb": 0.0, "out": args.out}
    finally:
        if joined:
            dist.shutdown()


def _build(args, dev) -> dict:
    """One pass over the dataset into ``args.out``."""
    from gmdx_torch.data import ParquetImageDataset
    from gmdx_torch.io import load_pipeline
    from gmdx_torch.io.params import load_params
    from gmdx_torch.train.latent_cache import (
        compute_latent_cache, latent_cache_fingerprint, save_latent_cache,
    )

    bundle = load_pipeline(args.pretrained_model_name_or_path, device=dev,
                           components=("vae", "tokenizer"))
    dataset = ParquetImageDataset(args.train_metadata)
    t0 = time.time()
    cache = compute_latent_cache(
        dataset, bundle["tokenizer"], bundle["modules"]["vae"], resolution=args.resolution,
        enc_batch=args.batch, num_workers=args.num_workers, max_samples=args.max_train_samples)
    dt = time.time() - t0
    n = cache["input_ids"].shape[0]
    vae_params = load_params(os.path.join(args.pretrained_model_name_or_path, "vae",
                                          "params.safetensors"))
    save_latent_cache(args.out, cache, resolution=args.resolution,
                      fingerprint=latent_cache_fingerprint(args.train_metadata, len(dataset),
                                                           vae_params))
    mb = sum(v.nbytes for v in cache.values()) / 1e6
    print(f"cached {n} samples at {args.resolution}^2 in {dt:.1f}s "
          f"({n / dt:.2f} samples/s end-to-end), {mb:.1f} MB -> {args.out}")
    return {"samples": n, "seconds": dt, "mb": mb, "out": args.out}


if __name__ == "__main__":
    main()
