"""Persistent VAE latent cache for Stage-2 training.

Counterpart of ``gmdx/train/latent_cache.py``: one pass over the dataset
(center crop, no flip) stores the frozen VAE's posterior (mean, std) of both
image columns as float16, with the tokenized captions; training samples the
posterior on the device each step, so the training distribution is that of
the pixel path. ``save_latent_cache`` / ``load_latent_cache`` keep it as an
``.npz`` with the JAX package's keys, resolution and fingerprint checks and
messages, so a cache built by either package loads in the other.
"""

from __future__ import annotations

import hashlib
import logging
import os

import numpy as np
import torch
from torch import nn

logger = logging.getLogger("gmdx_torch.train")

_META_KEYS = ("__resolution", "__fingerprint")


def _leaves(tree) -> list:
    """The leaves of a nested dict in ``jax.tree.leaves`` order (keys
    sorted at every level)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def latent_cache_fingerprint(dataset_files, n_samples: int, vae_params) -> str:
    """Identity digest of the (dataset, VAE weights) a cache was built from:
    the files' absolute paths, the sample count, and the shape and first 64
    values of the first and last three leaves of the VAE's Flax param tree,
    as the JAX package hashes them. ``vae_params`` is that tree (as a
    pipeline directory's ``vae/params.safetensors`` holds it) or the port's
    ``AutoencoderKL``, whose weights go through ``gmdx_torch.io.to_flax``
    (equal to the file's when the module holds them in float32)."""
    if isinstance(vae_params, nn.Module):
        from gmdx_torch.io.to_flax import convert_vae_state_dict

        vae_params = convert_vae_state_dict(
            {k: v.detach().float().cpu() for k, v in vae_params.state_dict().items()})
    h = hashlib.sha256()
    if isinstance(dataset_files, str):
        dataset_files = [dataset_files]
    for f in dataset_files:
        h.update(os.path.abspath(f).encode())
    h.update(str(int(n_samples)).encode())
    leaves = _leaves(vae_params)
    probe = leaves[:3] + leaves[-3:] if len(leaves) > 6 else leaves
    for leaf in probe:
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().float().cpu().numpy()
        arr = np.asarray(leaf, np.float32)
        h.update(repr(arr.shape).encode())
        h.update(arr.ravel()[:64].tobytes())
    return h.hexdigest()[:16]


@torch.no_grad()
def compute_latent_cache(
    dataset,
    tokenizer,
    vae: nn.Module,
    *,
    resolution: int,
    enc_batch: int = 16,
    num_workers: int = 4,
    max_samples: int | None = None,
) -> dict[str, np.ndarray]:
    """One pass over the dataset (batch 1, so no row is dropped): both image
    columns' posterior (mean, std) through the frozen VAE on its device, in
    chunks of ``enc_batch`` (the last one padded and the padding dropped),
    stored float16, plus the captions' ``input_ids``."""
    from gmdx_torch.data import make_dataloader

    dev = next(vae.parameters()).device
    loader = make_dataloader(
        dataset, tokenizer, batch_size=1, resolution=resolution, center_crop=True,
        random_flip=False, shuffle=False, num_epochs=1, num_workers=num_workers,
        max_samples=max_samples)
    pixels, gains, ids = [], [], []
    for item in loader:
        pixels.append(item["pixel_values"][0])
        gains.append(item["gainmap_values"][0])
        ids.append(item["input_ids"][0])
    n = len(ids)
    cache: dict[str, np.ndarray] = {"input_ids": np.stack(ids)}
    enc_bs = max(1, enc_batch)
    for images, prefix in ((pixels, "sdr"), (gains, "gm")):
        means, stds = [], []
        for start in range(0, n, enc_bs):
            chunk = np.stack(images[start:start + enc_bs])
            pad = enc_bs - chunk.shape[0]
            if pad:
                chunk = np.concatenate([chunk, chunk[-1:].repeat(pad, 0)])
            post = vae.encode(torch.from_numpy(chunk).to(dev))
            means.append(post.mean[:enc_bs - pad].to(torch.float16).cpu().numpy())
            stds.append(post.std[:enc_bs - pad].to(torch.float16).cpu().numpy())
        cache[f"{prefix}_latent_mean"] = np.concatenate(means)
        cache[f"{prefix}_latent_std"] = np.concatenate(stds)
    logger.info("cached VAE posteriors for %d samples", n)
    return cache


def save_latent_cache(path: str, cache: dict[str, np.ndarray], *, resolution: int,
                      fingerprint: str | None = None) -> None:
    meta = {"__resolution": np.int64(resolution)}
    if fingerprint is not None:
        meta["__fingerprint"] = np.array(fingerprint)
    np.savez(path, **meta, **cache)


def load_latent_cache(path: str, *, resolution: int,
                      fingerprint: str | None = None) -> dict[str, np.ndarray]:
    """Load a cache; a resolution or dataset/VAE fingerprint mismatch
    raises, naming the cause (same shapes, wrong latents would otherwise
    train silently)."""
    with np.load(path) as z:
        stored = int(z["__resolution"])
        if stored != resolution:
            raise ValueError(
                f"latent cache {path} was built at {stored}^2 but this run "
                f"trains at {resolution}^2 — rebuild with "
                f"scripts/tools/precompute_latents.py --resolution {resolution}"
            )
        if fingerprint is not None:
            if "__fingerprint" in z.files:
                stored_fp = str(z["__fingerprint"])
                if stored_fp != fingerprint:
                    raise ValueError(
                        f"latent cache {path} was built from a different "
                        f"dataset or VAE (fingerprint {stored_fp} != "
                        f"{fingerprint}) — rebuild with "
                        f"scripts/tools/precompute_latents.py"
                    )
            else:
                logger.warning(
                    "latent cache %s has no dataset/VAE fingerprint "
                    "(pre-r5 format) — cannot verify it matches this run",
                    path,
                )
        return {k: z[k] for k in z.files if k not in _META_KEYS}


__all__ = [
    "compute_latent_cache",
    "save_latent_cache",
    "load_latent_cache",
    "latent_cache_fingerprint",
]
