"""The rank side of the pipeline-parallel tests of ``gmdx_torch``.

Jobs of ``tests/torch_dist_ranks.py``'s :class:`Ranks` (its ``main`` takes
them from :data:`JOBS` here): each rank joins the gloo group, runs the job
on the CPU with one torch thread and hands numpy results back. They import
torch, numpy and ``gmdx_torch`` only; ``tests/test_torch_pp.py`` holds the
results against the JAX package's sequential loop and the port's own.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gmdx_torch.pipelines import pp


def stage_pipeline(setup: dict, stage: int):
    """The tiny dual pipeline as a rank of ``stage`` builds it: its own
    modules from the setup's state dicts, None for the other stage's."""
    from gmdx_torch.io.convert import load_unet, load_vae
    from gmdx_torch.models import TINY_UNET_CONFIG, TINY_VAE_CONFIG
    from gmdx_torch.pipelines import StableDiffusionDualUNetPipeline

    kw = dict(device="cpu", dtype=torch.float32)
    unet = gm = vae = None
    if stage == 0:
        unet = load_unet(setup["unet_sd"], TINY_UNET_CONFIG, **kw)
    else:
        gm = load_unet(setup["gm_unet_sd"], dataclasses.replace(TINY_UNET_CONFIG, in_channels=8),
                       **kw)
        vae = load_vae(setup["vae_sd"], TINY_VAE_CONFIG, **kw)
    return StableDiffusionDualUNetPipeline(unet, vae, None, gm, device="cpu")


def run_case(wrapper, case: dict) -> dict:
    """One ``denoise_dual`` of the wrapper on the case's whole-batch inputs
    (``step_noise`` pairs NHWC, or a CPU generator from ``seed``)."""
    from gmdx_torch.schedulers import get_scheduler

    wrapper.pipe.scheduler = get_scheduler(case["scheduler"])
    wrapper.chunk = case["chunk"]
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    noise = case.get("step_noise")
    if noise is not None:
        noise = [tuple(t(n) for n in pair) for pair in noise]
    gen = None if case.get("seed") is None else torch.Generator().manual_seed(case["seed"])
    sdr, gm = wrapper.denoise_dual(
        t(case["cond"]), t(case["uncond"]), t(case["latents"]),
        num_inference_steps=case["steps"], guidance_scale=case.get("guidance_scale", 7.5),
        guidance_rescale=case.get("guidance_rescale", 0.0), eta=case.get("eta", 0.0),
        generator=gen, step_noise=noise)
    return {"sdr": sdr.numpy(), "gm": None if gm is None else gm.numpy()}


def job_pp(setup: dict) -> dict:
    """Every case of the setup on this rank's stage: the latents it returns
    (its rows), where its rows start, and what it holds."""
    groups = pp.pp_stage_groups()
    wrapper = pp.PipelinedDualUNet(stage_pipeline(setup, groups.stage), groups=groups)
    held = {name: sorted(n for n, _ in m.named_parameters())
            for name in ("unet", "gm_unet", "vae", "text_encoder")
            if (m := getattr(wrapper.pipe, name)) is not None}
    b = setup["cases"][0]["latents"].shape[0] // groups.data_size
    out = {"stage": groups.stage, "first_row": groups.data_rank * b, "held": held,
           "cases": {c["name"]: run_case(wrapper, c) for c in setup["cases"]}}
    # The same from a pipeline directory: this stage's components alone.
    loaded = pp.PipelinedDualUNet.from_pretrained(setup["pipe_dir"], device="cpu", groups=groups)
    out["loaded"] = {"held": sorted(k for k in ("unet", "gm_unet", "vae", "text_encoder")
                                    if getattr(loaded.pipe, k) is not None),
                     "tokenizer": loaded.pipe.tokenizer is not None,
                     "case": run_case(loaded, setup["cases"][0])}
    return out


def job_pp_groups(setup: dict) -> dict:
    """This rank's place in :func:`pp.pp_stage_groups`, or the error it raised."""
    import torch.distributed as dist

    try:
        g = pp.pp_stage_groups()
    except ValueError as e:
        return {"error": str(e)}
    # One sum over each group names its members: this rank's bit in each.
    bits = {}
    for name, group in (("data", g.data_group), ("pair", g.pair_group)):
        t = torch.zeros(dist.get_world_size(), dtype=torch.int64)
        t[dist.get_rank()] = 1
        dist.all_reduce(t, group=group)
        bits[name] = np.flatnonzero(t.numpy()).tolist()
    return {"stage": g.stage, "ranks": list(g.ranks), "data_size": g.data_size,
            "data_rank": g.data_rank, "pair": list(g.pair), "members": bits}


JOBS = {"pp": job_pp, "pp_groups": job_pp_groups}
