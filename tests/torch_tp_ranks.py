"""The rank side of the tensor- and spatial-parallel tests of ``gmdx_torch``.

Jobs of ``tests/torch_dist_ranks.py``'s :class:`Ranks` (its ``main`` takes
them from :data:`JOBS` here): each rank joins the gloo group, runs the job
on the CPU with one torch thread and hands numpy results back. They import
torch, numpy and ``gmdx_torch`` only; the tests hold the results against
the JAX package and against the port's one-process run in their own
process (``tests/test_torch_tp.py``, ``tests/test_torch_sp.py``,
``tests/test_torch_cli.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import os

import torch

from gmdx_torch.dist import mesh, tp, tpctx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def tiny_models(setup: dict):
    """The tiny UNet, VAE and ControlNet of the setup's state dicts, fp32."""
    from gmdx_torch.io.convert import load_controlnet, load_unet, load_vae
    from gmdx_torch.models import TINY_CONTROLNET_CONFIG, TINY_UNET_CONFIG, TINY_VAE_CONFIG

    kw = dict(device="cpu", dtype=torch.float32)
    return (load_unet(setup["unet_sd"], TINY_UNET_CONFIG, **kw),
            load_vae(setup["vae_sd"], TINY_VAE_CONFIG, **kw),
            load_controlnet(setup["cnet_sd"], TINY_CONTROLNET_CONFIG, **kw))


def models_run(setup: dict, mode: str | None) -> dict:
    """The UNet forward, the VAE's posterior and decode and the ControlNet's
    residuals on the setup's inputs, whole on every rank: under ``mode``
    ("tp": each module holds this rank's slices; "sp": the inputs are this
    rank's rows, the outputs gathered) or in one process (None)."""
    unet, vae, cnet = tiny_models(setup)
    t = {k: torch.from_numpy(setup[k]) for k in ("x", "ctx", "img", "z", "cond")}
    out = {}
    ctx = tpctx.parallel_context(mode) if mode else contextlib.nullcontext()
    with ctx as c, torch.no_grad():
        if mode == "tp":
            for m in (unet, vae, cnet):
                tp.tp_shard_module(m, c.rank, c.size)
        if mode == "sp":
            def split(a):
                return mesh.shard_rows(a, c)

            def whole(a, h_dim=2):
                return mesh.gather_rows(a, c, h_dim)
        else:
            def split(a):
                return a

            def whole(a, h_dim=2):
                return a
        out["unet"] = whole(unet(split(t["x"]), setup["t"], t["ctx"]))
        post = vae.encode(split(t["img"]))
        out["vae_mean"], out["vae_std"] = whole(post.mean), whole(post.std)
        out["vae_decode"] = whole(vae.decode(split(t["z"])))
        down, mid = cnet(split(t["x"]), setup["t"], t["ctx"], split(t["cond"]))
        out["cnet_down"] = [whole(d, 1) for d in down]
        out["cnet_mid"] = whole(mid, 1)
    return _numpy(out)


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_numpy(v) for v in tree]
    return tree.detach().float().numpy() if isinstance(tree, torch.Tensor) else tree


def job_models(setup: dict) -> dict:
    return models_run(setup, setup["mode"])


def job_sp_edges(setup: dict) -> dict:
    """The halo exchange at the image's edges and the uneven-rows refusal."""
    out = {}
    with tpctx.parallel_context("sp") as c:
        full = torch.arange(2 * 8 * 3 * 2, dtype=torch.float32).reshape(2, 8, 3, 2)  # NHWC
        local = mesh.shard_rows(full, c, 1)
        out["halo"] = mesh.halo_rows(local, 1, 1, c).numpy()
        out["halo_top"] = mesh.halo_rows(local, 1, 0, c).numpy()
        padded = torch.nn.functional.pad(local, (0, 0, 1, 1, 1, 1))
        out["filled"] = mesh.fill_halo(padded, c).numpy()
        unet, _, _ = tiny_models(setup)
        for name, rows in (("unet_odd_level", 6 * c.size // 2), ("uneven_split", c.size + 1)):
            try:
                with torch.no_grad():
                    x = torch.zeros(1, 4, rows, 8)
                    unet(mesh.shard_rows(x, c), 1, torch.zeros(1, 7, 32))
                out[name] = None
            except ValueError as e:
                out[name] = str(e)
    return out


def dual_run(setup: dict, mode: str | None) -> dict:
    """Three PNDM steps of the tiny dual loop (CFG on the setup's
    embeddings), under ``mode`` or in one process: the (SDR, GM) latents."""
    from gmdx_torch.io.convert import load_unet, load_vae
    from gmdx_torch.models import TINY_UNET_CONFIG, TINY_VAE_CONFIG
    from gmdx_torch.pipelines import StableDiffusionDualUNetPipeline
    from gmdx_torch.schedulers import PNDMScheduler

    kw = dict(device="cpu", dtype=torch.float32)
    unet = load_unet(setup["unet_sd"], TINY_UNET_CONFIG, **kw)
    gm = load_unet(setup["gm_unet_sd"], dataclasses.replace(TINY_UNET_CONFIG, in_channels=8),
                   **kw)
    pipe = StableDiffusionDualUNetPipeline(unet, load_vae(setup["vae_sd"], TINY_VAE_CONFIG, **kw),
                                           PNDMScheduler(), gm, device="cpu")
    t = {k: torch.from_numpy(setup[k]) for k in ("cond", "uncond", "latents")}
    with (tpctx.parallel_context(mode) if mode else contextlib.nullcontext()) as c:
        if mode == "tp":
            for m in (unet, gm):
                tp.tp_shard_module(m, c.rank, c.size)
        sdr, gm_lat = pipe.denoise_dual(t["cond"], t["uncond"], t["latents"],
                                        num_inference_steps=3)
    return {"sdr": sdr.numpy(), "gm": gm_lat.numpy()}


def job_dual(setup: dict) -> dict:
    return dual_run(setup, setup["mode"])


def step_noise_run(mode: str | None) -> dict:
    """Three steps of DDPM, DDIM at eta 0.5 and 0 and LCM on NHWC latents
    (eps a fixed function of them), each from a generator of its own, under
    ``mode`` ("sp": the rank's rows) or in one process (None): the whole
    latents and the generator's next draw (equal only where as many draws
    were made)."""
    from gmdx_torch.pipelines.gm import scheduler_step
    from gmdx_torch.schedulers import DDIMScheduler, DDPMScheduler, LCMScheduler

    out = {}
    with (tpctx.parallel_context(mode) if mode else contextlib.nullcontext()) as c:
        for name, sched, eta in (("ddpm", DDPMScheduler(), 0.0), ("ddim", DDIMScheduler(), 0.5),
                                 ("ddim_eta0", DDIMScheduler(), 0.0), ("lcm", LCMScheduler(), 0.0)):
            g = torch.Generator().manual_seed(7)
            lat = torch.randn(2, 8, 6, 4, generator=torch.Generator().manual_seed(1))
            if mode:
                lat = mesh.shard_rows(lat, c, 1)
            state = sched.init_state(3)
            for _ in range(3):
                lat = scheduler_step(sched, state, 0.1 * lat, lat, eta=eta, generator=g)
            out[name] = mesh.gather_rows(lat, c, 1) if mode else lat
            out[f"{name}_next"] = torch.randn(4, generator=g)
    return _numpy(out)


def job_step_noise(setup: dict) -> dict:
    return step_noise_run(setup["mode"])


def job_cli(setup: dict) -> dict:
    """Each run of ``setup["cli_runs"]``: (name, script, argv): what
    ``scripts/torch/<script>.py``'s main(argv) wrote, by file."""
    out = {}
    for name, script, argv in setup["cli_runs"]:
        spec = importlib.util.spec_from_file_location(
            f"tp_ranks_{script}", os.path.join(REPO, "scripts", "torch", f"{script}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod.main(argv)
    return out


JOBS = {"tp_models": job_models, "sp_edges": job_sp_edges, "tp_dual": job_dual,
        "sp_step_noise": job_step_noise, "tp_cli": job_cli}
