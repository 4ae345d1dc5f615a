"""The rank side of the tensor- and spatial-parallel tests of ``gmdx_torch``.

Jobs of ``tests/torch_dist_ranks.py``'s :class:`Ranks` (its ``main`` takes
them from :data:`JOBS` here): each rank joins the gloo group, runs the job
on the CPU with one torch thread and hands numpy results back. They import
torch, numpy and ``gmdx_torch`` only; the tests hold the results against
the JAX package and against the port's one-process run in their own
process (``tests/test_torch_tp.py``, ``tests/test_torch_sp.py``,
``tests/test_torch_cli.py``, ``tests/test_torch_optin_train.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import os

import numpy as np
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
    for name, script, argv, *copy in setup["cli_runs"]:
        if copy:
            if tdist.get_rank() == 0:
                shutil.copytree(*copy[0])
            tdist.barrier()
        spec = importlib.util.spec_from_file_location(
            f"tp_ranks_{script}", os.path.join(REPO, "scripts", "torch", f"{script}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod.main(argv)
    return out


# --- Stage-2 training under tp / sp -----------------------------------------

# The training tests' global batch and latent side: 16^2 latents put the
# UNet's first level at 256 tokens, the flash route's (a rank's 128 queries
# against the 256 gathered keys under sp).
TRAIN_BATCH, TRAIN_LATENT = 4, 16


def train_setup(mode: str, workdir: str) -> dict:
    """The tiny GM UNet (a seeded torch init), a seeded CLIP, a cached-latent
    global batch of TRAIN_BATCH, the config (EMA, clipping, a noise offset,
    min-SNR weights) and two steps' seeds; ``mode`` over model groups of 2."""
    from gmdx_torch.models import (
        TINY_CLIP_CONFIG, TINY_UNET_CONFIG, CLIPTextModel, UNet2DConditionModel,
    )

    torch.manual_seed(3)
    unet = UNet2DConditionModel(dataclasses.replace(TINY_UNET_CONFIG, in_channels=8))
    torch.manual_seed(1)
    text = CLIPTextModel(TINY_CLIP_CONFIG)
    rng = np.random.default_rng(7)
    shape = (TRAIN_BATCH, 4, TRAIN_LATENT, TRAIN_LATENT)
    batch = {f"{k}_latent_{s}": (rng.standard_normal(shape) if s == "mean"
                                 else rng.uniform(0.05, 0.3, shape)).astype(np.float32)
             for k in ("sdr", "gm") for s in ("mean", "std")}
    batch["input_ids"] = rng.integers(0, 1000, (TRAIN_BATCH, 77)).astype(np.int64)
    return {"unet_sd": {k: v.numpy() for k, v in unet.state_dict().items()},
            "text_sd": {k: v.numpy() for k, v in text.state_dict().items()},
            "batch": batch, "seeds": [101, 202], "size": 2, "mode": mode,
            "workdir": workdir,
            "stage2_config": dict(learning_rate=3e-4, use_ema=True, max_grad_norm=1.0,
                                  noise_offset=0.1, snr_gamma=5.0)}


def collectives_setup(mode: str, n: int = 2) -> dict:
    """Whole tensors and each rank's cotangents for :func:`job_collectives`
    over ``n`` ranks: an NHWC image of 8 rows, a (3, 8) input, a (6, 8)
    weight."""
    rng = np.random.default_rng(5)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    rows = 8 // n
    return {"mode": mode, "collectives": {
        "x": r(3, 8), "w": r(6, 8), "cy": r(3, 6), "partials": r(n, 3, 6), "cw": r(6, 8),
        "img": r(2, 8, 3, 4), "cimg": r(n, 2, 8, 3, 4), "chalo_rows": r(n, 2, rows + 2, 3, 4),
        "chalo_rows_top": r(n, 2, rows + 1, 3, 4), "cfill": r(n, 2, rows + 2, 5, 4)}}


def collectives_one_process(setup: dict) -> dict:
    """:func:`job_collectives`' gradients of each rank's inputs, from the
    whole tensors in one process: a list a collective, one entry a rank."""
    t = {k: torch.from_numpy(v) for k, v in setup["collectives"].items()}
    n = t["partials"].shape[0]
    out = {"copy_to_model": [(t["cy"] @ t["w"]).numpy()] * n,
           "reduce_from_model": [t["cy"].numpy()] * n,
           "gather_full": [c.numpy() for c in t["cw"].chunk(n, 0)],
           "gather_rows": [c.numpy() for c in t["cimg"].sum(0).chunk(n, 1)]}
    rows = t["img"].shape[1] // n
    for name, top, bottom, pad in (("halo_rows", 1, 1, (0, 0, 0, 0, 1, 1)),
                                   ("halo_rows_top", 1, 0, (0, 0, 0, 0, 1, 1)),
                                   ("fill_halo", 1, 1, (0, 0, 1, 1, 1, 1))):
        img = t["img"].clone().requires_grad_()
        padded = torch.nn.functional.pad(img, pad)
        c = t["cfill"] if name == "fill_halo" else t[f"c{name}"]
        loss = sum((padded[:, r * rows:(r + 1) * rows + top + bottom] * c[r]).sum()
                   for r in range(n))
        out[name] = [g.numpy() for g in torch.autograd.grad(loss, img)[0].chunk(n, 1)]
    return out


def train_run(setup: dict, mode: str | None, *, steps=(0, 1), restore=None, save=None) -> dict:
    """Stage-2 updates ``steps`` (indices of the setup's seeds) of the tiny
    GM UNet on the setup's global batch: under ``mode`` ("tp" / "sp" over a
    data x model layout of ``setup["size"]``-rank model groups) on this
    rank's part of it, or in one process (None). ``restore`` / ``save``:
    (checkpoint dir, step) loaded first / saved after that update. Returns
    the metrics, the draws (this rank's rows), the first reduced gradient
    and every tensor of the state, whole, and the digests."""
    from torch_dist_ranks import _np, stage2_config, stage2_modules

    from gmdx_torch.train import init_state, make_ema_step, make_manager, make_train_step
    from gmdx_torch.train.checkpoint import restore_state, save_state, state_digest, \
        state_tensors

    layout = tpctx.join_train_parallel(mode, setup["size"]) if mode else None
    unet, vae, text = stage2_modules(setup)
    if "kernel_options" in setup:
        from gmdx_torch.models import set_kernel_options

        set_kernel_options(unet, **setup["kernel_options"])
    cfg = stage2_config(setup)
    step = make_train_step(cfg, unet=unet, vae=vae, text_encoder=text, device="cpu",
                           layout=layout)
    names = [n for n, p in unet.named_parameters() if p.requires_grad]
    state = mesh.apply_shard_strategy(init_state(cfg, unet), mode or "ddp",
                                      param_fields=("params", "ema"),
                                      opt_fields=("opt_state",), layout=layout)
    batch = {k: torch.from_numpy(v) for k, v in setup["batch"].items()}
    if layout is not None:
        batch = mesh.shard_batch(batch, layout.data_rank, layout.data_size)
        if mode == "sp":
            batch = mesh.spatial_batch(batch, layout)
    opt = state.optimizer
    grads: list = []
    inner = opt.step

    def capture(g, grad_norm=None):
        if not grads:
            dp = opt.dp
            grads.append([_np(t) for t in (dp.whole(g) if dp is not None else g)])
        return inner(g, grad_norm)

    opt.step = capture
    out = {"loss": [], "grad_norm": [], "module_grad_norms": [], "draws": [], "saved": None,
           "restored": None}
    if restore is not None:
        restore_state(make_manager(restore[0]), restore[1], state)
        out["restored"] = state_digest(state)
    for k in steps:
        gen = torch.Generator().manual_seed(setup["seeds"][k])
        out["draws"].append({n: _np(v) for n, v in step.draw_inputs(
            batch, torch.Generator().manual_seed(setup["seeds"][k])).items() if v is not None})
        state, m = step(state, batch, gen)
        make_ema_step(cfg)(state)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["module_grad_norms"].append({n: float(v) for n, v in m["module_grad_norms"].items()})
        if save is not None and save[1] == k + 1:
            out["saved"] = save_state(make_manager(save[0]), k + 1, state)
    del opt.step
    out["grads"] = dict(zip(names, grads[0])) if grads else None
    tensors, scalars = state_tensors(state)
    out["tensors"] = {n: _np(t) for n, t in tensors.items()}
    out["scalars"] = scalars
    out["digest"] = state_digest(state)
    out["held"] = sum(t.numel() for t in opt.params)  # parameters this rank holds
    return out


def job_train(setup: dict) -> dict:
    """The mode's two updates, checkpointed after the first; one update
    resumed from the one-process run's checkpoint of the first."""
    mode, work = setup["mode"], setup["workdir"]
    return {"run": train_run(setup, mode, save=(os.path.join(work, f"ckpt_{mode}"), 1)),
            "resumed": train_run(setup, mode, steps=(1,),
                                 restore=(os.path.join(work, "ckpt_one"), 1))}


def job_collectives(setup: dict) -> dict:
    """Each autograd collective on this rank's part of the setup's whole
    tensors, its part of a loss whose terms the setup gives (``c``: one
    cotangent a rank); the gradients of this rank's inputs."""
    from gmdx_torch.dist.tp import copy_to_model, gather_full, reduce_from_model

    t = {k: torch.from_numpy(v) for k, v in setup["collectives"].items()}
    with tpctx.parallel_context(setup["mode"]) as c:
        r, n = c.rank, c.size
        out = {}

        def grad(x, loss):
            return torch.autograd.grad(loss, x)[0].numpy()

        # copy_to_model: x whole, y = x W_r^T (W's rows r), the cotangent's columns r.
        x = t["x"].clone().requires_grad_()
        w_r = t["w"].chunk(n, 0)[r]
        out["copy_to_model"] = grad(x, (copy_to_model(x, c) @ w_r.T
                                        * t["cy"].chunk(n, 1)[r]).sum())
        # reduce_from_model: each rank's partial p_r, their sum used whole.
        p = t["partials"][r].clone().requires_grad_()
        out["reduce_from_model"] = grad(p, (reduce_from_model(p, c) * t["cy"]).sum())
        # gather_full: the rank's rows of w, the whole used alike by all.
        w = w_r.clone().requires_grad_()
        out["gather_full"] = grad(w, (gather_full(w, t["w"].shape, c) * t["cw"]).sum())
        # gather_rows: the rank's rows of an NHWC image, the whole used by
        # each rank in its own way (its own cotangent).
        img = mesh.shard_rows(t["img"], c, 1).requires_grad_()
        out["gather_rows"] = grad(img, (mesh.gather_rows(img, c, 1) * t["cimg"][r]).sum())
        # halo_rows: 1 above and 1 below, and 1 above alone (a stride-2 conv's).
        for name, top, bottom in (("halo_rows", 1, 1), ("halo_rows_top", 1, 0)):
            img = mesh.shard_rows(t["img"], c, 1).requires_grad_()
            h = mesh.halo_rows(img, top, bottom, c)
            out[name] = grad(img, (h * t[f"c{name}"][r]).sum())
        # fill_halo: the padded slab, its border rows the neighbours'.
        img = mesh.shard_rows(t["img"], c, 1).requires_grad_()
        xp = mesh.fill_halo(torch.nn.functional.pad(img, (0, 0, 1, 1, 1, 1)), c)
        out["fill_halo"] = grad(img, (xp * t["cfill"][r]).sum())
    return out


def job_train_cli(setup: dict) -> dict:
    """Each run of ``setup["cli_runs"]`` (name, argv) of
    ``scripts/torch/train_gm_unet.py``: its losses, steps and the state's
    whole tensors."""
    import sys

    from torch_dist_ranks import _np

    from gmdx_torch.train.checkpoint import state_tensors

    sys.modules["torch.utils.tensorboard"] = None  # as on the card's machine
    spec = importlib.util.spec_from_file_location(
        "tp_ranks_train_gm_unet", os.path.join(REPO, "scripts", "torch", "train_gm_unet.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = {}
    for name, argv in setup["cli_runs"]:
        res = mod.main(argv)
        tensors, _ = state_tensors(res.pop("state"))
        res["tensors"] = {k: _np(v) for k, v in tensors.items()}
        out[name] = res
    return out


def job_optin_train(setup: dict) -> dict:
    """One update of the mode's step with the setup's kernel options
    (``tests/test_torch_optin_train.py``)."""
    return train_run(setup, setup["mode"], steps=(0,))


JOBS = {"tp_models": job_models, "sp_edges": job_sp_edges, "tp_dual": job_dual,
        "sp_step_noise": job_step_noise, "tp_cli": job_cli, "tp_train": job_train,
        "tp_collectives": job_collectives, "tp_train_cli": job_train_cli,
        "optin_train": job_optin_train}


# --- the Stage-1 and ControlNet trainers under tp / sp -----------------------


def _capture_first(opt, into: list, whole=None) -> None:
    """Keep the first gradients ``opt.step`` takes (reduced; ``whole`` makes
    them whole), as numpy."""
    from torch_dist_ranks import _np

    inner = opt.step

    def step(g, grad_norm=None):
        if not into:
            into.append([_np(t) for t in (whole(g) if whole is not None else g)])
        return inner(g, grad_norm)

    opt.step = step


def _rank_batch(setup_batch: dict, layout) -> dict:
    """This rank's part of a global numpy batch: its data index's rows,
    under sp its H rows of each image."""
    batch = {k: torch.from_numpy(v) for k, v in setup_batch.items()}
    if layout is not None:
        batch = mesh.shard_batch(batch, layout.data_rank, layout.data_size)
        if layout.mode == "sp":
            batch = mesh.spatial_batch(batch, layout)
    return batch


def cnet_modules(setup: dict):
    """The tiny UNet, VAE, CLIP text encoder and ControlNet of the setup's
    state dicts, fp32."""
    from gmdx_torch.models import TINY_CLIP_CONFIG, CLIPTextModel

    unet, vae, cnet = tiny_models(setup)
    text = CLIPTextModel(TINY_CLIP_CONFIG)
    text.load_state_dict({k: torch.from_numpy(v) for k, v in setup["text_sd"].items()})
    return unet, vae, text, cnet.train()


def cnet_train_run(setup: dict, mode: str | None, *, steps=(0, 1), restore=None,
                   save=None) -> dict:
    """ControlNet updates ``steps`` (indices of the setup's seeds) on the
    setup's global batch: under ``mode`` over a data x model layout of
    ``setup["size"]``-rank model groups on this rank's part of it, or in
    one process (None). ``restore`` / ``save``: (checkpoint dir, step).
    Returns the metrics, the draws (this rank's rows), the first reduced
    gradient whole, the state's tensors whole, the digest, and the
    parameters' shapes this rank holds."""
    from torch_dist_ranks import _np

    from gmdx_torch.train import (
        ControlNetTrainConfig, init_controlnet_state, make_controlnet_ema_step,
        make_controlnet_train_step, make_manager,
    )
    from gmdx_torch.train.checkpoint import restore_state, save_state, state_digest, \
        state_tensors

    layout = tpctx.join_train_parallel(mode, setup["size"]) if mode else None
    unet, vae, text, cnet = cnet_modules(setup)
    cfg = ControlNetTrainConfig(**setup["cnet_config"])
    step = make_controlnet_train_step(cfg, unet=unet, vae=vae, text_encoder=text,
                                      controlnet=cnet, device="cpu", layout=layout)
    names = [n for n, p in cnet.named_parameters() if p.requires_grad]
    state = mesh.apply_shard_strategy(init_controlnet_state(cfg, cnet), mode or "ddp",
                                      param_fields=("params", "ema"),
                                      opt_fields=("opt_state",), layout=layout)
    batch = _rank_batch(setup["cnet_batch"], layout)
    opt = state.optimizer
    grads: list = []
    _capture_first(opt, grads, opt.dp.whole if opt.dp is not None else None)
    out = {"loss": [], "grad_norm": [], "draws": [], "saved": None, "restored": None}
    if restore is not None:
        restore_state(make_manager(restore[0]), restore[1], state)
        out["restored"] = state_digest(state)
    for k in steps:
        seed = setup["seeds"][k]
        out["draws"].append({n: _np(v) for n, v in step.draw_inputs(
            batch, torch.Generator().manual_seed(seed)).items()})
        state, m = step(state, batch, torch.Generator().manual_seed(seed))
        make_controlnet_ema_step(cfg)(state)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        if save is not None and save[1] == k + 1:
            out["saved"] = save_state(make_manager(save[0]), k + 1, state)
    del opt.step
    out["grads"] = dict(zip(names, grads[0])) if grads else None
    tensors, scalars = state_tensors(state)
    out["tensors"] = {n: _np(t) for n, t in tensors.items()}
    out["scalars"] = scalars
    out["digest"] = state_digest(state)
    out["held"] = {n: tuple(p.shape) for n, p in cnet.named_parameters()}
    return out


def job_cnet_train(setup: dict) -> dict:
    """The mode's two updates, checkpointed after the first; one update
    resumed from the one-process run's checkpoint of the first."""
    mode, work = setup["mode"], setup["workdir"]
    return {"run": cnet_train_run(setup, mode, save=(os.path.join(work, f"ckpt_{mode}"), 1)),
            "resumed": cnet_train_run(setup, mode, steps=(1,),
                                      restore=(os.path.join(work, "ckpt_one"), 1))}


def s1_train_run(setup: dict, mode: str | None, *, lr: float, restore=None,
                 save=None) -> dict:
    """A Stage-1 generator step, the EMA, then a discriminator step (the
    setup's seed for both) at learning rate ``lr`` on the setup's global
    batch: under ``mode`` on this rank's part of it, or in one process.
    Returns both steps' metrics, their first reduced gradients, the state's
    tensors whole, the digest and the shapes this rank holds."""
    from torch_dist_ranks import _np, stage1_setup

    from gmdx_torch.ops import tmo
    from gmdx_torch.train import make_manager, stage1
    from gmdx_torch.train.checkpoint import restore_state, save_state, state_digest, \
        state_tensors

    layout = tpctx.join_train_parallel(mode, setup["size"]) if mode else None
    cfg, vae, vgg, disc, trainables = stage1_setup(setup)
    names = stage1.trainable_names(trainables)
    disc_names = [n for n, _ in disc.named_parameters()]
    state = stage1.init_state(cfg, trainables, disc, stage1.make_optimizers(
        trainables, disc, learning_rate=lr, discr_learning_rate=lr, lr_warmup_steps=0))
    state = mesh.apply_shard_strategy(state, mode or "ddp",
                                      param_fields=("trainables", "disc_params", "ema"),
                                      opt_fields=("opt_state", "disc_opt_state"), layout=layout)
    kw = dict(vae=vae, discriminator=disc, tmo_fn=tmo.fix_mulog_tmo, device="cpu",
              layout=layout)
    gen_step = stage1.make_gen_step(cfg, vgg=vgg, **kw)
    disc_step = stage1.make_disc_step(cfg, **kw)
    batch = _rank_batch(setup["s1_batch"], layout)
    out = {"saved": None, "restored": None}
    if restore is not None:
        restore_state(make_manager(restore[0]), restore[1], state)
        out["restored"] = state_digest(state)
    gen_grads: list = []
    disc_grads: list = []
    _capture_first(state.optimizer, gen_grads)
    _capture_first(state.disc_optimizer, disc_grads)
    seed = setup["seeds"][0]
    state, g = gen_step(state, batch, torch.Generator().manual_seed(seed))
    stage1.make_ema_step(cfg)(state)
    state, d = disc_step(state, batch, torch.Generator().manual_seed(seed))
    del state.optimizer.step, state.disc_optimizer.step
    if save is not None:
        out["saved"] = save_state(make_manager(save), 1, state)
    tensors, scalars = state_tensors(state)
    out.update({
        "gen": {k: float(v) for k, v in g.items() if k != "module_grad_norms"},
        "disc": {k: float(v) for k, v in d.items()},
        "gen_grads": dict(zip(names, gen_grads[0])),
        "disc_grads": dict(zip(disc_names, disc_grads[0])),
        "tensors": {n: _np(t) for n, t in tensors.items()}, "scalars": scalars,
        "digest": state_digest(state),
        "held": {n: tuple(t.shape) for n, t in zip(
            names + disc_names, stage1.trainable_list(state.trainables)
            + list(state.discriminator.parameters()))}})
    return out


def job_s1_train(setup: dict) -> dict:
    """The mode's pair at learning rate 0 (the gradients gmdx's step is held
    to, at the initial state) and at the setup's rate (checkpointed), then
    the pair resumed from the one-process run's checkpoint."""
    mode, work = setup["mode"], setup["workdir"]
    return {"grads": s1_train_run(setup, mode, lr=0.0),
            "run": s1_train_run(setup, mode, lr=setup["lr"],
                                save=os.path.join(work, f"ckpt_{mode}")),
            "resumed": s1_train_run(setup, mode, lr=setup["lr"],
                                    restore=(os.path.join(work, "ckpt_one"), 1))}


def second_order_setup(n: int = 2) -> dict:
    """Whole tensors for :func:`second_order_run` over ``n`` ranks: an NHWC
    image of 8 rows and an NCHW one, a weight over their last dimension,
    and a cotangent of each."""
    rng = np.random.default_rng(9)

    def r(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"n": n, "second_order": {"nhwc": r(2, 8, 3, 4), "nchw": r(2, 3, 8, 4), "w": r(4),
                                     "c_nhwc": r(2, 8, 3, 4), "c_nchw": r(2, 3, 8, 4)}}


# Each collective of the second-order check: (H dim, replicated output).
SECOND_ORDER = {"all_reduce_sum": (1, True), "gather_rows": (1, True), "halo_rows": (1, False),
                "halo_rows_nchw": (2, False), "fill_halo": (1, False)}


def second_order_run(setup: dict, ctx) -> dict:
    """What a gradient penalty differentiates, through each collective: on
    a rank's rows x, the collective's outputs y, s = sum(tanh(y) * w) (a
    replicated output counted as its 1/n share), dx = ds/dx under
    create_graph, p = sum(dx^2 * c) (c's rows), then dp/dx and dp/dw. With
    ``ctx`` None the whole tensors in one process, each rank's outputs
    made from them (the windows a rank's halo reads, zero-padded at the
    image's edges): the sums over the ranks of s and p are the ranks'."""
    import torch.nn.functional as F

    t = {k: torch.from_numpy(v) for k, v in setup["second_order"].items()}
    n = setup["n"]

    def ys(name, x):
        """The outputs whose s the objective sums (one a rank)."""
        if ctx is not None:
            return [{"all_reduce_sum": lambda: mesh.all_reduce_sum(
                        0.05 * (x * x).sum(dim=(1, 2)), ctx),
                     "gather_rows": lambda: mesh.gather_rows(x, ctx, 1),
                     "halo_rows": lambda: mesh.halo_rows(x, 1, 1, ctx),
                     "halo_rows_nchw": lambda: mesh.halo_rows(x, 1, 0, ctx, h_dim=2),
                     "fill_halo": lambda: mesh.fill_halo(F.pad(x, (0, 0, 1, 1, 1, 1)), ctx),
                     }[name]()]
        if name == "all_reduce_sum":
            return [0.05 * (x * x).sum(dim=(1, 2))] * n
        if name == "gather_rows":
            return [x] * n
        h = x.shape[SECOND_ORDER[name][0]] // n
        if name == "halo_rows_nchw":
            xp = F.pad(x, (0, 0, 1, 0))
            return [xp[:, :, r * h:(r + 1) * h + 1] for r in range(n)]
        xp = F.pad(x, (0, 0, 0, 0, 1, 1) if name == "halo_rows" else (0, 0, 1, 1, 1, 1))
        return [xp[:, r * h:(r + 1) * h + 2] for r in range(n)]

    out = {}
    for name, (h_dim, replicated) in SECOND_ORDER.items():
        layout = "nchw" if h_dim == 2 else "nhwc"
        x, c = t[layout], t[f"c_{layout}"]
        if ctx is not None:
            x, c = mesh.shard_rows(x, ctx, h_dim), mesh.shard_rows(c, ctx, h_dim)
        x = x.clone().requires_grad_()
        w = t["w"].clone().requires_grad_()
        share = 1.0 / n if replicated else 1.0
        s = sum((torch.tanh(y) * w).sum() for y in ys(name, x)) * share
        (dx,) = torch.autograd.grad(s, x, create_graph=True)
        gx, gw = torch.autograd.grad((dx * dx * c).sum(), (x, w))
        out[name] = {"dx": dx.detach().numpy(), "gx": gx.numpy(), "gw": gw.numpy()}
    return out


def job_second_order(setup: dict) -> dict:
    with tpctx.parallel_context("sp") as c:
        return second_order_run(setup, c)


def job_trainer_cli(setup: dict) -> dict:
    """Each run of ``setup["cli_runs"]``: (name, script, argv) of
    ``scripts/torch/<script>.py``, optionally with (source, destination):
    a checkpoint directory rank 0 copies before the run; its losses,
    steps, digests and the state's whole tensors."""
    import shutil
    import sys

    import torch.distributed as tdist

    from torch_dist_ranks import _np

    from gmdx_torch.train.checkpoint import state_tensors

    sys.modules["torch.utils.tensorboard"] = None  # as on the card's machine
    out = {}
    for name, script, argv, *copy in setup["cli_runs"]:
        if copy:
            if tdist.get_rank() == 0:
                shutil.copytree(*copy[0])
            tdist.barrier()
        spec = importlib.util.spec_from_file_location(
            f"tp_ranks_{script}", os.path.join(REPO, "scripts", "torch", f"{script}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        res = mod.main(argv)
        tensors, _ = state_tensors(res.pop("state"))
        res["tensors"] = {k: _np(v) for k, v in tensors.items()}
        out[name] = res
    return out


def disc_gp_run(setup: dict, ctx) -> dict:
    """A seeded discriminator's hinge on reals plus the gradient penalty
    (gmdx's, weight 10) on ``setup["device"]`` in ``setup["dtype"]``
    (float32 by default): under ``ctx`` (sp) on this
    rank's rows, each term its share and the gradients summed over the
    group, or in one process. Returns the penalty, the input gradient's
    per-image norms and the discriminator's gradients."""
    from gmdx_torch.models.discriminator import Discriminator
    from gmdx_torch.train.stage1 import safe_norm, safe_norm_split

    dev = torch.device(setup["device"])
    if dev.type == "cuda":  # fp32 convs and matmuls, as the card tests' process
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(setup["seed"])
    dtype = getattr(torch, setup.get("dtype", "float32"))
    disc = Discriminator(depth=setup["depth"], hidden_channels=setup["hidden"]).to(dev, dtype)
    x = torch.from_numpy(setup["real"]).to(dev, dtype)
    n = 1 if ctx is None else ctx.size
    if ctx is not None:
        x = mesh.shard_rows(x, ctx)
    with tpctx.entered(ctx):
        real = x.requires_grad_()
        out = disc(real)
        (g,) = torch.autograd.grad(out.sum(), real, create_graph=True)
        g = g.reshape(g.shape[0], -1)
        norm = safe_norm(g) if ctx is None else safe_norm_split(g, ctx)
        gp = 10.0 * torch.mean((norm - 1.0) ** 2) / n
        loss = torch.mean(torch.relu(1.0 - out)) / n + gp
        grads = torch.autograd.grad(loss, list(disc.parameters()))
    flat = torch.cat([t.reshape(-1) for t in grads]).double()
    total = torch.stack([gp.detach().double(), loss.detach().double()])
    if ctx is not None:
        torch.distributed.all_reduce(flat, group=ctx.group)
        torch.distributed.all_reduce(total, group=ctx.group)
    return {"gp": float(total[0]), "loss": float(total[1]), "norm": norm.detach().cpu().numpy(),
            "grads": flat.cpu().numpy()}


def job_disc_gp(setup: dict) -> dict:
    with tpctx.parallel_context("sp") as c:
        return disc_gp_run(setup, c)


JOBS.update({"cnet_train": job_cnet_train, "s1_train": job_s1_train, "disc_gp": job_disc_gp,
             "second_order": job_second_order, "trainer_cli": job_trainer_cli})
