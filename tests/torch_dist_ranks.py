"""The rank side of the multi-process tests of ``gmdx_torch.dist``.

``python tests/torch_dist_ranks.py JOB RANK WORLD PORT WORKDIR`` (what
:class:`Ranks` starts, one process a rank) joins a
gloo process group on ``localhost:PORT``, reads the job's inputs from
``WORKDIR/setup.pkl`` (numpy arrays and plain values the test wrote), runs
JOB on the CPU with one torch thread, and writes its numpy results to
``WORKDIR/<JOB>_<RANK>.pkl``. It imports torch, numpy and ``gmdx_torch``
only; the tests hold the results against the JAX package in their own
process (``tests/test_torch_dist.py``, ``tests/test_torch_dist_cli.py``).
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gmdx_torch import dist  # noqa: E402


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 else \
        t.detach().cpu().numpy()


# --- Stage 2 ---------------------------------------------------------------


def stage2_modules(setup: dict):
    """The tiny GM UNet (the setup's weights), VAE and CLIP text encoder."""
    import dataclasses

    from gmdx_torch.io.convert import load_unet
    from gmdx_torch.models import (
        TINY_CLIP_CONFIG, TINY_UNET_CONFIG, TINY_VAE_CONFIG, AutoencoderKL, CLIPTextModel,
    )

    unet = load_unet(setup["unet_sd"], dataclasses.replace(TINY_UNET_CONFIG, in_channels=8),
                     device="cpu", dtype=torch.float32)
    vae = AutoencoderKL(TINY_VAE_CONFIG)
    text = CLIPTextModel(TINY_CLIP_CONFIG)
    text.load_state_dict({k: torch.from_numpy(v) for k, v in setup["text_sd"].items()})
    return unet, vae, text


def stage2_config(setup: dict):
    from gmdx_torch.train import Stage2Config

    return Stage2Config(**setup["stage2_config"])


def stage2_run(setup: dict, strategy: str, *, steps=(0, 1), restore=None, save=None):
    """Stage-2 updates ``steps`` (indices of the setup's seeds) on this
    rank's rows of the setup's global batch under ``strategy``; with
    ``restore`` (checkpoint dir, step) the state is loaded first, with
    ``save`` (dir, step) saved after that update. Returns the metrics, the
    draws of each step (this rank's rows), the digests and the state's
    full tensors."""
    from gmdx_torch.train import init_state, make_manager, make_train_step
    from gmdx_torch.train.checkpoint import restore_state, save_state, state_digest, \
        state_tensors

    unet, vae, text = stage2_modules(setup)
    cfg = stage2_config(setup)
    step = make_train_step(cfg, unet=unet, vae=vae, text_encoder=text, device="cpu")
    state = dist.apply_shard_strategy(init_state(cfg, unet), strategy,
                                      param_fields=("params", "ema"), opt_fields=("opt_state",))
    batch = dist.shard_batch({k: torch.from_numpy(v) for k, v in setup["batch"].items()})
    out = {"loss": [], "grad_norm": [], "module_grad_norms": [], "draws": [], "saved": None,
           "restored": None}
    if restore is not None:
        restore_state(make_manager(restore[0]), restore[1], state)
        out["restored"] = state_digest(state)
    for k in steps:
        seed = setup["seeds"][k]
        out["draws"].append({n: _np(v) for n, v in step.draw_inputs(
            batch, torch.Generator().manual_seed(seed)).items() if v is not None})
        state, m = step(state, batch, torch.Generator().manual_seed(seed))
        if state.ema is not None:
            from gmdx_torch.train import make_ema_step

            make_ema_step(cfg)(state)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["module_grad_norms"].append({n: float(v) for n, v in m["module_grad_norms"].items()})
        if save is not None and save[1] == k + 1:
            out["saved"] = save_state(make_manager(save[0]), k + 1, state)
    opt = state.optimizer
    out["placement"] = {  # elements this rank holds, between steps
        "params": sum(p.untyped_storage().nbytes() // p.element_size()
                      for p in opt.model_params),
        "master": sum(t.numel() for t in opt.master_params),
        "mu": sum(t.numel() for t in opt.mu), "nu": sum(t.numel() for t in opt.nu),
        "ema": sum(t.numel() for t in state.ema.shadow)}
    tensors, scalars = state_tensors(state)
    out["tensors"] = {n: _np(t) for n, t in tensors.items()}
    out["scalars"] = scalars
    out["digest"] = state_digest(state)
    return out


def job_stage2(setup: dict) -> dict:
    work = setup["workdir"]
    return {
        "ddp": stage2_run(setup, "ddp"),
        "zero1": stage2_run(setup, "zero1", save=(os.path.join(work, "ckpt_n2"), 1)),
        "fsdp": stage2_run(setup, "fsdp"),
        "fsdp_resumed": stage2_run(setup, "fsdp", steps=(1,),
                                   restore=(os.path.join(work, "ckpt_n1"), 1)),
    }


# --- Stage 1 ---------------------------------------------------------------


def stage1_setup(setup: dict):
    from gmdx_torch.io.convert import load_vae, stage1_trainables_from_flax
    from gmdx_torch.models import TINY_VAE_CONFIG
    from gmdx_torch.models.discriminator import Discriminator
    from gmdx_torch.models.lora import LoRAConfig
    from gmdx_torch.models.vgg import VGG19Features
    from gmdx_torch.train import stage1

    t = lambda v: torch.tensor(np.asarray(v))  # noqa: E731
    vae = load_vae(setup["vae_sd"], TINY_VAE_CONFIG, device="cpu", dtype=torch.float32)
    vgg = VGG19Features()
    vgg.load_state_dict({k: t(v) for k, v in setup["vgg_sd"].items()}, strict=True)
    disc = Discriminator(depth=4, hidden_channels=64)
    disc.load_state_dict({k: t(v) for k, v in setup["disc_sd"].items()}, strict=True)
    tr = stage1_trainables_from_flax(setup["trainables"])
    trainables = {"lora": {n: {k: t(v).requires_grad_(True) for k, v in f.items()}
                           for n, f in tr["lora"].items()},
                  "conv_out": {k: t(v).requires_grad_(True) for k, v in tr["conv_out"].items()}}
    cfg = stage1.Stage1Config(lora=LoRAConfig(rank=2, alpha=2.0),
                              vgg_resolution=setup["vgg_resolution"], use_ema=True,
                              adaptive_weight_max=setup["adaptive_weight_max"])
    return cfg, vae, vgg, disc, trainables


def stage1_run(setup: dict, strategy: str) -> dict:
    """One generator and one discriminator step of the tiny Stage 1 on this
    rank's rows, the posterior drawn from the setup's seed."""
    from gmdx_torch.ops import tmo
    from gmdx_torch.train import stage1

    cfg, vae, vgg, disc, trainables = stage1_setup(setup)
    state = stage1.init_state(cfg, trainables, disc,
                              stage1.make_optimizers(trainables, disc, lr_warmup_steps=0))
    state = dist.apply_shard_strategy(state, strategy,
                                      param_fields=("trainables", "disc_params", "ema"),
                                      opt_fields=("opt_state", "disc_opt_state"))
    gen_step = stage1.make_gen_step(cfg, vae=vae, discriminator=disc, vgg=vgg,
                                    tmo_fn=tmo.fix_mulog_tmo, device="cpu")
    disc_step = stage1.make_disc_step(cfg, vae=vae, discriminator=disc,
                                      tmo_fn=tmo.fix_mulog_tmo, device="cpu")
    batch = dist.shard_batch({k: torch.from_numpy(v) for k, v in setup["s1_batch"].items()})
    seed = setup["seeds"][0]
    state, g = gen_step(state, batch, torch.Generator().manual_seed(seed))
    stage1.make_ema_step(cfg)(state)
    state, d = disc_step(state, batch, torch.Generator().manual_seed(seed))
    from gmdx_torch.train.checkpoint import state_tensors

    tensors, _ = state_tensors(state)
    return {"gen": {k: float(v) for k, v in g.items() if k != "module_grad_norms"},
            "disc": {k: float(v) for k, v in d.items()},
            "tensors": {n: _np(t) for n, t in tensors.items()}}


def job_stage1(setup: dict) -> dict:
    return {s: stage1_run(setup, s) for s in ("ddp", "fsdp")}


# --- a small model, on any device ------------------------------------------


def mlp_setup(device: str) -> dict:
    """Four global batches of 8 rows for :func:`mlp_run` on ``device``."""
    rng = np.random.default_rng(11)
    return {"device": device, "mlp_batches": [
        (rng.standard_normal((8, 16)).astype(np.float32),
         rng.standard_normal((8, 16)).astype(np.float32)) for _ in range(4)]}


def mlp_run(setup: dict, strategy: str, accumulation: int) -> dict:
    """Updates of a seeded two-layer MLP (float32, ``setup["device"]``) with
    clipped AdamW, ``accumulation`` micro-batches an update (MultiSteps),
    on this rank's rows of the setup's global batches; the losses (the
    mean over the ranks) and the full parameters after."""
    from gmdx_torch.train.optim import (
        AdamW, MultiSteps, gathered, get_lr_schedule, model_params, reduce_gradients,
    )

    dev = torch.device(setup["device"])
    torch.manual_seed(0)
    model = torch.nn.Sequential(torch.nn.Linear(16, 64), torch.nn.GELU(),
                                torch.nn.Linear(64, 16)).to(dev)
    opt = AdamW(list(model.parameters()), get_lr_schedule("constant", 1e-2),
                max_grad_norm=0.5)
    if dist.is_initialized():  # small buckets: several a shard
        opt.distribute(dist.DataParallel(opt.params, strategy, bucket_bytes=1024))
    if accumulation > 1:
        opt = MultiSteps(opt, accumulation)
    losses = []
    for x, y in setup["mlp_batches"]:
        x, y = (dist.shard_batch({"t": torch.from_numpy(t).to(dev)})["t"] for t in (x, y))
        with gathered(opt):
            loss = torch.mean((model(x) - y) ** 2)
            grads = list(torch.autograd.grad(loss, model_params(opt)))
        opt.step(reduce_gradients(opt, grads))
        losses.append(float(dist.all_reduce_mean(loss.detach())))
    with gathered(opt):
        params = [p.detach().cpu().numpy().copy() for p in model_params(opt)]
    return {"loss": losses, "params": params}


def job_mlp(setup: dict) -> dict:
    return {(s, k): mlp_run(setup, s, k) for s in ("ddp", "zero1", "fsdp") for k in (1, 2)}


# --- the trainer CLIs ------------------------------------------------------


def job_cli(setup: dict) -> dict:
    """Each run of ``setup["cli_runs"]``: (name, script, argv); returns what
    each trainer's ``main`` returns, its state reduced to a digest."""
    import importlib.util

    from gmdx_torch.train.checkpoint import state_digest

    out = {}
    for name, script, argv in setup["cli_runs"]:
        spec = importlib.util.spec_from_file_location(
            script, os.path.join(REPO, "scripts", "torch", f"{script}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        res = mod.main(argv)
        res["digest"] = state_digest(res.pop("state"))
        out[name] = res
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Ranks:
    """``job`` of tests/torch_dist_ranks.py started on ``world`` gloo ranks
    (the test's own work goes on meanwhile); :meth:`results` waits for
    them. Logs go to files: a full pipe would block a rank inside a
    collective."""

    def __init__(self, job: str, world: int, workdir, setup: dict):
        self.job, self.workdir = job, str(workdir)
        with open(os.path.join(self.workdir, "setup.pkl"), "wb") as f:
            pickle.dump(setup, f)
        port = _free_port()
        env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
        env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", PYTHONPATH=REPO)
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            env.pop(k, None)
        self.logs = [open(os.path.join(self.workdir, f"{job}_{r}.log"), "w+")
                     for r in range(world)]
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, job, str(r), str(world), str(port), self.workdir],
            env=env, stdout=self.logs[r], stderr=subprocess.STDOUT, cwd=REPO)
            for r in range(world)]

    def results(self, timeout: float = 300) -> list[dict]:
        try:
            for p in self.procs:
                p.wait(timeout=timeout)
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
        out = []
        for r, (p, log) in enumerate(zip(self.procs, self.logs)):
            log.seek(0)
            text = log.read()
            log.close()
            assert p.returncode == 0, f"rank {r} of {self.job} failed:\n{text[-4000:]}"
            with open(os.path.join(self.workdir, f"{self.job}_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


JOBS = {"stage2": job_stage2, "stage1": job_stage1, "mlp": job_mlp, "cli": job_cli}


def main() -> None:
    job, rank, world, port, workdir = sys.argv[1:6]
    torch.set_num_threads(1)
    dist.initialize(f"localhost:{port}", int(world), int(rank), backend="gloo")
    with open(os.path.join(workdir, "setup.pkl"), "rb") as f:
        setup = pickle.load(f)
    setup["workdir"] = workdir
    from torch_pp_ranks import JOBS as PP_JOBS
    from torch_tp_ranks import JOBS as TP_JOBS

    out = {**JOBS, **TP_JOBS, **PP_JOBS}[job](setup)
    with open(os.path.join(workdir, f"{job}_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.shutdown()


if __name__ == "__main__":
    main()
