"""Where Stage 1's generator step under SP parts from one process's, on one H100.

    python scripts/torch/stage1_sp_probes.py

Run from the root of a checkout (it imports ``chip_smoke`` and
``gmdx_torch`` from the working directory and builds the kernels there).
It runs the generator step of ``chip_smoke.py``'s phase ``trainers_parallel``
(SD-1.5 width, 1024^2, batch 1, LoRA b factors N(0, 1e-2^2), VGG19 and the
discriminator in fp32, its seeds) in one process and on two gloo ranks of
the card under SP = 2, in four variants: the decoder's ``conv_out`` in
bf16 or in fp32, and the adaptive weight's two probes the ranks' own or
the one process's (so that the weight is the one process's and what stays
apart is the rest of the step). For each variant it prints one JSON line:
the loss parts and the adaptive weight against the one process's (relative
errors), the relative L2 of each summed probe against the one process's,
each rank's probe norm over the summed probe's (how far the two halves
cancel), and the generator gradient's cosine against the one process's
(bf16 vector, as the phase takes it). Then, from the bf16 run with the
ranks' own probes, the discriminator's input gradient of the adversarial
term (fp32, TF32 off, as in the phase): the ranks' (under SP, on their rows
of the image the step tonemapped) against one process's on the same image
(the ranks' arithmetic), and one process's on the ranks' image and on its
own image rounded to bf16 against its own (how far that gradient moves
with its input). Last, the card's name and power limit.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402

SIDE, BATCH, SEED = cs.HDRTV_SIDE, 1, cs.TRAINERS_PARALLEL_SEED + 1
DTYPES = ("bf16", "fp32")
VARIANTS = tuple((d, fixed) for d in DTYPES for fixed in (False, True))


def _patch(vae, dtype: str, probes_in: str | None, probes: list, tmos: list):
    """The decoder's conv_out computing in ``dtype``; the step's
    ``layout_mean`` of the two probes recording each (the rank's own norm,
    the combined probe) and, with ``probes_in``, returning the one
    process's probes in their place; the tonemapped image kept in ``tmos``."""
    import torch

    from gmdx_torch.models import vae as vae_mod
    from gmdx_torch.train import stage1

    conv, mean, tonemap = vae_mod.conv2d_nhwc, stage1.layout_mean, stage1.reconstruct_and_tonemap
    head = vae.decoder.conv_out
    want = torch.float32 if dtype == "fp32" else torch.bfloat16
    fixed = torch.load(probes_in) if probes_in else None

    def conv2d_nhwc(x, c, **kw):
        return conv(x.to(want) if c is head else x, c, **kw)

    def layout_mean(tensors, layout=None):
        out = mean(tensors, layout)
        if len(tensors) != 2 or tensors[0].shape != head.weight.shape:
            return out  # the reported scalars
        probes.extend((float(torch.linalg.vector_norm(g.float())), p.detach().float().clone())
                      for g, p in zip(tensors, out))
        return out if fixed is None else [p.to(o.device, o.dtype) for p, o in zip(fixed, out)]

    def reconstruct_and_tonemap(*a):
        tmos.append(tonemap(*a))
        return tmos[-1]

    vae_mod.conv2d_nhwc, stage1.layout_mean = conv2d_nhwc, layout_mean
    stage1.reconstruct_and_tonemap = reconstruct_and_tonemap
    return lambda: (setattr(vae_mod, "conv2d_nhwc", conv), setattr(stage1, "layout_mean", mean),
                    setattr(stage1, "reconstruct_and_tonemap", tonemap))


def _run(root: str, dtype: str, fixed: bool, layout, tag: str) -> dict:
    """One generator step of the variant, in one process or on a rank."""
    import torch

    from gmdx_torch import dist
    from gmdx_torch.train import stage1

    mode = None if layout is None else layout.mode
    config, vae, disc, trainables, (gen_step, _), _ = cs.build_stage1(
        SEED, lora_b_std=1e-2, layout=layout, gan_dtype=torch.float32)
    state = stage1.init_state(config, trainables, disc, stage1.make_optimizers(
        trainables, disc, learning_rate=0.0, discr_learning_rate=0.0, lr_warmup_steps=0))
    batch = cs.stage1_batch(BATCH, SIDE, torch.Generator(device="cuda").manual_seed(SEED + 3))
    if layout is not None:
        state = dist.apply_shard_strategy(
            state, mode, param_fields=("trainables", "disc_params", "ema"),
            opt_fields=("opt_state", "disc_opt_state"), layout=layout)
        batch = dist.spatial_batch(batch, layout)
    stats, probes, tmos = [], [], []
    grad = os.path.join(root, f"one_{dtype}_gen.bin")
    cs._capture_cosines(state.optimizer, stats, grad, mode)
    undo = _patch(vae, dtype, os.path.join(root, f"one_{dtype}_probes.pt") if fixed else None,
                  probes, tmos)
    try:
        state, m = gen_step(state, batch, torch.Generator(device="cuda").manual_seed(SEED + 4))
        torch.cuda.synchronize()
    finally:
        undo()
    row = {k: float(v) for k, v in m.items() if k not in ("module_grad_norms", "grad_norm")}
    row["own_probe_norms"] = [n for n, _ in probes]
    row["summed_probe_norms"] = [float(torch.linalg.vector_norm(p)) for _, p in probes]
    if dtype == "bf16" and not fixed:
        torch.save({"tmo": tmos[0].detach().cpu(), "grad": cs._disc_input_grad(
            state.discriminator, tmos[0], layout).cpu()}, os.path.join(root, f"{tag}_disc.pt"))
    if mode is None:
        torch.save([p.cpu() for _, p in probes], os.path.join(root, f"one_{dtype}_probes.pt"))
    else:
        ref = torch.load(os.path.join(root, f"one_{dtype}_probes.pt"))
        row["probe_rel_l2"] = [float(torch.linalg.vector_norm(p.cpu() - r)
                                     / torch.linalg.vector_norm(r))
                               for (_, p), r in zip(probes, ref)]
        row["gen_grad_cosine"], row["gen_grad_sign_flip_share"] = stats[0]
    return row


def job(role: str, root: str, port: int) -> None:
    """``one``: the one process's two dtypes; ``0`` / ``1``: a rank's four
    variants, each once the one process has written its dtype."""
    import torch

    from gmdx_torch import dist
    from gmdx_torch.dist import tpctx

    torch.backends.cuda.matmul.allow_tf32 = False  # as the phase's processes
    torch.backends.cudnn.allow_tf32 = False
    out = {}
    if role == "one":
        for dtype in DTYPES:
            out[dtype] = _run(root, dtype, False, None, "one")
            with open(os.path.join(root, f"one_{dtype}.json"), "w") as f:
                json.dump(out[dtype], f)
        return
    dist.initialize(f"localhost:{port}", 2, int(role), backend="gloo")
    layout = tpctx.join_train_parallel("sp", 2)
    for dtype, fixed in VARIANTS:
        deadline = time.perf_counter() + 600
        while not os.path.exists(os.path.join(root, f"one_{dtype}.json")):
            if time.perf_counter() > deadline:
                raise SystemExit(f"no one-process {dtype} run after 600 s")
            time.sleep(0.5)
        out[f"{dtype}_{'fixed' if fixed else 'own'}"] = _run(root, dtype, fixed, layout,
                                                             f"rank{role}")
    with open(os.path.join(root, f"rank{role}.json"), "w") as f:
        json.dump(out, f)
    dist.shutdown()


def _disc_sensitivity(root: str) -> dict:
    """The discriminator's input gradients of the bf16 run (relative L2s)."""
    import torch

    def rel(a, b):
        return float(torch.linalg.vector_norm((a - b).double()) / torch.linalg.vector_norm(
            b.double()))

    one = torch.load(os.path.join(root, "one_disc.pt"))
    ranks = [torch.load(os.path.join(root, f"rank{r}_disc.pt")) for r in (0, 1)]
    tmo = torch.cat([r["tmo"] for r in ranks], dim=2).cuda()
    grad = torch.cat([r["grad"] for r in ranks], dim=2).cuda()
    _, _, disc, *_ = cs.build_stage1(SEED, lora_b_std=1e-2, gan_dtype=torch.float32)
    at_ranks = cs._disc_input_grad(disc, tmo)
    own = one["grad"].cuda()
    return {"tmo_rel_l2": rel(tmo, one["tmo"].cuda()),
            "ranks_vs_one_same_image": rel(grad, at_ranks),
            "ranks_vs_one": rel(grad, own),
            "one_ranks_image_vs_own": rel(at_ranks, own),
            "one_bf16_rounded_vs_own": rel(cs._disc_input_grad(
                disc, one["tmo"].cuda().bfloat16().float()), own),
            "grad_norm_one": float(torch.linalg.vector_norm(own))}


def main() -> None:
    cs.phase_device()
    cs.phase_build()
    root = tempfile.mkdtemp(prefix="stage1_sp_probes_")
    me = [sys.executable, os.path.abspath(__file__)]
    port = cs._free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs = []
    try:
        for role in ("one", "0", "1"):
            log = open(os.path.join(root, f"{role}.log"), "w")
            procs.append((role, log, subprocess.Popen(me + [role, root, str(port)], stdout=log,
                                                      stderr=subprocess.STDOUT, env=env)))
        deadline = time.perf_counter() + 700
        for role, log, p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                pass
            if p.returncode != 0:
                with open(os.path.join(root, f"{role}.log")) as f:
                    raise SystemExit(f"{role} failed ({p.returncode}):\n{f.read()[-3000:]}")
        one = {d: json.load(open(os.path.join(root, f"one_{d}.json"))) for d in DTYPES}
        ranks = [json.load(open(os.path.join(root, f"rank{r}.json"))) for r in (0, 1)]
        print(json.dumps({"one_process": one, "adaptive_weight_fp32_vs_bf16": abs(
            one["fp32"]["adaptive_weight"] - one["bf16"]["adaptive_weight"])
            / one["bf16"]["adaptive_weight"]}), flush=True)
        for name in ranks[0]:
            base = one[name.split("_")[0]]
            for r, res in enumerate(ranks):
                run = res[name]
                print(json.dumps({"variant": name, "rank": r, **run, "rel_err": {
                    k: abs(run[k] - base[k]) / max(abs(base[k]), 1e-30)
                    for k in ("gen_loss", "recon", "perceptual", "adversarial",
                              "adaptive_weight")}}), flush=True)
        print(json.dumps(_disc_sensitivity(root)), flush=True)
        print(cs.nvidia_smi_line(), flush=True)
    finally:
        for _, log, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()


if __name__ == "__main__":
    if len(sys.argv) == 4:
        job(*sys.argv[1:3], int(sys.argv[3]))
    else:
        main()
