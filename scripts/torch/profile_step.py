"""Device trace of the port's hot paths: the counterpart of
``scripts/tools/profile_step.py``.

Builds a workload at SD-1.5 width with seeded random weights, runs it once
(kernel builds, cuDNN's plans), then traces ``--iters`` steady-state
iterations through ``gmdx_torch.utils.trace`` (one Chrome trace, each
iteration an ``annotate`` span) and prints ``gmdx_torch.utils.read_trace``'s
reading of it: device time by category and the top kernels, the device's
busy share over the traced window, and its longest idle gaps, each named by
the host op and span open where it began; then the same as one JSON line,
with the card's name and power limit.

    python scripts/torch/profile_step.py --workload gm_unet_fwd --iters 10
    python scripts/torch/profile_step.py --workload dual_step --top 30
    python scripts/torch/profile_step.py --workload dual_scan --iters 1 --out traces/
    python scripts/torch/profile_step.py --workload train_step --category "cublas gemm"
    python scripts/torch/profile_step.py --workload gm_unet_fwd --size tiny --res 64 --device cpu

Workloads: ``gm_unet_fwd`` (the 8-channel GM UNet), ``dual_step`` (one step
of the dual loop: the SDR UNet at the CFG batch, the guidance, x0, the GM
UNet), ``dual_scan`` (``bench.py``'s workload: ``denoise_dual`` at PNDM 50,
CFG 7.5, then one batched decode of SDR and GM), ``vae_decode``,
``train_step`` (the Stage-2 step, pixel batch, bf16 first moment),
``unet_grad`` (the GM UNet's loss and gradient, no optimizer),
``stage1_gen`` and ``stage1_disc`` (Stage 1's generator and discriminator
steps: the VAE with LoRA r = 64, VGG19, the Paella discriminator). A
trace of ``dual_scan`` holds 51 iterations of two UNets: keep ``--iters``
at 1 or 2. The kernel flags (``gmdx_torch.kernel_flags``) set the JAX
tool's ``GMDX_*`` choices on every module.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

from scan_bench import SIZES, configs  # noqa: E402

DUAL_SCAN_STEPS = 50
GUIDANCE = 7.5


def _inputs(args, dev, channels: int, ctx_rows: int):
    """Seeded latents (batch, channels, res/8, res/8) in fp32, a text
    context (ctx_rows, 77, width) in the compute dtype, t = 501 on the
    device."""
    cfg = configs(args.size)
    g = torch.Generator(device=dev).manual_seed(1)
    h = args.res // 8
    x = torch.randn(args.batch, channels, h, h, generator=g, device=dev)
    ctx = torch.randn(ctx_rows, *cfg["ctx"], generator=g, device=dev).to(args.dtype)
    return x, ctx, torch.tensor(501, dtype=torch.int32, device=dev)


def _unet(args, dev, which: str):
    from gmdx_torch.models import UNet2DConditionModel

    with torch.device(dev):
        return UNet2DConditionModel(configs(args.size)[which]).to(args.dtype).eval()


def _vae(args, dev):
    from gmdx_torch.models import AutoencoderKL

    with torch.device(dev):
        return AutoencoderKL(configs(args.size)["vae"]).to(args.dtype).eval()


def build_gm_unet_fwd(args, dev):
    torch.manual_seed(0)
    unet = _unet(args, dev, "gm_unet")
    x, ctx, t = _inputs(args, dev, 8, args.batch)
    return torch.no_grad()(lambda: unet(x, t, ctx)), [unet]


def build_dual_step(args, dev):
    from gmdx_torch.schedulers import PNDMScheduler

    torch.manual_seed(0)
    sdr_unet, gm_unet = _unet(args, dev, "unet"), _unet(args, dev, "gm_unet")
    acp = torch.as_tensor(PNDMScheduler().alphas_cumprod, device=dev)
    lat, ctx, t = _inputs(args, dev, 4, 2 * args.batch)
    a_t = acp[t.long()]

    @torch.no_grad()
    def step():
        eps = sdr_unet(torch.cat([lat, lat]), t, ctx)
        eps_u, eps_t = eps.chunk(2)
        eps = eps_u + GUIDANCE * (eps_t - eps_u)
        x0 = (lat - torch.sqrt(1.0 - a_t) * eps) / torch.sqrt(a_t)
        gm_eps = gm_unet(torch.cat([x0, lat], dim=1), t, ctx[args.batch:])
        return eps, gm_eps

    return step, [sdr_unet, gm_unet]


def build_dual_scan(args, dev):
    from gmdx_torch.pipelines import StableDiffusionDualUNetPipeline
    from gmdx_torch.schedulers import PNDMScheduler

    torch.manual_seed(0)
    pipe = StableDiffusionDualUNetPipeline(
        _unet(args, dev, "unet"), _vae(args, dev), PNDMScheduler(), _unet(args, dev, "gm_unet"),
        device=dev)
    latents = pipe.prepare_latents(torch.Generator(device=dev).manual_seed(1), args.batch,
                                   args.res, args.res)
    _, cond, _ = _inputs(args, dev, 4, args.batch)
    uncond = torch.zeros_like(cond)

    @torch.no_grad()
    def step():
        sdr, gm = pipe.denoise_dual(cond, uncond, latents, num_inference_steps=DUAL_SCAN_STEPS,
                                    guidance_scale=GUIDANCE)
        return pipe.decode_latents(torch.cat([sdr, gm]))

    return step, [pipe.unet, pipe.gm_unet, pipe.vae]


def build_vae_decode(args, dev):
    torch.manual_seed(0)
    vae = _vae(args, dev)
    lat, _, _ = _inputs(args, dev, 4, 1)
    return torch.no_grad()(lambda: vae.decode(lat)), [vae]


def build_train_step(args, dev):
    from gmdx_torch.models import AutoencoderKL, CLIPTextModel, UNet2DConditionModel
    from gmdx_torch.train import Stage2Config, init_state, make_train_step

    cfg = configs(args.size)
    torch.manual_seed(0)
    with torch.device(dev):  # fp32 master weights, compute in --dtype
        unet = UNet2DConditionModel(cfg["gm_unet"], dtype=args.dtype)
        vae = AutoencoderKL(cfg["vae"]).to(args.dtype).eval()
        text = CLIPTextModel(cfg["clip"]).to(args.dtype).eval()
    config = Stage2Config(use_ema=False, use_8bit_adam=True)
    step_fn = make_train_step(config, unet=unet, vae=vae, text_encoder=text, device=dev)
    holder = {"state": init_state(config, unet)}
    g = torch.Generator(device=dev).manual_seed(4)
    b, r = args.batch, args.res
    batch = {"sdr": torch.rand(b, 3, r, r, generator=g, device=dev) * 2 - 1,
             "gm": torch.rand(b, 3, r, r, generator=g, device=dev) * 2 - 1,
             "input_ids": torch.ones(b, 77, dtype=torch.long, device=dev)}

    def step():
        holder["state"], metrics = step_fn(holder["state"], batch, g)
        return metrics["loss"]

    return step, [unet, vae]


def build_unet_grad(args, dev):
    from gmdx_torch.models import UNet2DConditionModel

    torch.manual_seed(0)
    with torch.device(dev):
        unet = UNet2DConditionModel(configs(args.size)["gm_unet"], dtype=args.dtype).train()
    x, ctx, t = _inputs(args, dev, 8, args.batch)
    tgt = torch.randn(x.shape[0], 4, *x.shape[2:], generator=torch.Generator(
        device=dev).manual_seed(3), device=dev)

    def step():
        unet.zero_grad(set_to_none=True)
        loss = ((unet(x, t, ctx).float() - tgt) ** 2).mean()
        loss.backward()
        return loss

    return step, [unet]


def _build_stage1(args, dev, kind: str):
    from gmdx_torch.models import AutoencoderKL
    from gmdx_torch.models.discriminator import Discriminator
    from gmdx_torch.models.lora import LoRAConfig
    from gmdx_torch.models.vgg import VGG19Features
    from gmdx_torch.ops import fix_mulog_tmo
    from gmdx_torch.train import stage1

    tiny = args.size == "tiny"
    torch.manual_seed(0)
    with torch.device(dev):
        vae = AutoencoderKL(configs(args.size)["vae"], dtype=args.dtype)
        vgg = VGG19Features(dtype=args.dtype)
        disc = (Discriminator(depth=4, hidden_channels=64, dtype=args.dtype) if tiny
                else Discriminator(dtype=args.dtype))
    config = (stage1.Stage1Config(lora=LoRAConfig(rank=2, alpha=2.0), vgg_resolution=32)
              if tiny else stage1.Stage1Config())
    g = torch.Generator(device=dev).manual_seed(1)
    state = stage1.init_state(config, stage1.init_trainables(g, vae, config), disc)
    if kind == "gen":
        step_fn = stage1.make_gen_step(config, vae=vae, discriminator=disc, vgg=vgg,
                                       tmo_fn=fix_mulog_tmo, device=dev)
    else:
        step_fn = stage1.make_disc_step(config, vae=vae, discriminator=disc,
                                        tmo_fn=fix_mulog_tmo, device=dev)
    b, r = args.batch, args.res
    batch = {k: torch.rand(b, 3, r, r, generator=g, device=dev) * 2 - 1
             for k in ("pixel_values", "miss_pixel_values")}
    holder = {"state": state}

    def step():
        holder["state"], metrics = step_fn(holder["state"], batch, g)
        return metrics[f"{kind}_loss"]

    return step, [vae]


def build_stage1_gen(args, dev):
    return _build_stage1(args, dev, "gen")


def build_stage1_disc(args, dev):
    return _build_stage1(args, dev, "disc")


WORKLOADS = {
    "gm_unet_fwd": build_gm_unet_fwd,
    "dual_step": build_dual_step,
    "dual_scan": build_dual_scan,
    "vae_decode": build_vae_decode,
    "train_step": build_train_step,
    "unet_grad": build_unet_grad,
    "stage1_gen": build_stage1_gen,
    "stage1_disc": build_stage1_disc,
}


def parse_args(argv=None):
    from gmdx_torch.kernel_flags import add_kernel_flags

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", choices=sorted(WORKLOADS), default="gm_unet_fwd")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--out", default=None, help="trace directory (default: a temporary one)")
    ap.add_argument("--category", default=None,
                    help="restrict the top kernels to one category (e.g. 'cublas gemm')")
    ap.add_argument("--size", choices=SIZES, default="sd15",
                    help="model widths: SD-1.5's, or the tiny test configs")
    ap.add_argument("--device", default="cuda")
    add_kernel_flags(ap, train=True)
    args = ap.parse_args(argv)
    args.dtype = getattr(torch, args.dtype)
    return args


def report(reading: dict, iters: int, category=None) -> None:
    """The reading as the JAX tool prints its table."""
    total = reading["device_ms"]
    print(f"device total: {total:.2f} ms over {iters} iters ({total / iters:.2f} ms/iter); "
          f"window {reading['window_ms']:.2f} ms; busy share {reading['busy_share']}")
    print("== by category ==")
    for row in reading["by_category"]:
        print(f"{100 * row['share']:5.1f}%  {row['device_ms']:9.3f} ms  {row['count']:6d}  "
              f"{row['category']}")
    print(f"== top {len(reading['top'])} {repr(category) + ' ' if category else ''}kernels ==")
    for row in reading["top"]:
        print(f"{100 * row['share']:5.1f}%  {row['device_ms']:9.3f} ms  {row['count']:6d}  "
              f"[{row['category']}] {row['name'][:110]}")
    print("== longest idle gaps ==")
    for gap in reading["idle_gaps"]:
        print(f"{gap['ms']:9.3f} ms at {gap['at_ms']:9.3f} ms  host op {gap['host_op']}  "
              f"span {gap['span']}")


def main(argv=None) -> dict:
    from gmdx_torch import resolve_device
    from gmdx_torch.kernel_flags import apply_kernel_flags, kernel_options
    from gmdx_torch.utils import annotate, card_line, read_trace, sync, trace

    args = parse_args(argv)
    dev = resolve_device(args.device)
    step, modules = WORKLOADS[args.workload](args, dev)
    apply_kernel_flags(args, *modules)
    sync(step())  # kernel builds, weight operands, cuDNN's plans: outside the trace
    with tempfile.TemporaryDirectory(prefix="gmdx_trace_") as tmp:
        with trace(args.out or tmp, prefix=f"{args.workload}_") as path:
            for i in range(args.iters):
                with annotate(f"{args.workload}[{i}]"):
                    out = step()
            sync(out)
        reading = read_trace(path, top=args.top, only_category=args.category)
    print(f"trace: {path if args.out else '(temporary)'}")
    report(reading, args.iters, args.category)
    row = {"tool": "profile_step", "workload": args.workload, "batch": args.batch,
           "res": args.res, "size": args.size, "dtype": str(args.dtype).removeprefix("torch."),
           "iters": args.iters, "kernel_options": kernel_options(args), "device": str(dev),
           "card": card_line() if dev.type == "cuda" else None,
           "trace": path if args.out else None, **reading}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
