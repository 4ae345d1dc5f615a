"""Time gmdx_torch's GroupNorm forward (or backward) on one H100.

    python scripts/torch/time_group_norm.py [TAG] [--paths=NAME,...]
    python scripts/torch/time_group_norm.py [TAG] --bwd

Run from the root of a checkout (or of a copy, such as the parent commit
unpacked under ``build/``: each copy builds its own kernels; the script
imports ``chip_smoke`` and ``gmdx_torch`` from the working directory). At
every GroupNorm shape of the four paths, with the padded output and the
SiLU of a resnet's first norm, it prints one JSON line with three means of
20 launches (ms, CUDA events) of ``group_norm_silu`` (the copy's own plan,
or in a copy without plans the stats + apply pair), of its fp32 plain
version (``plain_ms``, the kernel table's reference column) and of
``F.silu(F.group_norm(...))`` over the NCHW view as the yardstick; the
relative L2 error of ``group_norm_silu`` against the fp32 plain version;
the bound (x read once, y written once, at 3.35 TB/s); the plan where the
copy has one; and the card's name and power limit. To compare plans or
kernels, run it from the root of each copy in turns in one call.

Paths (batch of the GroupNorm calls): ``unet512`` the 512^2 UNet at the
serving and sdr2hdr CFG batch 16; ``train`` the same UNet at the Stage-2
batch 8; ``dec512`` the VAE decoder of SDR + GM latents at 16; ``enc512``
the sdr2hdr encode at 8; ``unet1024`` the 1024^2 UNet and ControlNet at the
CFG batch 2; ``dec1024`` the 1024^2 decode at 2. ``--paths`` keeps those
named. TAG is copied into every line, to tell copies apart when several
run in turns in one call.

``--bwd`` times ``group_norm_silu_bwd`` instead, at every GroupNorm shape of
the Stage-2 step at batch 8: a resnet norm2's form (temb, SiLU, padded
cotangent) at each shape, and the transformer's (neither) at its four. Each
line has three means of 20 calls by CUDA events (host and device), the
device time a call by torch.profiler (every kernel the call launches,
summed: the wrapper's own reductions too, where it has them) and by kernel
name, the same for the fp32 plain version (``plain``) and for
``F.group_norm`` (+ ``F.silu``) differentiated by
autograd (on x + temb; dtemb is not in it) as the yardstick, the largest
relative L2 error of the four outputs against the fp32 plain version, the
bound (x and g read once, dx written once, at 3.35 TB/s), the plan where the
copy has one, and the card's name and power limit. Run this file from the
root of each copy (``cd COPY && python /path/to/time_group_norm.py TAG
--bwd``): it imports ``chip_smoke`` and ``gmdx_torch`` from there.
"""

import json
import os
import sys

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke as cs  # noqa: E402
from gmdx_torch.kernels import _build  # noqa: E402
from gmdx_torch.kernels import groupnorm as gn  # noqa: E402

# (H, W, C) of each model's GroupNorm calls (distinct shapes), from the
# SD-1.5 configs (tests/test_torch_norm_plan.py collects them by a forward
# on the meta device).
UNET_64 = [(8, 8, 1280), (8, 8, 2560), (16, 16, 640), (16, 16, 1280), (16, 16, 1920),
           (16, 16, 2560), (32, 32, 320), (32, 32, 640), (32, 32, 960), (32, 32, 1280),
           (32, 32, 1920), (64, 64, 320), (64, 64, 640), (64, 64, 960)]
UNET_128 = [(2 * h, 2 * w, c) for h, w, c in UNET_64]
DEC_64 = [(64, 64, 512), (128, 128, 512), (256, 256, 256), (256, 256, 512), (512, 512, 128),
          (512, 512, 256)]
ENC_512 = [(64, 64, 512), (128, 128, 256), (128, 128, 512), (256, 256, 128), (256, 256, 256),
           (512, 512, 128)]
DEC_128 = [(2 * h, 2 * w, c) for h, w, c in DEC_64]
PATHS = {"unet512": (16, UNET_64), "train": (8, UNET_64), "dec512": (16, DEC_64),
         "enc512": (8, ENC_512), "unet1024": (2, UNET_128), "dec1024": (2, DEC_128)}
# The backward's cases at the Stage-2 batch: (H, W, C, temb, SiLU, pad).
TRAIN_BATCH = 8
BWD_CASES = [(h, w, c, True, True, True) for h, w, c in UNET_64] + [
    (h, w, c, False, False, False) for h, w, c in ((64, 64, 320), (32, 32, 640), (16, 16, 1280),
                                                     (8, 8, 1280))]


def device_ms(fn, iters: int = 10) -> tuple[float, dict[str, float]]:
    """Device time of one call of ``fn`` (every kernel it launches, by
    torch.profiler over ``iters`` calls) and the same by kernel name."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    by_name = {ev.key[:60]: ev.self_device_time_total / iters / 1e3 for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0}
    return sum(by_name.values()), by_name


def time_bwd(tag: str, smi: str, gen) -> None:
    b = TRAIN_BATCH
    plan_of = getattr(gn, "group_norm_bwd_plan", None)
    for h, w, c, temb, act, pad in BWD_CASES:
        x = (torch.randn(b, h, w, c, generator=gen, device="cuda") * 2 + 0.5).to(torch.bfloat16)
        gam = (1 + 0.2 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
        bet = (0.2 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
        t = (torch.randn(b, c, generator=gen, device="cuda").to(torch.bfloat16)
             if temb else None)
        cot = torch.randn(b, h + 2 * pad, w + 2 * pad, c, generator=gen,
                          device="cuda").to(torch.bfloat16)
        _, stats = gn.group_norm_silu(x, gam, bet, t, activate=act, pad_output=pad,
                                      return_stats=True)
        f32 = (x.float(), gam.float(), bet.float(), t.float() if temb else None)
        cot32 = cot.float()
        ref = gn.group_norm_silu_bwd_plain(*f32, stats, cot32, activate=act, pad_output=pad)
        xin = x if t is None else (x.float() + t.float()[:, None, None, :]).to(torch.bfloat16)
        xl = xin.permute(0, 3, 1, 2).detach().requires_grad_()
        gl, bl = gam.detach().requires_grad_(), bet.detach().requires_grad_()
        yl = F.group_norm(xl, 32, gl, bl, 1e-5)
        yl = F.silu(yl) if act else yl
        cot_l = (cot[:, 1:-1, 1:-1] if pad else cot).permute(0, 3, 1, 2)
        fns = {
            "default": lambda: gn.group_norm_silu_bwd(x, gam, bet, t, stats, cot, activate=act,
                                                      pad_output=pad),
            "plain": lambda: gn.group_norm_silu_bwd_plain(*f32, stats, cot32, activate=act,
                                                          pad_output=pad),
            "library": lambda: torch.autograd.grad(yl, (xl, gl, bl), cot_l, retain_graph=True),
        }
        row = {"tag": tag, "kind": "bwd", "shape": [b, h, w, c], "temb": temb, "silu": act,
               "pad": pad, "device": smi}
        if plan_of is not None:
            row["plan"] = plan_of(b, h, w, c).__dict__
        got = fns["default"]()
        row["rel_l2"] = max(cs.compare(a, r)[1] for a, r in zip(got, ref) if r is not None)
        for name, fn in fns.items():
            row[f"{name}_ms"] = [cs.time_ms(fn, iters=20) for _ in range(3)]
            row[f"{name}_device_ms"], row[f"{name}_kernels_ms"] = device_ms(fn)
        nbytes = (2 * x.numel() + cot.numel()) * 2
        row["bound_ms"] = nbytes / cs.HBM_BYTES_S * 1e3
        print(json.dumps(row), flush=True)
        del x, cot, ref, xl, yl, f32, cot32


def main() -> None:
    argv = [a for a in sys.argv[1:] if not a.startswith("--")]
    tag = argv[0] if argv else ""
    only = [a.split("=", 1)[1].split(",") for a in sys.argv if a.startswith("--paths=")]
    if not torch.cuda.is_available():
        raise SystemExit("time_group_norm: no CUDA device")
    _build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(1)
    smi = cs.nvidia_smi_line()
    if "--bwd" in sys.argv:
        time_bwd(tag, smi, gen)
        return
    plan_of = getattr(gn, "group_norm_plan", None)
    for path, (b, shapes) in PATHS.items():
        if only and path not in only[0]:
            continue
        for h, w, c in shapes:
            x = (torch.randn(b, h, w, c, generator=gen, device="cuda") * 2 + 0.5).to(torch.bfloat16)
            g = (1 + 0.2 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
            be = (0.2 * torch.randn(c, generator=gen, device="cuda")).to(torch.bfloat16)
            f32 = (x.float(), g.float(), be.float())
            ref = gn.group_norm_silu_plain(*f32, pad_output=True)
            fns = {"default": lambda: gn.group_norm_silu(x, g, be, pad_output=True),
                   "plain": lambda: gn.group_norm_silu_plain(*f32, pad_output=True)}
            row = {"tag": tag, "path": path, "shape": [b, h, w, c], "device": smi}
            if plan_of is not None:
                row["plan"] = plan_of(b, h, w, c).__dict__
            x_nchw = x.permute(0, 3, 1, 2)
            fns["library"] = lambda: F.silu(F.group_norm(x_nchw, 32, g, be, 1e-5))
            for name, fn in fns.items():
                if name == "default":
                    row[f"{name}_rel_l2"] = cs.compare(fn(), ref)[1]
                row[f"{name}_ms"] = [cs.time_ms(fn, iters=20) for _ in range(3)]
            nbytes = (x.numel() + b * (h + 2) * (w + 2) * c + 2 * c) * 2
            row["bound_ms"] = nbytes / cs.HBM_BYTES_S * 1e3
            print(json.dumps(row), flush=True)
            del x, ref, x_nchw, f32


if __name__ == "__main__":
    main()
