"""Smoke run of the PyTorch/CUDA port (``gmdx_torch``) on one NVIDIA H100.

    python3 chip_smoke.py                    # batch 2, 10 PNDM steps
    python3 chip_smoke.py --batch 8 --steps 50 --profile

Phases, each printing JSON lines; any failure exits non-zero:
  1. device: card name, power limit and capability; requires a (9, 0) card.
  2. build: compiles gmdx_torch/csrc with nvcc (seconds printed).
  3. kernels: each hand-written kernel at the main path's shapes against its
     plain PyTorch version (fp32, TF32 off; relative L2 <= 1e-2, the bf16
     rounding of inputs and output), with times for the kernel, the plain
     version and one PyTorch library call as a yardstick.
  4. main: the full-width SD-1.5 dual-UNet text-to-HDR path at 512^2 with
     seeded random bf16 weights: denoise_dual (PNDM, CFG 7.5), one batched
     VAE decode, Eq. (1), a .hdr written and read back. Launch counts of
     every kernel are read around this phase only.
  5. e2e: batch 1, 3 steps, kernels vs plain versions; decoded SDR and GM
     images must agree to >= 40 dB PSNR.
``--profile`` adds, before phase 4's timed run, the device time by kernel
over one denoise iteration and the device's busy share.
The line before the last is the {"kernels": [...]} summary; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, fp32 outside
# the tensor cores, HBM.
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12
REL_L2_MAX = 1e-2
PSNR_MIN_DB = 40.0
E2E_STEPS = 3

# Each ported kernel's source and the TPU kernel's pl.pallas_call site it
# replaces (group_norm_silu also replaces gmdx/kernels/groupnorm.py:712).
KERNELS = {
    "attention_kv_resident": (
        "gmdx_torch/csrc/attention.cu", "gmdx/kernels/flash_attention.py:778"),
    "conv3x3": ("gmdx_torch/csrc/conv3x3.cu", "gmdx/kernels/winograd.py:815"),
    "group_norm_silu": (
        "gmdx_torch/csrc/groupnorm.cu", "gmdx/kernels/groupnorm.py:473"),
    "geglu_ff_ln": ("gmdx_torch/csrc/geglu_ff.cu", "gmdx/kernels/geglu_ff.py:325"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls
    after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float, peak: float = BF16_FLOPS) -> tuple[float, str]:
    """The least time for ``flops`` operations at ``peak`` and ``nbytes``
    of device memory traffic, and which of the two bounds it."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def compare(out, ref) -> tuple[float, float]:
    """(max abs error, relative L2 error) of ``out`` against ``ref``."""
    d = out.float() - ref.float()
    rel = float(d.norm() / ref.float().norm().clamp_min(1e-30))
    return float(d.abs().max()), rel


# ---------------------------------------------------------------------------
# phase 1 + 2
# ---------------------------------------------------------------------------


def phase_device() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = nvidia_smi_line()
    print(smi, flush=True)
    cap = torch.cuda.get_device_capability(0)
    info = {
        "phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
        "capability": list(cap), "count": torch.cuda.device_count(),
        "torch": torch.__version__, "cuda": torch.version.cuda,
    }
    emit(info)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: needs an sm_90 card, got capability {cap}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return info


def phase_build() -> None:
    from gmdx_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build_all()
    for name in _build.SIGNATURES:
        _build.library(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_info.get("seconds")})
    for name, report in _build.build_info.get("ptxas", {}).items():
        lines = [ln for ln in report.splitlines() if "registers" in ln or "spill" in ln]
        emit({"phase": "build", "source": f"{name}.cu", "ptxas": lines})


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------


def _randn(gen, *shape, scale=1.0):
    import torch

    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)


def _check(name, shape, kernel_fn, plain_fn, library_fn, flops, nbytes, results,
           peak=BF16_FLOPS):
    """Run one kernel case: error against the fp32 plain version, times."""
    import torch

    out = kernel_fn()
    torch.cuda.synchronize()
    ref = plain_fn()
    max_abs, rel = compare(out, ref)
    ms = time_ms(kernel_fn)
    plain_ms = time_ms(plain_fn, iters=3)
    lib_ms = time_ms(library_fn) if library_fn is not None else None
    b_ms, b_by = bound_ms(flops, nbytes, peak)
    row = {
        "phase": "kernels", "name": name, "shape": shape, "max_abs_err": max_abs,
        "rel_l2": rel, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
        "bound_ms": b_ms, "bound_by": b_by, "roofline_share": b_ms / ms,
    }
    emit(row)
    results.append(row)
    if not math.isfinite(rel) or rel > REL_L2_MAX:
        raise SystemExit(f"chip_smoke: {name} {shape} rel-L2 {rel} > {REL_L2_MAX}")


def phase_kernels(batch: int) -> list[dict]:
    import torch
    import torch.nn.functional as F

    from gmdx_torch.kernels.attention import (
        attention_kv_resident, attention_kv_resident_plain,
    )
    from gmdx_torch.kernels.geglu_ff import geglu_ff_ln, geglu_ff_ln_plain
    from gmdx_torch.kernels.groupnorm import group_norm_silu, group_norm_silu_plain
    from gmdx_torch.kernels.winograd import conv3x3, conv3x3_plain, pack_weight

    gen = torch.Generator(device="cuda").manual_seed(1234)
    cfg_b = 2 * batch  # the SDR UNet's CFG-doubled batch
    results: list[dict] = []
    f32 = lambda *ts: [t.float() if t is not None else None for t in ts]  # noqa: E731

    # A. attention: the three self-attention levels of the UNet at 512^2.
    for s, c in ((4096, 320), (1024, 640), (256, 1280)):
        heads = 8
        q, k, v = (_randn(gen, cfg_b, s, c) for _ in range(3))
        qf, kf, vf = f32(q, k, v)
        d = c // heads
        qh, kh, vh = (t.view(cfg_b, s, heads, d).transpose(1, 2) for t in (q, k, v))
        _check(
            "attention_kv_resident", [cfg_b, s, heads, d],
            lambda: attention_kv_resident(q, k, v, heads),
            lambda: attention_kv_resident_plain(qf, kf, vf, heads),
            lambda: F.scaled_dot_product_attention(qh, kh, vh),
            4.0 * cfg_b * heads * s * s * d, 4 * cfg_b * s * c * 2, results,
        )

    # B. 3x3 conv: the resnet convs of the four UNet levels and one of the
    # VAE decoder (the 256^2 level of a batch-B decode of SDR + GM).
    for bb, hw, c, o, pre in (
        (cfg_b, 64, 320, 320, True), (cfg_b, 32, 640, 640, True),
        (cfg_b, 16, 1280, 1280, True), (cfg_b, 8, 1280, 1280, False),
        (2 * batch, 256, 256, 256, True),
    ):
        x = _randn(gen, bb, hw + 2 * pre, hw + 2 * pre, c)
        if pre:
            x[:, 0] = 0
            x[:, -1] = 0
            x[:, :, 0] = 0
            x[:, :, -1] = 0
        w = _randn(gen, o, c, 3, 3, scale=(9 * c) ** -0.5)
        bias = _randn(gen, o, scale=0.1)
        wp = pack_weight(w)
        xf, wpf, bf = f32(x, wp, bias)
        x_nchw = x.permute(0, 3, 1, 2)
        pad = 0 if pre else 1
        _check(
            "conv3x3", [bb, hw, hw, c, o, "pre_padded" if pre else "raw"],
            lambda: conv3x3(x, wp, bias, pre_padded=pre),
            lambda: conv3x3_plain(xf, wpf, bf, pre_padded=pre),
            lambda: F.conv2d(x_nchw, w, bias, padding=pad),
            2.0 * bb * hw * hw * 9 * c * o,
            (x.numel() + w.numel() + o + bb * hw * hw * o) * 2, results,
        )

    # C. GroupNorm(+temb)+SiLU: resnet norm1 (padded), norm2 (temb, padded),
    # the transformer's GN (no SiLU, eps 1e-6), the VAE's widest level.
    for bb, hw, c, temb_on, act, pad, eps in (
        (cfg_b, 64, 320, False, True, True, 1e-5),
        (cfg_b, 64, 320, True, True, True, 1e-5),
        (cfg_b, 32, 640, False, False, False, 1e-6),
        (cfg_b, 16, 1280, True, True, True, 1e-5),
        (2 * batch, 512, 128, False, True, True, 1e-5),
    ):
        x = _randn(gen, bb, hw, hw, c, scale=2.0)
        x = (x.float() + 0.5).to(torch.bfloat16)
        g = _randn(gen, c, scale=0.2)
        g = (g.float() + 1.0).to(torch.bfloat16)
        be = _randn(gen, c, scale=0.2)
        t = _randn(gen, bb, c) if temb_on else None
        xf, gf, bef, tf = f32(x, g, be, t)
        x_nchw = x.permute(0, 3, 1, 2)

        def lib(x_nchw=x_nchw, c=c, g=g, be=be, eps=eps, act=act):
            y = F.group_norm(x_nchw, 32, g, be, eps)
            return F.silu(y) if act else y

        # The yardstick is F.group_norm (+ F.silu): it writes no border and
        # has no form with the temb pre-add (null there).
        hp = hw + 2 * pad
        _check(
            "group_norm_silu",
            [bb, hw, hw, c] + (["temb"] if temb_on else []) + (["silu"] if act else [])
            + (["pad"] if pad else []),
            lambda: group_norm_silu(x, g, be, t, eps=eps, activate=act, pad_output=pad),
            lambda: group_norm_silu_plain(xf, gf, bef, tf, eps=eps, activate=act,
                                          pad_output=pad),
            None if temb_on else lib,
            10.0 * x.numel(),
            (x.numel() + bb * hp * hp * c + (bb * c if temb_on else 0) + 2 * c) * 2,
            results, peak=FP32_FLOPS,
        )

    # D. LN -> GEGLU FF -> residual at the three transformer widths.
    for s, dim in ((4096, 320), (1024, 640), (256, 1280)):
        inner = 4 * dim
        x = _randn(gen, cfg_b, s, dim)
        a = _randn(gen, cfg_b, s, dim)
        gam = (_randn(gen, dim, scale=0.2).float() + 1.0).to(torch.bfloat16)
        bet = _randn(gen, dim, scale=0.2)
        w1 = _randn(gen, 2 * inner, dim, scale=dim ** -0.5)
        b1 = _randn(gen, 2 * inner, scale=0.1)
        w2 = _randn(gen, dim, inner, scale=inner ** -0.5)
        b2 = _randn(gen, dim, scale=0.1)
        args32 = f32(x, a, gam, bet, w1, b1, w2, b2)

        def lib(x=x, a=a, gam=gam, bet=bet, w1=w1, b1=b1, w2=w2, b2=b2, dim=dim):
            s_ = x + a
            h = F.layer_norm(s_, (dim,), gam, bet, 1e-5)
            hid, gate = F.linear(h, w1, b1).chunk(2, dim=-1)
            return F.linear(hid * F.gelu(gate), w2, b2) + s_

        m = cfg_b * s
        _check(
            "geglu_ff_ln", [cfg_b, s, dim],
            lambda: geglu_ff_ln(x, a, gam, bet, w1, b1, w2, b2),
            lambda: geglu_ff_ln_plain(*args32),
            lib,
            2.0 * m * dim * 8 * dim + 2.0 * m * inner * dim,
            (3 * m * dim + w1.numel() + w2.numel() + 2 * inner + 3 * dim) * 2, results,
        )
    return results


# ---------------------------------------------------------------------------
# phases 4 + 5: the main path
# ---------------------------------------------------------------------------


def build_pipeline(seed: int):
    """Full-width SD-1.5 SDR UNet, GM UNet and VAE with seeded random bf16
    weights, in the dual pipeline."""
    import torch

    from gmdx_torch.models import (
        SD15_GM_UNET_CONFIG, SD15_UNET_CONFIG, SD15_VAE_CONFIG,
        AutoencoderKL, UNet2DConditionModel,
    )
    from gmdx_torch.pipelines import StableDiffusionDualUNetPipeline
    from gmdx_torch.schedulers import PNDMScheduler

    torch.manual_seed(seed)
    with torch.device("cuda"):
        unet = UNet2DConditionModel(SD15_UNET_CONFIG)
        gm_unet = UNet2DConditionModel(SD15_GM_UNET_CONFIG)
        vae = AutoencoderKL(SD15_VAE_CONFIG)
    mods = [m.to(torch.bfloat16).eval() for m in (unet, vae, gm_unet)]
    return StableDiffusionDualUNetPipeline(
        mods[0], mods[1], PNDMScheduler(), mods[2], device="cuda"
    )


def make_inputs(pipe, batch: int, seed: int):
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    latents = pipe.prepare_latents(gen, batch, 512, 512)
    cond = torch.randn(batch, 77, 768, generator=gen, device="cuda").to(torch.bfloat16)
    uncond = torch.randn(batch, 77, 768, generator=gen, device="cuda").to(torch.bfloat16)
    return latents, cond, uncond


def run_path(pipe, latents, cond, uncond, steps: int):
    """denoise_dual (PNDM, CFG 7.5) + one batched decode of SDR and GM."""
    import torch

    sdr_lat, gm_lat = pipe.denoise_dual(
        cond, uncond, latents, num_inference_steps=steps, guidance_scale=7.5
    )
    both = pipe.decode_latents(torch.cat([sdr_lat, gm_lat]))
    b = sdr_lat.shape[0]
    return sdr_lat, gm_lat, both[:b], both[b:]


def to01(img):
    return (img / 2.0 + 0.5).clamp(0.0, 1.0)


def psnr01(a, b) -> float:
    mse = float(((a.double() - b.double()) ** 2).mean())
    return float("inf") if mse == 0.0 else -10.0 * math.log10(mse)


def profile_step(pipe, latents, cond, uncond) -> None:
    """Device time by kernel over one denoise iteration (torch.profiler), and
    the device's busy share against the same iteration's unprofiled wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def one_step():
        pipe.denoise_dual(cond, uncond, latents, num_inference_steps=1, guidance_scale=7.5)
        torch.cuda.synchronize()

    one_step()
    t0 = time.perf_counter()
    one_step()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        one_step()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            rows.append((ev.self_device_time_total, ev.key, ev.count))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    emit({"phase": "profile", "wall_ms": wall_ms, "device_ms": total / 1e3,
          "device_busy_share": total / 1e3 / wall_ms, "top": [
              {"name": k[:80], "device_ms": us / 1e3, "share": us / total, "count": n}
              for us, k, n in rows[:25]]})


def phase_main(args) -> dict[str, int]:
    import numpy as np
    import torch

    from gmdx_torch.io import read_hdr, save_hdr_image
    from gmdx_torch.kernels import launch_counts, reset_launch_counts
    from gmdx_torch.ops import apply_gm_to_sdr

    t0 = time.perf_counter()
    pipe = build_pipeline(args.seed)
    latents, cond, uncond = make_inputs(pipe, args.batch, args.seed + 1)
    torch.cuda.synchronize()
    emit({"phase": "main", "setup_s": time.perf_counter() - t0,
          "weights_gb": sum(p.numel() * p.element_size() for m in
                            (pipe.unet, pipe.gm_unet, pipe.vae) for p in m.parameters()) / 1e9})

    run_path(pipe, latents, cond, uncond, 1)  # warm-up: cuDNN/cuBLAS plans
    if args.profile:
        profile_step(pipe, latents, cond, uncond)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launch_counts()
    t0 = time.perf_counter()
    sdr_lat, gm_lat = pipe.denoise_dual(
        cond, uncond, latents, num_inference_steps=args.steps, guidance_scale=7.5
    )
    torch.cuda.synchronize()
    t_denoise = time.perf_counter() - t0
    both = pipe.decode_latents(torch.cat([sdr_lat, gm_lat]))
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0 - t_denoise
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    b = args.batch
    n_steps = pipe.scheduler.num_steps(args.steps)
    sdr01, gm01 = to01(both[:b]), to01(both[b:])
    hdr = apply_gm_to_sdr(gm01, sdr01, qmax=99.0, clip_output=False)
    ok = all(bool(torch.isfinite(t).all()) for t in (sdr_lat, gm_lat, both, hdr))
    if not ok or both.shape != (2 * b, 3, 512, 512):
        raise SystemExit(f"chip_smoke: main path output not finite or misshapen {tuple(both.shape)}")
    hdr0 = hdr[0].permute(1, 2, 0).cpu().numpy()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "hdr_0.hdr")
        save_hdr_image(path, hdr0, qmax=99.0)
        back = read_hdr(path)
    want = np.maximum(hdr0 / 100.0, 0.0)
    tol = want.max(axis=-1, keepdims=True) / 128.0 + 1e-30
    hdr_ok = back.shape == want.shape and bool(np.all(np.abs(back - want) <= tol))
    emit({
        "phase": "main", "batch": b, "resolution": 512, "steps": args.steps,
        "denoise_iterations": n_steps, "guidance_scale": 7.5,
        "denoise_s": t_denoise, "s_per_step": t_denoise / n_steps, "decode_s": t_decode,
        "img_per_s": b / (t_denoise + t_decode), "peak_mem_gb": peak_gb,
        "launches": counts, "hdr_readback_ok": hdr_ok,
        "hdr_max": float(hdr.max()), "sdr_mean": float(sdr01.mean()),
        "gm_mean": float(gm01.mean()),
    })
    if not hdr_ok:
        raise SystemExit("chip_smoke: .hdr read back does not match what was written")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise SystemExit(f"chip_smoke: kernels never launched on the main path: {missing}")
    del pipe
    torch.cuda.empty_cache()
    return counts


def phase_e2e(args) -> None:
    import torch

    from gmdx_torch.models import set_use_kernels

    pipe = build_pipeline(args.seed)
    latents, cond, uncond = make_inputs(pipe, 1, args.seed + 2)
    outs = {}
    for flag in (True, False):
        for m in (pipe.unet, pipe.gm_unet, pipe.vae):
            set_use_kernels(m, flag)
        _, _, sdr, gm = run_path(pipe, latents, cond, uncond, E2E_STEPS)
        outs[flag] = (to01(sdr), to01(gm))
    torch.cuda.synchronize()
    p_sdr = psnr01(outs[True][0], outs[False][0])
    p_gm = psnr01(outs[True][1], outs[False][1])
    emit({"phase": "e2e", "batch": 1, "steps": E2E_STEPS,
          "psnr_sdr_db": p_sdr, "psnr_gm_db": p_gm, "min_db": PSNR_MIN_DB})
    if not min(p_sdr, p_gm) >= PSNR_MIN_DB:
        raise SystemExit(f"chip_smoke: kernels vs plain PSNR {min(p_sdr, p_gm)} < {PSNR_MIN_DB} dB")


# ---------------------------------------------------------------------------


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--profile", action="store_true",
                   help="device time by kernel over one denoise iteration")
    args = p.parse_args()

    if not os.path.isdir(os.path.join(REPO, "gmdx_torch")):
        raise SystemExit("chip_smoke: gmdx_torch/ not found beside this script")
    sys.path.insert(0, REPO)
    dev = phase_device()
    phase_build()
    kernel_rows = phase_kernels(args.batch)
    launches = phase_main(args)
    phase_e2e(args)

    summary = []
    for name, (source, replaces) in KERNELS.items():
        rows = [r for r in kernel_rows if r["name"] == name]
        head = rows[0]
        summary.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shape": head["shape"],
        })
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev["name"], "count": dev["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
