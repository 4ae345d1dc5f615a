"""Smoke run of the PyTorch/CUDA port (``gmdx_torch``) on one NVIDIA H100.

    python3 chip_smoke.py                    # batch 2 x 10 PNDM steps; train batch 2;
                                             # 1024^2 up-conversion, 10 steps;
                                             # SDR->HDR batch 2 x 10 steps;
                                             # Stage 1 batch 1 x 2 pairs; the samplers;
                                             # both CLIs on a full-width directory
    python3 chip_smoke.py --batch 8 --steps 50 --profile
    python3 chip_smoke.py --train-batch 8 --train-steps 10 --profile
    python3 chip_smoke.py --hdrtv-steps 50 --profile
    python3 chip_smoke.py --sdr2hdr-batch 8 --sdr2hdr-steps 50 --profile
    python3 chip_smoke.py --stage1-batch 4 --stage1-steps 10 --profile

Phases, each printing JSON lines; any failure exits non-zero:
  1. device: card name, power limit and capability; requires a (9, 0) card.
  2. build: compiles gmdx_torch/csrc with nvcc (seconds printed), prints
     each kernel's ptxas registers and spills, and fails unless every
     instance of the Hopper kernels (the GEMM core's conv, both FFs and
     F(4x4)'s products; attention_sm90.cuh's forward as the KV-resident,
     the long-sequence and the training kernel, the flash backward's dK/dV
     and dQ, the short-K cross-attention; attention_wide_sm90.cuh's 512-wide
     forward and its dV, dK and dQ kernels) issues wgmma (HGMMA) and TMA
     loads (UTMALDG) in its SASS and spills nothing, unless no kernel of
     any library issues mma.sync (HMMA), unless the
     GroupNorm forward's cluster kernel crosses the cluster barrier
     (UCGABAR_ARV, UCGABAR_WAIT), loads its slice by bulk copy (UBLKCP)
     and spills nothing, unless the add + LayerNorm ring issues bulk
     copies (UBLKCP) and spills nothing, and unless the GroupNorm
     backward spills nothing.
  3. kernels: each hand-written kernel at the main paths' shapes against its
     plain PyTorch version (fp32, TF32 off; relative L2 <= 1e-2, the bf16
     rounding of inputs and output), with times for the kernel, the plain
     version and one PyTorch library call as a yardstick. The training
     kernels (flash forward and backward, GroupNorm backward) run at the
     Stage-2 step's shapes, batch --train-batch; the 1024^2 path's kernels
     (flash_attention_bsc, the flash forward at head dim 512) and the
     largest 1024^2 shapes of the conv, GroupNorm and FF kernels at the
     up-conversion's (CFG) batch; the four opt-in kernels (short-K
     cross-attention, add + LayerNorm, the LN-free FF, Winograd F(4x4)) at
     the single-UNet SDR->HDR path's shapes, batch --sdr2hdr-batch, with
     F(4x4) also held, by its max error over the output's peak, to the JAX
     package's bar against the fp32 direct conv (its relative L2 there is
     reported: the algorithm's own bf16 error), its rows timing the
     implicit-GEMM conv3x3 on the same input beside F.conv2d and carrying
     its launch plan, held to the kernel's own (gmdx_wino4_plan).
     Attention rows also give their exp2 count and the SFU's floor for it;
     the four kernels on attention_sm90.cuh (attention_kv_resident,
     flash_attention_fwd, flash_attention_bsc, flash_attention_bwd) their
     launch plans, each held to the kernel's own (gmdx_attention_sm90_plan),
     and the short-K cross-attention its plan (gmdx_xattn_plan).
     GroupNorm rows (among them 64^2 x 640 and 32^2 x 1920, the images of
     the UNet too large for one cluster) carry their plan's form, cluster
     size and the clusters resident at once, held to gmdx_group_norm_plan
     (which reports cudaOccupancyMaxActiveClusters) and to the plan's
     RESIDENT_CLUSTERS; GroupNorm-backward rows their plan, held to
     gmdx_group_norm_bwd_plan (blocks an SM by
     cudaOccupancyMaxActiveBlocksPerMultiprocessor), and each runs twice
     and must give the same bits; add + LayerNorm rows their plan, held to
     gmdx_add_ln_plan. Stage 1's rows: the flash forward and backward at
     the VAE's 512-wide head at 1x16384 and 4x9216 (out, or dq, dk, dv,
     each against the plain version, five repeats bit for bit, SDPA where
     a backend takes d = 512, the plans held to gmdx_wide_plan; the
     backward's bound at the function's 10 B H Sq Sk D operations and the
     design's 16 beside it) and the GroupNorm backward at the VAE's shapes
     (4x512^2x128 ... 1x1024^2x128, eps 1e-6).
  4. main: the full-width SD-1.5 dual-UNet text-to-HDR path at 512^2 with
     seeded random bf16 weights: denoise_dual (PNDM, CFG 7.5), one batched
     VAE decode, Eq. (1), a .hdr written and read back. Launch counts of
     every kernel are read around this phase only.
  5. e2e: batch 1, 3 steps, kernels vs plain versions; decoded SDR and GM
     images must agree to >= 40 dB PSNR.
  6. train: the Stage-2 step (gmdx_torch.train.stage2) at 512^2 images on the
     full-width 8-channel GM UNet, made by inflate_conv_in from a seeded
     random SD-1.5 UNet, fp32 master weights, bf16 compute, clipped AdamW;
     frozen full-width VAE encoder and CLIP text encoder. One step in the
     pixel form (VAE encode), then the cached-posterior form; samples/s and
     s/step (median of the timed steps), peak memory, the loss (finite) and
     the launch counts of every kernel over the phase.
  7. train_e2e: batch 1, one loss and gradient with the kernels and with
     the plain versions on the same latents, noise and timesteps: losses
     within 1e-3 relative, flattened gradients at cosine >= 0.9995, and the
     gradient of every attention projection (to_q/to_k/to_v), norm
     parameter and resnet time_emb_proj (which takes the GroupNorm
     backward's dtemb) within relative L2 TRAIN_LEAF_REL_L2_MAX of the
     plain one
     and, per kind of parameter, the gradients' norm ratio within
     TRAIN_NORM_RATIO_TOL of 1, so that an error confined to one backward
     kernel cannot hide in the global cosine.
  8. train_e2e_controls: the same check with each output of the two
     backward kernels scaled by 0.95 in turn (dQ, dK, dV; the GroupNorm
     backward's dx, dgamma, dbeta and dtemb); fails unless every one is
     caught.
  9. hdrtv: ControlNet SDR->HDRTV up-conversion (upconvert_sdr_to_hdrtv) of
     one random 1024^2 frame at full SD-1.5 width with seeded random bf16
     weights: the ControlNet copied from the SDR UNet with zero adapters,
     random 77x768 embeddings, PNDM --hdrtv-steps steps, CFG 7.5, one
     batched decode, Eq. (1) from the input frame, a .hdr written and read
     back. s/frame, s/iteration, the decode's time, peak memory and the
     launches of every kernel over the phase; flash_attention_bsc must
     launch 12 times an iteration (5 SDR-UNet and 2 ControlNet calls at the
     CFG batch, 5 GM-UNet calls) and the 512-wide flash forward once.
 10. hdrtv_e2e: batch 1, 2 steps, non-zero ControlNet output convs; kernels
     against plain versions: decoded SDR and GM >= 40 dB; the kernels' run
     with conditioning_scale 0 must differ from it by more than that.
 11. sdr2hdr: the single-UNet SDR->HDR up-conversion at 512^2 (the JAX
     package's benchmark config 1) with seeded random bf16 weights: random
     SDR frames in [-1, 1] encoded by the VAE, PNDM --sdr2hdr-steps steps of
     the full-width 8-channel GM UNet with CFG 7.5 on random 77x768
     embeddings, one batched decode of SDR and GM latents, Eq. (1) from the
     decoded and the original SDR, .hdr read back; first with the three
     kernel opt-ins (short-K cross-attention, fused add + LayerNorm, F(4x4))
     on the UNet and the VAE, each kernel's launches checked exactly, then
     with the same opt-ins but F(4x4) off (winograd_m=2: the implicit-GEMM
     conv), then with the default kernels. img/s, s/iteration, encode and
     decode seconds and peak memory for each.
 12. sdr2hdr_e2e: batch 1, 3 steps, kernels against plain versions with the
     three opt-ins and with F(4x4) off: decoded GM and HDR >= 40 dB; the
     opt-in kernels against the default kernels, report only.
 13. stage1: Stage-1 VAE-LoRA + GAN training (gmdx_torch.train.stage1) at
     full SD-1.5 VAE width with seeded random weights (VAE fp32 master
     weights, bf16 compute; VGG19 and the Paella discriminator, depth 6,
     hidden 512, bf16; LoRA r = 64 on every VAE conv and Linear weight plus
     conv_out; clipped AdamW): gen + disc step pairs at 512^2, batch
     --stage1-batch, a warm-up and --stage1-steps timed pairs, then a
     warm-up and one timed pair at 1024^2, batch 1 (the mid-block
     attentions past 4096 tokens: the 512-wide flash forward and
     backward). s/pair, pairs/s, peak memory and launches of each; every
     Stage-1 kernel must launch, the 512-wide ones exactly 4 (forward) and
     2 (backward) a pair at 1024^2 and never at 512^2.
 14. stage1_e2e: kernels against plain versions at batch 1 and 1024^2, one
     gen and one disc step: loss parts within 1e-3 relative (the adaptive
     weight, a gradient-norm ratio, within 1e-2), gen and disc gradients at
     cosine >= 0.9995, the LoRA leaves of both mid-block attentions'
     to_q/to_k/to_v/to_out within rel-L2 0.1 and, per kind, norm ratio
     within STAGE1_NORM_RATIO_TOL of 1.
 15. stage1_e2e_d512_plain: stage1_e2e with the 512-wide attention's
     forward and backward on their plain versions (bf16 out) and every
     other kernel as it is; report only: it says whether the kernels'
     LoRA norm deficit lies in the 512-wide kernels.
 16. stage1_e2e_controls: stage1_e2e with the 512-wide backward's dQ, then
     its dK, scaled by 0.95; each must be caught.
 17. samplers: the full-width single-UNet and dual paths at 512^2, batch 2,
     CFG 7.5, through PNDM, DDIM (eta 0 and 0.5), DPM-Solver++ (order 2, 8
     steps, so the last is first order) and LCM (4 steps), then PNDM and
     DDIM once more (a row's wall against its place in the sequence): the
     median of a few timed loops an iteration, peak memory; latents
     finite and the launches a UNet call equal to PNDM's.
 18. samplers_e2e: batch 1, 3 steps of each sampler through the dual path,
     kernels against plain versions on the same generator: decoded SDR and
     GM >= 40 dB; the latents' dB after each step are printed.
 19. cli: scripts/torch/init_pipeline.py --size sd15 --dual --scheduler dpm++
     writes a full-width directory into a temporary directory (removed at
     the end); generate_hdr (a 512^2 and a 640x480 PNG, 4 steps) and
     upconvert_hdrtv (one 1024^2 PNG, 2 steps) run on it in-process; every
     PNG and .hdr they write reads back finite at its size; the write and
     load seconds and s/image are printed, and the up-conversion launches
     the 512-wide flash forward once and flash_attention_bsc 12 times an
     iteration.
``--profile`` adds the device time by kernel and the device's busy share
over one denoise iteration (phases 4, 9 and 11, the last with the opt-ins
on and off), over one train step (phase 6), over one Stage-1 pair at
512^2 and one at 1024^2 (phase 13) and over each sampler's single-UNet
loop (phase 17).
The line before the last is the {"kernels": [...]} summary; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
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
# exp2 on the SFU: 16 a clock on each of the 132 SMs, about 3.9 T/s
# (FlashAttention-3, section 3.1). One exp2 a score is a floor of its own
# beside the bound, the larger of operations and bytes.
EXP2_S = 3.9e12
REL_L2_MAX = 1e-2
PSNR_MIN_DB = 40.0
E2E_STEPS = 3
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GRAD_COS_MIN = 0.9995
TRAIN_LEAF_REL_L2_MAX = 1e-1
TRAIN_NORM_RATIO_TOL = 3e-3
# stage1_e2e's per-kind norm-ratio bar, set between its sound reading (the
# to_k and to_q LoRA leaves at 0.9947-0.9960, "NVIDIA H100 80GB HBM3") and a
# 5 % error in the 512-wide backward's dQ or dK (stage1_e2e_controls). The
# adaptive weight, a ratio of two gradient norms at conv_out, carries the
# gradients' bf16 noise (sound reading 1.4e-3) and has a bar of its own;
# the loss parts keep TRAIN_LOSS_RTOL.
STAGE1_NORM_RATIO_TOL = 2e-2
STAGE1_ADAPTIVE_RTOL = 1e-2
# train_e2e's per-leaf and per-kind checks: the parameters whose gradient
# flows straight out of the attention and GroupNorm backward kernels (the
# resnets' time_emb_proj takes the GroupNorm backward's dtemb).
TRAIN_WATCHED = (".to_q.", ".to_k.", ".to_v.", "norm", ".time_emb_proj.")
CLIP_VOCAB = 49408

# Each ported kernel's source and the TPU kernel function (whose
# pl.pallas_call it replaces; group_norm_silu also replaces
# gmdx/kernels/groupnorm.py:712).
KERNELS = {
    "attention_kv_resident": (
        "gmdx_torch/csrc/attention.cu", "gmdx/kernels/flash_attention.py:778"),
    "conv3x3": ("gmdx_torch/csrc/conv3x3.cu", "gmdx/kernels/winograd.py:815"),
    "group_norm_silu": (
        "gmdx_torch/csrc/groupnorm.cu", "gmdx/kernels/groupnorm.py:473"),
    "geglu_ff_ln": ("gmdx_torch/csrc/geglu_ff.cu", "gmdx/kernels/geglu_ff.py:325"),
    "flash_attention_fwd": (
        "gmdx_torch/csrc/flash_attention.cu", "gmdx/kernels/flash_attention.py:142"),
    "flash_attention_bwd": (
        "gmdx_torch/csrc/flash_attention.cu", "gmdx/kernels/flash_attention.py:348"),
    "group_norm_silu_bwd": (
        "gmdx_torch/csrc/groupnorm.cu", "gmdx/kernels/groupnorm.py:268"),
    "flash_attention_bsc": (
        "gmdx_torch/csrc/attention_sm90.cuh", "gmdx/kernels/flash_attention.py:558"),
    "flash_attention_fwd_d512": (
        "gmdx_torch/csrc/attention_wide_sm90.cuh", "gmdx/kernels/flash_attention.py:142"),
    "cross_attention_shortk": (
        "gmdx_torch/csrc/attention_xattn.cuh", "gmdx/kernels/flash_attention.py:939"),
    "add_layer_norm": ("gmdx_torch/csrc/add_ln.cu", "gmdx/kernels/geglu_ff.py:521"),
    "geglu_ff": ("gmdx_torch/csrc/geglu_ff.cu", "gmdx/kernels/geglu_ff.py:139"),
    "winograd4_conv3x3": ("gmdx_torch/csrc/winograd4.cu", "gmdx/kernels/winograd.py:693"),
    "flash_attention_bwd_d512": (
        "gmdx_torch/csrc/attention_wide_sm90.cuh", "gmdx/kernels/flash_attention.py:348"),
}
# The kernels of each path: the phase whose run must launch them all.
INFERENCE_KERNELS = ("attention_kv_resident", "conv3x3", "group_norm_silu", "geglu_ff_ln")
TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_bwd", "group_norm_silu_bwd",
                 "group_norm_silu", "geglu_ff_ln", "conv3x3")
HDRTV_KERNELS = ("flash_attention_bsc", "flash_attention_fwd_d512", "attention_kv_resident",
                 "conv3x3", "group_norm_silu", "geglu_ff_ln")
STAGE1_KERNELS = ("flash_attention_bwd_d512", "flash_attention_fwd_d512", "group_norm_silu_bwd",
                  "group_norm_silu", "conv3x3")
HDRTV_SIDE = 1024
HDRTV_E2E_STEPS = 2
# flash_attention_bsc calls per denoise iteration at 1024^2: the 16384-token
# level's self-attentions, 5 in each UNet (2 down, 3 up) and 2 in the
# ControlNet's copy of the down blocks.
HDRTV_BSC_PER_ITERATION = 12
# The single-UNet SDR->HDR path with the three opt-ins: launches per GM-UNet
# call at 512^2 (SD-1.5: 16 transformer blocks, 10 of them at the 64^2 and
# 32^2 levels, 15 self-attentions of 256-4096 keys; 44 resnet convs, 14 of
# them at 8^2) and per VAE encode (20 resnet convs) and decode (28), F(4x4)
# where conv_route gives it (the JAX tiling budget): the encoder's and the
# decoder's 512^2 levels and the decoder's 256^2 x 256 convs take conv3x3.
SDR2HDR_PER_UNET_CALL = {
    "cross_attention_shortk": 10, "add_layer_norm": 16, "winograd4_conv3x3": 30,
    "conv3x3": 14, "attention_kv_resident": 15, "geglu_ff_ln": 16, "geglu_ff": 0,
}
SDR2HDR_VAE_WINO4 = 13 + 16
SDR2HDR_VAE_CONV3X3 = 7 + 12
SDR2HDR_E2E_STEPS = 3
# DDIM's steps in phase samplers, and the timed repeats of each sampler
# (the median is reported).
SAMPLER_STEPS = 4
SAMPLER_REPEATS = 5
# The F(4x4) algorithm's max error relative to the output's peak against the
# fp32 direct conv must stay under max(10x the direct bf16 conv's, 5e-2), the
# JAX package's own bar (tests/test_kernels.py:1192-1219).
WINO4_BAR_FACTOR, WINO4_BAR_FLOOR = 10.0, 5e-2
OPT_INS = {"xattn_kernel": True, "fused_addln": True, "winograd_m": 4}
# The same with the convs on the default F(2x2) route (the implicit-GEMM
# conv3x3): sdr2hdr's third run, to read what F(4x4) itself buys.
OPT_INS_WINO2 = dict(OPT_INS, winograd_m=2)


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


def exp2_keys(n: float) -> dict:
    """The exp2 count of an attention call and the time the SFU needs for
    it, for a kernel row."""
    return {"exp2": n, "exp2_floor_ms": n / EXP2_S * 1e3}


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
    build_dir = _build.build_all()
    for name in _build.LIBRARIES:
        _build.library(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_info.get("seconds")})
    reports = _build.build_info.get("ptxas", {})
    for name, report in reports.items():
        lines = [ln for ln in report.splitlines()
                 if "entry function" in ln or "registers" in ln or "spill" in ln]
        emit({"phase": "build", "source": f"{name}.cu", "ptxas": lines})
    check_spills(reports)
    check_sass(build_dir, _build._nvcc())


# The Hopper kernels, by library: every instance of each must issue wgmma
# (HGMMA) and TMA loads (UTMALDG) in its SASS. The conv, both FF kernels and
# F(4x4)'s products run on the GEMM core (gemm_sm90.cuh); the KV-resident
# attention, flash_attention_bsc and the short-K cross-attention
# (libattention), the training forward and the flash backward
# (libflash_attention) on attention_sm90.cuh; the 512-wide forward and its
# dV, dK and dQ kernels (libflash_attention) on attention_wide_sm90.cuh.
SM90_KERNELS = {
    "conv3x3": ("ws_gemm_kernel",),
    "geglu_ff": ("ws_gemm_kernel",),
    "winograd4": ("ws_gemm_kernel",),
    "attention": ("flash_bsc_kernel", "kvres_sm90_kernel", "xattn_sm90_kernel"),
    "flash_attention": ("train_fwd_sm90_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel",
                        "flash_fwd_wide_kernel", "flash_bwd_wide_"),
}
SM90_SASS = ("HGMMA", "UTMALDG")
# mma.sync's SASS opcode: no kernel of any library may issue it.
MMA_SYNC_SASS = "HMMA"
# The bulk-copy kernels, (library, kernel) -> what every instance's SASS
# must hold: the GroupNorm forward's cluster kernel crosses the cluster
# barrier (barrier.cluster.arrive / wait, which cuobjdump prints as
# UCGABAR_ARV / UCGABAR_WAIT) and loads its slice with the 1-D bulk copy
# (cp.async.bulk: UBLKCP); the add + LayerNorm ring moves its tiles by bulk
# copy both ways.
BULK_KERNELS = {
    ("groupnorm", "gn_cluster_kernel"): ("UCGABAR_ARV", "UCGABAR_WAIT", "UBLKCP"),
    ("add_ln", "add_ln_ring_kernel"): ("UBLKCP",),
}
# Kernels that must not spill beside those: the GroupNorm backward.
NO_SPILL_KERNELS = (("groupnorm", "gn_bwd_kernel"),)
_SPILLS = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")


def _no_spill_kernels() -> dict:
    kernels = {lib: list(names) for lib, names in SM90_KERNELS.items()}
    for lib, kernel in (*BULK_KERNELS, *NO_SPILL_KERNELS):
        kernels.setdefault(lib, []).append(kernel)
    return kernels


def check_spills(reports: dict) -> None:
    """No instance of the Hopper kernels of SM90_KERNELS, of the bulk-copy
    kernels or of the GroupNorm backward may spill: the wgmma accumulators
    live in the registers setmaxnreg gives a consumer thread, the others
    keep their loads in flight in registers, and ptxas alone decides whether
    they fit (``-Xptxas -v``)."""
    for lib, kernels in _no_spill_kernels().items():
        func, bad = None, {}
        for ln in reports.get(lib, "").splitlines():
            hit = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)", ln)
            if hit:
                func = hit.group(1)
            spill = _SPILLS.search(ln)
            if spill and func and any(k in func for k in kernels) \
                    and any(int(n) for n in spill.groups()):
                bad[func] = ln.strip()
        if bad:
            raise SystemExit(f"chip_smoke: lib{lib}.so spills in its Hopper kernels: {bad}")


def check_sass(build_dir, nvcc: str) -> None:
    """Every instance of the Hopper kernels of SM90_KERNELS must issue wgmma
    (HGMMA) and TMA loads (UTMALDG) in its SASS (cuobjdump -sass), and no
    function of any library mma.sync (HMMA)."""
    from gmdx_torch.kernels import _build

    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    for lib in _build.LIBRARIES:
        sass = subprocess.run([cuobjdump, "-sass", str(build_dir / f"lib{lib}.so")],
                              check=True, capture_output=True, text=True).stdout
        funcs = {}
        for chunk in sass.split("Function : ")[1:]:
            name, _, body = chunk.partition("\n")
            funcs[name.strip()] = body
        mma_sync = {n: body.count(MMA_SYNC_SASS) for n, body in funcs.items()
                    if MMA_SYNC_SASS in body}
        if mma_sync:
            raise SystemExit(f"chip_smoke: lib{lib}.so issues mma.sync ({MMA_SYNC_SASS}): "
                             f"{mma_sync}")
        for kernel in SM90_KERNELS.get(lib, ()):
            inst = {n: {op: body.count(op) for op in SM90_SASS}
                    for n, body in funcs.items() if kernel in n}
            emit({"phase": "build", "sass": f"lib{lib}.so", "kernels": len(funcs),
                  "kernel": kernel, "instances": inst})
            if not inst or any(min(c.values()) == 0 for c in inst.values()):
                raise SystemExit(f"chip_smoke: lib{lib}.so lacks {SM90_SASS} in its "
                                 f"{kernel} instances: {inst}")
    for (lib, kernel), ops in BULK_KERNELS.items():
        sass = subprocess.run([cuobjdump, "-sass", str(build_dir / f"lib{lib}.so")],
                              check=True, capture_output=True, text=True).stdout
        inst = {}
        for chunk in sass.split("Function : ")[1:]:
            name, _, body = chunk.partition("\n")
            if kernel in name:
                inst[name.strip()] = {op: body.count(op) for op in ops}
        emit({"phase": "build", "sass": f"lib{lib}.so", "kernel": kernel, "instances": inst})
        if not inst or any(min(c.values()) == 0 for c in inst.values()):
            raise SystemExit(f"chip_smoke: lib{lib}.so's {kernel} lacks {ops}: {inst}")


# ---------------------------------------------------------------------------
# phase 3: every kernel against its plain version at the main path's shapes
# ---------------------------------------------------------------------------


def _randn(gen, *shape, scale=1.0):
    import torch

    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)


def _check(name, shape, kernel_fn, plain_fn, library_fn, flops, nbytes, results,
           peak=BF16_FLOPS, library=None, extra=None):
    """Run one kernel case: error against the fp32 plain version (the worst
    output where there are several), times. ``library`` names the yardstick
    where the row should say which call it was; ``extra`` adds keys (a
    launch plan) to the row."""
    import torch

    outs = kernel_fn()
    torch.cuda.synchronize()
    refs = plain_fn()
    if not isinstance(outs, (tuple, list)):
        outs, refs = (outs,), (refs,)
    errs = [compare(o, r) for o, r in zip(outs, refs) if r is not None]
    max_abs, rel = max(e[0] for e in errs), max(e[1] for e in errs)
    ms = time_ms(kernel_fn)
    plain_ms = time_ms(plain_fn, iters=3)
    lib_ms = time_ms(library_fn) if library_fn is not None else None
    b_ms, b_by = bound_ms(flops, nbytes, peak)
    row = {
        "phase": "kernels", "name": name, "shape": shape, "max_abs_err": max_abs,
        "rel_l2": rel, "ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
        "bound_ms": b_ms, "bound_by": b_by, "roofline_share": b_ms / ms,
    }
    if library is not None:
        row["library"] = library
    row.update(extra or {})
    emit(row)
    results.append(row)
    if not math.isfinite(rel) or rel > REL_L2_MAX:
        raise SystemExit(f"chip_smoke: {name} {shape} rel-L2 {rel} > {REL_L2_MAX}")


def _conv_plan_keys(b, hw, c, o, pre) -> dict:
    from gmdx_torch.kernels.winograd import conv3x3_plan

    p = conv3x3_plan(b, hw, hw, c, o, pre)
    return {"plan": {"route": p.route, "box": p.box, "bn": p.bn, "split": p.split,
                     "units": p.units}}


def _attention_plan(kind, plan, b, sq, sk, heads, d) -> dict:
    """The C plan of attention_sm90.cuh's kernel ``kind`` (0 the forward, 1
    dK/dV, 2 dQ) at this shape, held to the Python ``plan`` field for field."""
    import ctypes
    import dataclasses

    from gmdx_torch.kernels import _build

    got = (ctypes.c_int * 9)()
    if _build.library("attention").gmdx_attention_sm90_plan(kind, b, sq, sk, heads, d, got):
        raise SystemExit(f"chip_smoke: no attention plan of kind {kind} at d {d}")
    mine = dataclasses.astuple(plan)
    flat = [*mine[:4], *mine[4], *mine[5]]
    if list(got) != flat:
        raise SystemExit(f"chip_smoke: attention plan {kind} at {[b, sq, sk, heads, d]}: "
                         f"kernel {list(got)}, Python {flat}")
    return dataclasses.asdict(plan)


def _fwd_plan_keys(b, s, heads, d) -> dict:
    """The Hopper forward's plan at a (b, s, s, heads, d) self-attention,
    held to the C plan, and the K and V bytes its query tiles read from L2
    (each reads its head's whole K and V once)."""
    from gmdx_torch.kernels.flash_attention import attention_fwd_plan

    p = attention_fwd_plan(b, s, s, heads, d)
    return {"plan": _attention_plan(0, p, b, s, s, heads, d),
            "l2_kv_bytes": -(-s // p.owned) * b * heads * 2 * s * d * 2}


def _wino4_plan_keys(b, hw, c, o) -> dict:
    """The F(4x4) plan at this shape, held to the C plan the kernel
    launches with (gmdx_wino4_plan) field for field."""
    import ctypes

    from gmdx_torch.kernels import _build
    from gmdx_torch.kernels.winograd import winograd4_plan

    p = winograd4_plan(b, hw, hw, c, o, True)
    got = (ctypes.c_int * 12)()
    if _build.library("winograd4").gmdx_wino4_plan(b, hw, hw, c, o, got) \
            or list(got) != p.c_fields():
        raise SystemExit(f"chip_smoke: F(4x4) plan at {[b, hw, c, o]}: kernel {list(got)}, "
                         f"Python {p.c_fields()}")
    keys = ("bn", "units", "grid", "stages", "smem_bytes", "in_cgt", "in_tx", "in_ty", "in_grid",
            "out_grid")
    return {"plan": {k: getattr(p, k) for k in keys}}


def _gn_plan_keys(b, h, w, c) -> dict:
    """The GroupNorm forward's plan at this shape, held to the C plan the
    kernel launches with (gmdx_group_norm_plan) field for field, with the
    clusters that can be resident at once (cudaOccupancyMaxActiveClusters)."""
    import ctypes

    from gmdx_torch.kernels import _build
    from gmdx_torch.kernels.groupnorm import RESIDENT_CLUSTERS, group_norm_plan

    p = group_norm_plan(b, h, w, c)
    got = (ctypes.c_int * 8)()
    if _build.library("groupnorm").gmdx_group_norm_plan(b, h, w, c, got) \
            or list(got)[:7] != p.c_fields():
        raise SystemExit(f"chip_smoke: GroupNorm plan at {[b, h, w, c]}: kernel {list(got)}, "
                         f"Python {p.c_fields()}")
    if p.form != "pair" and got[7] != RESIDENT_CLUSTERS[p.cluster]:
        raise SystemExit(f"chip_smoke: {got[7]} GroupNorm clusters of {p.cluster} CTAs resident "
                         f"at {[b, h, w, c]} ({p.smem_bytes} bytes of shared memory), the plan "
                         f"counts {RESIDENT_CLUSTERS[p.cluster]}")
    return {"form": p.form, "cluster": p.cluster, "active_clusters": got[7],
            "plan": {"pixels": p.pixels, "smem_bytes": p.smem_bytes, "grid": p.grid,
                     "threads": p.threads}}


def _gn_bwd_plan_keys(b, h, w, c) -> dict:
    """The GroupNorm backward's plan at this shape, held to the C plan the
    kernel launches with (gmdx_group_norm_bwd_plan) field for field; its
    blocks an SM are cudaOccupancyMaxActiveBlocksPerMultiprocessor's."""
    import ctypes
    import dataclasses

    from gmdx_torch.kernels import _build
    from gmdx_torch.kernels.groupnorm import group_norm_bwd_plan

    p = group_norm_bwd_plan(b, h, w, c)
    got = (ctypes.c_int * 7)()
    if _build.library("groupnorm").gmdx_group_norm_bwd_plan(b, h, w, c, got) \
            or list(got) != p.c_fields():
        raise SystemExit(f"chip_smoke: GroupNorm backward plan at {[b, h, w, c]}: kernel "
                         f"{list(got)}, Python {p.c_fields()}")
    return {"plan": dataclasses.asdict(p)}


def _add_ln_plan_keys(m, c) -> dict:
    """The add + LayerNorm plan, held to gmdx_add_ln_plan field for field;
    the card must hold the blocks an SM the plan puts on it."""
    import ctypes
    import dataclasses

    from gmdx_torch.kernels import _build
    from gmdx_torch.kernels.geglu_ff import add_layer_norm_plan

    p = add_layer_norm_plan(m, c)
    got = (ctypes.c_int * 7)()
    if _build.library("add_ln").gmdx_add_ln_plan(m, c, got) or list(got)[:6] != p.c_fields() \
            or got[6] < p.per_sm:
        raise SystemExit(f"chip_smoke: add + LayerNorm plan at {[m, c]}: kernel {list(got)}, "
                         f"Python {p.c_fields()} ({p.per_sm} an SM)")
    return {"plan": dataclasses.asdict(p), "resident": got[6]}


def _xattn_plan_keys(b, sq, sk, heads, d) -> dict:
    """The short-K kernel's plan, held to gmdx_xattn_plan field for field."""
    import ctypes
    import dataclasses

    from gmdx_torch.kernels import _build
    from gmdx_torch.kernels.flash_attention import xattn_plan

    p = xattn_plan(b, sq, sk, heads, d)
    got = (ctypes.c_int * 8)()
    if _build.library("attention").gmdx_xattn_plan(b, sq, sk, heads, d, got) \
            or list(got) != p.c_fields():
        raise SystemExit(f"chip_smoke: short-K plan at {[b, sq, sk, heads, d]}: kernel "
                         f"{list(got)}, Python {p.c_fields()}")
    return {"plan": dataclasses.asdict(p)}


def _ff_plan_keys(m, dim) -> dict:
    from gmdx_torch.kernels.geglu_ff import geglu_ff_ln_plan

    return {"plan": geglu_ff_ln_plan(m, dim, 4 * dim)}


def phase_kernels(batch: int, train_batch: int, sdr2hdr_batch: int) -> list[dict]:
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
            extra={**exp2_keys(cfg_b * heads * s * s), **_fwd_plan_keys(cfg_b, s, heads, d)},
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
            extra=_conv_plan_keys(bb, hw, c, o, pre),
        )

    # C. GroupNorm(+temb)+SiLU: resnet norm1 (padded), norm2 (temb, padded),
    # the transformer's GN (no SiLU, eps 1e-6), two UNet images too large for
    # one cluster (64^2 x 640, 32^2 x 1920: the pair), the VAE's widest
    # level. Each row carries its plan's form and cluster size.
    for bb, hw, c, temb_on, act, pad, eps in (
        (cfg_b, 64, 320, False, True, True, 1e-5),
        (cfg_b, 64, 320, True, True, True, 1e-5),
        (cfg_b, 32, 640, False, False, False, 1e-6),
        (cfg_b, 16, 1280, True, True, True, 1e-5),
        (cfg_b, 64, 640, True, True, True, 1e-5),
        (cfg_b, 32, 1920, False, True, True, 1e-5),
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
            results, peak=FP32_FLOPS, extra=_gn_plan_keys(bb, hw, hw, c),
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
            extra=_ff_plan_keys(m, dim),
        )
    _training_kernel_rows(gen, train_batch, results)
    _hdrtv_kernel_rows(gen, results)
    _optin_kernel_rows(gen, sdr2hdr_batch, results)
    _stage1_kernel_rows(gen, results)
    return results


def _training_kernel_rows(gen, tb: int, results: list[dict]) -> None:
    """E. flash attention forward and backward at the three differentiated
    self-attention levels of the Stage-2 step; F. the GroupNorm backward at
    a resnet norm2 (temb, SiLU, padded), the transformer's GN (no SiLU, eps
    1e-6), the 16^2 level and the widest norm1 (16^2 x 2560), each run twice
    for the same bits. Batch ``tb``: training has no CFG doubling."""
    import torch
    import torch.nn.functional as F

    from gmdx_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_fwd_plain, flash_bwd_plan,
    )
    from gmdx_torch.kernels.groupnorm import (
        group_norm_silu, group_norm_silu_bwd, group_norm_silu_bwd_plain, group_norm_silu_plain,
    )

    for s, c in ((4096, 320), (1024, 640), (256, 1280)):
        heads = 8
        d = c // heads
        scale = d**-0.5
        q, k, v, dout = (_randn(gen, tb, s, c) for _ in range(4))
        qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
        out, lse = flash_attention_fwd(q, k, v, heads)
        ref_out, ref_lse = flash_attention_fwd_plain(qf, kf, vf, heads, scale)
        # Library yardstick: SDPA forward, and its backward through autograd.
        qh, kh, vh = (t.view(tb, s, heads, d).transpose(1, 2).detach().requires_grad_()
                      for t in (q, k, v))
        out_l = F.scaled_dot_product_attention(qh, kh, vh)
        dout_h = dout.view(tb, s, heads, d).transpose(1, 2)
        shape = [tb, s, heads, d]
        # Forward: S = QK^T and PV. Backward, given (q, k, v, lse, dO): the
        # five products S, dV, dP, dQ, dK (2.5x the forward; the dQ kernel's
        # recompute of S and dP is the design's, not the function's).
        fwd_flops = 4.0 * tb * heads * s * s * d
        _check(
            "flash_attention_fwd", shape,
            lambda: flash_attention_fwd(q, k, v, heads),
            lambda: flash_attention_fwd_plain(qf, kf, vf, heads, scale),
            lambda: F.scaled_dot_product_attention(qh, kh, vh),
            fwd_flops, 4 * tb * s * c * 2 + tb * heads * s * 4, results,
            extra={**exp2_keys(tb * heads * s * s), **_fwd_plan_keys(tb, s, heads, d)},
        )
        # The dK/dV and dQ kernels both recompute P: two exp2 a score.
        dkv, dq = flash_bwd_plan(tb, s, s, heads, d)
        _check(
            "flash_attention_bwd", shape,
            lambda: flash_attention_bwd(q, k, v, out, lse, dout, heads),
            lambda: flash_attention_bwd_plain(qf, kf, vf, ref_out, ref_lse, dof, heads, scale),
            lambda: torch.autograd.grad(out_l, (qh, kh, vh), dout_h, retain_graph=True),
            2.5 * fwd_flops, 8 * tb * s * c * 2 + tb * heads * s * 4, results,
            extra={**exp2_keys(2 * tb * heads * s * s),
                   "plan": {"dkv": _attention_plan(1, dkv, tb, s, s, heads, d),
                            "dq": _attention_plan(2, dq, tb, s, s, heads, d)}},
        )
        del out_l, qh, kh, vh

    for hw, c, temb_on, act, pad, eps in (
        (64, 320, True, True, True, 1e-5),
        (32, 640, False, False, False, 1e-6),
        (16, 1280, True, True, True, 1e-5),
        (16, 2560, False, True, True, 1e-5),
    ):
        x = (_randn(gen, tb, hw, hw, c, scale=2.0).float() + 0.5).to(torch.bfloat16)
        gam = (_randn(gen, c, scale=0.2).float() + 1.0).to(torch.bfloat16)
        bet = _randn(gen, c, scale=0.2)
        t = _randn(gen, tb, c) if temb_on else None
        hp = hw + 2 * pad
        cot = _randn(gen, tb, hp, hp, c)
        _, stats = group_norm_silu(x, gam, bet, t, eps=eps, activate=act, pad_output=pad,
                                   return_stats=True)
        f32 = [u.float() if u is not None else None for u in (x, gam, bet, t)]
        _, ref_stats = group_norm_silu_plain(*f32, eps=eps, activate=act, pad_output=pad,
                                             return_stats=True)
        # Library yardstick: F.group_norm (+ F.silu) backward through
        # autograd, on x + temb where the forward pre-adds a temb (it has no
        # temb form; dtemb's reduction is not in it).
        xin = x if t is None else (x.float() + t.float()[:, None, None, :]).to(torch.bfloat16)
        xl = xin.permute(0, 3, 1, 2).detach().requires_grad_()
        gl, bl = gam.detach().requires_grad_(), bet.detach().requires_grad_()
        yl = F.group_norm(xl, 32, gl, bl, eps)
        yl = F.silu(yl) if act else yl
        cot_l = (cot[:, 1:-1, 1:-1] if pad else cot).permute(0, 3, 1, 2)
        n = tb * hw * hw * c
        shape = [tb, hw, hw, c] + (["temb"] if temb_on else []) + (["silu"] if act else []) \
            + (["pad"] if pad else [])
        one, two = (group_norm_silu_bwd(x, gam, bet, t, stats, cot, activate=act, pad_output=pad)
                    for _ in range(2))
        if not all(a is b is None or torch.equal(a, b) for a, b in zip(one, two)):
            raise SystemExit(f"chip_smoke: group_norm_silu_bwd {shape}: two calls differ")
        _check(
            "group_norm_silu_bwd", shape,
            lambda: group_norm_silu_bwd(x, gam, bet, t, stats, cot, activate=act, pad_output=pad),
            lambda: group_norm_silu_bwd_plain(*f32, ref_stats, cot.float(), activate=act,
                                              pad_output=pad),
            lambda: torch.autograd.grad(yl, (xl, gl, bl), cot_l, retain_graph=True),
            30.0 * n,
            # x, g read; dx written (bf16); gamma, beta, temb, stats read and
            # dgamma, dbeta, dtemb written (fp32 where fp32).
            (n + tb * hp * hp * c + n) * 2 + 2 * c * 2 + tb * 2 * 32 * 4
            + (tb * c * (2 + 4) if temb_on else 0) + 2 * c * 4,
            results, peak=FP32_FLOPS,
            extra={**_gn_bwd_plan_keys(tb, hw, hw, c), "repeat_identical": True},
        )
        del yl, xl


def _sdpa_bwd_backend(q, k, v, dout):
    """The first backend of PyTorch's own order whose SDPA forward and
    backward take these operands, and a call of its backward (autograd
    through one forward); ("none: no backend takes d = 512", None) when
    none does."""
    import warnings

    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        try:
            with warnings.catch_warnings(), sdpa_kernel(backend):
                warnings.simplefilter("ignore")
                out = F.scaled_dot_product_attention(*leaves)
                torch.autograd.grad(out, leaves, dout, retain_graph=True)
        except RuntimeError:
            continue
        return backend.name.lower(), lambda out=out: torch.autograd.grad(
            out, leaves, dout, retain_graph=True)
    return "none: no backend takes d = 512", None


def _wide_plan_keys(b: int, s: int) -> dict:
    """The 512-wide kernels' plans at a (b, s, s, 1) self-attention, by kind
    (fwd, dv, dk, dq), each held to the C plan (gmdx_wide_plan) field for
    field."""
    import ctypes
    import dataclasses

    from gmdx_torch.kernels import _build
    from gmdx_torch.kernels.flash_attention import WIDE_KINDS, wide_bwd_plans, wide_fwd_plan

    lib = _build.library("flash_attention")
    plans = dict(zip(WIDE_KINDS, (wide_fwd_plan(b, s, s, 1), *wide_bwd_plans(b, s, s, 1))))
    for i, (kind, plan) in enumerate(plans.items()):
        got = (ctypes.c_int * 8)()
        if lib.gmdx_wide_plan(i, b, s, s, 1, got) or list(got) != plan.c_fields():
            raise SystemExit(f"chip_smoke: wide plan {kind} at {[b, s]}: kernel {list(got)}, "
                             f"Python {plan.c_fields()}")
    return {kind: dataclasses.asdict(p) for kind, p in plans.items()}


def _stage1_kernel_rows(gen, results: list[dict]) -> None:
    """H. Stage 1's kernels at its shapes: the flash forward and backward at
    the VAE's 512-wide head, 1x16384 (1024^2, batch 1) and 4x9216 (768^2,
    batch 4), each output's relative L2 against the fp32 plain version,
    repeats bit for bit, SDPA where a backend takes d = 512, the plans held
    to the kernels'; the backward's bound at the function's 10 B H Sq Sk D
    operations, with the design's 16 beside it; the GroupNorm backward at
    the VAE's shapes (eps 1e-6, no temb), repeats bit for bit."""
    import torch
    import torch.nn.functional as F

    from gmdx_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
        flash_attention_fwd_plain,
    )
    from gmdx_torch.kernels.groupnorm import (
        group_norm_silu, group_norm_silu_bwd, group_norm_silu_bwd_plain, group_norm_silu_plain,
    )

    d = 512
    for b, s in ((1, 16384), (4, 9216)):
        q, k, v, dout = (_randn(gen, b, s, d) for _ in range(4))
        plans = _wide_plan_keys(b, s)
        out, lse = flash_attention_fwd(q, k, v, 1)
        repeats = 5
        if not all(all(torch.equal(a, g) for a, g in zip(flash_attention_fwd(q, k, v, 1),
                                                         (out, lse))) for _ in range(repeats)):
            raise SystemExit(f"chip_smoke: flash_attention_fwd_d512 {[b, s]}: repeats differ")
        qf, kf, vf = (t.float() for t in (q, k, v))
        _, ref_lse = flash_attention_fwd_plain(qf, kf, vf, 1, d**-0.5)
        qh, kh, vh = (t.view(b, s, 1, d).transpose(1, 2) for t in (q, k, v))
        backend, lib = _sdpa_backend(qh, kh, vh)
        _check(
            "flash_attention_fwd_d512", [b, s, 1, d],
            lambda: flash_attention_fwd(q, k, v, 1)[0],
            lambda: flash_attention_fwd_plain(qf, kf, vf, 1, d**-0.5)[0],
            lib, 4.0 * b * s * s * d, 4 * b * s * d * 2, results,
            library=f"F.scaled_dot_product_attention ({backend} backend)",
            extra={**exp2_keys(2 * b * s * s), "rel_l2_lse": compare(lse, ref_lse)[1],
                   "plan": plans["fwd"], "repeat_identical": repeats},
        )
        del qf, kf, vf, qh, kh, vh, ref_lse, lib
        grads = flash_attention_bwd(q, k, v, out, lse, dout, 1)
        identical = all(all(torch.equal(a, g) for a, g in zip(
            flash_attention_bwd(q, k, v, out, lse, dout, 1), grads)) for _ in range(repeats))
        if not identical:
            raise SystemExit(f"chip_smoke: flash_attention_bwd_d512 {[b, s]}: repeats differ")
        refs = flash_attention_bwd_plain(q.float(), k.float(), v.float(), out.float(), lse,
                                         dout.float(), 1, d**-0.5)
        rels = {f"rel_l2_{n}": compare(g, r)[1] for n, g, r in zip(("dq", "dk", "dv"), grads, refs)}
        del refs
        qh, kh, vh, dh = (t.view(b, s, 1, d).transpose(1, 2) for t in (q, k, v, dout))
        backend, lib = _sdpa_bwd_backend(qh, kh, vh, dh)
        _check(
            "flash_attention_bwd_d512", [b, s, 1, d],
            lambda: flash_attention_bwd(q, k, v, out, lse, dout, 1),
            lambda: flash_attention_bwd_plain(q.float(), k.float(), v.float(), out.float(), lse,
                                              dout.float(), 1, d**-0.5),
            lib, 10.0 * b * s * s * d, 8 * b * s * d * 2 + 2 * b * s * 4, results,
            library=f"SDPA backward ({backend})",
            extra={**exp2_keys(3 * 2 * b * s * s), **rels, "repeat_identical": repeats,
                   "design_floor_ms": 16.0 * b * s * s * d / BF16_FLOPS * 1e3,
                   "plans": {k: plans[k] for k in ("dv", "dk", "dq")}},
        )
        del q, k, v, dout, out, lse, grads, lib, qh, kh, vh, dh
        torch.cuda.empty_cache()

    for b, hw, c in ((4, 512, 128), (4, 256, 256), (4, 128, 512), (4, 64, 512), (1, 1024, 128)):
        x = (_randn(gen, b, hw, hw, c, scale=2.0).float() + 0.5).to(torch.bfloat16)
        gam = (_randn(gen, c, scale=0.2).float() + 1.0).to(torch.bfloat16)
        bet = _randn(gen, c, scale=0.2)
        cot = _randn(gen, b, hw + 2, hw + 2, c)
        _, stats = group_norm_silu(x, gam, bet, None, eps=1e-6, pad_output=True,
                                   return_stats=True)
        f32 = [x.float(), gam.float(), bet.float(), None]
        _, ref_stats = group_norm_silu_plain(*f32, eps=1e-6, pad_output=True, return_stats=True)
        one, two = (group_norm_silu_bwd(x, gam, bet, None, stats, cot, pad_output=True)
                    for _ in range(2))
        if not all(a is r is None or torch.equal(a, r) for a, r in zip(one, two)):
            raise SystemExit(f"chip_smoke: group_norm_silu_bwd VAE {[b, hw, c]}: two calls differ")
        n = b * hw * hw * c
        # Library yardstick: F.group_norm + F.silu differentiated by autograd.
        xl = x.permute(0, 3, 1, 2).detach().requires_grad_()
        gl, bl = gam.detach().requires_grad_(), bet.detach().requires_grad_()
        yl = F.silu(F.group_norm(xl, 32, gl, bl, 1e-6))
        cot_l = cot[:, 1:-1, 1:-1].permute(0, 3, 1, 2)
        _check(
            "group_norm_silu_bwd", [b, hw, hw, c, "silu", "pad", "vae"],
            lambda: group_norm_silu_bwd(x, gam, bet, None, stats, cot, pad_output=True),
            lambda: group_norm_silu_bwd_plain(*f32, ref_stats, cot.float(), pad_output=True),
            lambda: torch.autograd.grad(yl, (xl, gl, bl), cot_l, retain_graph=True), 30.0 * n,
            (n + b * (hw + 2) ** 2 * c + n) * 2 + 2 * c * 2 + b * 2 * 32 * 4 + 2 * c * 4,
            results, peak=FP32_FLOPS,
            extra={**_gn_bwd_plan_keys(b, hw, hw, c), "repeat_identical": True},
        )
        del x, cot, one, two, xl, yl


def _sdpa_backend(q, k, v):
    """The first backend of PyTorch's own order that takes these SDPA
    operands, and a call through it; ("none", None) when none does."""
    import warnings

    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        def call(backend=backend):
            with sdpa_kernel(backend):
                return F.scaled_dot_product_attention(q, k, v)
        try:
            with warnings.catch_warnings():  # each refusal warns why
                warnings.simplefilter("ignore")
                call()
        except RuntimeError:
            continue
        return backend.name.lower(), call
    return "none", None


def _hdrtv_kernel_rows(gen, results: list[dict]) -> None:
    """G. The 1024^2 up-conversion's kernels at its shapes: flash_attention_bsc
    at the 16384-token UNet level (CFG batch 2 and the GM UNet's batch 1),
    the flash forward at the VAE's 512-wide head (one batched decode of SDR
    and GM), and the largest 1024^2 shapes of the 512^2 path's kernels: the VAE's
    1024^2 x 128 and the UNet's 128^2 x 320 conv, the VAE's 1024^2 x 128
    GroupNorm, the FF at 16384 tokens x 320."""
    import torch
    import torch.nn.functional as F

    from gmdx_torch.kernels.flash_attention import (
        flash_attention_bsc, flash_attention_bsc_plain, flash_attention_fwd,
        flash_attention_fwd_plain,
    )
    from gmdx_torch.kernels.geglu_ff import geglu_ff_ln, geglu_ff_ln_plain
    from gmdx_torch.kernels.groupnorm import group_norm_silu, group_norm_silu_plain
    from gmdx_torch.kernels.winograd import conv3x3, conv3x3_plain, pack_weight

    s = (HDRTV_SIDE // 8) ** 2
    for b, heads, d in ((2, 8, 40), (1, 8, 40), (2, 1, 512)):
        c = heads * d
        q, k, v = (_randn(gen, b, s, c) for _ in range(3))
        qf, kf, vf = (t.float() for t in (q, k, v))
        qh, kh, vh = (t.view(b, s, heads, d).transpose(1, 2) for t in (q, k, v))
        extra = exp2_keys(b * heads * s * s)
        if d == 512:  # both CTAs of a pair take every exp2 of their rows
            name = "flash_attention_fwd_d512"
            extra = {**exp2_keys(2 * b * heads * s * s), "plan": _wide_plan_keys(b, s)["fwd"]}
            backend, lib = _sdpa_backend(qh, kh, vh)
            kern = lambda: flash_attention_fwd(q, k, v, heads)[0]  # noqa: E731
            plain = lambda: flash_attention_fwd_plain(qf, kf, vf, heads, d**-0.5)[0]  # noqa: E731
        else:
            name, backend = "flash_attention_bsc", "default"
            lib = lambda: F.scaled_dot_product_attention(qh, kh, vh)  # noqa: E731
            kern = lambda: flash_attention_bsc(q, k, v, heads)  # noqa: E731
            plain = lambda: flash_attention_bsc_plain(qf, kf, vf, heads)  # noqa: E731
            extra.update(_fwd_plan_keys(b, s, heads, d))
        _check(name, [b, s, heads, d], kern, plain, lib, 4.0 * b * heads * s * s * d,
               4 * b * s * c * 2, results,
               library=f"F.scaled_dot_product_attention ({backend} backend)", extra=extra)
        del q, k, v, qf, kf, vf, qh, kh, vh

    for bb, hw, c in ((2, HDRTV_SIDE, 128), (2, HDRTV_SIDE // 8, 320)):
        x = F.pad(_randn(gen, bb, hw, hw, c), (0, 0, 1, 1, 1, 1))
        w = _randn(gen, c, c, 3, 3, scale=(9 * c) ** -0.5)
        bias = _randn(gen, c, scale=0.1)
        wp = pack_weight(w)
        x_nchw = x[:, 1:-1, 1:-1].permute(0, 3, 1, 2)
        _check(
            "conv3x3", [bb, hw, hw, c, c, "pre_padded"],
            lambda: conv3x3(x, wp, bias, pre_padded=True),
            lambda: conv3x3_plain(x.float(), wp.float(), bias.float(), pre_padded=True),
            lambda: F.conv2d(x_nchw, w, bias, padding=1),
            2.0 * bb * hw * hw * 9 * c * c,
            (x.numel() + w.numel() + c + bb * hw * hw * c) * 2, results,
            extra=_conv_plan_keys(bb, hw, c, c, True),
        )
        del x, x_nchw

    bb, hw, c = 2, HDRTV_SIDE, 128
    x = (_randn(gen, bb, hw, hw, c, scale=2.0).float() + 0.5).to(torch.bfloat16)
    g = (_randn(gen, c, scale=0.2).float() + 1.0).to(torch.bfloat16)
    be = _randn(gen, c, scale=0.2)
    x_nchw = x.permute(0, 3, 1, 2)
    _check(
        "group_norm_silu", [bb, hw, hw, c, "silu", "pad"],
        lambda: group_norm_silu(x, g, be, None, eps=1e-5, activate=True, pad_output=True),
        lambda: group_norm_silu_plain(x.float(), g.float(), be.float(), None, eps=1e-5,
                                      activate=True, pad_output=True),
        lambda: F.silu(F.group_norm(x_nchw, 32, g, be, 1e-5)),
        10.0 * x.numel(), (x.numel() + bb * (hw + 2) ** 2 * c + 2 * c) * 2, results,
        peak=FP32_FLOPS, extra=_gn_plan_keys(bb, hw, hw, c),
    )
    del x, x_nchw

    dim, inner, m = 320, 1280, 2 * s
    x, a = _randn(gen, 2, s, dim), _randn(gen, 2, s, dim)
    ff = [(_randn(gen, dim, scale=0.2).float() + 1.0).to(torch.bfloat16),
          _randn(gen, dim, scale=0.2), _randn(gen, 2 * inner, dim, scale=dim ** -0.5),
          _randn(gen, 2 * inner, scale=0.1), _randn(gen, dim, inner, scale=inner ** -0.5),
          _randn(gen, dim, scale=0.1)]

    def lib():
        s_ = x + a
        h = F.layer_norm(s_, (dim,), ff[0], ff[1], 1e-5)
        hid, gate = F.linear(h, ff[2], ff[3]).chunk(2, dim=-1)
        return F.linear(hid * F.gelu(gate), ff[4], ff[5]) + s_

    _check(
        "geglu_ff_ln", [2, s, dim],
        lambda: geglu_ff_ln(x, a, *ff),
        lambda: geglu_ff_ln_plain(x.float(), a.float(), *(t.float() for t in ff)),
        lib, 2.0 * m * dim * 8 * dim + 2.0 * m * inner * dim,
        (3 * m * dim + ff[2].numel() + ff[4].numel() + 2 * inner + 3 * dim) * 2, results,
        extra=_ff_plan_keys(m, dim),
    )


def _optin_kernel_rows(gen, batch: int, results: list[dict]) -> None:
    """H. The four opt-in kernels at the single-UNet SDR->HDR path's shapes,
    the GM UNet's CFG batch 2 * ``batch``: the short-K cross-attention at
    the 64^2 and 32^2 levels (77 keys), add + LayerNorm and the LN-free FF at
    the transformer widths, F(4x4) at the three UNet levels it takes and the
    VAE decoder's 512^2 x 128 level (SDR + GM at ``batch``). F(4x4) is also
    held to the fp32 direct conv (report only: the algorithm's error) and,
    by its max error over the output's peak, to the JAX package's bar."""
    import torch
    import torch.nn.functional as F

    from gmdx_torch.kernels.flash_attention import (
        cross_attention_shortk, cross_attention_shortk_plain,
    )
    from gmdx_torch.kernels.geglu_ff import (
        add_layer_norm, add_layer_norm_plain, geglu_ff, geglu_ff_plain,
    )
    from gmdx_torch.kernels.winograd import (
        conv3x3, pack_weight, pack_weight4, winograd4_conv3x3, winograd4_conv3x3_plain,
    )

    cfg_b, sk, heads = 2 * batch, 77, 8
    for s, c in ((4096, 320), (1024, 640)):
        d = c // heads
        q = _randn(gen, cfg_b, s, c)
        k, v = _randn(gen, cfg_b, sk, c), _randn(gen, cfg_b, sk, c)
        qh = q.view(cfg_b, s, heads, d).transpose(1, 2)
        kh, vh = (t.view(cfg_b, sk, heads, d).transpose(1, 2) for t in (k, v))
        _check(
            "cross_attention_shortk", [cfg_b, s, sk, heads, d],
            lambda: cross_attention_shortk(q, k, v, heads),
            lambda: cross_attention_shortk_plain(q, k, v, heads),
            lambda: F.scaled_dot_product_attention(qh, kh, vh),
            4.0 * cfg_b * heads * s * sk * d, (2 * cfg_b * s * c + 2 * cfg_b * sk * c) * 2,
            results,
            extra={**exp2_keys(cfg_b * heads * s * sk), **_xattn_plan_keys(cfg_b, s, sk, heads, d)},
        )

    for s, c in ((4096, 320), (1024, 640), (256, 1280), (64, 1280)):
        x, y = _randn(gen, cfg_b, s, c), _randn(gen, cfg_b, s, c)
        gam = _randn(gen, c, scale=0.2).float() + 1.0
        bet = _randn(gen, c, scale=0.2).float()
        n = x.numel()

        def lib(x=x, y=y, gam=gam, bet=bet, c=c):
            s_ = x + y
            return s_, F.layer_norm(s_, (c,), gam.to(s_.dtype), bet.to(s_.dtype), 1e-5)

        _check(
            "add_layer_norm", [cfg_b, s, c],
            lambda: add_layer_norm(x, y, gam, bet),
            lambda: add_layer_norm_plain(x, y, gam, bet),
            lib, 10.0 * n, 4 * n * 2 + 2 * c * 4, results, peak=FP32_FLOPS,
            library="x + y, then F.layer_norm (two calls: no single call gives both outputs)",
            extra=_add_ln_plan_keys(cfg_b * s, c),
        )

    for s, dim in ((4096, 320), (1024, 640)):
        inner = 4 * dim
        x, res = _randn(gen, cfg_b, s, dim), _randn(gen, cfg_b, s, dim)
        ff = [_randn(gen, 2 * inner, dim, scale=dim ** -0.5), _randn(gen, 2 * inner, scale=0.1),
              _randn(gen, dim, inner, scale=inner ** -0.5), _randn(gen, dim, scale=0.1)]
        m = cfg_b * s

        def lib(x=x, res=res, ff=ff):
            hid, gate = F.linear(x, ff[0], ff[1]).chunk(2, dim=-1)
            return F.linear(hid * F.gelu(gate), ff[2], ff[3]) + res

        _check(
            "geglu_ff", [cfg_b, s, dim],
            lambda: geglu_ff(x, res, *ff),
            lambda: geglu_ff_plain(x.float(), res.float(), *(t.float() for t in ff)),
            lib, 24.0 * m * dim * dim,
            (3 * m * dim + ff[0].numel() + ff[2].numel() + 2 * inner + dim) * 2, results,
            extra=_ff_plan_keys(m, dim),
        )

    for bb, hw, c, o in ((cfg_b, 64, 320, 320), (cfg_b, 32, 640, 640),
                         (cfg_b, 16, 1280, 1280), (cfg_b, 512, 128, 128)):
        x = F.pad(_randn(gen, bb, hw, hw, c), (0, 0, 1, 1, 1, 1))
        w = _randn(gen, o, c, 3, 3, scale=(9 * c) ** -0.5)
        bias = _randn(gen, o, scale=0.1)
        u = pack_weight4(w, torch.bfloat16)
        wp = pack_weight(w)
        x_nchw = x[:, 1:-1, 1:-1].permute(0, 3, 1, 2)
        tiles = bb * (hw // 4) ** 2
        shape = [bb, hw, hw, c, o, "pre_padded"]
        # Beside F.conv2d: the implicit-GEMM conv3x3 kernel on the same
        # input, the default route of the same conv.
        conv_ms = time_ms(lambda: conv3x3(x, wp, bias, pre_padded=True))
        _check(
            "winograd4_conv3x3", shape,
            lambda: winograd4_conv3x3(x, u, bias, pre_padded=True),
            # bf16 x: the plain version rounds V to it where the kernel does.
            lambda: winograd4_conv3x3_plain(x, u, bias, pre_padded=True),
            lambda: F.conv2d(x_nchw, w, bias, padding=1),
            2.0 * 36 * tiles * c * o, (x.numel() + u.numel() + o + bb * hw * hw * o) * 2, results,
            library="F.conv2d", extra={"conv3x3_ms": conv_ms, **_wino4_plan_keys(bb, hw, c, o)},
        )
        ref = F.conv2d(x_nchw.float(), w.float(), bias.float(), padding=1)
        out = winograd4_conv3x3(x, u, bias, pre_padded=True).permute(0, 3, 1, 2)
        direct_bf16 = F.conv2d(x_nchw, w, bias, padding=1)
        peak = float(ref.abs().max())
        max_rel = float((out.float() - ref).abs().max()) / peak
        direct_max_rel = float((direct_bf16.float() - ref).abs().max()) / peak
        bar = max(WINO4_BAR_FACTOR * direct_max_rel, WINO4_BAR_FLOOR)
        row = {"phase": "kernels", "name": "winograd4_conv3x3 vs fp32 direct conv",
               "shape": shape, "rel_l2": compare(out, ref)[1], "max_rel": max_rel,
               "direct_bf16_rel_l2": compare(direct_bf16, ref)[1],
               "direct_bf16_max_rel": direct_max_rel, "max_rel_bar": bar,
               # The direct conv's least time, to read beside conv3x3's rows.
               "direct_bound_ms": bound_ms(2.0 * bb * hw * hw * 9 * c * o,
                                           (x.numel() + w.numel() + o + bb * hw * hw * o) * 2)[0]}
        emit(row)
        if not max_rel < bar:
            raise SystemExit(f"chip_smoke: F(4x4) {shape} max-rel {max_rel} >= bar {bar}")
        del x, x_nchw, ref, out, direct_bf16


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


# Device kernels by name, for the profile's breakdown: (category, substrings).
PROFILE_CATEGORIES = (
    ("flash_attention_bsc", ("flash_bsc_kernel",)),
    ("flash_attention_fwd_d512", ("flash_fwd_wide_kernel",)),
    ("flash_attention_bwd_d512", ("flash_bwd_wide_",)),
    ("flash_attention_bwd", ("flash_bwd_",)),
    ("flash_attention_fwd", ("train_fwd_sm90_kernel",)),
    ("attention_kv_resident", ("kvres_sm90_kernel",)),
    ("group_norm_silu_bwd", ("gn_bwd_",)),
    ("group_norm_silu", ("gn_cluster_kernel", "gn_stats_kernel", "gn_apply_kernel")),
    ("geglu_ff_ln", ("Gemm1Op", "Gemm2Op", "ln_rows_kernel")),
    ("geglu_ff", ("NoLnGegluOp", "NoLnOutOp")),
    ("cross_attention_shortk", ("xattn_sm90_kernel",)),
    ("add_layer_norm", ("add_ln_",)),
    ("winograd4_conv3x3", ("wino4_", "Wino4Op")),
    ("conv3x3", ("ConvOp", "splitk_reduce_kernel")),
    ("cudnn conv fprop", ("xmma_fprop", "fprop_implicit")),
    ("cudnn conv dgrad", ("xmma_dgrad", "dgrad")),
    ("cudnn conv wgrad", ("xmma_wgrad", "wgrad")),
    ("cublas gemm", ("nvjet", "gemm", "cutlass")),
    ("foreach (optimizer, grad norms)", ("multi_tensor_apply",)),
    ("copies and casts", ("copy",)),
    ("layernorm", ("layer_norm", "GammaBeta")),
    ("reductions", ("reduce_kernel",)),
)


def _category(name: str) -> str:
    for cat, keys in PROFILE_CATEGORIES:
        if any(k in name for k in keys):
            return cat
    return "other elementwise"


def profile_fn(phase: str, one_step) -> None:
    """Device time by kernel over one call of ``one_step`` (torch.profiler),
    and the device's busy share against the same call's unprofiled wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        one_step()
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    rows = []
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0:
            rows.append((ev.self_device_time_total, ev.key, ev.count))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    cats: dict[str, list] = {}
    for us, k, n in rows:
        c = cats.setdefault(_category(k), [0.0, 0])
        c[0] += us
        c[1] += n
    emit({"phase": phase, "wall_ms": wall_ms, "device_ms": total / 1e3,
          "device_busy_share": total / 1e3 / wall_ms, "by_category": [
              {"category": c, "device_ms": us / 1e3, "share": us / total, "count": n}
              for c, (us, n) in sorted(cats.items(), key=lambda kv: -kv[1][0])], "top": [
              {"name": k[:80], "device_ms": us / 1e3, "share": us / total, "count": n}
              for us, k, n in rows[:40]]})


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
        profile_fn("profile", lambda: pipe.denoise_dual(
            cond, uncond, latents, num_inference_steps=1, guidance_scale=7.5))
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
    missing = [k for k in INFERENCE_KERNELS if counts[k] == 0]
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
# phases 6 + 7: the Stage-2 training step
# ---------------------------------------------------------------------------


def build_gm_unet(seed: int):
    """The full-width 8-channel GM UNet as Stage 2 starts it: a seeded random
    SD-1.5 UNet's weights with conv_in inflated (tile x2, scale 0.5); fp32
    master weights, bf16 compute."""
    import torch

    from gmdx_torch.models import (
        SD15_GM_UNET_CONFIG, SD15_UNET_CONFIG, UNet2DConditionModel, inflate_conv_in,
    )

    torch.manual_seed(seed)
    with torch.device("cuda"):
        sd = inflate_conv_in(UNet2DConditionModel(SD15_UNET_CONFIG).state_dict(), 8)
        unet = UNet2DConditionModel(SD15_GM_UNET_CONFIG, dtype=torch.bfloat16)
    unet.load_state_dict(sd, strict=True)
    return unet


def phase_train(args) -> dict[str, int]:
    import statistics

    import torch

    from gmdx_torch.kernels import launch_counts, reset_launch_counts
    from gmdx_torch.models import (
        CLIP_VIT_L_CONFIG, SD15_VAE_CONFIG, AutoencoderKL, CLIPTextModel,
    )
    from gmdx_torch.train import Stage2Config, init_state, make_train_step

    t0 = time.perf_counter()
    b = args.train_batch
    unet = build_gm_unet(args.seed + 10)
    with torch.device("cuda"):
        vae = AutoencoderKL(SD15_VAE_CONFIG).to(torch.bfloat16).eval()
        text = CLIPTextModel(CLIP_VIT_L_CONFIG).to(torch.bfloat16).eval()
    config = Stage2Config(learning_rate=1e-5)
    step = make_train_step(config, unet=unet, vae=vae, text_encoder=text)
    state = init_state(config, unet)
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 11)
    pixel = {
        "sdr": torch.rand(b, 3, 512, 512, generator=gen, device="cuda") * 2 - 1,
        "gm": torch.rand(b, 3, 512, 512, generator=gen, device="cuda") * 2 - 1,
        "input_ids": torch.randint(0, CLIP_VOCAB, (b, 77), generator=gen, device="cuda"),
    }
    cached = {"input_ids": pixel["input_ids"]}
    with torch.no_grad():  # the latent cache: the same images' posteriors
        for k in ("sdr", "gm"):
            post = vae.encode(pixel[k])
            cached[f"{k}_latent_mean"], cached[f"{k}_latent_std"] = post.mean, post.std
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in unet.parameters())
    emit({"phase": "train", "setup_s": time.perf_counter() - t0, "unet_params": n_params})

    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    losses, times = [], []
    for i in range(2 + args.train_steps):  # pixel form, cached warm-up, timed
        t1 = time.perf_counter()
        state, metrics = step(state, pixel if i == 0 else cached, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        losses.append(float(metrics["loss"]))
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    s_step = statistics.median(times[2:])
    emit({
        "phase": "train", "batch": b, "resolution": 512, "timed_steps": args.train_steps,
        "pixel_step_s": times[0], "step_s": times[2:], "s_per_step": s_step,
        "samples_per_s": b / s_step, "peak_mem_gb": peak_gb, "losses": losses,
        "grad_norm": float(metrics["grad_norm"]), "launches": counts,
    })
    if args.profile:
        profile_fn("train_profile", lambda: step(state, cached, gen))
    if not all(math.isfinite(v) for v in losses):
        raise SystemExit(f"chip_smoke: train loss not finite: {losses}")
    missing = [k for k in TRAIN_KERNELS if counts[k] == 0]
    if missing:
        raise SystemExit(f"chip_smoke: kernels never launched on the train path: {missing}")
    del state, step, unet, vae, text
    torch.cuda.empty_cache()
    return counts


def phase_train_e2e(args) -> None:
    import torch

    from gmdx_torch.models import set_use_kernels
    from gmdx_torch.schedulers import DDPMScheduler
    from gmdx_torch.train import Stage2Config, stage2_loss

    unet = build_gm_unet(args.seed + 10)
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 12)
    lat = {k: torch.randn(1, 4, 64, 64, generator=gen, device="cuda")
           for k in ("sdr_latents", "gm_latents", "noise")}
    context = torch.randn(1, 77, 768, generator=gen, device="cuda")
    acp = torch.as_tensor(DDPMScheduler().alphas_cumprod, device="cuda")
    names, params = zip(*unet.named_parameters())
    res = {}
    for flag in (True, False):
        set_use_kernels(unet, flag)
        loss = stage2_loss(unet, **lat, encoder_hidden_states=context,
                           timesteps=torch.tensor([500], device="cuda"), alphas_cumprod=acp,
                           config=Stage2Config())
        grads = torch.autograd.grad(loss, params)
        res[flag] = (float(loss.detach()), torch.cat([g.float().flatten() for g in grads]))
        del grads
    (lk, gk), (lp, gp) = res[True], res[False]
    rel = abs(lk - lp) / abs(lp)
    cos = float(torch.dot(gk, gp) / (gk.norm() * gp.norm()))
    # The parameters whose gradient flows straight out of the attention and
    # GroupNorm backward kernels, per leaf (rel-L2) and per kind (the norm
    # ratio, which a wrong scale of dQ, dK, dV, dgamma, dbeta or dtemb
    # moves while bf16 rounding leaves it at 1).
    diff = torch.split(gk - gp, [p.numel() for p in params])
    ref = torch.split(gp, [p.numel() for p in params])
    kern = torch.split(gk, [p.numel() for p in params])
    watched = {}
    for i, n in enumerate(names):
        for key in TRAIN_WATCHED:
            if key in n:
                watched.setdefault(key.strip(".") + "." + n.rsplit(".", 1)[1], []).append(i)
                break
    idx = [i for ii in watched.values() for i in ii]
    norms = {}
    for name, parts in (("diff", diff), ("ref", ref), ("kern", kern)):
        norms[name] = dict(zip(idx, torch.stack(
            torch._foreach_norm([parts[i] for i in idx])).tolist()))
    leaf = sorted(((norms["diff"][i] / norms["ref"][i], names[i]) for i in idx), reverse=True)
    ratio = {k: math.sqrt(sum(norms["kern"][i] ** 2 for i in ii)
                          / sum(norms["ref"][i] ** 2 for i in ii)) for k, ii in watched.items()}
    worst_ratio = max(abs(r - 1.0) for r in ratio.values())
    emit({"phase": "train_e2e", "batch": 1, "loss_kernels": lk, "loss_plain": lp,
          "loss_rel_err": rel, "grad_cosine": cos, "grad_norm_kernels": float(gk.norm()),
          "grad_norm_plain": float(gp.norm()), "leaves_checked": len(leaf),
          "leaf_rel_l2_worst": leaf[:5], "norm_ratio_by_kind": ratio})
    if not (rel <= TRAIN_LOSS_RTOL and cos >= TRAIN_GRAD_COS_MIN
            and leaf[0][0] <= TRAIN_LEAF_REL_L2_MAX and worst_ratio <= TRAIN_NORM_RATIO_TOL):
        raise SystemExit(f"chip_smoke: train_e2e loss rel {rel}, grad cosine {cos}, leaf "
                         f"rel-L2 {leaf[0]} or norm ratio {ratio} out of bounds")
    del unet, res, gk, gp
    torch.cuda.empty_cache()


def phase_train_e2e_controls(args) -> None:
    """train_e2e with one output of a backward kernel scaled by 0.95 (dQ,
    dK, dV; GroupNorm dx, dgamma, dbeta and, wherever a temb was added,
    dtemb): each must fail the check."""
    import gmdx_torch.kernels.attention as attention
    import gmdx_torch.kernels.groupnorm as groupnorm

    for mod, fn_name, n_out in ((attention, "flash_attention_bwd", 3),
                                (groupnorm, "group_norm_silu_bwd", 4)):
        orig = getattr(mod, fn_name)
        for i in range(n_out):
            def scaled(*a, _orig=orig, _i=i, **kw):
                outs = list(_orig(*a, **kw))
                if outs[_i] is not None:
                    outs[_i] = outs[_i] * 0.95
                return tuple(outs)

            setattr(mod, fn_name, scaled)
            try:
                phase_train_e2e(args)
                caught = False
            except SystemExit:
                caught = True
            finally:
                setattr(mod, fn_name, orig)
            emit({"phase": "train_e2e_control", "kernel": fn_name, "output": i,
                  "scale": 0.95, "caught": caught})
            if not caught:
                raise SystemExit(f"chip_smoke: train_e2e missed {fn_name} output {i} x 0.95")


# ---------------------------------------------------------------------------
# phases 9 + 10: ControlNet SDR->HDRTV up-conversion at 1024^2
# ---------------------------------------------------------------------------


def build_hdrtv_pipeline(seed: int, adapter_std: float = 0.0):
    """The full-width dual pipeline of build_pipeline plus a ControlNet
    copied from its SDR UNet by controlnet_state_dict_from_unet, bf16. Its
    zero convs (the 1x1 output convs and the embedder's conv_out) stay zero,
    as the up-conversion starts, or with ``adapter_std`` are drawn
    N(0, adapter_std^2) so that the adapter acts."""
    import torch

    from gmdx_torch.io import controlnet_state_dict_from_unet
    from gmdx_torch.models import SD15_CONTROLNET_CONFIG, ControlNetModel
    from gmdx_torch.pipelines import StableDiffusionControlNetHDRPipeline

    dual = build_pipeline(seed)
    with torch.device("cuda"):
        cnet = ControlNetModel(SD15_CONTROLNET_CONFIG).to(torch.bfloat16).eval()
    cnet.load_state_dict(controlnet_state_dict_from_unet(cnet.state_dict(), dual.unet.state_dict()))
    if adapter_std:
        gen = torch.Generator(device="cuda").manual_seed(seed + 30)
        for name, p in cnet.named_parameters():
            if name.startswith(("controlnet_down_blocks.", "controlnet_mid_block.",
                                "controlnet_cond_embedding.conv_out.")):
                p.data.copy_(torch.randn(p.shape, generator=gen, device="cuda") * adapter_std)
    return StableDiffusionControlNetHDRPipeline(
        dual.unet, dual.vae, dual.scheduler, dual.gm_unet, cnet, device="cuda")


def hdrtv_inputs(batch: int, seed: int):
    """A random SDR frame in [0, 1] and random 77x768 embeddings."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    sdr = torch.rand(batch, 3, HDRTV_SIDE, HDRTV_SIDE, generator=gen, device="cuda")
    cond, uncond = (torch.randn(batch, 77, 768, generator=gen, device="cuda").to(torch.bfloat16)
                    for _ in range(2))
    return sdr, cond, uncond


def upconvert(pipe, sdr, cond, uncond, steps: int, seed: int, conditioning_scale: float = 1.0):
    import torch

    from gmdx_torch.pipelines import upconvert_sdr_to_hdrtv

    return upconvert_sdr_to_hdrtv(
        pipe, sdr, generator=torch.Generator(device="cuda").manual_seed(seed),
        num_inference_steps=steps, guidance_scale=7.5, conditioning_scale=conditioning_scale,
        qmax=99.0, prompt_embeds=cond, negative_prompt_embeds=uncond,
    )


def phase_hdrtv(args) -> dict[str, int]:
    import numpy as np
    import torch

    from gmdx_torch.io import read_hdr, save_hdr_image
    from gmdx_torch.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    pipe = build_hdrtv_pipeline(args.seed)
    sdr, cond, uncond = hdrtv_inputs(1, args.seed + 20)
    torch.cuda.synchronize()
    emit({"phase": "hdrtv", "setup_s": time.perf_counter() - t0,
          "weights_gb": sum(p.numel() * p.element_size() for m in
                            (pipe.unet, pipe.gm_unet, pipe.controlnet, pipe.vae)
                            for p in m.parameters()) / 1e9})

    upconvert(pipe, sdr, cond, uncond, 1, args.seed + 21)  # warm-up: cuDNN/cuBLAS plans
    if args.profile:
        latents = pipe.prepare_latents(torch.Generator(device="cuda").manual_seed(0), 1,
                                       HDRTV_SIDE, HDRTV_SIDE)
        profile_fn("hdrtv_profile", lambda: pipe.denoise_dual(
            cond, uncond, latents, control_image=sdr, num_inference_steps=1, guidance_scale=7.5))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # The frame's denoise and decode, timed inside the one up-conversion call.
    spans: dict[str, float] = {}

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spans[name] = time.perf_counter() - t
            return out
        return run

    pipe.denoise_dual = timed("denoise_s", pipe.denoise_dual)
    pipe.decode_latents = timed("decode_s", pipe.decode_latents)
    reset_launch_counts()
    t0 = time.perf_counter()
    sdr01, gm01, hdr = upconvert(pipe, sdr, cond, uncond, args.hdrtv_steps, args.seed + 22)
    frame_s = time.perf_counter() - t0
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    n_iter = pipe.scheduler.num_steps(args.hdrtv_steps)
    side = HDRTV_SIDE
    ok = all(np.isfinite(a).all() for a in (sdr01, gm01, hdr))
    if not ok or sdr01.shape != (1, side, side, 3) or hdr.shape != (1, 3, side, side):
        raise SystemExit(f"chip_smoke: hdrtv output not finite or misshapen {sdr01.shape} "
                         f"{hdr.shape}")
    hdr0 = np.ascontiguousarray(hdr[0].transpose(1, 2, 0))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "hdrtv_0.hdr")
        save_hdr_image(path, hdr0, qmax=99.0)
        back = read_hdr(path)
    want = np.maximum(hdr0 / 100.0, 0.0)
    tol = want.max(axis=-1, keepdims=True) / 128.0 + 1e-30
    hdr_ok = back.shape == want.shape and bool(np.all(np.abs(back - want) <= tol))
    emit({
        "phase": "hdrtv", "batch": 1, "resolution": side, "steps": args.hdrtv_steps,
        "denoise_iterations": n_iter, "guidance_scale": 7.5, "s_per_frame": frame_s,
        "denoise_s": spans["denoise_s"], "s_per_iteration": spans["denoise_s"] / n_iter,
        "decode_s": spans["decode_s"], "peak_mem_gb": peak_gb, "launches": counts,
        "bsc_per_iteration": counts["flash_attention_bsc"] / n_iter, "hdr_readback_ok": hdr_ok,
        "hdr_max": float(hdr.max()), "sdr_mean": float(sdr01.mean()),
        "gm_mean": float(gm01.mean()),
    })
    if not hdr_ok:
        raise SystemExit("chip_smoke: hdrtv .hdr read back does not match what was written")
    missing = [k for k in HDRTV_KERNELS if counts[k] == 0]
    if missing:
        raise SystemExit(f"chip_smoke: kernels never launched on the hdrtv path: {missing}")
    if (counts["flash_attention_bsc"] != HDRTV_BSC_PER_ITERATION * n_iter
            or counts["flash_attention_fwd_d512"] != 1):
        raise SystemExit(f"chip_smoke: hdrtv launched flash_attention_bsc "
                         f"{counts['flash_attention_bsc']} times in {n_iter} iterations and the "
                         f"512-wide flash forward {counts['flash_attention_fwd_d512']} times")
    del pipe
    torch.cuda.empty_cache()
    return counts


def phase_hdrtv_e2e(args) -> None:
    import numpy as np
    import torch

    from gmdx_torch.models import set_use_kernels

    pipe = build_hdrtv_pipeline(args.seed, adapter_std=0.05)
    sdr, cond, uncond = hdrtv_inputs(1, args.seed + 23)
    mods = (pipe.unet, pipe.gm_unet, pipe.controlnet, pipe.vae)
    outs = {}
    for name, flag, scale in (("kernels", True, 1.0), ("plain", False, 1.0),
                              ("kernels_scale0", True, 0.0)):
        for m in mods:
            set_use_kernels(m, flag)
        sdr01, gm01, _ = upconvert(pipe, sdr, cond, uncond, HDRTV_E2E_STEPS, args.seed + 24,
                                   conditioning_scale=scale)
        outs[name] = [torch.from_numpy(np.ascontiguousarray(a)) for a in (sdr01, gm01)]
    p_sdr, p_gm = (psnr01(a, b) for a, b in zip(outs["kernels"], outs["plain"]))
    s_sdr, s_gm = (psnr01(a, b) for a, b in zip(outs["kernels"], outs["kernels_scale0"]))
    emit({"phase": "hdrtv_e2e", "batch": 1, "resolution": HDRTV_SIDE, "steps": HDRTV_E2E_STEPS,
          "psnr_sdr_db": p_sdr, "psnr_gm_db": p_gm, "min_db": PSNR_MIN_DB,
          "scale0_psnr_sdr_db": s_sdr, "scale0_psnr_gm_db": s_gm})
    if not min(p_sdr, p_gm) >= PSNR_MIN_DB:
        raise SystemExit(f"chip_smoke: hdrtv kernels vs plain PSNR {min(p_sdr, p_gm)} "
                         f"< {PSNR_MIN_DB} dB")
    if not s_sdr < PSNR_MIN_DB:
        raise SystemExit(f"chip_smoke: conditioning_scale 0 leaves the SDR at {s_sdr} dB of "
                         f"scale 1: the adapter does not act")
    del pipe
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 11 + 12: single-UNet SDR->HDR up-conversion at 512^2 with the opt-ins
# ---------------------------------------------------------------------------


def build_gm_pipeline(seed: int):
    """The full-width 8-channel GM UNet and the VAE with seeded random bf16
    weights, in the single-UNet pipeline."""
    import torch

    from gmdx_torch.models import (
        SD15_GM_UNET_CONFIG, SD15_VAE_CONFIG, AutoencoderKL, UNet2DConditionModel,
    )
    from gmdx_torch.pipelines import StableDiffusionGMPipeline
    from gmdx_torch.schedulers import PNDMScheduler

    torch.manual_seed(seed)
    with torch.device("cuda"):
        unet = UNet2DConditionModel(SD15_GM_UNET_CONFIG).to(torch.bfloat16).eval()
        vae = AutoencoderKL(SD15_VAE_CONFIG).to(torch.bfloat16).eval()
    return StableDiffusionGMPipeline(unet, vae, PNDMScheduler(), device="cuda")


def set_options(pipe, **options) -> None:
    """The kernel options on the UNet and the VAE alike, as the JAX package's
    environment toggles are global."""
    from gmdx_torch.models import set_kernel_options

    for m in (pipe.unet, pipe.vae):
        set_kernel_options(m, **options)


def sdr2hdr_inputs(batch: int, seed: int):
    """Random SDR frames in [-1, 1] and random 77x768 embeddings."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    sdr = torch.rand(batch, 3, 512, 512, generator=gen, device="cuda") * 2 - 1
    cond, uncond = (torch.randn(batch, 77, 768, generator=gen, device="cuda").to(torch.bfloat16)
                    for _ in range(2))
    return sdr, cond, uncond


def run_sdr2hdr(pipe, sdr, cond, uncond, steps: int, seed: int, spans: dict | None = None):
    """encode_sdr -> prepare_latents -> denoise (PNDM, CFG 7.5) -> one batched
    decode of the SDR and GM latents; the decoded SDR and GM in [0, 1]. With
    ``spans``, the seconds of the three stages land there."""
    import torch

    def stage(name, fn, *a, **kw):
        if spans is not None:
            torch.cuda.synchronize()
            t = time.perf_counter()
        out = fn(*a, **kw)
        if spans is not None:
            torch.cuda.synchronize()
            spans[name] = time.perf_counter() - t
        return out

    gen = torch.Generator(device="cuda").manual_seed(seed)
    sdr_lat = stage("encode_s", pipe.encode_sdr, sdr, gen)
    latents = pipe.prepare_latents(gen, sdr_lat)
    gm_lat = stage("denoise_s", pipe.denoise, sdr_lat, cond, uncond, latents,
                   num_inference_steps=steps, guidance_scale=7.5)
    both = stage("decode_s", pipe.decode_latents, torch.cat([sdr_lat, gm_lat]))
    b = sdr.shape[0]
    return to01(both[:b]), to01(both[b:])


def phase_sdr2hdr(args) -> dict[str, int]:
    """The single-UNet SDR->HDR path at 512^2 with the three opt-ins, then
    with the JAX package's default kernel set at the same settings."""
    import numpy as np
    import torch

    from gmdx_torch.io import read_hdr, save_hdr_image
    from gmdx_torch.kernels import launch_counts, reset_launch_counts
    from gmdx_torch.ops import apply_gm_to_sdr

    t0 = time.perf_counter()
    b, steps = args.sdr2hdr_batch, args.sdr2hdr_steps
    pipe = build_gm_pipeline(args.seed + 40)
    sdr, cond, uncond = sdr2hdr_inputs(b, args.seed + 41)
    torch.cuda.synchronize()
    emit({"phase": "sdr2hdr", "setup_s": time.perf_counter() - t0,
          "weights_gb": sum(p.numel() * p.element_size() for m in (pipe.unet, pipe.vae)
                            for p in m.parameters()) / 1e9})
    n_iter = pipe.scheduler.num_steps(steps)
    opt_in_counts = None
    for name, options in (("opt_ins", OPT_INS), ("opt_ins_wino2", OPT_INS_WINO2),
                          ("defaults", {})):
        set_options(pipe, **options)
        run_sdr2hdr(pipe, sdr, cond, uncond, 1, args.seed + 42)  # warm-up: weight caches, plans
        if args.profile:
            sdr_lat = pipe.encode_sdr(sdr)
            lat = pipe.prepare_latents(torch.Generator(device="cuda").manual_seed(0), sdr_lat)
            profile_fn(f"sdr2hdr_profile_{name}", lambda: pipe.denoise(
                sdr_lat, cond, uncond, lat, num_inference_steps=1, guidance_scale=7.5))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        spans: dict[str, float] = {}
        reset_launch_counts()
        sdr01, gm01 = run_sdr2hdr(pipe, sdr, cond, uncond, steps, args.seed + 43, spans)
        counts = launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        hdr = apply_gm_to_sdr(gm01, sdr01, qmax=99.0, clip_output=False)
        hdr_orig = apply_gm_to_sdr(gm01, to01(sdr), qmax=99.0, clip_output=False)
        ok = all(bool(torch.isfinite(t).all()) for t in (sdr01, gm01, hdr, hdr_orig))
        if not ok or gm01.shape != (b, 3, 512, 512) or hdr_orig.shape != (b, 3, 512, 512):
            raise SystemExit(f"chip_smoke: sdr2hdr ({name}) output not finite or misshapen "
                             f"{tuple(gm01.shape)}")
        hdr_ok = True
        with tempfile.TemporaryDirectory() as tmp:
            for tag, img in (("decoded", hdr), ("original", hdr_orig)):
                img0 = img[0].permute(1, 2, 0).cpu().numpy()
                path = os.path.join(tmp, f"hdr_{tag}_0.hdr")
                save_hdr_image(path, img0, qmax=99.0)
                back = read_hdr(path)
                want = np.maximum(img0 / 100.0, 0.0)
                tol = want.max(axis=-1, keepdims=True) / 128.0 + 1e-30
                hdr_ok &= back.shape == want.shape and bool(np.all(np.abs(back - want) <= tol))
        total = spans["encode_s"] + spans["denoise_s"] + spans["decode_s"]
        emit({
            "phase": "sdr2hdr", "kernels": name, "options": options, "batch": b,
            "resolution": 512, "steps": steps, "denoise_iterations": n_iter,
            "guidance_scale": 7.5, **spans, "s_per_iteration": spans["denoise_s"] / n_iter,
            "img_per_s": b / total, "peak_mem_gb": peak_gb, "launches": counts,
            "hdr_readback_ok": hdr_ok, "hdr_max": float(hdr.max()),
            "hdr_original_max": float(hdr_orig.max()), "gm_mean": float(gm01.mean()),
        })
        if not hdr_ok:
            raise SystemExit(f"chip_smoke: sdr2hdr ({name}) .hdr read back does not match")
        if name == "opt_ins":
            want_counts = {k: n * n_iter for k, n in SDR2HDR_PER_UNET_CALL.items()}
            want_counts["winograd4_conv3x3"] += SDR2HDR_VAE_WINO4
            want_counts["conv3x3"] += SDR2HDR_VAE_CONV3X3
            wrong = {k: (counts[k], n) for k, n in want_counts.items() if counts[k] != n}
            if wrong:
                raise SystemExit(f"chip_smoke: sdr2hdr launches (got, want): {wrong}")
            opt_in_counts = counts
        elif name == "opt_ins_wino2":
            want = {k: SDR2HDR_PER_UNET_CALL[k] * n_iter
                    for k in ("cross_attention_shortk", "add_layer_norm")}
            want["winograd4_conv3x3"] = 0
            wrong = {k: (counts[k], n) for k, n in want.items() if counts[k] != n}
            if wrong:
                raise SystemExit(f"chip_smoke: sdr2hdr ({name}) launches (got, want): {wrong}")
        elif any(counts[k] for k in ("cross_attention_shortk", "add_layer_norm",
                                     "winograd4_conv3x3")):
            raise SystemExit(f"chip_smoke: sdr2hdr with the default kernels launched an "
                             f"opt-in kernel: {counts}")
    del pipe
    torch.cuda.empty_cache()
    return opt_in_counts


def phase_sdr2hdr_e2e(args) -> None:
    """Batch 1, 3 steps: kernels against plain versions with the three
    opt-ins and with the short-K and add+LN opt-ins alone (>= 40 dB); the
    opt-in kernels against the default kernels, report only (F(4x4)'s bf16
    arithmetic end to end)."""
    import torch

    from gmdx_torch.models import set_use_kernels

    pipe = build_gm_pipeline(args.seed + 40)
    sdr, cond, uncond = sdr2hdr_inputs(1, args.seed + 44)
    outs = {}
    for name, flag, options in (("opt_ins", True, OPT_INS), ("opt_ins_plain", False, OPT_INS),
                                ("no_wino4", True, OPT_INS_WINO2),
                                ("no_wino4_plain", False, OPT_INS_WINO2),
                                ("defaults", True, {})):
        set_options(pipe, **options)
        for m in (pipe.unet, pipe.vae):
            set_use_kernels(m, flag)
        outs[name] = run_sdr2hdr(pipe, sdr, cond, uncond, SDR2HDR_E2E_STEPS, args.seed + 45)
    from gmdx_torch.ops import apply_gm_to_sdr

    def db(a, b):
        (sdr_a, gm_a), (sdr_b, gm_b) = outs[a], outs[b]
        hdr_a = apply_gm_to_sdr(gm_a, sdr_a, qmax=99.0, clip_output=False) / 100.0
        hdr_b = apply_gm_to_sdr(gm_b, sdr_b, qmax=99.0, clip_output=False) / 100.0
        peak = float(hdr_b.abs().max())
        return psnr01(gm_a, gm_b), psnr01(hdr_a / peak, hdr_b / peak)

    res = {"opt_ins": db("opt_ins", "opt_ins_plain"), "no_wino4": db("no_wino4", "no_wino4_plain"),
           "opt_ins_vs_defaults": db("opt_ins", "defaults")}
    emit({"phase": "sdr2hdr_e2e", "batch": 1, "steps": SDR2HDR_E2E_STEPS,
          "min_db": PSNR_MIN_DB, **{f"{k}_psnr_gm_hdr_db": v for k, v in res.items()}})
    worst = min(min(res["opt_ins"]), min(res["no_wino4"]))
    if not worst >= PSNR_MIN_DB:
        raise SystemExit(f"chip_smoke: sdr2hdr kernels vs plain PSNR {worst} < {PSNR_MIN_DB} dB")
    del pipe
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 13-15: Stage-1 VAE-LoRA + GAN training
# ---------------------------------------------------------------------------


def build_stage1(seed: int, lora_b_std: float = 0.0):
    """Stage 1 at full SD-1.5 width with seeded random weights: the VAE
    (fp32 parameters, bf16 compute), VGG19 and the Paella discriminator
    (depth 6, hidden 512) in bf16 compute, LoRA r = 64 on every VAE conv and
    Linear weight plus the trainable conv_out, clipped AdamW at the CLI's
    defaults. The LoRA ``b`` factors start at 0, as the step does, or with
    ``lora_b_std`` are drawn N(0, lora_b_std^2) so that every factor takes
    gradient."""
    import torch

    from gmdx_torch.models import SD15_VAE_CONFIG, AutoencoderKL
    from gmdx_torch.models.discriminator import Discriminator
    from gmdx_torch.models.vgg import VGG19Features
    from gmdx_torch.ops import fix_mulog_tmo
    from gmdx_torch.train import stage1

    torch.manual_seed(seed)
    with torch.device("cuda"):
        vae = AutoencoderKL(SD15_VAE_CONFIG, dtype=torch.bfloat16)
        vgg = VGG19Features(dtype=torch.bfloat16)
        disc = Discriminator(dtype=torch.bfloat16)
    config = stage1.Stage1Config()
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    trainables = stage1.init_trainables(gen, vae, config)
    if lora_b_std:
        with torch.no_grad():
            for f in trainables["lora"].values():
                f["b"].normal_(0.0, lora_b_std, generator=gen)
    steps = (stage1.make_gen_step(config, vae=vae, discriminator=disc, vgg=vgg,
                                  tmo_fn=fix_mulog_tmo),
             stage1.make_disc_step(config, vae=vae, discriminator=disc, tmo_fn=fix_mulog_tmo))
    return config, vae, disc, trainables, steps, gen


def stage1_batch(b: int, side: int, gen):
    import torch

    return {k: torch.rand(b, 3, side, side, generator=gen, device=gen.device) * 2 - 1
            for k in ("pixel_values", "miss_pixel_values")}


def phase_stage1(args) -> dict[str, int]:
    """Gen + disc step pairs at 512^2 (batch --stage1-batch, one warm-up and
    --stage1-steps timed pairs), then one pair at 1024^2, batch 1, the
    shape that takes the 512-wide flash forward and backward."""
    import statistics

    import torch

    from gmdx_torch.kernels import launch_counts, reset_launch_counts
    from gmdx_torch.train import stage1

    t0 = time.perf_counter()
    config, vae, disc, trainables, (gen_step, disc_step), gen = build_stage1(args.seed + 50)
    state = stage1.init_state(config, trainables, disc)
    torch.cuda.synchronize()
    emit({"phase": "stage1", "setup_s": time.perf_counter() - t0,
          "vae_params": sum(p.numel() for p in vae.parameters()),
          "trainable_params": sum(t.numel() for t in stage1.trainable_list(trainables)),
          "disc_params": sum(p.numel() for p in disc.parameters())})

    reset_launch_counts()
    runs = {}
    for side, b, n_timed in ((512, args.stage1_batch, args.stage1_steps), (HDRTV_SIDE, 1, 1)):
        # A warm-up pair at each resolution (cuDNN's first use of its shapes),
        # launches counted, then the timed pairs.
        batch = stage1_batch(b, side, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = launch_counts()
        times, metrics = [], []
        for i in range(n_timed + 1):
            t1 = time.perf_counter()
            state, gm = gen_step(state, batch, gen)
            state, dm = disc_step(state, batch, gen)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
            metrics.append({k: float(v) for m in (gm, dm) for k, v in m.items()
                            if k != "module_grad_norms"})
        timed = times[1:]
        s_pair = statistics.median(timed)
        after = launch_counts()
        runs[side] = {
            "phase": "stage1", "resolution": side, "batch": b, "timed_pairs": len(timed),
            "warmup_pair_s": times[0], "pair_s": timed, "s_per_pair": s_pair, "pairs_per_s": 1.0 / s_pair,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]},
            "metrics_last": metrics[-1],
        }
        emit(runs[side])
        bad = [m for m in metrics if not all(math.isfinite(v) for v in m.values())]
        if bad:
            raise SystemExit(f"chip_smoke: stage1 at {side}^2: metrics not finite: {bad[0]}")
    counts = launch_counts()
    if args.profile:
        for side, b in ((512, args.stage1_batch), (HDRTV_SIDE, 1)):
            batch = stage1_batch(b, side, gen)
            profile_fn(f"stage1_profile_{side}", lambda: (gen_step(state, batch, gen),
                                                          disc_step(state, batch, gen)))
    missing = [k for k in STAGE1_KERNELS if counts[k] == 0]
    if missing:
        raise SystemExit(f"chip_smoke: kernels never launched on the Stage-1 path: {missing}")
    # Per pair at 1024^2 (a warm-up and a timed one): both mid-block
    # attentions forward in the gen step (then backward) and in the disc
    # step's no-grad VAE forward.
    want = {"flash_attention_fwd_d512": 8, "flash_attention_bwd_d512": 4}
    got = {k: runs[HDRTV_SIDE]["launches"].get(k, 0) for k in want}
    if got != want or any(runs[512]["launches"].get(k, 0) for k in want):
        raise SystemExit(f"chip_smoke: stage1 512-wide attention launches {got}, want {want} "
                         f"at 1024^2 and none at 512^2")
    del state, vae, disc, trainables, gen_step, disc_step
    torch.cuda.empty_cache()
    return counts


class _Recorder:
    """An optimizer stand-in for stage1_e2e: records the gradients and
    leaves the parameters as they are."""

    def __init__(self, params):
        self.params, self.grads = list(params), None

    def step(self, grads, grad_norm=None):
        self.grads = [g.float().flatten() for g in grads]


# stage1_e2e's watched leaves: the LoRA factors of both mid-block attentions'
# projections, whose gradient flows straight out of the 512-wide flash
# backward kernel.
STAGE1_WATCHED = tuple(f"mid_block.attentions.0.{p}." for p in ("to_q", "to_k", "to_v", "to_out"))
STAGE1_E2E_SIDE = HDRTV_SIDE


def _stage1_e2e_run(args, use_kernels: bool) -> dict:
    """One gen step and one disc step at batch 1 and 1024^2 with recording
    optimizers: loss parts, flattened gradients and the watched leaves'."""
    import torch

    from gmdx_torch.models import set_use_kernels
    from gmdx_torch.train import stage1

    config, vae, disc, trainables, (gen_step, disc_step), gen = build_stage1(
        args.seed + 60, lora_b_std=1e-2)
    set_use_kernels(vae, use_kernels)
    names = [f"{n}.{k}" for n in sorted(trainables["lora"]) for k in ("a", "b")] + [
        "conv_out.weight", "conv_out.bias"]
    state = stage1.init_state(config, trainables, disc, (
        _Recorder(stage1.trainable_list(trainables)), _Recorder(disc.parameters())))
    batch = stage1_batch(1, STAGE1_E2E_SIDE, gen)
    side = STAGE1_E2E_SIDE // 2 ** (len(vae.config.block_out_channels) - 1)
    batch["encode_eps"] = torch.randn(1, 4, side, side, generator=gen, device=gen.device)
    _, gm = gen_step(state, batch)
    _, dm = disc_step(state, batch)
    g = state.optimizer.grads
    out = {
        "parts": {k: float(v) for m in (gm, dm) for k, v in m.items()
                  if k in ("recon", "perceptual", "adversarial", "adaptive_weight", "hinge", "gp")},
        "gen": torch.cat(g), "disc": torch.cat(state.disc_optimizer.grads),
        "watched": {n: t for n, t in zip(names, g) if any(w in n for w in STAGE1_WATCHED)},
    }
    del state, vae, disc, trainables
    torch.cuda.empty_cache()
    return out


def _stage1_e2e_compare(kern: dict, plain: dict) -> tuple[dict, bool]:
    """The train_e2e bars on one kernels run against the plain run."""
    import torch

    rel = {k: abs(kern["parts"][k] - v) / max(abs(v), 1e-30) for k, v in plain["parts"].items()}
    parts_ok = all(r <= (STAGE1_ADAPTIVE_RTOL if k == "adaptive_weight" else TRAIN_LOSS_RTOL)
                   for k, r in rel.items())
    cos = {k: float(torch.dot(kern[k], plain[k]) / (kern[k].norm() * plain[k].norm()))
           for k in ("gen", "disc")}
    leaf = sorted(((float((kern["watched"][n] - p).norm() / p.norm().clamp_min(1e-30)), n)
                   for n, p in plain["watched"].items()), reverse=True)
    kinds = {}
    for n in plain["watched"]:
        kind = next(w for w in STAGE1_WATCHED if w in n).strip(".").split(".")[-1] \
            + "." + n.rsplit(".", 1)[1]
        kinds.setdefault(kind, []).append(n)
    ratio = {k: math.sqrt(sum(float(kern["watched"][n].norm()) ** 2 for n in ns)
                          / sum(float(plain["watched"][n].norm()) ** 2 for n in ns))
             for k, ns in kinds.items()}
    worst_ratio = max(abs(r - 1.0) for r in ratio.values())
    ok = (parts_ok and min(cos.values()) >= TRAIN_GRAD_COS_MIN
          and leaf[0][0] <= TRAIN_LEAF_REL_L2_MAX and worst_ratio <= STAGE1_NORM_RATIO_TOL)
    return {"parts_rel_err": rel, "grad_cosine": cos, "leaves_checked": len(leaf),
            "leaf_rel_l2_worst": leaf[:4], "norm_ratio_by_kind": ratio}, ok


_STAGE1_PLAIN: dict = {}


def phase_stage1_e2e(args) -> None:
    """Kernels against use_kernels=False at batch 1 and 1024^2, one gen step
    and one disc step on the same weights, batch and posterior draw: each
    loss part within TRAIN_LOSS_RTOL relative (the adaptive weight within
    STAGE1_ADAPTIVE_RTOL), the gen and disc gradients at
    cosine >= TRAIN_GRAD_COS_MIN, the watched LoRA leaves within
    TRAIN_LEAF_REL_L2_MAX rel-L2 and, per kind, their norm ratio within
    STAGE1_NORM_RATIO_TOL of 1."""
    import torch

    if "plain" not in _STAGE1_PLAIN:
        _STAGE1_PLAIN["plain"] = _stage1_e2e_run(args, False)
    report, ok = _stage1_e2e_compare(_stage1_e2e_run(args, True), _STAGE1_PLAIN["plain"])
    emit({"phase": "stage1_e2e", "batch": 1, "resolution": STAGE1_E2E_SIDE, **report})
    torch.cuda.empty_cache()
    if not ok:
        raise SystemExit(f"chip_smoke: stage1_e2e out of bounds: {report}")


def phase_stage1_e2e_d512_plain(args) -> None:
    """stage1_e2e once more with the kernels, but the 512-wide attention's
    forward and backward on their plain versions in bf16 (fp32 inside, bf16
    out, as the kernels): which part carries the kernels' to_q / to_k norm
    deficit. Report only."""
    import torch

    import gmdx_torch.kernels.attention as attention
    from gmdx_torch.kernels.flash_attention import (
        flash_attention_bwd_plain, flash_attention_fwd_plain,
    )

    fwd, bwd = attention.flash_attention_fwd, attention.flash_attention_bwd

    def plain_fwd(q, k, v, heads, *, scale=None):
        if q.shape[-1] // heads != 512:
            return fwd(q, k, v, heads, scale=scale)
        return flash_attention_fwd_plain(q, k, v, heads, scale or 512**-0.5)

    def plain_bwd(q, k, v, out, lse, dout, heads, *, scale=None):
        if q.shape[-1] // heads != 512:
            return bwd(q, k, v, out, lse, dout, heads, scale=scale)
        return flash_attention_bwd_plain(q, k, v, out, lse, dout, heads, scale or 512**-0.5)

    attention.flash_attention_fwd, attention.flash_attention_bwd = plain_fwd, plain_bwd
    try:
        if "plain" not in _STAGE1_PLAIN:
            _STAGE1_PLAIN["plain"] = _stage1_e2e_run(args, False)
        report, ok = _stage1_e2e_compare(_stage1_e2e_run(args, True), _STAGE1_PLAIN["plain"])
    finally:
        attention.flash_attention_fwd, attention.flash_attention_bwd = fwd, bwd
    emit({"phase": "stage1_e2e_d512_plain", "batch": 1, "resolution": STAGE1_E2E_SIDE,
          "within_bars": ok, **report})
    torch.cuda.empty_cache()


def phase_stage1_e2e_controls(args) -> None:
    """stage1_e2e with the 512-wide backward's dQ, then its dK, scaled by
    0.95: each must fail the check."""
    import gmdx_torch.kernels.attention as attention

    orig = attention.flash_attention_bwd
    for i, out_name in ((0, "dq"), (1, "dk")):
        def scaled(*a, _i=i, **kw):
            outs = list(orig(*a, **kw))
            outs[_i] = outs[_i] * 0.95
            return tuple(outs)

        attention.flash_attention_bwd = scaled
        try:
            phase_stage1_e2e(args)
            caught = False
        except SystemExit:
            caught = True
        finally:
            attention.flash_attention_bwd = orig
        emit({"phase": "stage1_e2e_control", "kernel": "flash_attention_bwd_d512",
              "output": out_name, "scale": 0.95, "caught": caught})
        if not caught:
            raise SystemExit(f"chip_smoke: stage1_e2e missed the 512-wide backward's {out_name}"
                             " x 0.95")
    _STAGE1_PLAIN.clear()


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phases 17-19: the samplers and the inference CLIs
# ---------------------------------------------------------------------------


def sampler_schedulers():
    """(tag, scheduler, eta, steps) of the samplers phase: DDIM without and
    with noise, DPM-Solver++ order 2 at 8 steps (so the last step is first
    order: lower_order_final), LCM at 4."""
    from gmdx_torch.schedulers import get_scheduler

    return (("ddim_eta0", get_scheduler("ddim"), 0.0, SAMPLER_STEPS),
            ("ddim_eta05", get_scheduler("ddim"), 0.5, SAMPLER_STEPS),
            ("dpm++", get_scheduler("dpm++"), 0.0, 8),
            ("lcm", get_scheduler("lcm"), 0.0, 4))


def phase_samplers(args) -> None:
    """The full-width single-UNet and dual paths at 512^2, batch 2, through
    each sampler after PNDM: s/iteration, peak memory, finite latents, and
    the kernel launches per UNet call equal to PNDM's."""
    import torch

    from gmdx_torch.kernels import launch_counts, reset_launch_counts
    from gmdx_torch.pipelines import StableDiffusionGMPipeline
    from gmdx_torch.schedulers import PNDMScheduler

    dual = build_pipeline(args.seed)
    single = StableDiffusionGMPipeline(dual.gm_unet, dual.vae, PNDMScheduler(), device="cuda")
    latents, cond, uncond = make_inputs(dual, 2, args.seed + 40)
    sdr_lat = torch.randn(latents.shape, device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(args.seed + 41))
    runs = {
        # (pipeline, UNet calls an iteration, run(steps, eta, generator))
        "single": (single, 1, lambda n, eta, g: single.denoise(
            sdr_lat, cond, uncond, latents, num_inference_steps=n, guidance_scale=7.5,
            eta=eta, generator=g)),
        "dual": (dual, 2, lambda n, eta, g: dual.denoise_dual(
            cond, uncond, latents, num_inference_steps=n, guidance_scale=7.5, eta=eta,
            generator=g)),
    }
    for path, (pipe, calls, run) in runs.items():
        per_call = None
        cases = (("pndm", PNDMScheduler(), 0.0, 2),) + sampler_schedulers()
        # PNDM and the first sampler once more at the end: whether a row's
        # wall depends on its place in the sequence (report only).
        cases += tuple((f"{tag}_again", sched, eta, steps) for tag, sched, eta, steps in cases[:2])
        for tag, sched, eta, steps in cases:
            pipe.scheduler = sched
            gen = torch.Generator(device="cuda").manual_seed(args.seed + 42)
            run(1 if tag == "lcm" else 2, eta, gen)  # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            out = run(steps, eta, gen)
            counts = launch_counts()
            walls = []
            for _ in range(SAMPLER_REPEATS):  # walls swing: the median of a few
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                run(steps, eta, gen)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            dt = sorted(walls)[len(walls) // 2]
            n_iter = pipe._num_steps(steps)
            per = {k: v / (n_iter * calls) for k, v in counts.items() if v}
            per_call = per if per_call is None else per_call
            outs = out if isinstance(out, tuple) else (out,)
            finite = all(bool(torch.isfinite(o).all()) for o in outs)
            emit({"phase": "samplers", "path": path, "sampler": tag, "eta": eta,
                  "batch": 2, "resolution": 512, "steps": steps, "iterations": n_iter,
                  "denoise_s": dt, "s_per_iteration": dt / n_iter, "walls_s": walls,
                  "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                  "launches_per_unet_call": per, "finite": finite})
            if not finite:
                raise SystemExit(f"chip_smoke: {path} latents not finite with {tag}")
            if per != per_call:
                raise SystemExit(f"chip_smoke: {path} with {tag} launched {per} a UNet call, "
                                 f"PNDM {per_call}")
            if args.profile and path == "single" and not tag.endswith("_again"):
                # Device time against wall: whether a sampler's wall is the
                # device's or the host's.
                profile_fn(f"samplers_profile_{tag}", lambda: run(steps, eta, gen))
        pipe.scheduler = PNDMScheduler()
    del dual, single, runs
    torch.cuda.empty_cache()


def phase_samplers_e2e(args) -> None:
    """Batch 1, 3 steps of each sampler through the dual path, kernels
    against plain versions on the same generator: decoded SDR and GM
    >= 40 dB; the latents' dB after each step are printed, so that a miss
    shows the step that amplifies the difference."""
    import torch

    from gmdx_torch.models import set_use_kernels

    pipe = build_pipeline(args.seed)
    latents, cond, uncond = make_inputs(pipe, 1, args.seed + 50)
    worst = []
    for tag, sched, eta, _ in sampler_schedulers():
        pipe.scheduler = sched
        outs = {}
        for flag in (True, False):
            for m in (pipe.unet, pipe.gm_unet, pipe.vae):
                set_use_kernels(m, flag)
            gen = torch.Generator(device="cuda").manual_seed(args.seed + 51)
            (sdr_lat, gm_lat), (sdr_st, gm_st) = pipe.denoise_dual(
                cond, uncond, latents, num_inference_steps=E2E_STEPS, guidance_scale=7.5,
                eta=eta, generator=gen, return_intermediates=True)
            both = to01(pipe.decode_latents(torch.cat([sdr_lat, gm_lat])))
            outs[flag] = (both[:1], both[1:], sdr_st, gm_st)
        p_sdr, p_gm = (psnr01(a, b) for a, b in zip(outs[True][:2], outs[False][:2]))

        def db(a, b):
            return float(10 * torch.log10(b.double().abs().max() ** 2
                                          / ((a.double() - b.double()) ** 2).mean()))

        steps = [{"sdr_db": db(a, b), "gm_db": db(c, d)} for a, b, c, d in zip(
            outs[True][2], outs[False][2], outs[True][3], outs[False][3])]
        emit({"phase": "samplers_e2e", "sampler": tag, "eta": eta, "batch": 1,
              "steps": E2E_STEPS, "psnr_sdr_db": p_sdr, "psnr_gm_db": p_gm,
              "min_db": PSNR_MIN_DB, "latent_db_by_step": steps})
        worst.append((min(p_sdr, p_gm), tag))
    for m in (pipe.unet, pipe.gm_unet, pipe.vae):
        set_use_kernels(m, True)
    del pipe
    torch.cuda.empty_cache()
    low, tag = min(worst)
    if not low >= PSNR_MIN_DB:
        raise SystemExit(f"chip_smoke: {tag} kernels vs plain PSNR {low} < {PSNR_MIN_DB} dB")


def _script(name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"torch_cli_{name}", os.path.join(REPO, "scripts", "torch", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_cli(args) -> None:
    """The port's CLIs on a full-width directory: scripts/torch/init_pipeline.py
    --size sd15 --dual --scheduler dpm++ writes one (7.70 GB, float32), then
    generate_hdr on a 512^2 and a 640x480 PNG (resized) at 4 steps and
    upconvert_hdrtv on one 1024^2 PNG at 2 steps read it; every PNG and
    .hdr they write is read back, and the up-conversion's launches are
    checked as phase hdrtv's. The directory is removed at the end."""
    import shutil

    import numpy as np
    import torch

    import gmdx_torch.io as gio
    from gmdx_torch.io import read_hdr
    from gmdx_torch.io.png import read_png, write_png
    from gmdx_torch.kernels import launch_counts, reset_launch_counts

    tmp = tempfile.mkdtemp(prefix="gmdx_cli_")
    try:
        pipe_dir, out = os.path.join(tmp, "pipe"), os.path.join(tmp, "out")
        t0 = time.perf_counter()
        _script("init_pipeline").main(["--output_dir", pipe_dir, "--size", "sd15", "--dual",
                                       "--scheduler", "dpm++", "--seed", str(args.seed)])
        write_s = time.perf_counter() - t0
        dir_gb = sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(pipe_dir)
                     for f in fs) / 1e9
        torch.cuda.empty_cache()
        rng = np.random.default_rng(args.seed + 60)
        for sub, sizes in (("sdr", ((512, 512), (480, 640))), ("hdrtv", ((1024, 1024),))):
            os.makedirs(os.path.join(tmp, sub))
            for i, (h, w) in enumerate(sizes):
                y, x = np.mgrid[0:h, 0:w]
                img = np.stack([np.sin(x / (17 + 5 * c) + y / 23) * 100 + 128 for c in range(3)],
                               -1) + rng.integers(-20, 20, (h, w, 3))
                write_png(os.path.join(tmp, sub, f"frame{i}.png"),
                          np.clip(img, 0, 255).astype(np.uint8))

        load_s = [0.0]

        def timed(fn):
            def run(*a, **kw):
                t = time.perf_counter()
                out = fn(*a, **kw)
                load_s[0] += time.perf_counter() - t
                return out
            return run

        saved = gio.load_pipeline, gio.load_component
        gio.load_pipeline, gio.load_component = timed(gio.load_pipeline), timed(gio.load_component)
        try:
            t0 = time.perf_counter()
            _script("generate_hdr").main([
                "--pretrained_model_name_or_path", pipe_dir, "--unet_ckpt",
                os.path.join(pipe_dir, "gm_unet"), "--sdr_input_path", os.path.join(tmp, "sdr"),
                "--output_dir", os.path.join(out, "gen"), "--num_inference_steps", "4",
                "--seed", str(args.seed)])
            torch.cuda.synchronize()
            gen_s, gen_load_s = time.perf_counter() - t0, load_s[0]
            torch.cuda.empty_cache()
            load_s[0] = 0.0
            reset_launch_counts()
            t0 = time.perf_counter()
            _script("upconvert_hdrtv").main([
                "--pretrained_model_name_or_path", pipe_dir, "--sdr_input_path",
                os.path.join(tmp, "hdrtv"), "--output_dir", os.path.join(out, "hdrtv"),
                "--num_inference_steps", "2", "--seed", str(args.seed)])
            torch.cuda.synchronize()
            up_s, up_load_s = time.perf_counter() - t0, load_s[0]
            counts = launch_counts()
        finally:
            gio.load_pipeline, gio.load_component = saved
        torch.cuda.empty_cache()

        want = {os.path.join("gen", f"{k}_frame{i}.{e}"): (512, 512, 3)
                for i in range(2) for k, e in (("sdr", "png"), ("gm", "png"),
                                               ("hdr_decoded", "hdr"), ("hdr_original", "hdr"))}
        want.update({os.path.join("hdrtv", "hdrtv_frame0.hdr"): (1024, 1024, 3),
                     os.path.join("hdrtv", "sdr_frame0.png"): (1024, 1024, 3),
                     os.path.join("hdrtv", "gm_frame0.png"): (1024, 1024, 3)})
        bad = []
        for rel, shape in want.items():
            path = os.path.join(out, rel)
            arr = read_hdr(path) if path.endswith(".hdr") else read_png(path)
            if arr.shape != shape or not np.isfinite(arr).all():
                bad.append((rel, arr.shape))
        n_iter = 2  # DPM-Solver++: one UNet iteration a step
        emit({"phase": "cli", "dir_gb": dir_gb, "write_s": write_s,
              "generate_load_s": gen_load_s, "generate_s": gen_s,
              "generate_s_per_image": (gen_s - gen_load_s) / 2,
              "upconvert_load_s": up_load_s, "upconvert_s": up_s,
              "upconvert_s_per_image": up_s - up_load_s, "files_checked": len(want),
              "bad_files": bad, "upconvert_launches": counts})
        if bad:
            raise SystemExit(f"chip_smoke: CLI outputs missing, misshapen or not finite: {bad}")
        if (counts["flash_attention_fwd_d512"] != 1
                or counts["flash_attention_bsc"] != HDRTV_BSC_PER_ITERATION * n_iter):
            raise SystemExit(f"chip_smoke: upconvert_hdrtv launched flash_attention_bsc "
                             f"{counts['flash_attention_bsc']} times in {n_iter} iterations and "
                             f"the 512-wide flash forward {counts['flash_attention_fwd_d512']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--train-batch", type=int, default=2)
    p.add_argument("--train-steps", type=int, default=4, help="timed Stage-2 steps")
    p.add_argument("--hdrtv-steps", type=int, default=10,
                   help="PNDM steps of the 1024^2 up-conversion (50 for the headline)")
    p.add_argument("--sdr2hdr-batch", type=int, default=2,
                   help="frames of the single-UNet SDR->HDR phase (8 for the headline)")
    p.add_argument("--sdr2hdr-steps", type=int, default=10,
                   help="PNDM steps of the single-UNet SDR->HDR phase (50 for the headline)")
    p.add_argument("--stage1-batch", type=int, default=1,
                   help="images of the Stage-1 phase's 512^2 pairs (4 for the headline)")
    p.add_argument("--stage1-steps", type=int, default=2,
                   help="timed gen + disc pairs of the Stage-1 phase (10 for the headline)")
    p.add_argument("--profile", action="store_true",
                   help="device time by kernel over one denoise iteration (512^2 and 1024^2), "
                        "one train step and one Stage-1 pair")
    args = p.parse_args()

    if not os.path.isdir(os.path.join(REPO, "gmdx_torch")):
        raise SystemExit("chip_smoke: gmdx_torch/ not found beside this script")
    sys.path.insert(0, REPO)
    dev = phase_device()
    phase_build()
    kernel_rows = phase_kernels(args.batch, args.train_batch, args.sdr2hdr_batch)
    launches = phase_main(args)
    phase_e2e(args)
    train_launches = phase_train(args)
    phase_train_e2e(args)
    phase_train_e2e_controls(args)
    hdrtv_launches = phase_hdrtv(args)
    phase_hdrtv_e2e(args)
    sdr2hdr_launches = phase_sdr2hdr(args)
    phase_sdr2hdr_e2e(args)
    stage1_launches = phase_stage1(args)
    phase_stage1_e2e(args)
    phase_stage1_e2e_d512_plain(args)
    phase_stage1_e2e_controls(args)
    phase_samplers(args)
    phase_samplers_e2e(args)
    phase_cli(args)

    summary = []
    for name, (source, replaces) in KERNELS.items():
        rows = [r for r in kernel_rows if r["name"] == name]
        head = rows[0]
        # Launches from the run of the path the kernel was ported for.
        n = (launches if name in INFERENCE_KERNELS
             else train_launches if name in TRAIN_KERNELS
             else hdrtv_launches if name in HDRTV_KERNELS
             else stage1_launches if name in STAGE1_KERNELS else sdr2hdr_launches)[name]
        summary.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": n, "max_abs_err": max(r["max_abs_err"] for r in rows),
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
