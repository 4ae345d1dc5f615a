"""Smoke run of the PyTorch/CUDA port (``gmdx_torch``) on one NVIDIA H100.

    python3 chip_smoke.py                    # batch 2 x 10 PNDM steps; train batch 2;
                                             # 1024^2 up-conversion, 10 steps;
                                             # SDR->HDR batch 2 x 10 steps;
                                             # Stage 1 batch 1 x 2 pairs; the samplers;
                                             # both CLIs on a full-width directory;
                                             # the Stage-2, Stage-1 and ControlNet
                                             # trainer CLIs on it; its diffusers
                                             # round trip and the safety checker
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
     The split GroupNorm's entries (group_norm_moments, group_norm_apply)
     and the attention kernels at the shapes two ranks give them (a rank's
     queries against the whole image's keys; half the heads) have rows of
     their own, and so has the split backward (group_norm_bwd_sums, each
     sum column, dgamma and dbeta apart; group_norm_bwd_apply, dx and
     dtemb apart) at a rank's half of phase train_parallel's images.
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
     iteration. The directory stays for phase 20.
 20. train_cli: the Stage-2 trainer CLI (scripts/torch/train_gm_unet.py) on
     that directory (its 4-channel unet inflated to 8): 24 pairs of 600x800
     PNGs in a parquet written by the port. Run A, the parquet path at
     512^2, batch 8, random flips, EMA, 6 steps, asynchronous checkpoints
     at 3 and 6, one validation image an epoch (PNDM 49), the final
     pipeline directory: losses finite, both checkpoints, the saved unet
     8-channel and the EMA shadow bit for bit, the validation PNG and .hdr
     finite at 512^2; the loader's s/batch alone, s/step, checkpoint s and
     GB, validation and save_pipeline s, peak memory. Then the latent cache
     (scripts/torch/precompute_latents.py) and, on it, B (20 steps) and C
     (10 steps, then --resume_from_checkpoint latest to 20): C restores the
     bits it saved, B's launches a step of the flash forward and backward
     and the GroupNorm backward equal phase train's, C's step-20 loss is
     within 1e-3 relative of B's. Last, one step with and one without
     --gradient_checkpointing on the same cached batch and generator: the
     same loss, gradient norms within 1e-3; peak memory of each and of a
     remat step at batch 16.
 21. stage1_cli: the Stage-1 trainer CLI (scripts/torch/train_vqgan_lora.py)
     on that directory's VAE at full width, 512^2, batch 4, --clip_pixel
     --use_ema, on 24 pairs of 600x800 PNGs. A: 4 updates, checkpoints at
     2 and 4, one validation PNG, --debug_mode: losses finite,
     finetuned_VAE/vae read back equal to the EMA-merged VAE bit for bit,
     discriminator/ read back at depth 6, hidden 512, equal to the run's,
     the validation grid and .hdr and the debug strip finite at their
     sizes. C: 2 updates, then --resume_from_checkpoint latest to 4: the
     restored digest equals the saved one, C's step-4 loss within
     TRAIN_CLI_LOSS_RTOL of A's, the resumed pair's launches equal phase
     stage1's a pair at 512^2. Then 2 updates with
     --gradient_accumulation_steps 2 (cadence gen, gen, discr, discr).
     s/pair, pairs/s, the loader alone, checkpoint call and restore s and
     GB, peak memory.
 22. controlnet_cli: the ControlNet trainer CLI
     (scripts/torch/train_controlnet.py) on that directory, the ControlNet
     copied from its UNet, 512^2, batch 4, --use_ema, the same pairs. A: 6
     steps, asynchronous checkpoints at 3 and 6: losses finite,
     controlnet/ read back at full width equal to the EMA shadow bit for
     bit, every step's launches by the route rule (the frozen UNet's 6
     down-block self-attentions on the KV-resident kernel, its 9 up-block
     and the ControlNet's 6 on the flash forward and as many backwards;
     conv3x3, both GroupNorm directions and the LN-fused FF launched; every
     other kernel never). C: 3 steps, then a resume to 6: the restored
     digest equals the saved one, C's step-6 loss within
     TRAIN_CLI_LOSS_RTOL of A's. s/step, samples/s, checkpoint call and
     restore s and GB, peak memory.
 23. convert: scripts/torch/convert_torch_checkpoint.py exports that
     directory to diffusers' layout; a seeded full-width ViT-L/14 safety
     checker (transformers' layout, position_ids included) joins it; the
     result is imported into a second directory, whose unet, gm_unet, vae
     and text_encoder tensors, configs, scheduler and tokenizer must equal
     the source's bit for bit and whose checker the seeded one;
     generate_hdr from it (4 steps, phase cli's PNGs) at >= 40 dB of a run
     from the source (bit equality reported); the checker in float32 on
     the card against the CPU on 8 decoded 512^2 images (cosine >= 0.9999,
     flags equal where every score is beyond 1e-3 of 0), its ms and fp32
     bound for the batch; a pipeline call at batch 2 with every concept
     firing must come out black. Export and import s and GB, peak memory.
 24. parallel: tensor- and spatial-parallel serving (gmdx_torch.dist.tp,
     tpctx and the H split) on two gloo ranks of the one card beside one
     process with the same seeded weights, embeddings and generators:
     TP = 2 through the dual path at 512^2 (batch 1, 3 steps), SP = 2
     through generate_hdr's path at 512^2 (encode, 3 steps, decode) and
     upconvert_hdrtv's at 1024^2 (2 steps); each rank's decoded SDR and GM
     >= 40 dB of the one process's, its launches (under TP the attention
     kernels as in one process and the conv, GroupNorm and FF kernels
     never; under SP every kernel of the path, the split GroupNorm's
     entries in place of group_norm_silu), its peak memory beside the one
     process's, the phase's wall beside PARALLEL_BUDGET_S.
 25. train_parallel: Stage-2 training under tensor and spatial parallelism
     at SD-1.5 width, 512^2, global batch 8 of cached latents, bf16, remat:
     two gloo ranks of the one card under TP = 2, then SP = 2, each beside
     one process on the global batch: losses within TRAIN_LOSS_RTOL, the
     first reduced gradient, whole (TP's slices gathered), at cosine >=
     TRAIN_GRAD_COS_MIN against the one process's; the steps' launches by
     the mode's rule (SP: the flash forward and backward, the LN-fused FF
     and the split GroupNorm's four entries, group_norm_bwd_sums and
     group_norm_bwd_apply in place of group_norm_silu_bwd; TP: the flash
     kernels as in one process, GroupNorm, the conv and the FF never); a
     rank's peak memory beside one process's; then train_gm_unet.py on phase
     cli's directory for 2 steps under --shard_strategy tp (cached latents)
     and sp (pixels: the VAE on each rank's rows) on the two ranks: losses
     finite, the saved pipeline's UNet whole. Its wall beside
     TRAIN_PARALLEL_BUDGET_S.
``python3 chip_smoke.py --parallel-cards N`` (N cards, not the default run)
runs TP = N and SP = N with a rank a card under NCCL against one card:
s/image of generate_hdr's path at 512^2 and s/frame of upconvert_hdrtv's
at 1024^2, PNDM 50, with phase parallel's checks; then generate_hdr
(--tp_size N, --sp_size N) and upconvert_hdrtv (--sp_size N) themselves
under torchrun on a full-width directory, their files >= 40 dB of the
one-card run's; then train_gm_unet.py for 2 steps at 512^2 under
--shard_strategy tp --tp_size N and sp --sp_size N under torchrun against
one card, the step-1 loss within TRAIN_LOSS_RTOL of the one card's.
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
import gc
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
    "group_norm_moments": ("gmdx_torch/csrc/groupnorm.cu", "gmdx/kernels/groupnorm.py:561"),
    "group_norm_apply": ("gmdx_torch/csrc/groupnorm.cu", "gmdx/kernels/groupnorm.py:578"),
    "group_norm_bwd_sums": ("gmdx_torch/csrc/groupnorm.cu", "gmdx/kernels/groupnorm.py:291"),
    "group_norm_bwd_apply": ("gmdx_torch/csrc/groupnorm.cu", "gmdx/kernels/groupnorm.py:315"),
}
# The kernels of each path: the phase whose run must launch them all.
INFERENCE_KERNELS = ("attention_kv_resident", "conv3x3", "group_norm_silu", "geglu_ff_ln")
TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_bwd", "group_norm_silu_bwd",
                 "group_norm_silu", "geglu_ff_ln", "conv3x3")
HDRTV_KERNELS = ("flash_attention_bsc", "flash_attention_fwd_d512", "attention_kv_resident",
                 "conv3x3", "group_norm_silu", "geglu_ff_ln")
STAGE1_KERNELS = ("flash_attention_bwd_d512", "flash_attention_fwd_d512", "group_norm_silu_bwd",
                  "group_norm_silu", "conv3x3")
# The split GroupNorm's entries: launched by spatial parallelism (phase
# parallel's SP runs) in place of group_norm_silu.
PARALLEL_KERNELS = ("group_norm_moments", "group_norm_apply")
# The split GroupNorm backward's entries: launched by Stage 2 under spatial
# parallelism (phase train_parallel's SP run) in place of group_norm_silu_bwd.
TRAIN_PARALLEL_KERNELS = ("group_norm_bwd_sums", "group_norm_bwd_apply")
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
    _parallel_kernel_rows(gen, batch, results)
    _train_parallel_kernel_rows(gen, DIST_BATCH, results)
    return results


def _parallel_kernel_rows(gen, batch: int, results: list[dict]) -> None:
    """I. The shapes tensor and spatial parallelism give the kernels over
    two ranks: the split GroupNorm's entries (a rank's half of the rows of
    the UNet's 64^2 x 320 image at the CFG batch, temb and padded output;
    of the 1024^2 frame's VAE at 1024^2 x 128); the attention kernels at a
    rank's queries against the whole image's keys (KV-resident 2048 of 4096
    at 512^2, bsc 8192 of 16384 and the 512-wide forward at 1024^2) and at
    a rank's half of the heads (KV-resident, 4 heads of 40)."""
    import torch
    import torch.nn.functional as F

    from gmdx_torch.kernels.attention import attention_kv_resident, attention_kv_resident_plain
    from gmdx_torch.kernels.flash_attention import (
        flash_attention_bsc, flash_attention_bsc_plain, flash_attention_fwd,
        flash_attention_fwd_plain,
    )
    from gmdx_torch.kernels.groupnorm import (
        group_norm_apply, group_norm_apply_plain, group_norm_moments, group_norm_moments_plain,
        group_norm_silu_plain,
    )

    cfg_b = 2 * batch
    for bb, h, w, c, temb_on in ((cfg_b, 32, 64, 320, True), (2, HDRTV_SIDE // 2, HDRTV_SIDE,
                                                               128, False)):
        x = (_randn(gen, bb, h, w, c, scale=2.0).float() + 0.5).to(torch.bfloat16)
        g = (_randn(gen, c, scale=0.2).float() + 1.0).to(torch.bfloat16)
        be = _randn(gen, c, scale=0.2)
        t = _randn(gen, bb, c) if temb_on else None
        xf, tf = x.float(), t.float() if temb_on else None
        x4 = x.view(bb, h * w, 32, c // 32)
        shape = [bb, h, w, c] + (["temb"] if temb_on else [])
        # The moments: x read once, (B, G, 2) written; ~3 operations an
        # element. The mean and M2 columns are held apart: M2 is ~1e5 times
        # the mean, and would hide it in one norm.
        _check("group_norm_moments", shape, lambda: group_norm_moments(x, t).unbind(-1),
               lambda: group_norm_moments_plain(xf, tf).unbind(-1),
               None if temb_on else (lambda: torch.var_mean(x4, dim=(1, 3))),
               3.0 * x.numel(), x.numel() * 2 + bb * 32 * 2 * 4, results, peak=FP32_FLOPS,
               library=None if temb_on else "torch.var_mean")
        _, stats = group_norm_silu_plain(xf, g.float(), be.float(), tf, return_stats=True)
        # The apply: x read once, the padded rows written; no one PyTorch call
        # normalises with given statistics.
        _check("group_norm_apply", shape + ["silu", "pad"],
               lambda: group_norm_apply(x, g, be, t, stats, pad_output=True),
               lambda: group_norm_apply_plain(xf, g.float(), be.float(), tf, stats,
                                              pad_output=True),
               None, 10.0 * x.numel(),
               (x.numel() + bb * (h + 2) * (w + 2) * c + 2 * c) * 2 + stats.numel() * 4,
               results, peak=FP32_FLOPS)
        del x, xf, x4

    for name, b, sq, sk, heads, d in (
        ("attention_kv_resident", cfg_b, 2048, 4096, 8, 40),
        ("attention_kv_resident", cfg_b, 4096, 4096, 4, 40),
        ("flash_attention_bsc", 2, 8192, 16384, 8, 40),
        ("flash_attention_fwd_d512", 1, 8192, 16384, 1, 512),
    ):
        c = heads * d
        q = _randn(gen, b, sq, c)
        k, v = _randn(gen, b, sk, c), _randn(gen, b, sk, c)
        qf, kf, vf = (t.float() for t in (q, k, v))
        qh = q.view(b, sq, heads, d).transpose(1, 2)
        kh, vh = (t.view(b, sk, heads, d).transpose(1, 2) for t in (k, v))
        kern, plain = {
            "attention_kv_resident": (lambda: attention_kv_resident(q, k, v, heads),
                                      lambda: attention_kv_resident_plain(qf, kf, vf, heads)),
            "flash_attention_bsc": (lambda: flash_attention_bsc(q, k, v, heads),
                                    lambda: flash_attention_bsc_plain(qf, kf, vf, heads)),
            "flash_attention_fwd_d512": (
                lambda: flash_attention_fwd(q, k, v, heads)[0],
                lambda: flash_attention_fwd_plain(qf, kf, vf, heads, d**-0.5)[0]),
        }[name]
        if d == 512:
            backend, lib = _sdpa_backend(qh, kh, vh)
        else:
            backend = "default"
            lib = lambda: F.scaled_dot_product_attention(qh, kh, vh)  # noqa: E731
        _check(name, [b, sq, sk, heads, d], kern, plain, lib, 4.0 * b * heads * sq * sk * d,
               (2 * b * sq * c + 2 * b * sk * c) * 2, results,
               library=f"F.scaled_dot_product_attention ({backend} backend)",
               extra=exp2_keys((2 if d == 512 else 1) * b * heads * sq * sk))
        del q, k, v, qf, kf, vf, qh, kh, vh


def _train_parallel_kernel_rows(gen, tb: int, results: list[dict]) -> None:
    """J. The split GroupNorm backward at the shapes spatial parallelism over
    two ranks gives Stage 2 at 512^2 (phase train_parallel's global batch
    ``tb``): a rank's half of the
    64^2 x 320 image of a resnet's norm2 (temb, SiLU, the padded cotangent)
    and of the 32^2 x 640 image of a transformer's GroupNorm (neither). The
    statistics are the whole image's; the sums entry's outputs (each group
    sum column, dgamma, dbeta) and the apply entry's (dx, dtemb) are held
    apart. No PyTorch call computes either from given statistics."""
    import torch

    from gmdx_torch.kernels.groupnorm import (
        group_norm_bwd_apply, group_norm_bwd_apply_plain, group_norm_bwd_sums,
        group_norm_bwd_sums_plain, group_norm_silu_plain,
    )

    for hw, c, temb_on, act, pad in ((64, 320, True, True, True), (32, 640, False, False, False)):
        h = hw // 2
        x = (_randn(gen, tb, h, hw, c, scale=2.0).float() + 0.5).to(torch.bfloat16)
        gam = (_randn(gen, c, scale=0.2).float() + 1.0).to(torch.bfloat16)
        bet = _randn(gen, c, scale=0.2)
        t = _randn(gen, tb, c) if temb_on else None
        cot = _randn(gen, tb, h + 2 * pad, hw + 2 * pad, c)
        f32 = [u.float() if u is not None else None for u in (x, gam, bet, t)]
        # The whole image's statistics: this half's rows twice over.
        _, stats = group_norm_silu_plain(torch.cat([f32[0]] * 2, 1), *f32[1:], activate=act,
                                         return_stats=True)
        kw = dict(activate=act, pad_output=pad)
        n = tb * h * hw * c
        shape = [tb, h, hw, c] + (["temb"] if temb_on else []) + (["silu"] if act else []) \
            + (["pad"] if pad else [])
        small = tb * 2 * 32 * 4 + 2 * c * 2 + (tb * c * 2 if temb_on else 0)  # stats, affine, temb

        def sums_kernel():
            s, ds, db = group_norm_bwd_sums(x, gam, bet, t, stats, cot, **kw)
            return s[:, 0], s[:, 1], ds, db

        def sums_plain():
            s, ds, db = group_norm_bwd_sums_plain(*f32, stats, cot.float(), **kw)
            return s[:, 0], s[:, 1], ds, db

        # x and the cotangent read, (B, 2, G) sums and (2, C) partials
        # written; the SiLU derivative and the products, ~20 operations an
        # element.
        _check("group_norm_bwd_sums", shape, sums_kernel, sums_plain, None, 20.0 * n,
               (n + tb * (h + 2 * pad) * (hw + 2 * pad) * c) * 2 + small
               + (tb * 2 * 32 + 2 * c) * 4, results, peak=FP32_FLOPS)
        sums = group_norm_bwd_sums_plain(*f32, stats, cot.float(), **kw)[0] * 2
        # x and the cotangent read, dx written (bf16), dtemb (fp32); ~25
        # operations an element.
        _check("group_norm_bwd_apply", shape,
               lambda: group_norm_bwd_apply(x, gam, bet, t, stats, cot, sums, 2 * h * hw, **kw),
               lambda: group_norm_bwd_apply_plain(*f32, stats, cot.float(), sums, 2 * h * hw,
                                                  **kw),
               None, 25.0 * n,
               (2 * n + tb * (h + 2 * pad) * (hw + 2 * pad) * c) * 2 + small
               + tb * 2 * 32 * 4 + (tb * c * 4 if temb_on else 0), results, peak=FP32_FLOPS)
        del x, cot


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


def build_gm_unet(seed: int, remat: bool = False):
    """The full-width 8-channel GM UNet as Stage 2 starts it: a seeded random
    SD-1.5 UNet's weights with conv_in inflated (tile x2, scale 0.5); fp32
    master weights, bf16 compute; ``remat`` recomputes its blocks in the
    backward pass (--gradient_checkpointing)."""
    import dataclasses

    import torch

    from gmdx_torch.models import (
        SD15_GM_UNET_CONFIG, SD15_UNET_CONFIG, UNet2DConditionModel, inflate_conv_in,
    )

    torch.manual_seed(seed)
    with torch.device("cuda"):
        sd = inflate_conv_in(UNet2DConditionModel(SD15_UNET_CONFIG).state_dict(), 8)
        unet = UNet2DConditionModel(dataclasses.replace(SD15_GM_UNET_CONFIG, remat=remat),
                                    dtype=torch.bfloat16)
    unet.load_state_dict(sd, strict=True)
    return unet.train() if remat else unet


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
        if i == 1 + args.train_steps:
            before = launch_counts()  # the last cached step's own launches, for phase dist
        t1 = time.perf_counter()
        state, metrics = step(state, pixel if i == 0 else cached, gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
        losses.append(float(metrics["loss"]))
    counts = launch_counts()
    args.train_step_launches = {k: counts[k] - before[k] for k in TRAIN_KERNELS}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    s_step = statistics.median(times[2:])
    args.train_samples_per_s = b / s_step  # beside phase train_cli's cached steps
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


def phase_stage1(args) -> tuple[dict[str, int], dict[str, float]]:
    """Gen + disc step pairs at 512^2 (batch --stage1-batch, one warm-up and
    --stage1-steps timed pairs), then one pair at 1024^2, batch 1, the
    shape that takes the 512-wide flash forward and backward. Returns the
    launches over the phase and those a pair at 512^2."""
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
    pairs_512 = runs[512]["timed_pairs"] + 1
    return counts, {k: v / pairs_512 for k, v in runs[512]["launches"].items()}


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


def phase_cli(args, workdir: str | None = None) -> str:
    """The port's CLIs on a full-width directory: scripts/torch/init_pipeline.py
    --size sd15 --dual --scheduler dpm++ writes one (7.70 GB, float32), then
    generate_hdr on a 512^2 and a 640x480 PNG (resized) at 4 steps and
    upconvert_hdrtv on one 1024^2 PNG at 2 steps read it; every PNG and
    .hdr they write is read back, and the up-conversion's launches are
    checked as phase hdrtv's. The directory is written under ``workdir``
    and left there for phase train_cli (its path is returned), or, without
    ``workdir``, under a temporary directory removed at the end."""
    import shutil

    import numpy as np
    import torch

    import gmdx_torch.io as gio
    from gmdx_torch.io import read_hdr
    from gmdx_torch.io.png import read_png, write_png
    from gmdx_torch.kernels import launch_counts, reset_launch_counts

    tmp = workdir or tempfile.mkdtemp(prefix="gmdx_cli_")
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
        shutil.rmtree(out, ignore_errors=True)
    finally:
        if workdir is None:
            shutil.rmtree(tmp, ignore_errors=True)
    return pipe_dir


TRAIN_CLI_PAIRS = 24
TRAIN_CLI_BATCH = 8
# Resume: C's step-20 window loss against B's; remat: the gradient norm.
TRAIN_CLI_LOSS_RTOL = 1e-3
TRAIN_CLI_REMAT_RTOL = 1e-3
RESUME_KERNELS = ("flash_attention_fwd", "flash_attention_bwd", "group_norm_silu_bwd")


def _train_cli_data(root: str, seed: int) -> tuple[str, str]:
    """24 pairs of 600x800 SDR PNGs on disk and gain-map PNG bytes with
    captions, in one parquet written by the port; one 512^2 validation
    PNG. Returns (parquet, validation directory)."""
    import numpy as np

    from gmdx_torch.data import write_parquet_dataset
    from gmdx_torch.io.png import encode_png, write_png

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:600, 0:800]
    os.makedirs(os.path.join(root, "sdr"))
    os.makedirs(os.path.join(root, "val"))
    paths, gms, texts = [], [], []
    for i in range(TRAIN_CLI_PAIRS):
        base = np.stack([np.sin(x / (13 + 3 * c + i) + y / (19 + i)) for c in range(3)], -1)
        sdr = np.clip(base * 90 + 128 + rng.integers(-4, 4, (600, 800, 3)), 0, 255)
        paths.append(os.path.join(root, "sdr", f"{i}.png"))
        write_png(paths[-1], sdr.astype(np.uint8))
        gm = np.clip(np.abs(base) * 200 + rng.integers(0, 8, (600, 800, 3)), 0, 255)
        gms.append(encode_png(gm.astype(np.uint8)))
        texts.append(f"a high dynamic range photograph, scene {i}")
    write_png(os.path.join(root, "val", "v0.png"),
              rng.integers(0, 256, (512, 512, 3)).astype(np.uint8))
    meta = os.path.join(root, "train.parquet")
    write_parquet_dataset(meta, paths, gms, texts)
    return meta, os.path.join(root, "val")


def _dir_gb(path: str) -> float:
    return sum(os.path.getsize(os.path.join(r, f)) for r, _, fs in os.walk(path) for f in fs) / 1e9


def phase_train_cli(args, pipe_dir: str, train_launches: dict[str, int]) -> None:
    """The Stage-2 trainer CLI (scripts/torch/train_gm_unet.py) at full
    SD-1.5 width on phase cli's sd15 directory, whose 4-channel unet takes
    the 4->8 conv_in inflation. 24 pairs of 600x800 PNGs (resized by the
    port's BILINEAR) in a parquet written by the port.
      A: the parquet path, batch 8, 512^2, --random_flip --use_ema,
         6 steps, checkpoints at 3 and 6 (asynchronous), one validation
         image each epoch (3 steps): losses finite, checkpoint_3 and
         checkpoint_6 written, the saved unet 8-channel and equal to the
         EMA shadow bit for bit, the validation GM PNG and .hdr finite at
         512^2; the loader's s/batch alone, s/step, checkpoint s and GB,
         validation and save_pipeline s, peak memory.
      B / C: the cached path (precompute_latents.py's npz, --center_crop),
         batch 8: B 20 steps; C 10 steps with a checkpoint, then
         --resume_from_checkpoint latest to 20. C restores the bits it saved
         (parameters, moments, count, EMA, global step: the digests), B's
         launches a step of the training kernels equal phase train's, and
         C's step-20 window loss is within TRAIN_CLI_LOSS_RTOL of B's.
      remat: one cached step with --gradient_checkpointing's UNet and one
         without, same batch and generator: the same loss, gradient norms
         within TRAIN_CLI_REMAT_RTOL; peak memory of each and of a remat
         step at batch 16 (reported)."""
    import shutil

    import numpy as np
    import torch

    import gmdx_torch.io as gio
    import gmdx_torch.train as gtrain
    from gmdx_torch.data import ParquetImageDataset, make_dataloader
    from gmdx_torch.io import read_hdr
    from gmdx_torch.io.convert import unet_state_dict_from_flax
    from gmdx_torch.io.params import load_params
    from gmdx_torch.io.png import read_png
    from gmdx_torch.kernels import launch_counts, reset_launch_counts
    from gmdx_torch.models import CLIPTokenizer
    from gmdx_torch.train.checkpoint import state_tensors, tensor_digest

    root = os.path.join(os.path.dirname(pipe_dir), "train_cli")
    os.makedirs(root)
    t_phase = t0 = time.perf_counter()
    meta, val_dir = _train_cli_data(root, args.seed + 70)
    data_s = time.perf_counter() - t0
    tok = CLIPTokenizer.from_pretrained(os.path.join(pipe_dir, "tokenizer"))
    loader = make_dataloader(ParquetImageDataset(meta), tok, batch_size=TRAIN_CLI_BATCH,
                             resolution=512, random_flip=True, seed=args.seed, num_epochs=1)
    t0 = time.perf_counter()
    n_batches = sum(1 for _ in loader)
    loader_s_batch = (time.perf_counter() - t0) / n_batches

    trainer = _script("train_gm_unet")
    spans: dict[str, list] = {}
    step_losses: list[float] = []
    originals = (gtrain.make_train_step, gtrain.save_state, gio.save_pipeline,
                 trainer.log_validation, gtrain.restore_state, trainer.load_training_unet)

    def timed(name, fn):
        return _traced(spans, name, fn)

    def make_step(*a, **kw):
        step = timed("step", originals[0](*a, **kw))

        def run(state, batch, gen):
            state, m = step(state, batch, gen)
            step_losses.append(float(m["loss"]))
            return state, m
        return run

    def run_cli(argv):
        spans.clear()
        step_losses.clear()
        gtrain.make_train_step, gtrain.save_state = make_step, timed("checkpoint", originals[1])
        gio.save_pipeline = timed("save_pipeline", originals[2])
        trainer.log_validation = timed("validation", originals[3])
        gtrain.restore_state = timed("restore", originals[4])
        trainer.load_training_unet = timed("unet_load", originals[5])
        try:
            t = time.perf_counter()
            res = trainer.main(["--pretrained_model_name_or_path", pipe_dir, "--train_metadata",
                                meta, "--resolution", "512", "--train_batch_size",
                                str(TRAIN_CLI_BATCH), "--seed", str(args.seed),
                                "--report_to", "tensorboard"] + argv)
            torch.cuda.synchronize()
            res["wall_s"] = time.perf_counter() - t
        finally:
            (gtrain.make_train_step, gtrain.save_state, gio.save_pipeline,
             trainer.log_validation, gtrain.restore_state,
             trainer.load_training_unet) = originals
        res["spans"], res["step_losses"] = dict(spans), list(step_losses)
        return res

    try:
        # A: the parquet path.
        out_a = os.path.join(root, "a")
        torch.cuda.reset_peak_memory_stats()
        a = run_cli(["--output_dir", out_a, "--mixed_precision", "no", "--random_flip",
                     "--use_ema", "--max_train_steps", "6", "--checkpointing_steps", "3",
                     "--async_checkpointing", "--validation_image_dir", val_dir,
                     "--validation_epochs", "1"])
        peak_a = torch.cuda.max_memory_allocated() / 1e9
        step_s = a["spans"]["step"][1:]
        ckpt_gb = _dir_gb(os.path.join(out_a, "checkpoint_3"))
        saved = os.path.join(out_a, "save_pipeline", "unet")
        with open(os.path.join(saved, "config.json")) as f:
            in_channels = json.load(f)["in_channels"]
        sd = unet_state_dict_from_flax(load_params(os.path.join(saved, "params.safetensors")))
        names = [n for n, p in a["state"].unet.named_parameters() if p.requires_grad]
        not_shadow = [n for n, s in zip(names, a["state"].ema.shadow)
                      if not torch.equal(torch.as_tensor(sd[n]), s.cpu())]
        val_files = {}
        for name in ("gm_step6_0.png", "hdr_step6_0.hdr"):
            path = os.path.join(out_a, "validation", name)
            arr = read_hdr(path) if name.endswith(".hdr") else read_png(path)
            val_files[name] = (list(arr.shape), bool(np.isfinite(arr).all()))
        ckpts = sorted(n for n in os.listdir(out_a) if n.startswith("checkpoint"))
        emit({"phase": "train_cli", "run": "A", "elapsed_s": time.perf_counter() - t_phase,
              "pairs": TRAIN_CLI_PAIRS, "data_s": data_s,
              "loader_s_per_batch": loader_s_batch, "wall_s": a["wall_s"],
              "step_s": a["spans"]["step"], "s_per_step_2_6": float(np.mean(step_s)),
              "samples_per_s": TRAIN_CLI_BATCH / float(np.mean(step_s)),
              "unet_load_s": a["spans"]["unet_load"],
              "checkpoint_call_s": a["spans"]["checkpoint"], "checkpoint_gb": ckpt_gb,
              "validation_s": a["spans"]["validation"],
              "save_pipeline_s": a["spans"]["save_pipeline"], "peak_mem_gb": peak_a,
              "losses": a["step_losses"], "checkpoints": ckpts, "unet_in_channels": in_channels,
              "unet_not_ema": len(not_shadow), "validation_files": val_files})
        want_val = {k: ([512, 512, 3], True) for k in val_files}
        if (not all(math.isfinite(v) for v in a["step_losses"]) or len(a["step_losses"]) != 6
                or ckpts != ["checkpoint_3", "checkpoint_6"] or in_channels != 8 or not_shadow
                or val_files != want_val):
            raise SystemExit(f"chip_smoke: train_cli run A failed its checks: losses "
                             f"{a['step_losses']}, checkpoints {ckpts}, in_channels "
                             f"{in_channels}, {len(not_shadow)} tensors not the EMA shadow, "
                             f"validation {val_files}")
        del a, sd
        shutil.rmtree(out_a, ignore_errors=True)
        torch.cuda.empty_cache()

        # The latent cache, then B and C on it.
        npz = os.path.join(root, "latents.npz")
        t = time.perf_counter()
        built = _script("precompute_latents").main([
            "--train_metadata", meta, "--pretrained_model_name_or_path", pipe_dir,
            "--resolution", "512", "--out", npz, "--batch", str(TRAIN_CLI_BATCH)])
        cache_s = time.perf_counter() - t
        torch.cuda.empty_cache()
        cached = ["--latent_cache_path", npz, "--center_crop", "--use_ema"]
        reset_launch_counts()
        b = run_cli(cached + ["--output_dir", os.path.join(root, "b"), "--max_train_steps", "20",
                              "--checkpointing_steps", "100"])
        per_step = {k: launch_counts()[k] / 20 for k in RESUME_KERNELS}
        want_per_step = {k: train_launches[k] / (2 + args.train_steps) for k in RESUME_KERNELS}
        b_loss, b_digest = b["losses"][20], tensor_digest(state_tensors(b["state"])[0])
        b_step_s = float(np.median(b["spans"]["step"][1:]))
        b_wall_s = b["wall_s"]
        del b
        torch.cuda.empty_cache()
        out_c = os.path.join(root, "c")
        c1 = run_cli(cached + ["--output_dir", out_c, "--max_train_steps", "10",
                               "--checkpointing_steps", "10"])
        c1_saved = c1["saved_digests"].get(10)
        c1_ckpt_s, c1_wall_s = c1["spans"]["checkpoint"], c1["wall_s"]
        del c1
        torch.cuda.empty_cache()
        c2 = run_cli(cached + ["--output_dir", out_c, "--max_train_steps", "20",
                               "--checkpointing_steps", "100", "--resume_from_checkpoint",
                               "latest"])
        c_loss, c_restore_s = c2["losses"].get(20), c2["spans"].get("restore")
        rel = abs(c_loss - b_loss) / abs(b_loss) if c_loss is not None else math.inf
        c2_digest = tensor_digest(state_tensors(c2["state"])[0])
        emit({"phase": "train_cli", "run": "B/C", "elapsed_s": time.perf_counter() - t_phase,
              "c1_wall_s": c1_wall_s, "cache_build_s": cache_s,
              "cache_s_per_sample": cache_s / built["samples"], "cache_mb": built["mb"],
              "b_wall_s": b_wall_s, "b_s_per_step": b_step_s,
              "b_samples_per_s": TRAIN_CLI_BATCH / b_step_s,
              "train_phase_samples_per_s": args.train_samples_per_s,
              "train_phase_batch": args.train_batch, "c_resume_wall_s": c2["wall_s"],
              "c_checkpoint_call_s": c1_ckpt_s, "c_restore_s": c_restore_s,
              "restored_equals_saved":
              c2["restored_digest"] == c1_saved, "resumed_from": c2["start_step"],
              "b_loss_20": b_loss, "c_loss_20": c_loss, "loss_rel_diff": rel,
              "final_state_bit_identical": c2_digest == b_digest,
              "launches_per_step": per_step, "train_phase_per_step": want_per_step})
        if not (c1_saved is not None and c2["restored_digest"] == c1_saved
                and c2["start_step"] == 10 and c2["global_step"] == 20):
            raise SystemExit(f"chip_smoke: train_cli resume did not restore the saved state: "
                             f"saved {c1_saved}, restored {c2['restored_digest']}, from step "
                             f"{c2['start_step']}")
        if per_step != want_per_step:
            raise SystemExit(f"chip_smoke: train_cli launches a step {per_step}, phase train's "
                             f"{want_per_step}")
        if not rel <= TRAIN_CLI_LOSS_RTOL:
            raise SystemExit(f"chip_smoke: train_cli resumed step-20 loss {c_loss} against "
                             f"{b_loss} (rel {rel})")
        del c2
        torch.cuda.empty_cache()
        phase_train_cli_remat(args, pipe_dir, npz, trainer)
        emit({"phase": "train_cli", "elapsed_s": time.perf_counter() - t_phase})
    finally:
        (gtrain.make_train_step, gtrain.save_state, gio.save_pipeline,
         trainer.log_validation, gtrain.restore_state, trainer.load_training_unet) = originals
        shutil.rmtree(root, ignore_errors=True)


def phase_train_cli_remat(args, pipe_dir: str, npz: str, trainer) -> None:
    """One cached step of the trainer's UNet with and without
    --gradient_checkpointing (train_gm_unet.load_training_unet), same batch
    and generator seed: loss and gradient norm, peak memory over the step
    and up to the optimizer update (forward and backward alone), and the
    forward launches; then a remat step at batch 16 (memory reported)."""
    import numpy as np
    import torch

    from gmdx_torch.io import load_pipeline
    from gmdx_torch.kernels import launch_counts, reset_launch_counts
    from gmdx_torch.train import Stage2Config, init_state, make_train_step

    dev = torch.device("cuda")
    bundle = load_pipeline(pipe_dir, device=dev, components=("vae", "text_encoder"))
    with np.load(npz) as z:
        cache = {k: z[k] for k in z.files if not k.startswith("__")}

    def batch(n):
        idx = np.arange(n) % len(cache["input_ids"])
        return {k: torch.from_numpy(v[idx]).to(dev) for k, v in cache.items()}

    rows, unet = {}, None
    for name, remat, n in (("plain", False, 8), ("remat", True, 8), ("remat_b16", True, 16)):
        if unet is None or unet.remat != remat:  # batch 16 reuses the remat UNet
            unet = None
            unet = trainer.load_training_unet(pipe_dir, dev, remat)
        config = Stage2Config(learning_rate=1e-5)
        step = make_train_step(config, unet=unet, vae=bundle["modules"]["vae"],
                               text_encoder=bundle["modules"]["text_encoder"], device=dev)
        state = init_state(config, unet)
        data = batch(n)
        update = state.optimizer.step
        peaks = {}

        def update_after_peak(*a, **kw):
            peaks["fwd_bwd"] = torch.cuda.max_memory_allocated() / 1e9
            return update(*a, **kw)

        state.optimizer.step = update_after_peak
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        gen = torch.Generator(device=dev).manual_seed(args.seed + 80)
        t = time.perf_counter()
        state, m = step(state, data, gen)
        torch.cuda.synchronize()
        rows[name] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                      "step_s": time.perf_counter() - t,
                      "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                      "fwd_bwd_peak_gb": peaks["fwd_bwd"],
                      "launches": {k: v for k, v in launch_counts().items() if v}}
        del step, state, data, m
        torch.cuda.empty_cache()
    rel = abs(rows["remat"]["grad_norm"] - rows["plain"]["grad_norm"]) / rows["plain"]["grad_norm"]
    emit({"phase": "train_cli", "run": "remat", **{k: v for k, v in rows.items()},
          "grad_norm_rel_diff": rel})
    if rows["remat"]["loss"] != rows["plain"]["loss"] or not rel <= TRAIN_CLI_REMAT_RTOL:
        raise SystemExit(f"chip_smoke: remat step {rows['remat']} against plain "
                         f"{rows['plain']} (grad norm rel {rel})")


# ---------------------------------------------------------------------------
# phases 21 + 22: the Stage-1 and ControlNet trainer CLIs
# ---------------------------------------------------------------------------

TRAINER_CLI_BATCH = 4
# Launches a ControlNet step at SD-1.5 width, by the route rule: the frozen
# UNet's down blocks see no tensor that needs a gradient (2 self-attentions
# at each of the 4096-, 1024- and 256-token levels: the KV-resident kernel);
# its up blocks (3 a level) and the ControlNet's down blocks (2 a level) do
# (the flash forward, then as many flash backwards); both mid blocks' 64
# tokens take the plain path.
CONTROLNET_STEP_ATTENTION = {"attention_kv_resident": 6, "flash_attention_fwd": 15,
                             "flash_attention_bwd": 15}
# The rest of the ControlNet step's kernels: the no-grad convs (VAE encode,
# the UNet's down and mid blocks), both GroupNorm directions, the LN-fused
# FF; every other kernel of the table stays off its path.
CONTROLNET_STEP_KERNELS = ("conv3x3", "group_norm_silu", "group_norm_silu_bwd", "geglu_ff_ln")


def _traced(spans: dict, name: str, fn, calls: list | None = None):
    """``fn`` timed between synchronisations into ``spans[name]``; with
    ``calls``, each call's launches are appended there too."""
    import torch

    from gmdx_torch.kernels import launch_counts

    def run(*a, **kw):
        torch.cuda.synchronize()
        before, t = launch_counts(), time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        spans.setdefault(name, []).append(time.perf_counter() - t)
        if calls is not None:
            after = launch_counts()
            calls.append({k: after[k] - before[k] for k in after if after[k] != before[k]})
        return out
    return run


def _loader_s_per_batch(meta: str, pipe_dir: str, seed: int) -> float:
    """The loader alone at 512^2, batch TRAINER_CLI_BATCH, one epoch."""
    from gmdx_torch.data import ParquetImageDataset, make_dataloader
    from gmdx_torch.models import CLIPTokenizer

    tok = CLIPTokenizer.from_pretrained(os.path.join(pipe_dir, "tokenizer"))
    loader = make_dataloader(ParquetImageDataset(meta), tok, batch_size=TRAINER_CLI_BATCH,
                             resolution=512, random_flip=True, seed=seed, num_epochs=1)
    t0 = time.perf_counter()
    n = sum(1 for _ in loader)
    return (time.perf_counter() - t0) / n


def phase_stage1_cli(args, pipe_dir: str, meta: str, val_dir: str, loader_s: float,
                     per_pair_512: dict[str, float]) -> None:
    """The Stage-1 trainer CLI (scripts/torch/train_vqgan_lora.py) at full
    SD-1.5 VAE width on phase cli's directory (LoRA r = 64 + conv_out, the
    Paella discriminator and VGG19 at random), 512^2, batch 4,
    --clip_pixel --use_ema, on trainers' 24 pairs.
      A: 4 updates (two gen + disc pairs), checkpoints at 2 and 4, one
         validation PNG at 4, --debug_mode: losses finite; both
         checkpoints; finetuned_VAE/vae read back at full width equal to
         the EMA-merged VAE bit for bit; discriminator/ read back (depth 6,
         hidden 512) equal to the run's; the validation grid and .hdr and
         the debug strip finite at their sizes.
      C: 2 updates, then --resume_from_checkpoint latest to 4: the restored
         digest equals the saved one; C's step-4 loss within
         TRAIN_CLI_LOSS_RTOL of A's; the resumed pair's launches equal phase
         stage1's a pair at 512^2.
      ga: 2 updates with --gradient_accumulation_steps 2: the cadence gen,
         gen, discr, discr; losses finite.
    Reports s/pair, pairs/s, the loader alone, checkpoint call and restore
    s, the checkpoint's GB, peak memory."""
    import shutil

    import numpy as np
    import torch

    import gmdx_torch.train as gtrain
    import gmdx_torch.train.stage1 as gstage1
    from gmdx_torch.io import load_component, read_hdr
    from gmdx_torch.io.png import read_png
    from gmdx_torch.kernels import launch_counts, reset_launch_counts
    from gmdx_torch.models import LoRAConfig

    t_phase = time.perf_counter()
    root = os.path.dirname(meta)
    trainer = _script("train_vqgan_lora")
    spans: dict[str, list] = {}
    originals = (gstage1.make_gen_step, gstage1.make_disc_step, gtrain.save_state,
                 gtrain.restore_state)

    def run_cli(out, argv):
        spans.clear()
        gstage1.make_gen_step = lambda *a, **kw: _traced(spans, "gen", originals[0](*a, **kw))
        gstage1.make_disc_step = lambda *a, **kw: _traced(spans, "disc", originals[1](*a, **kw))
        gtrain.save_state = _traced(spans, "checkpoint", originals[2])
        gtrain.restore_state = _traced(spans, "restore", originals[3])
        try:
            t = time.perf_counter()
            res = trainer.main(["--pretrained_model_name_or_path", pipe_dir, "--train_metadata",
                                meta, "--output_dir", out, "--resolution", "512",
                                "--train_batch_size", str(TRAINER_CLI_BATCH), "--seed",
                                str(args.seed), "--clip_pixel", "--use_ema", "--log_steps", "1",
                                "--report_to", "tensorboard"] + argv)
            torch.cuda.synchronize()
            res["wall_s"] = time.perf_counter() - t
        finally:
            (gstage1.make_gen_step, gstage1.make_disc_step, gtrain.save_state,
             gtrain.restore_state) = originals
        res["spans"] = {k: list(v) for k, v in spans.items()}
        return res

    # A
    out_a = os.path.join(root, "s1_a")
    torch.cuda.reset_peak_memory_stats()
    a = run_cli(out_a, ["--max_train_steps", "4", "--checkpointing_steps", "2",
                        "--val_images_dir", val_dir, "--validation_steps", "4",
                        "--debug_mode"])
    peak_a = torch.cuda.max_memory_allocated() / 1e9
    pair_s = [g + d for g, d in zip(a["spans"]["gen"], a["spans"]["disc"])]
    losses_a = {s: a["losses"][s] for s in sorted(a["losses"])}
    ckpts = sorted(n for n in os.listdir(out_a) if n.startswith("checkpoint"))
    ckpt_gb = _dir_gb(os.path.join(out_a, "checkpoint_2"))
    state = a["state"]
    with torch.no_grad():  # the CLI's LoRA: r = 64, alpha = 64
        cfg = gstage1.Stage1Config(lora=LoRAConfig(rank=64, alpha=64.0))
        want = gstage1.effective_vae_params(
            cfg, trainer.load_training_vae(pipe_dir, torch.device("cuda"), False),
            gstage1.trainables_like(state.trainables, state.ema.shadow))
    saved_vae = load_component(os.path.join(out_a, "finetuned_VAE", "vae"), dtype=torch.float32)
    not_ema = [k for k, v in saved_vae.state_dict().items()
               if not torch.equal(v, want[k].detach().float())]
    vae_width = list(saved_vae.config.block_out_channels)
    disc = load_component(os.path.join(out_a, "discriminator"))
    disc_ok = (disc.depth, disc.hidden_channels) == (6, 512) and all(
        torch.equal(v, state.discriminator.state_dict()[k]) for k, v in disc.state_dict().items())
    files = {}
    for rel, shape in ((os.path.join("validation", "grid_step4_0.png"), [512, 1536, 3]),
                       (os.path.join("validation", "hdr_step4_0.hdr"), [512, 512, 3]),
                       (os.path.join("debug_train", "step_0_concat_image.png"),
                        [4 * 512, 5 * 512, 3])):
        arr = read_hdr(os.path.join(out_a, rel)) if rel.endswith(".hdr") else read_png(
            os.path.join(out_a, rel))
        files[rel] = (list(arr.shape) == shape and bool(np.isfinite(arr).all()), list(arr.shape))
    emit({"phase": "stage1_cli", "run": "A", "wall_s": a["wall_s"], "batch": TRAINER_CLI_BATCH,
          "gen_s": a["spans"]["gen"], "disc_s": a["spans"]["disc"], "pair_s": pair_s,
          "s_per_pair": pair_s[-1], "pairs_per_s": 1.0 / pair_s[-1],
          "loader_s_per_batch": loader_s, "checkpoint_call_s": a["spans"]["checkpoint"],
          "checkpoint_gb": ckpt_gb, "peak_mem_gb": peak_a, "losses": losses_a,
          "checkpoints": ckpts, "vae_width": vae_width, "vae_not_ema": len(not_ema),
          "discriminator_ok": disc_ok, "files": files})
    finite = all(math.isfinite(v) for row in a["metrics"] for v in row.values())
    if not (finite and len(losses_a) == 4 and ckpts == ["checkpoint_2", "checkpoint_4"]
            and vae_width == [128, 256, 512, 512] and not not_ema and disc_ok
            and all(ok for ok, _ in files.values())):
        raise SystemExit(f"chip_smoke: stage1_cli run A failed its checks: finite {finite}, "
                         f"losses {losses_a}, checkpoints {ckpts}, VAE {vae_width} with "
                         f"{len(not_ema)} tensors not the EMA merge, discriminator {disc_ok}, "
                         f"files {files}")
    del a, state, saved_vae, disc, want
    shutil.rmtree(out_a, ignore_errors=True)
    torch.cuda.empty_cache()

    # C
    out_c = os.path.join(root, "s1_c")
    c1 = run_cli(out_c, ["--max_train_steps", "2", "--checkpointing_steps", "2"])
    saved = c1["saved_digests"].get(2)
    del c1
    reset_launch_counts()
    c2 = run_cli(out_c, ["--max_train_steps", "4", "--checkpointing_steps", "100",
                         "--resume_from_checkpoint", "latest"])
    pair = launch_counts()
    c_loss, a_loss = c2["losses"].get(4), losses_a[4]
    rel = abs(c_loss - a_loss) / abs(a_loss) if c_loss is not None else math.inf
    want_pair = {k: per_pair_512.get(k, 0) for k in pair}
    emit({"phase": "stage1_cli", "run": "C", "c_resume_wall_s": c2["wall_s"],
          "restore_s": c2["spans"].get("restore"), "restored_equals_saved":
          c2["restored_digest"] == saved, "resumed_from": c2["start_step"],
          "a_loss_4": a_loss, "c_loss_4": c_loss, "loss_rel_diff": rel,
          "launches_per_pair": {k: v for k, v in pair.items() if v},
          "stage1_phase_per_pair_512": {k: v for k, v in want_pair.items() if v}})
    if not (saved is not None and c2["restored_digest"] == saved and c2["start_step"] == 2
            and c2["global_step"] == 4):
        raise SystemExit(f"chip_smoke: stage1_cli resume did not restore the saved state: "
                         f"saved {saved}, restored {c2['restored_digest']}")
    if not rel <= TRAIN_CLI_LOSS_RTOL:
        raise SystemExit(f"chip_smoke: stage1_cli resumed step-4 loss {c_loss} against "
                         f"{a_loss} (rel {rel})")
    if pair != want_pair:
        raise SystemExit(f"chip_smoke: stage1_cli launches a pair {pair}, phase stage1's at "
                         f"512^2 {want_pair}")
    del c2
    shutil.rmtree(out_c, ignore_errors=True)
    torch.cuda.empty_cache()

    # gradient accumulation
    g = run_cli(os.path.join(root, "s1_ga"), ["--max_train_steps", "2",
                                              "--gradient_accumulation_steps", "2",
                                              "--checkpointing_steps", "100"])
    cadence = [c[1] for c in g["cadence"]]
    ga_finite = all(math.isfinite(v) for row in g["metrics"] for v in row.values())
    emit({"phase": "stage1_cli", "run": "ga2", "wall_s": g["wall_s"], "cadence": cadence,
          "losses": g["losses"], "global_step": g["global_step"],
          "elapsed_s": time.perf_counter() - t_phase})
    if cadence != ["gen", "gen", "discr", "discr"] or g["global_step"] != 2 or not ga_finite:
        raise SystemExit(f"chip_smoke: stage1_cli ga 2 run: cadence {cadence}, global step "
                         f"{g['global_step']}, losses {g['losses']}")
    del g
    shutil.rmtree(os.path.join(root, "s1_ga"), ignore_errors=True)
    torch.cuda.empty_cache()


def phase_controlnet_cli(args, pipe_dir: str, meta: str, loader_s: float) -> None:
    """The ControlNet trainer CLI (scripts/torch/train_controlnet.py) at full
    SD-1.5 width on phase cli's directory: the ControlNet copied from its
    4-channel UNet, 512^2, batch 4, --use_ema, on trainers' 24 pairs.
      A: 6 steps, asynchronous checkpoints at 3 and 6: losses finite; both
         checkpoints; controlnet/ read back at full width equal to the EMA
         shadow bit for bit; every step's launches by the route rule
         (CONTROLNET_STEP_ATTENTION exactly, CONTROLNET_STEP_KERNELS each at
         least once, every other kernel never).
      C: 3 steps with a checkpoint, then --resume_from_checkpoint latest to
         6: the restored digest equals the saved one; C's step-6 loss within
         TRAIN_CLI_LOSS_RTOL of A's.
    Reports s/step, samples/s, the loader alone, checkpoint call and restore
    s, the checkpoint's GB, peak memory."""
    import shutil

    import numpy as np
    import torch

    import gmdx_torch.train as gtrain
    from gmdx_torch.io import load_component
    from gmdx_torch.models import SD15_CONTROLNET_CONFIG

    t_phase = time.perf_counter()
    root = os.path.dirname(meta)
    trainer = _script("train_controlnet")
    spans: dict[str, list] = {}
    calls: list[dict] = []
    losses: list[float] = []
    originals = (gtrain.make_controlnet_train_step, gtrain.save_state, gtrain.restore_state)

    def make_step(*a, **kw):
        step = _traced(spans, "step", originals[0](*a, **kw), calls)

        def run(state, batch, gen):
            state, m = step(state, batch, gen)
            losses.append(float(m["loss"]))
            return state, m
        return run

    def run_cli(out, argv):
        spans.clear()
        calls.clear()
        losses.clear()
        gtrain.make_controlnet_train_step = make_step
        gtrain.save_state = _traced(spans, "checkpoint", originals[1])
        gtrain.restore_state = _traced(spans, "restore", originals[2])
        try:
            t = time.perf_counter()
            res = trainer.main(["--pretrained_model_name_or_path", pipe_dir, "--train_metadata",
                                meta, "--output_dir", out, "--resolution", "512",
                                "--train_batch_size", str(TRAINER_CLI_BATCH), "--seed",
                                str(args.seed), "--use_ema", "--report_to", "tensorboard"]
                               + argv)
            torch.cuda.synchronize()
            res["wall_s"] = time.perf_counter() - t
        finally:
            (gtrain.make_controlnet_train_step, gtrain.save_state,
             gtrain.restore_state) = originals
        res.update(spans={k: list(v) for k, v in spans.items()}, calls=list(calls),
                   step_losses=list(losses))
        return res

    out_a = os.path.join(root, "cn_a")
    torch.cuda.reset_peak_memory_stats()
    a = run_cli(out_a, ["--max_train_steps", "6", "--checkpointing_steps", "3",
                        "--async_checkpointing"])
    peak_a = torch.cuda.max_memory_allocated() / 1e9
    step_s = a["spans"]["step"]
    ckpts = sorted(n for n in os.listdir(out_a) if n.startswith("checkpoint"))
    ckpt_gb = _dir_gb(os.path.join(out_a, "checkpoint_3"))
    saved = load_component(os.path.join(out_a, "controlnet"), dtype=torch.float32)
    state = a["state"]
    names = [n for n, _ in state.controlnet.named_parameters()]
    not_ema = [n for n, s in zip(names, state.ema.shadow)
               if not torch.equal(saved.state_dict()[n], s)]
    width_ok = saved.config == SD15_CONTROLNET_CONFIG
    off_path = [k for k in KERNELS if k not in CONTROLNET_STEP_ATTENTION
                and k not in CONTROLNET_STEP_KERNELS]
    bad_calls = [c for c in a["calls"]
                 if any(c.get(k, 0) != v for k, v in CONTROLNET_STEP_ATTENTION.items())
                 or any(c.get(k, 0) == 0 for k in CONTROLNET_STEP_KERNELS)
                 or any(c.get(k, 0) for k in off_path)]
    emit({"phase": "controlnet_cli", "run": "A", "wall_s": a["wall_s"],
          "batch": TRAINER_CLI_BATCH, "step_s": step_s,
          "s_per_step_2_6": float(np.median(step_s[1:])),
          "samples_per_s": TRAINER_CLI_BATCH / float(np.median(step_s[1:])),
          "loader_s_per_batch": loader_s, "checkpoint_call_s": a["spans"]["checkpoint"],
          "checkpoint_gb": ckpt_gb, "peak_mem_gb": peak_a, "losses": a["step_losses"],
          "checkpoints": ckpts, "controlnet_full_width": width_ok,
          "controlnet_not_ema": len(not_ema), "launches_per_step": a["calls"][0]})
    if (not all(math.isfinite(v) for v in a["step_losses"]) or len(a["step_losses"]) != 6
            or ckpts != ["checkpoint_3", "checkpoint_6"] or not width_ok or not_ema):
        raise SystemExit(f"chip_smoke: controlnet_cli run A failed its checks: losses "
                         f"{a['step_losses']}, checkpoints {ckpts}, full width {width_ok}, "
                         f"{len(not_ema)} tensors not the EMA shadow")
    if bad_calls:
        raise SystemExit(f"chip_smoke: controlnet_cli launches a step {bad_calls[0]}, the route "
                         f"rule {CONTROLNET_STEP_ATTENTION} and {CONTROLNET_STEP_KERNELS}")
    a_loss = a["step_losses"][-1]
    del a, state, saved
    shutil.rmtree(out_a, ignore_errors=True)
    torch.cuda.empty_cache()

    out_c = os.path.join(root, "cn_c")
    c1 = run_cli(out_c, ["--max_train_steps", "3", "--checkpointing_steps", "3"])
    saved_digest, c1_ckpt_s = c1["saved_digests"].get(3), c1["spans"]["checkpoint"]
    del c1
    torch.cuda.empty_cache()
    c2 = run_cli(out_c, ["--max_train_steps", "6", "--checkpointing_steps", "100",
                         "--resume_from_checkpoint", "latest"])
    c_loss = c2["step_losses"][-1] if c2["step_losses"] else math.nan
    rel = abs(c_loss - a_loss) / abs(a_loss)
    emit({"phase": "controlnet_cli", "run": "C", "c_resume_wall_s": c2["wall_s"],
          "c_checkpoint_call_s": c1_ckpt_s, "restore_s": c2["spans"].get("restore"),
          "restored_equals_saved": c2["restored_digest"] == saved_digest,
          "resumed_from": c2["start_step"], "a_loss_6": a_loss, "c_loss_6": c_loss,
          "loss_rel_diff": rel, "elapsed_s": time.perf_counter() - t_phase})
    if not (saved_digest is not None and c2["restored_digest"] == saved_digest
            and c2["start_step"] == 3 and c2["global_step"] == 6):
        raise SystemExit(f"chip_smoke: controlnet_cli resume did not restore the saved state: "
                         f"saved {saved_digest}, restored {c2['restored_digest']}")
    if not rel <= TRAIN_CLI_LOSS_RTOL:
        raise SystemExit(f"chip_smoke: controlnet_cli resumed step-6 loss {c_loss} against "
                         f"{a_loss} (rel {rel})")
    del c2
    shutil.rmtree(out_c, ignore_errors=True)
    torch.cuda.empty_cache()


def phase_trainer_clis(args, pipe_dir: str, stage1_per_pair: dict[str, float]) -> None:
    """Phases stage1_cli, controlnet_cli and dist on one set of 24 pairs
    (the train_cli phase's data), removed at the end."""
    import shutil

    root = os.path.join(os.path.dirname(pipe_dir), "trainers")
    os.makedirs(root)
    try:
        meta, val_dir = _train_cli_data(root, args.seed + 90)
        loader_s = _loader_s_per_batch(meta, pipe_dir, args.seed)
        phase_stage1_cli(args, pipe_dir, meta, val_dir, loader_s, stage1_per_pair)
        phase_controlnet_cli(args, pipe_dir, meta, loader_s)
        phase_dist(args, pipe_dir, meta)
    finally:
        shutil.rmtree(root, ignore_errors=True)


CONVERT_CHECKER_BATCH = 8
# The card's checker against the CPU's: projected embeddings' cosine per
# image; flags compared where every score is this far from 0.
CONVERT_COS_MIN = 0.9999
CONVERT_SCORE_MARGIN = 1e-3


def _same_json(a: str, b: str) -> bool:
    with open(a) as f, open(b) as g:
        return json.load(f) == json.load(g)


def _same_tensors(got: dict, want: dict) -> list[str]:
    """The keys of ``want`` that ``got`` lacks or holds with another dtype,
    shape or bits (and the keys ``got`` has beyond them)."""
    import numpy as np
    import torch

    def arr(v):
        if isinstance(v, torch.Tensor):
            return (v.view(torch.int16) if v.dtype == torch.bfloat16 else v).numpy()
        return v

    bad = sorted(set(got) ^ set(want))
    for k in set(got) & set(want):
        g, w = got[k], want[k]
        if g.dtype != w.dtype or tuple(g.shape) != tuple(w.shape) or not np.array_equal(arr(g),
                                                                                         arr(w)):
            bad.append(k)
    return bad


def phase_convert(args, pipe_dir: str) -> None:
    """The port's converter (scripts/torch/convert_torch_checkpoint.py) on
    phase cli's full-width sd15 directory: export it to diffusers' layout,
    add a seeded full-width ViT-L/14 safety checker (304 M parameters) in
    transformers' layout, with its position_ids buffer, import the result
    into a second directory. Every tensor of unet, gm_unet, vae and
    text_encoder must equal the source bit for bit, dtype included, every
    config.json, the scheduler and the tokenizer too, and the checker the
    seeded one. generate_hdr from the imported directory (4 steps, phase
    cli's PNGs) must give finite outputs at >= 40 dB of a run from the
    source (bit equality reported). The checker, loaded on the card in
    float32, runs on 8 decoded 512^2 images: projected embeddings at cosine
    >= 0.9999 of the CPU's per image, the flags equal wherever every score
    is beyond 1e-3 of 0 (the thresholds set 0.01 off the first image's
    cosines, so that it fires). Control: with every concept threshold at -2,
    a StableDiffusionGMPipeline(safety_checker=fn) call at batch 2 must
    give black images. Export and import seconds and GB, the checker's ms
    for a batch of 8 and peak memory are printed; the directories go at
    the end."""
    import shutil

    import numpy as np
    import torch

    from gmdx_torch.io import convert, read_hdr
    from gmdx_torch.io.params import load_file, load_params, save_file
    from gmdx_torch.io.pipeline import load_component, load_pipeline
    from gmdx_torch.io.png import read_png
    from gmdx_torch.models import (
        CLIP_VIT_L_VISION_CONFIG, StableDiffusionSafetyChecker, make_safety_checker_fn,
        preprocess_for_clip,
    )
    from gmdx_torch.pipelines import StableDiffusionGMPipeline

    tool = _script("convert_torch_checkpoint")
    workdir = os.path.dirname(pipe_dir)
    sdr = os.path.join(workdir, "sdr")
    if not os.path.isdir(sdr):
        raise SystemExit(f"chip_smoke: phase cli's PNGs are gone from {sdr}")
    root = os.path.join(workdir, "convert")
    diff, back = os.path.join(root, "diffusers"), os.path.join(root, "imported")
    os.makedirs(root)
    torch.cuda.reset_peak_memory_stats()
    try:
        t0 = time.perf_counter()
        tool.main(["export", "--src", pipe_dir, "--dst", diff])
        export_s, export_gb = time.perf_counter() - t0, _dir_gb(diff)

        torch.manual_seed(args.seed + 110)
        with torch.device("cuda"):
            seeded = StableDiffusionSafetyChecker(CLIP_VIT_L_VISION_CONFIG).state_dict()
        seeded = {k: v.cpu() for k, v in seeded.items()}
        os.makedirs(os.path.join(diff, "safety_checker"))
        n_pos = (CLIP_VIT_L_VISION_CONFIG.image_size // CLIP_VIT_L_VISION_CONFIG.patch_size) ** 2 + 1
        save_file({**seeded, "vision_model.vision_model.embeddings.position_ids":
                   torch.arange(n_pos)[None]},
                  os.path.join(diff, "safety_checker", "model.safetensors"))
        with open(os.path.join(diff, "safety_checker", "config.json"), "w") as f:
            json.dump(tool._checker_transformers_config(CLIP_VIT_L_VISION_CONFIG), f)
        with open(os.path.join(diff, "model_index.json")) as f:
            index = json.load(f)
        index["safety_checker"] = ["stable_diffusion", "StableDiffusionSafetyChecker"]
        with open(os.path.join(diff, "model_index.json"), "w") as f:
            json.dump(index, f)
        t0 = time.perf_counter()
        tool.main(["import", "--src", diff, "--dst", back])
        import_s, import_gb = time.perf_counter() - t0, _dir_gb(back)
        shutil.rmtree(diff)

        bad, n_tensors = [], 0
        for name in ("unet", "gm_unet", "vae", "text_encoder"):
            want = load_file(os.path.join(pipe_dir, name, "params.safetensors"))
            got = load_file(os.path.join(back, name, "params.safetensors"))
            n_tensors += len(want)
            bad += [f"{name}/{k}" for k in _same_tensors(got, want)]
            if not _same_json(os.path.join(back, name, "config.json"),
                              os.path.join(pipe_dir, name, "config.json")):
                bad.append(f"{name}/config.json")
            del want, got
        for rel in (("scheduler", "config.json"), ("tokenizer", "vocab.json")):
            if not _same_json(os.path.join(back, *rel), os.path.join(pipe_dir, *rel)):
                bad.append("/".join(rel))
        with open(os.path.join(back, "tokenizer", "merges.txt")) as f, \
                open(os.path.join(pipe_dir, "tokenizer", "merges.txt")) as g:
            if f.read() != g.read():
                bad.append("tokenizer/merges.txt")
        with open(os.path.join(back, "model_index.json")) as f, \
                open(os.path.join(pipe_dir, "model_index.json")) as g:
            if sorted(json.load(f)["components"]) != sorted(json.load(g)["components"]
                                                            + ["safety_checker"]):
                bad.append("model_index.json")
        checker_sd = convert.safety_checker_state_dict_from_flax(
            load_params(os.path.join(back, "safety_checker", "params.safetensors")))
        bad += [f"safety_checker/{k}" for k in _same_tensors(
            {k: torch.from_numpy(np.asarray(v)) for k, v in checker_sd.items()}, seeded)]
        n_tensors += len(seeded)
        del checker_sd

        gen_s, db, bit_equal = {}, [], True
        for tag, d in (("source", pipe_dir), ("imported", back)):
            t0 = time.perf_counter()
            _script("generate_hdr").main([
                "--pretrained_model_name_or_path", d, "--unet_ckpt", os.path.join(d, "gm_unet"),
                "--sdr_input_path", sdr, "--output_dir", os.path.join(root, f"gen_{tag}"),
                "--num_inference_steps", "4", "--seed", str(args.seed)])
            torch.cuda.synchronize()
            gen_s[tag] = time.perf_counter() - t0
            torch.cuda.empty_cache()
        outputs = sorted(os.listdir(os.path.join(root, "gen_source")))
        for fn in outputs:
            a, b = (os.path.join(root, f"gen_{tag}", fn) for tag in ("source", "imported"))
            read = read_hdr if fn.endswith(".hdr") else read_png
            x, y = (torch.from_numpy(np.asarray(read(p), np.float32)) for p in (a, b))
            if not (torch.isfinite(x).all() and torch.isfinite(y).all()):
                bad.append(f"generate_hdr/{fn}: not finite")
            peak = max(float(x.abs().max()), 1e-9)
            db.append(psnr01(x / peak, y / peak))
            bit_equal &= bool(torch.equal(x, y))

        sc_dir = os.path.join(back, "safety_checker")
        gpu = load_component(sc_dir, device="cuda")
        cpu = load_component(sc_dir, device="cpu")
        vae = load_component(os.path.join(back, "vae"), device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(args.seed + 111)
        z = torch.randn(CONVERT_CHECKER_BATCH, 4, 64, 64, generator=gen, device="cuda")
        with torch.no_grad():
            imgs = to01(vae.decode(z / vae.config.scaling_factor)).permute(0, 2, 3, 1).float()
            del vae
            size = cpu.config.image_size
            want = cpu.image_embeds(preprocess_for_clip(imgs.cpu(), size))
            for embeds, weights in ((cpu.concept_embeds, cpu.concept_embeds_weights),
                                    (cpu.special_care_embeds, cpu.special_care_embeds_weights)):
                cos = torch.nn.functional.cosine_similarity(want[:1], embeds, dim=-1)
                below = (torch.arange(len(cos)) % 2 == 1) & (embeds is cpu.concept_embeds)
                weights.copy_(cos + torch.where(below, -0.01, 0.01))
            for name in ("concept_embeds_weights", "special_care_embeds_weights"):
                getattr(gpu, name).copy_(getattr(cpu, name))
            got = gpu.image_embeds(preprocess_for_clip(imgs, size))
            cos = torch.nn.functional.cosine_similarity(got.cpu().double(), want.double(), dim=-1)
            special, concept = cpu.scores(want)
            decided = (torch.cat([special, concept], 1).abs().min(1).values
                       > CONVERT_SCORE_MARGIN).numpy()
        fn = make_safety_checker_fn(gpu)
        host = imgs.cpu().numpy()
        flags, want_flags = fn(host)[1], make_safety_checker_fn(cpu)(host)[1]

        @torch.no_grad()
        def checker_call():
            return gpu(preprocess_for_clip(imgs, size))

        checker_ms = time_ms(checker_call, iters=5)
        cfg = gpu.config
        n_tok, d = (cfg.image_size // cfg.patch_size) ** 2 + 1, cfg.hidden_size
        flops = CONVERT_CHECKER_BATCH * (
            cfg.num_layers * (2 * n_tok * d * (4 * d + 2 * cfg.intermediate_size)
                              + 4 * n_tok * n_tok * d)
            + 2 * (n_tok - 1) * 3 * cfg.patch_size ** 2 * d)
        nbytes = 4 * sum(p.numel() for p in gpu.parameters()) + imgs.numel() * 4
        checker_bound_ms, checker_bound_by = bound_ms(flops, nbytes, peak=FP32_FLOPS)
        t0 = time.perf_counter()
        fn(host)
        checker_wall_s = time.perf_counter() - t0
        del cpu, imgs

        with torch.no_grad():
            gpu.concept_embeds_weights.fill_(-2.0)
        seen = []

        def all_flagged(images01):
            out, fl = fn(images01)
            seen.append(fl)
            return out, fl

        bundle = load_pipeline(back, device="cuda",
                               components=("vae", "text_encoder", "tokenizer", "scheduler"))
        pipe = StableDiffusionGMPipeline(
            load_component(os.path.join(back, "gm_unet"), device="cuda"), bundle["modules"]["vae"],
            bundle["scheduler"], text_encoder=bundle["modules"]["text_encoder"],
            tokenizer=bundle["tokenizer"], safety_checker=all_flagged, device="cuda")
        sdr_latent = torch.randn(2, 4, 64, 64, generator=gen, device="cuda")
        black = pipe(sdr_latent, prompt=["a photo"] * 2, num_inference_steps=2,
                     generator=torch.Generator(device="cuda").manual_seed(args.seed),
                     output_type="np")
        control_black = bool(black.shape == (2, 512, 512, 3) and not black.any()
                             and len(seen) == 1 and seen[0].all())
        del pipe, bundle, gpu
        torch.cuda.empty_cache()

        emit({"phase": "convert", "export_s": export_s, "export_gb": export_gb,
              "import_s": import_s, "import_gb": import_gb, "tensors_checked": n_tensors,
              "mismatched": bad[:20], "n_mismatched": len(bad),
              "generate_s": gen_s, "generate_files": len(outputs),
              "generate_db_min": min(db), "generate_bit_equal": bit_equal,
              "checker_cos_min": float(cos.min()), "checker_decided": int(decided.sum()),
              "checker_flags": flags.tolist(), "checker_flags_cpu": want_flags.tolist(),
              "checker_ms_batch8": checker_ms, "checker_bound_ms": checker_bound_ms,
              "checker_bound_by": checker_bound_by, "checker_fn_wall_s_batch8": checker_wall_s,
              "control_black": control_black,
              "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
        if bad:
            raise SystemExit(f"chip_smoke: the round trip changed {len(bad)} entries: {bad[:8]}")
        if len(outputs) != 8 or min(db) < PSNR_MIN_DB:
            raise SystemExit(f"chip_smoke: generate_hdr from the imported directory: "
                             f"{len(outputs)} files, min {min(db):.2f} dB of the source run")
        if not (cos >= CONVERT_COS_MIN).all():
            raise SystemExit(f"chip_smoke: safety checker on the card vs the CPU: cosines "
                             f"{cos.tolist()} < {CONVERT_COS_MIN}")
        if not (decided[0] and want_flags[0]
                and np.array_equal(flags[decided], want_flags[decided])):
            raise SystemExit(f"chip_smoke: safety checker flags {flags} vs the CPU's "
                             f"{want_flags} where decided {decided}")
        if not control_black:
            raise SystemExit("chip_smoke: with every concept firing, the pipeline's images "
                             "were not all black")
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase dist: data-parallel training over ranks (gmdx_torch.dist)
# ---------------------------------------------------------------------------

DIST_WORLD = 2
DIST_STRATEGIES = ("ddp", "zero1", "fsdp")
DIST_BATCH = 8  # Stage 2's global batch: DIST_BATCH / DIST_WORLD a rank
DIST_STAGE1_BATCH = 2
DIST_CONTROLNET_BATCH = 4
DIST_STEPS = 2
# (strategy, remat): the three under remat, where fsdp's sharded state
# shows in the peak, and ddp without it, whose step's launches are phase
# train's.
DIST_STAGE2_RUNS = (("ddp", False), ("ddp", True), ("zero1", True), ("fsdp", True))
# The two-rank runs against one rank on the global batch: train_e2e's bars.
DIST_LOSS_RTOL = TRAIN_LOSS_RTOL
DIST_COS_MIN = TRAIN_GRAD_COS_MIN
# Stage 1 unclipped, so that its adaptive weight itself is compared (its
# default clip, 1e4, would hold both sides at the clip).
DIST_ADAPTIVE_WEIGHT_MAX = 1e12
DIST_BUDGET_S = 150.0
DIST_TIMED_STEPS = 5  # --dist-cards only
DIST_SEED = 130


def _dist_stage2(seed: int, remat: bool = False, layout=None):
    """Phase train's modules and a global cached-latent batch of DIST_BATCH,
    with the EMA on (part of the state each strategy places); ``remat``
    as --gradient_checkpointing; ``layout`` tp / sp's data x model grid."""
    import torch

    from gmdx_torch.models import CLIP_VIT_L_CONFIG, SD15_VAE_CONFIG, AutoencoderKL, CLIPTextModel
    from gmdx_torch.train import Stage2Config, make_train_step

    unet = build_gm_unet(seed, remat)
    torch.manual_seed(seed + 1)
    with torch.device("cuda"):
        vae = AutoencoderKL(SD15_VAE_CONFIG).to(torch.bfloat16).eval()
        text = CLIPTextModel(CLIP_VIT_L_CONFIG).to(torch.bfloat16).eval()
    config = Stage2Config(learning_rate=1e-5, use_ema=True)
    step = make_train_step(config, unet=unet, vae=vae, text_encoder=text, layout=layout)
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    shape = (DIST_BATCH, 4, 64, 64)
    batch = {"sdr_latent_mean": torch.randn(shape, generator=gen, device="cuda"),
             "gm_latent_mean": torch.randn(shape, generator=gen, device="cuda"),
             "input_ids": torch.randint(0, CLIP_VOCAB, (DIST_BATCH, 77), generator=gen,
                                        device="cuda")}
    for k in ("sdr", "gm"):
        batch[f"{k}_latent_std"] = torch.rand(shape, generator=gen, device="cuda") * 0.2 + 0.05
    return config, unet, step, batch


def _dist_stage1(seed: int):
    """Stage 1 at full width (phase stage1's VAE, VGG19 and discriminator,
    LoRA r = 64 with non-zero b factors, the CLI's optimizers) with the
    adaptive weight unclipped, in float32 on the plain versions; a global
    batch of DIST_STAGE1_BATCH 512^2 pairs. Float32, because at random
    weights the adversarial probe's gradient norm is near zero: in bf16 the
    ratio compares the rounding of two batch shapes (13 % apart between one
    batch of 2 and two of 1 on "NVIDIA H100 80GB HBM3", PERF.md §6), not the
    ranks' arithmetic."""
    import dataclasses

    import torch

    from gmdx_torch.models import SD15_VAE_CONFIG, AutoencoderKL, set_use_kernels
    from gmdx_torch.models.discriminator import Discriminator
    from gmdx_torch.models.vgg import VGG19Features
    from gmdx_torch.ops import fix_mulog_tmo
    from gmdx_torch.train import stage1

    torch.manual_seed(seed)
    with torch.device("cuda"):
        vae = AutoencoderKL(SD15_VAE_CONFIG)
        vgg = VGG19Features()
        disc = Discriminator()
    set_use_kernels(vae, False)
    config = dataclasses.replace(stage1.Stage1Config(),
                                 adaptive_weight_max=DIST_ADAPTIVE_WEIGHT_MAX)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    trainables = stage1.init_trainables(gen, vae, config)
    with torch.no_grad():
        for f in trainables["lora"].values():
            f["b"].normal_(0.0, 1e-2, generator=gen)
    gen_step = stage1.make_gen_step(config, vae=vae, discriminator=disc, vgg=vgg,
                                    tmo_fn=fix_mulog_tmo)
    disc_step = stage1.make_disc_step(config, vae=vae, discriminator=disc, tmo_fn=fix_mulog_tmo)
    state = stage1.init_state(config, trainables, disc,
                              stage1.make_optimizers(trainables, disc, lr_warmup_steps=0))
    batch = stage1_batch(DIST_STAGE1_BATCH, 512, torch.Generator(device="cuda").manual_seed(
        seed + 3))
    return state, gen_step, disc_step, batch


def _dist_controlnet(seed: int):
    """The ControlNet trainer's step at full width: a seeded random SD-1.5
    UNet (frozen, bf16), the ControlNet copied from it (fp32 master weights,
    bf16 compute), random VAE and CLIP; a global batch of
    DIST_CONTROLNET_BATCH 512^2 frames."""
    import torch

    from gmdx_torch.io import controlnet_state_dict_from_unet
    from gmdx_torch.models import (
        CLIP_VIT_L_CONFIG, SD15_CONTROLNET_CONFIG, SD15_UNET_CONFIG, SD15_VAE_CONFIG,
        AutoencoderKL, CLIPTextModel, ControlNetModel, UNet2DConditionModel,
    )
    from gmdx_torch.train import (
        ControlNetTrainConfig, init_controlnet_state, make_controlnet_train_step,
    )

    torch.manual_seed(seed)
    with torch.device("cuda"):
        unet = UNet2DConditionModel(SD15_UNET_CONFIG, dtype=torch.bfloat16)
        cnet = ControlNetModel(SD15_CONTROLNET_CONFIG, dtype=torch.bfloat16)
        vae = AutoencoderKL(SD15_VAE_CONFIG).to(torch.bfloat16).eval()
        text = CLIPTextModel(CLIP_VIT_L_CONFIG).to(torch.bfloat16).eval()
    cnet.load_state_dict(controlnet_state_dict_from_unet(cnet.state_dict(), unet.state_dict()))
    unet = unet.to(torch.bfloat16)
    config = ControlNetTrainConfig(learning_rate=1e-5)
    step = make_controlnet_train_step(config, unet=unet, vae=vae, text_encoder=text,
                                      controlnet=cnet.train())
    state = init_controlnet_state(config, cnet)
    gen = torch.Generator(device="cuda").manual_seed(seed + 5)
    frames = torch.rand(DIST_CONTROLNET_BATCH, 3, 512, 512, generator=gen, device="cuda") * 2 - 1
    batch = {"image": frames, "cond": frames,
             "input_ids": torch.randint(0, CLIP_VOCAB, (DIST_CONTROLNET_BATCH, 77),
                                        generator=gen, device="cuda")}
    return state, step, batch


def _dist_capture_grads(opt, into: list, measure=None):
    """Wrap ``opt.step`` so that the first gradients it takes (reduced
    across ranks: full tensors, or this rank's pieces) are kept, or, with
    ``measure``, only ``measure(grads)`` (no copy held on the card)."""
    inner = opt.step

    def step(grads, grad_norm=None):
        if not into:
            into.append(measure(grads) if measure is not None
                        else [g.detach().clone() for g in grads])
        return inner(grads, grad_norm)

    opt.step = step


def _dist_flat_bf16(path: str, tensors) -> None:
    """The tensors, flattened in order, as raw bf16 (int16 bits) in ``path``."""
    import torch

    with open(path, "wb") as f:
        for t in tensors:
            f.write(t.detach().reshape(-1).to(torch.bfloat16).view(torch.int16).cpu()
                    .numpy().tobytes())


def _dist_cosine(dp, pieces, path: str) -> tuple[float, float]:
    """Over all ranks, between this rank's pieces of a vector in ``dp``'s
    layout (its own spans, in order) and the same elements of the bf16
    vector in ``path``: the cosine and the share of elements whose sign
    differs."""
    import numpy as np
    import torch
    import torch.distributed as tdist

    ref = np.memmap(path, dtype=np.int16, mode="r")
    acc = torch.zeros(5, dtype=torch.float64, device="cuda")
    for (i, a, b, _), p in zip(dp.own, pieces):
        off = dp.layout.offsets[i]
        r = torch.from_numpy(np.array(ref[off + a:off + b])).cuda().view(torch.bfloat16).double()
        p = p.reshape(-1).double()
        acc += torch.stack([(p * r).sum(), (p * p).sum(), (r * r).sum(),
                            ((p > 0) != (r > 0)).sum().double(),
                            torch.tensor(float(p.numel()), device=p.device).double()])
    tdist.all_reduce(acc)
    dot, na, nb, flips, n = acc.tolist()
    return dot / math.sqrt(max(na * nb, 1e-300)), flips / max(n, 1.0)


def _dist_own(dp, tensors, pieces: bool):
    """This rank's pieces of ``tensors``: as they are when they already are
    its pieces (``pieces``), else views into the full tensors."""
    return tensors if pieces else dp.views(tensors)


def dist_job_ref(args) -> None:
    """One process, no group: the global batch's Stage-2 updates (losses,
    gradient norms; the first gradient and the update written as bf16
    vectors), the Stage-1 pair and the ControlNet step."""
    import torch

    from gmdx_torch.train import init_state, make_ema_step

    out = {}
    config, unet, step, batch = _dist_stage2(args.seed + DIST_SEED)
    state = init_state(config, unet)
    grads: list = []
    _dist_capture_grads(state.optimizer, grads)
    before = [p.detach().clone() for p in state.optimizer.params]
    losses = []
    for i in range(DIST_STEPS):
        gen = torch.Generator(device="cuda").manual_seed(args.seed + 100 + i)
        state, m = step(state, batch, gen)
        make_ema_step(config)(state)
        losses.append(float(m["loss"]))
    _dist_flat_bf16(os.path.join(args.dist_dir, "grad.bin"), grads[0])
    _dist_flat_bf16(os.path.join(args.dist_dir, "mu.bin"), state.optimizer.mu)
    _dist_flat_bf16(os.path.join(args.dist_dir, "update.bin"),
                    [p - b for p, b in zip(state.optimizer.params, before)])
    out["stage2"] = {"loss": losses, "step_s": _dist_timed_steps(args, step, state, batch)}
    del state, unet, step, batch, grads, before
    torch.cuda.empty_cache()
    if not args.dist_cards:
        out.update(_dist_stage1_and_controlnet(args))
    with open(os.path.join(args.dist_dir, "ref.json"), "w") as f:
        json.dump(out, f)


def _dist_stage1_and_controlnet(args, strategies=None) -> dict:
    """The Stage-1 pair (under ``strategies[0]`` across ranks) and the
    ControlNet step (under ``strategies[1]``): their metrics."""
    import torch

    from gmdx_torch import dist
    from gmdx_torch.train import stage1

    out = {}
    state, gen_step, disc_step, batch = _dist_stage1(args.seed + DIST_SEED + 10)
    if strategies:
        state = dist.apply_shard_strategy(state, strategies[0],
                                          param_fields=("trainables", "disc_params", "ema"),
                                          opt_fields=("opt_state", "disc_opt_state"))
    local = dist.shard_batch(batch)
    seed = args.seed + 110
    state, g = gen_step(state, local, torch.Generator(device="cuda").manual_seed(seed))
    state, d = disc_step(state, local, torch.Generator(device="cuda").manual_seed(seed + 1))
    out["stage1"] = {**{k: float(v) for k, v in g.items() if k != "module_grad_norms"},
                     **{k: float(v) for k, v in d.items() if k != "grad_norm"}}
    del state, gen_step, disc_step, batch, local
    torch.cuda.empty_cache()
    state, step, batch = _dist_controlnet(args.seed + DIST_SEED + 20)
    if strategies:
        state = dist.apply_shard_strategy(state, strategies[1], param_fields=("params", "ema"),
                                          opt_fields=("opt_state",))
    state, m = step(state, dist.shard_batch(batch),
                    torch.Generator(device="cuda").manual_seed(args.seed + 120))
    out["controlnet"] = {k: float(v) for k, v in m.items()}
    del state, step, batch
    torch.cuda.empty_cache()
    return out


def dist_job_ranks(args) -> None:
    """A rank of DIST_WORLD on the one card under gloo: the Stage-2 updates
    under each strategy (losses, the first reduced gradient's and the
    update's cosine against the reference, the peak memory, a step's
    launches), then the Stage-1 pair under fsdp and the ControlNet step
    under zero1."""
    import torch

    from gmdx_torch import dist
    from gmdx_torch.kernels import launch_counts, reset_launch_counts
    from gmdx_torch.train import init_state, make_ema_step

    if args.dist_port:  # two ranks on the one card
        dist.initialize(f"localhost:{args.dist_port}", args.dist_world, args.dist_rank,
                        backend="gloo")
    else:  # under torchrun: a rank a card, NCCL
        dist.initialize()
    out = {"backend": torch.distributed.get_backend(), "world": dist.world_size(),
           "device": str(torch.cuda.current_device()), "stage2": {}}
    for strategy, remat in DIST_STAGE2_RUNS:
        t0 = time.perf_counter()
        config, unet, step, batch = _dist_stage2(args.seed + DIST_SEED, remat)
        gc.collect()  # the last run's state, whose wrapped step held it in a cycle
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        state = dist.apply_shard_strategy(init_state(config, unet), strategy,
                                          param_fields=("params", "ema"),
                                          opt_fields=("opt_state",))
        # init_state builds the whole state on every rank before it is
        # placed: the setup's peak, apart from the training's.
        setup_peak = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        placed = torch.cuda.memory_allocated()
        opt = state.optimizer
        dp = opt.dp
        # The harness holds nothing on the card beside the state: the
        # first gradient is measured where the step takes it, the
        # parameters before the updates are kept on the host.
        grad_stats: list = []
        _dist_capture_grads(opt, grad_stats, lambda g: _dist_cosine(
            dp, _dist_own(dp, g, dp.sharded), os.path.join(args.dist_dir, "grad.bin")))
        sharded_master = dp.master is not None  # fsdp: the optimizer steps the master shard
        before = [t.detach().to("cpu", copy=True)
                  for t in _dist_own(dp, opt.master_params, sharded_master)]
        local = dist.shard_batch(batch)
        losses = []
        for i in range(DIST_STEPS):
            if i == DIST_STEPS - 1:
                reset_launch_counts()
            gen = torch.Generator(device="cuda").manual_seed(args.seed + 100 + i)
            state, m = step(state, local, gen)
            make_ema_step(config)(state)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        per_step = launch_counts()
        peak = torch.cuda.max_memory_allocated() / 1e9
        after = _dist_own(dp, opt.master_params, sharded_master)
        grad_cos, grad_flips = grad_stats[0]
        mu_cos, _ = _dist_cosine(dp, opt.mu if dp.sharded else dp.views(opt.mu),
                                 os.path.join(args.dist_dir, "mu.bin"))
        update_cos, update_flips = _dist_cosine(
            dp, [a - b.to(a.device) for a, b in zip(after, before)],
            os.path.join(args.dist_dir, "update.bin"))
        step_s = _dist_timed_steps(args, step, state, local)  # after every comparison
        out["stage2"][strategy + ("_remat" if remat else "")] = {
            "loss": losses, "peak_mem_gb": peak, "base_mem_gb": base / 1e9,
            "setup_peak_gb": setup_peak, "placed_mem_gb": placed / 1e9,
            "launches_per_step": per_step, "grad_cosine": grad_cos,
            "grad_sign_flip_share": grad_flips, "mu_cosine": mu_cos,
            "update_cosine": update_cos, "update_sign_flip_share": update_flips,
            "step_s": step_s, "s": time.perf_counter() - t0}
        del opt.step  # the wrapper, and with it the cycle
        del state, opt, dp, grad_stats, before, after, unet, step, batch, local, m
        gc.collect()
        torch.cuda.empty_cache()
    if not args.dist_cards:
        out.update(_dist_stage1_and_controlnet(args, ("fsdp", "zero1")))
    with open(os.path.join(args.dist_dir, f"rank{dist.rank()}.json"), "w") as f:
        json.dump(out, f)
    dist.shutdown()


def _dist_timed_steps(args, step, state, batch) -> list[float]:
    """--dist-cards: the walls of DIST_TIMED_STEPS more steps (the
    parameters move on; nothing is compared after them)."""
    import torch

    walls = []
    for i in range(DIST_TIMED_STEPS if args.dist_cards else 0):
        gen = torch.Generator(device="cuda").manual_seed(args.seed + 200 + i)
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(state, batch, gen)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    return walls


def dist_job_cli(args) -> None:
    """Under torchrun (one rank, NCCL): the Stage-2 trainer CLI under zero1
    (2 updates, a checkpoint), under fsdp resumed from it (1 update, an
    asynchronous checkpoint), then under ddp resumed from that."""
    import torch

    from gmdx_torch import dist

    dist.initialize()  # torchrun's environment; the trainer then keeps the group
    out = {"backend": torch.distributed.get_backend(), "world": dist.world_size(),
           "env": {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")}}
    trainer = _script("train_gm_unet")
    common = ["--pretrained_model_name_or_path", args.dist_pipe, "--train_metadata",
              args.dist_meta, "--resolution", "512", "--train_batch_size", "2", "--seed",
              str(args.seed), "--center_crop", "--output_dir",
              os.path.join(args.dist_dir, "cli"), "--checkpoints_total_limit", "1",
              "--dataloader_num_workers", "2", "--report_to", "tensorboard"]
    runs = {}
    for name, extra in (
            ("zero1", ["--shard_strategy", "zero1", "--max_train_steps", "2",
                       "--checkpointing_steps", "2"]),
            ("fsdp", ["--shard_strategy", "fsdp", "--max_train_steps", "3",
                      "--checkpointing_steps", "3", "--async_checkpointing",
                      "--resume_from_checkpoint", "latest"]),
            ("ddp", ["--shard_strategy", "ddp", "--max_train_steps", "3",
                     "--resume_from_checkpoint", "latest"])):
        t0 = time.perf_counter()
        res = trainer.main(common + extra)
        torch.cuda.synchronize()
        runs[name] = {"start_step": res["start_step"], "global_step": res["global_step"],
                      "losses": res["losses"], "saved": res["saved_digests"],
                      "restored": res["restored_digest"], "wall_s": time.perf_counter() - t0}
        del res
        torch.cuda.empty_cache()
    out["runs"] = runs
    with open(os.path.join(args.dist_dir, "cli.json"), "w") as f:
        json.dump(out, f)
    dist.shutdown()


def _dist_spawn(argv: list[str], log: str, timeout: float, env=None) -> None:
    """Run a child (its output to ``log``), waiting at most ``timeout``;
    it is killed if it outlives that, and a failure raises with its log."""
    with open(log, "w") as f:
        proc = subprocess.Popen(argv, stdout=f, stderr=subprocess.STDOUT, cwd=REPO,
                                env=env or os.environ.copy())
        try:
            proc.wait(timeout=timeout)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if proc.returncode != 0:
        with open(log) as f:
            tail = f.read()[-3000:]
        raise SystemExit(f"chip_smoke: dist child {argv[2:5]} failed ({proc.returncode}):\n"
                         f"{tail}")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dist_check_stage2(ranks: list[dict], ref: dict, want_launches) -> list[str]:
    """Emit each rank's Stage-2 rows; the failed checks (loss, the first
    reduced gradient's and first moment's cosines, a step's launches
    without remat where ``want_launches`` is given, the remat peaks'
    order)."""
    bad = []
    for r, res in enumerate(ranks):
        for strategy, s2 in res["stage2"].items():
            rel = max(abs(a - b) / abs(b) for a, b in zip(s2["loss"], ref["stage2"]["loss"]))
            row = {"phase": "dist", "part": "stage2", "rank": r, "strategy": strategy,
                   "backend": res["backend"], "world": res["world"],
                   "loss": s2["loss"], "ref_loss": ref["stage2"]["loss"], "loss_rel_err": rel,
                   **{k: s2[k] for k in ("grad_cosine", "grad_sign_flip_share", "mu_cosine",
                                         "update_cosine", "update_sign_flip_share",
                                         "peak_mem_gb", "base_mem_gb", "setup_peak_gb",
                                         "placed_mem_gb", "step_s", "s")},
                   "launches_per_step": {k: s2["launches_per_step"][k] for k in TRAIN_KERNELS},
                   "train_launches_per_step": want_launches}
            emit(row)
            if not (rel <= DIST_LOSS_RTOL and s2["grad_cosine"] >= DIST_COS_MIN
                    and s2["mu_cosine"] >= DIST_COS_MIN):
                bad.append(f"rank {r} {strategy}: loss rel {rel}, cosines gradient "
                           f"{s2['grad_cosine']}, first moment {s2['mu_cosine']}")
            if (want_launches is not None and not strategy.endswith("_remat")
                    and row["launches_per_step"] != want_launches):
                bad.append(f"rank {r} {strategy}: launches a step {row['launches_per_step']}"
                           f", phase train's {want_launches}")
        # Without remat the backward's activations and gradients make
        # zero1's and fsdp's peaks alike (both hold the full fp32
        # parameters then); the order is held under remat.
        peaks = [res["stage2"][s + "_remat"]["peak_mem_gb"] for s in ("fsdp", "zero1", "ddp")]
        if not peaks[0] < peaks[1] < peaks[2]:
            bad.append(f"rank {r}: remat peaks fsdp / zero1 / ddp {peaks} not increasing")
    return bad


def phase_dist(args, pipe_dir: str, meta: str) -> None:
    """Data-parallel training (gmdx_torch.dist) at SD-1.5 width, 512^2.
      ref: one process, no group: DIST_STEPS Stage-2 updates of the global
         batch (DIST_BATCH cached latents, EMA on; the first gradient, the
         first moment and the update written as bf16 vectors), a Stage-1
         pair (DIST_STAGE1_BATCH, float32, plain) and a ControlNet step
         (DIST_CONTROLNET_BATCH).
      cli (beside ref): torchrun, one rank under NCCL: train_gm_unet.py
         under zero1 (a checkpoint), fsdp resumed from it (an asynchronous
         checkpoint) and ddp resumed from that, restoring the digest fsdp
         saved.
      ranks: DIST_WORLD processes on the one card under gloo (NCCL refuses
         two ranks on one device), each on its rows: the Stage-2 updates of
         DIST_STAGE2_RUNS: loss within DIST_LOSS_RTOL of ref's, the first
         reduced gradient's and the first moment's cosine against ref's
         >= DIST_COS_MIN (the update's cosine and the share of elements
         whose sign differs are reported: AdamW's first updates are about
         lr * sign(g), so an element whose gradient lies within bf16
         rounding of zero flips), a step's launches of every training
         kernel phase train's (without remat), the training's peak memory
         (from the state's placement on) fsdp < zero1 < ddp (under remat;
         the setup's peak, init_state's whole state before its placement,
         reported); then the Stage-1 pair under fsdp and the
         ControlNet step under zero1 (losses and the adaptive weight
         within DIST_LOSS_RTOL).
    Its time is printed beside DIST_BUDGET_S."""
    import shutil

    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(pipe_dir), "dist")
    os.makedirs(root)
    me = [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--seed", str(args.seed),
          "--dist-dir", root]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    cli_log = open(os.path.join(root, "cli.log"), "w")
    cli_proc = None
    try:
        # The NCCL rank beside the reference (the card holds both; the two
        # gloo ranks and it do not fit in 80 GB at once, PERF.md §6).
        t0 = time.perf_counter()
        cli_proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc_per_node",
             "1", "--master_addr", "localhost", "--master_port", str(_free_port()),
             os.path.join(REPO, "chip_smoke.py"), "--seed", str(args.seed), "--dist-dir", root,
             "--dist-job", "cli", "--dist-pipe", pipe_dir, "--dist-meta", meta],
            stdout=cli_log, stderr=subprocess.STDOUT, cwd=REPO, env=env)
        _dist_spawn(me + ["--dist-job", "ref"], os.path.join(root, "ref.log"), 600)
        ref_s = time.perf_counter() - t0
        with open(os.path.join(root, "ref.json")) as f:
            ref = json.load(f)
        cli_proc.wait(timeout=900)
        cli_s = time.perf_counter() - t0
        if cli_proc.returncode != 0:
            with open(os.path.join(root, "cli.log")) as f:
                tail = f.read()[-3000:]
            raise SystemExit(f"chip_smoke: dist cli under torchrun failed "
                             f"({cli_proc.returncode}):\n{tail}")
        t0 = time.perf_counter()
        port = _free_port()
        logs = [open(os.path.join(root, f"rank{r}.log"), "w") for r in range(DIST_WORLD)]
        procs = [subprocess.Popen(me + ["--dist-job", "ranks", "--dist-rank", str(r),
                                        "--dist-world", str(DIST_WORLD), "--dist-port",
                                        str(port)],
                                  stdout=logs[r], stderr=subprocess.STDOUT, cwd=REPO)
                 for r in range(DIST_WORLD)]
        try:
            for p in procs:
                p.wait(timeout=900)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                with open(os.path.join(root, f"rank{r}.log")) as f:
                    tail = f.read()[-3000:]
                raise SystemExit(f"chip_smoke: dist rank {r} failed ({p.returncode}):\n{tail}")
        ranks = []
        for r in range(DIST_WORLD):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        ranks_s = time.perf_counter() - t0

        bad = _dist_check_stage2(ranks, ref, getattr(args, "train_step_launches", None))
        for r, res in enumerate(ranks):
            for part, keys in (("stage1", ("gen_loss", "recon", "perceptual", "adversarial",
                                           "adaptive_weight", "disc_loss", "hinge", "gp")),
                               ("controlnet", ("loss", "grad_norm"))):
                errs = {k: abs(res[part][k] - ref[part][k]) / max(abs(ref[part][k]), 1e-30)
                        for k in keys}
                emit({"phase": "dist", "part": part, "rank": r,
                      "strategy": "fsdp" if part == "stage1" else "zero1",
                      "values": {k: res[part][k] for k in keys},
                      "ref": {k: ref[part][k] for k in keys}, "rel_err": errs})
                if max(errs.values()) > DIST_LOSS_RTOL:
                    bad.append(f"rank {r} {part}: rel errors {errs}")

        with open(os.path.join(root, "cli.json")) as f:
            cli = json.load(f)
        runs = cli["runs"]
        emit({"phase": "dist", "part": "cli", "backend": cli["backend"], "world": cli["world"],
              "env": cli["env"], "runs": runs})
        losses = [v for run in runs.values() for v in run["losses"].values()]
        if not (cli["backend"] == "nccl" and cli["world"] == 1
                and runs["zero1"]["global_step"] == 2 and 2 in map(int, runs["zero1"]["saved"])
                and runs["fsdp"]["start_step"] == 2 and runs["fsdp"]["global_step"] == 3
                and runs["fsdp"]["restored"] == runs["zero1"]["saved"]["2"]
                and runs["ddp"]["start_step"] == 3
                and runs["ddp"]["restored"] == runs["fsdp"]["saved"]["3"]
                and all(math.isfinite(v) for v in losses)):
            bad.append(f"cli under NCCL: {cli['backend']} x {cli['world']}, runs {runs}")
        elapsed = time.perf_counter() - t_phase
        emit({"phase": "dist", "elapsed_s": elapsed, "ref_s": ref_s, "cli_s": cli_s,
              "ranks_s": ranks_s, "budget_s": DIST_BUDGET_S,
              "within_budget": elapsed <= DIST_BUDGET_S})
        if bad:
            raise SystemExit("chip_smoke: dist failed its checks: " + "; ".join(bad))
    finally:
        if cli_proc is not None and cli_proc.poll() is None:
            cli_proc.kill()
            cli_proc.wait()
        cli_log.close()
        shutil.rmtree(root, ignore_errors=True)


def phase_dist_cards(args) -> None:
    """``--dist-cards N`` (not part of the default run; N cards): the
    Stage-2 part of phase dist with a rank a card under NCCL (torchrun),
    against one process on the global batch on one card, with
    DIST_TIMED_STEPS more steps timed on each side; phase dist's checks
    but the launches (no phase train here). Prints s/step and samples/s of
    the global batch for each strategy and for the one card."""
    import shutil
    import statistics

    root = tempfile.mkdtemp(prefix="gmdx_dist_cards_")
    me = [os.path.join(REPO, "chip_smoke.py"), "--seed", str(args.seed), "--dist-dir", root,
          "--dist-cards", str(args.dist_cards)]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    try:
        _dist_spawn([sys.executable] + me + ["--dist-job", "ref"],
                    os.path.join(root, "ref.log"), 600, env=env)
        _dist_spawn([sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
                     "--nproc_per_node", str(args.dist_cards), "--master_addr", "localhost",
                     "--master_port", str(_free_port())] + me + ["--dist-job", "ranks"],
                    os.path.join(root, "ranks.log"), 900, env=env)
        with open(os.path.join(root, "ref.json")) as f:
            ref = json.load(f)
        ranks = []
        for r in range(args.dist_cards):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        bad = _dist_check_stage2(ranks, ref, None)
        one = statistics.median(ref["stage2"]["step_s"])
        summary = {"one_card_s_per_step": one, "one_card_samples_per_s": DIST_BATCH / one}
        for strategy in ranks[0]["stage2"]:
            walls = [statistics.median(r["stage2"][strategy]["step_s"]) for r in ranks]
            summary[strategy] = {"s_per_step": max(walls), "samples_per_s": DIST_BATCH / max(walls),
                                 "peak_mem_gb": max(r["stage2"][strategy]["peak_mem_gb"]
                                                    for r in ranks)}
        emit({"phase": "dist_cards", "cards": args.dist_cards, "global_batch": DIST_BATCH,
              "backend": ranks[0]["backend"], "world": ranks[0]["world"], **summary})
        if bad:
            raise SystemExit("chip_smoke: dist_cards failed its checks: " + "; ".join(bad))
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 24: tensor- and spatial-parallel serving
# ---------------------------------------------------------------------------

PARALLEL_WORLD = 2
PARALLEL_BUDGET_S = 150.0
PARALLEL_SEED = 140
# Phase parallel's runs: (name, mode, path, PNDM steps). TP: the dual
# text-to-HDR path at 512^2; SP: generate_hdr's single-UNet path at 512^2
# (encode, steps, decode) and upconvert_hdrtv's at 1024^2.
PARALLEL_RUNS = (("tp_dual", "tp", "dual", 3), ("sp_gm", "sp", "gm", 3),
                 ("sp_hdrtv", "sp", "hdrtv", 2))
# --parallel-cards N: generate_hdr's path under TP = N and SP = N and
# upconvert_hdrtv's under SP = N, at PNDM 50, each after a 2-step warm-up.
PARALLEL_CARDS_RUNS = (("tp_gm", "tp", "gm", 50), ("sp_gm", "sp", "gm", 50),
                       ("sp_hdrtv", "sp", "hdrtv", 50))
# Under TP the JAX dispatch keeps only attention on its kernels.
TP_OFF_KERNELS = ("conv3x3", "group_norm_silu", "group_norm_moments", "group_norm_apply",
                  "geglu_ff_ln", "geglu_ff", "winograd4_conv3x3", "add_layer_norm")
TP_ATTENTION_KERNELS = ("attention_kv_resident", "flash_attention_bsc",
                        "flash_attention_fwd_d512")
# Under SP every kernel of the path launches, the split GroupNorm in place
# of the one-rank one.
SP_KERNELS = {"gm": ("attention_kv_resident", "conv3x3", "geglu_ff_ln") + PARALLEL_KERNELS,
              "hdrtv": ("attention_kv_resident", "flash_attention_bsc",
                        "flash_attention_fwd_d512", "conv3x3", "geglu_ff_ln")
              + PARALLEL_KERNELS}


def _parallel_pipeline(path: str, seed: int, ctx):
    """``path``'s pipeline at SD-1.5 width with seeded random bf16 weights;
    under TP (``ctx``) each module holds this rank's slices."""
    from gmdx_torch.dist.tp import tp_shard_module

    pipe = {"dual": build_pipeline, "gm": build_gm_pipeline,
            "hdrtv": build_hdrtv_pipeline}[path](seed)
    if ctx is not None and ctx.mode == "tp":
        for m in (pipe.unet, getattr(pipe, "gm_unet", None), pipe.vae,
                  getattr(pipe, "controlnet", None)):
            if m is not None:
                tp_shard_module(m, ctx.rank, ctx.size)
    return pipe


def _parallel_path(pipe, path: str, seed: int, steps: int, ctx):
    """One run of ``path`` through ``pipe`` inside the model-parallel
    context ``ctx`` (None: one process): its decoded outputs in [0, 1] as
    CPU tensors."""
    import torch

    from gmdx_torch.dist import shard_rows

    if path == "dual":
        latents, cond, uncond = make_inputs(pipe, 1, seed + 2)
        _, _, sdr, gm = run_path(pipe, latents, cond, uncond, steps)
        out = {"sdr": to01(sdr), "gm": to01(gm)}
    elif path == "gm":
        sdr, cond, uncond = sdr2hdr_inputs(1, seed + 3)
        if ctx is not None and ctx.mode == "sp":
            sdr = shard_rows(sdr, ctx)
        sdr01, gm01 = run_sdr2hdr(pipe, sdr, cond, uncond, steps, seed + 4)
        out = {"sdr": sdr01, "gm": gm01}
    else:
        sdr, cond, uncond = hdrtv_inputs(1, seed + 5)
        sdr01, gm01, hdr = upconvert(pipe, sdr, cond, uncond, steps, seed + 6)
        out = {k: torch.from_numpy(v) for k, v in (("sdr", sdr01), ("gm", gm01), ("hdr", hdr))}
    torch.cuda.synchronize()
    return {k: v.float().cpu() for k, v in out.items()}


def parallel_job(args) -> None:
    """A process of phase parallel: with --parallel-port, rank
    --parallel-rank of PARALLEL_WORLD gloo ranks on the one card; under
    torchrun (--parallel-cards), a rank a card under NCCL; else the one
    process the ranks are held against. Each run's launches (counts set to
    0 just before it, read just after), peak memory, wall and outputs go to
    --parallel-dir."""
    import contextlib

    import torch

    from gmdx_torch import dist
    from gmdx_torch.dist import tpctx
    from gmdx_torch.kernels import launch_counts, reset_launch_counts

    rank_tag = "ref"
    if args.parallel_job == "ranks":
        if args.parallel_port:
            dist.initialize(f"localhost:{args.parallel_port}", PARALLEL_WORLD,
                            args.parallel_rank, backend="gloo")
        else:
            dist.initialize()
        rank_tag = f"rank{dist.rank()}"
    runs = PARALLEL_CARDS_RUNS if args.parallel_cards else PARALLEL_RUNS
    out = {"backend": torch.distributed.get_backend() if dist.is_initialized() else None,
           "world": dist.world_size(), "runs": {}}
    for name, mode, path, steps in runs:
        seed = args.seed + PARALLEL_SEED
        with (tpctx.parallel_context(mode) if dist.is_initialized()
              else contextlib.nullcontext()) as ctx:
            pipe = _parallel_pipeline(path, seed, ctx)
            if args.parallel_cards:  # a warm-up: cuDNN/cuBLAS plans, gloo/NCCL buffers
                _parallel_path(pipe, path, seed, 2, ctx)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.synchronize()
            # The run's peak, from the placed weights on (a TP rank builds
            # the whole model before it keeps its slices).
            weights_gb = torch.cuda.memory_allocated() / 1e9
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            t0 = time.perf_counter()
            outs = _parallel_path(pipe, path, seed, steps, ctx)
            wall = time.perf_counter() - t0
            counts = launch_counts()
        torch.save(outs, os.path.join(args.parallel_dir, f"{rank_tag}_{name}.pt"))
        out["runs"][name] = {"launches": counts, "wall_s": wall, "steps": steps,
                             "weights_gb": weights_gb,
                             "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        del pipe
        gc.collect()
        torch.cuda.empty_cache()
    with open(os.path.join(args.parallel_dir, f"{rank_tag}.json"), "w") as f:
        json.dump(out, f)
    dist.shutdown()


def _parallel_check(ranks: list[dict], ref: dict, root: str, runs) -> tuple[list[str], dict]:
    """Each rank's outputs against the one process's (PSNR), its launches by
    the rule of its mode, its peak memory beside the one process's."""
    import torch

    bad, launches = [], {}
    for name, mode, path, steps in runs:
        want = torch.load(os.path.join(root, f"ref_{name}.pt"))
        ref_counts = ref["runs"][name]["launches"]
        for r, res in enumerate(ranks):
            got = torch.load(os.path.join(root, f"rank{r}_{name}.pt"))
            db = {k: psnr01(got[k].clamp(0, 1), want[k].clamp(0, 1)) for k in ("sdr", "gm")}
            run = res["runs"][name]
            counts = run["launches"]
            row = {"phase": "parallel", "run": name, "mode": mode, "rank": r,
                   "world": res["world"], "backend": res["backend"], "steps": steps,
                   "psnr_db": db, "min_db": PSNR_MIN_DB, "wall_s": run["wall_s"],
                   "one_process_wall_s": ref["runs"][name]["wall_s"],
                   "weights_gb": run["weights_gb"],
                   "one_process_weights_gb": ref["runs"][name]["weights_gb"],
                   "peak_mem_gb": run["peak_mem_gb"],
                   "one_process_peak_mem_gb": ref["runs"][name]["peak_mem_gb"],
                   "launches": {k: v for k, v in counts.items() if v},
                   "one_process_launches": {k: v for k, v in ref_counts.items() if v}}
            if path == "hdrtv":
                hdr_ok = bool(torch.isfinite(got["hdr"]).all()) and \
                    got["hdr"].shape == want["hdr"].shape
                row["hdr_finite"] = hdr_ok
                if not hdr_ok:
                    bad.append(f"{name} rank {r}: HDR frame not finite or misshapen")
            emit(row)
            if not min(db.values()) >= PSNR_MIN_DB:
                bad.append(f"{name} rank {r}: PSNR {db} < {PSNR_MIN_DB} dB")
            if mode == "tp":
                wrong = {k: (counts[k], ref_counts[k]) for k in TP_ATTENTION_KERNELS
                         if counts[k] != ref_counts[k]}
                wrong.update({k: counts[k] for k in TP_OFF_KERNELS if counts[k]})
            else:
                wrong = {k: counts[k] for k in SP_KERNELS[path] if counts[k] == 0}
                if counts["group_norm_silu"]:
                    wrong["group_norm_silu"] = counts["group_norm_silu"]
            if wrong:
                bad.append(f"{name} rank {r}: launches off the rule of {mode}: {wrong}")
            if r == 0:
                launches[name] = counts
    return bad, launches


def phase_parallel(args) -> dict[str, int]:
    """Tensor- and spatial-parallel serving (gmdx_torch.dist.tp, tpctx and
    the H split) at SD-1.5 width: PARALLEL_WORLD gloo ranks on the one card
    (NCCL refuses two ranks on one device) beside one process with the same
    weights, prompt embeddings and generators:
      tp_dual: TP = 2, the dual text-to-HDR path at 512^2, batch 1, 3 steps;
      sp_gm: SP = 2, generate_hdr's path at 512^2 (encode, 3 steps, decode);
      sp_hdrtv: SP = 2, upconvert_hdrtv's path at 1024^2, 2 steps.
    Each rank's decoded SDR and GM >= 40 dB of the one process's (TP takes
    the library route for GroupNorm, the conv and the FF, in bf16); the
    launches of each run on a rank: under TP the attention kernels as in
    one process and GroupNorm, the conv and the FF never, under SP every
    kernel of the path, the split GroupNorm in place of the one-rank one;
    each rank's peak memory beside the one process's, the phase's wall
    beside PARALLEL_BUDGET_S. Returns rank 0's launches of the SP runs."""
    import shutil

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="gmdx_parallel_")
    me = [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--seed", str(args.seed),
          "--parallel-dir", root]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    logs, procs = [], []
    try:
        port = _free_port()
        for r in range(PARALLEL_WORLD):
            logs.append(open(os.path.join(root, f"rank{r}.log"), "w"))
            procs.append(subprocess.Popen(
                me + ["--parallel-job", "ranks", "--parallel-rank", str(r), "--parallel-port",
                      str(port)], stdout=logs[r], stderr=subprocess.STDOUT, cwd=REPO, env=env))
        # The one process beside the ranks (the card holds all three).
        _dist_spawn(me + ["--parallel-job", "ref"], os.path.join(root, "ref.log"), 600, env=env)
        for p in procs:
            p.wait(timeout=600)
        for r, p in enumerate(procs):
            if p.returncode != 0:
                with open(os.path.join(root, f"rank{r}.log")) as f:
                    tail = f.read()[-3000:]
                raise SystemExit(f"chip_smoke: parallel rank {r} failed ({p.returncode}):\n"
                                 f"{tail}")
        with open(os.path.join(root, "ref.json")) as f:
            ref = json.load(f)
        ranks = []
        for r in range(PARALLEL_WORLD):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        bad, launches = _parallel_check(ranks, ref, root, PARALLEL_RUNS)
        elapsed = time.perf_counter() - t_phase
        emit({"phase": "parallel", "elapsed_s": elapsed, "budget_s": PARALLEL_BUDGET_S,
              "within_budget": elapsed <= PARALLEL_BUDGET_S, "card": nvidia_smi_line()})
        if bad:
            raise SystemExit("chip_smoke: parallel failed its checks: " + "; ".join(bad))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
        shutil.rmtree(root, ignore_errors=True)
    return {k: launches["sp_gm"][k] + launches["sp_hdrtv"][k] for k in launches["sp_gm"]}


# ---------------------------------------------------------------------------
# phase 25: Stage-2 training under tensor and spatial parallelism
# ---------------------------------------------------------------------------

TRAIN_PARALLEL_WORLD = 2
TRAIN_PARALLEL_MODES = ("tp", "sp")
TRAIN_PARALLEL_BUDGET_S = 150.0
TRAIN_PARALLEL_SEED = 150
# Under SP every kernel of a cached-latent step launches, the split
# GroupNorm's entries in place of the one-rank ones; under TP the flash
# kernels as in one process, and GroupNorm, the conv and the FF never (the
# JAX dispatch's library route).
TRAIN_SP_KERNELS = ("flash_attention_fwd", "flash_attention_bwd", "geglu_ff_ln")
TRAIN_SP_OFF = ("group_norm_silu", "group_norm_silu_bwd")
TRAIN_TP_ATTENTION = ("flash_attention_fwd", "flash_attention_bwd")
TRAIN_TP_OFF = ("conv3x3", "group_norm_silu", "group_norm_silu_bwd", "geglu_ff_ln", "geglu_ff",
                "winograd4_conv3x3", "add_layer_norm") + PARALLEL_KERNELS + TRAIN_PARALLEL_KERNELS


def _whole_grad_cosine(dp, grads, path: str) -> tuple[float, float]:
    """Between a reduced gradient in ``dp``'s layout (TP's slices gathered
    over the model group leaf by leaf, a collective) and the one process's
    bf16 vector in ``path``: the cosine and the share of elements whose
    sign differs."""
    import numpy as np
    import torch

    from gmdx_torch.dist.tp import gather_slices

    ref = np.memmap(path, dtype=np.int16, mode="r")
    acc = torch.zeros(4, dtype=torch.float64, device="cuda")
    off = 0
    for i, g in enumerate(grads):
        if dp.sliced is not None and dp.sliced[i]:
            g = gather_slices(dp.names[i], g, dp.full_shapes[i], dp.layout_ctx)
        n = g.numel()
        r = torch.from_numpy(np.array(ref[off:off + n])).cuda().view(torch.bfloat16).double()
        p = g.reshape(-1).double()
        acc += torch.stack([(p * r).sum(), (p * p).sum(), (r * r).sum(),
                            ((p > 0) != (r > 0)).sum().double()])
        off += n
    dot, na, nb, flips = acc.tolist()
    return dot / math.sqrt(max(na * nb, 1e-300)), flips / max(off, 1)


def _train_parallel_cli(args, root: str) -> dict:
    """train_gm_unet.py on this rank (inside the gloo group the job joined):
    2 steps under tp (cached latents of 8 samples) and under sp (pixels),
    EMA and remat on; each run's steps, losses, wall, and (rank 0) the
    saved pipeline's UNet's elements."""
    import torch

    from gmdx_torch import dist
    from gmdx_torch.io.params import load_file

    trainer = _script("train_gm_unet")
    common = ["--pretrained_model_name_or_path", args.train_parallel_pipe, "--train_metadata",
              args.train_parallel_meta, "--resolution", "512", "--train_batch_size", "2",
              "--max_train_steps", "2", "--seed", str(args.seed), "--center_crop",
              "--use_ema", "--gradient_checkpointing", "--dataloader_num_workers", "2"]
    out = {}
    for mode, extra in (("tp", ["--cache_latents", "--max_train_samples", "8"]), ("sp", [])):
        run_dir = os.path.join(root, f"cli_{mode}")
        t0 = time.perf_counter()
        res = trainer.main(common + ["--shard_strategy", mode, f"--{mode}_size",
                                     str(TRAIN_PARALLEL_WORLD), "--output_dir", run_dir] + extra)
        torch.cuda.synchronize()
        row = {"global_step": res["global_step"], "losses": res["losses"],
               "wall_s": time.perf_counter() - t0}
        del res
        gc.collect()
        torch.cuda.empty_cache()
        if dist.rank() == 0:
            saved = load_file(os.path.join(run_dir, "save_pipeline", "unet", "params.safetensors"))
            row["unet_elements"] = sum(v.numel() if isinstance(v, torch.Tensor) else v.size
                                       for v in saved.values())
            del saved
        out[mode] = row
    return out


def train_parallel_job(args) -> None:
    """A process of phase train_parallel: with --train-parallel-port, rank
    --train-parallel-rank of TRAIN_PARALLEL_WORLD gloo ranks on the one card
    (TP, then SP, each on a data x model grid of (1, 2); then the CLI under
    both); else the one process on the global batch (its first gradient
    written as a bf16 vector for the ranks' cosines). Each run's losses,
    launches (counts set to 0 just before its steps, read just after), peak
    memory and wall go to --train-parallel-dir."""
    import torch

    from gmdx_torch import dist
    from gmdx_torch.dist import tpctx
    from gmdx_torch.kernels import launch_counts, reset_launch_counts
    from gmdx_torch.train import init_state, make_ema_step

    root = args.train_parallel_dir
    ranks = args.train_parallel_job == "ranks"
    if ranks:
        dist.initialize(f"localhost:{args.train_parallel_port}", TRAIN_PARALLEL_WORLD,
                        args.train_parallel_rank, backend="gloo")
    out = {"backend": torch.distributed.get_backend() if ranks else None,
           "world": dist.world_size(), "runs": {}}
    seed = args.seed + TRAIN_PARALLEL_SEED
    for mode in TRAIN_PARALLEL_MODES if ranks else (None,):
        t0 = time.perf_counter()
        layout = tpctx.join_train_parallel(mode, TRAIN_PARALLEL_WORLD) if mode else None
        config, unet, step, batch = _dist_stage2(seed, remat=True, layout=layout)
        out["unet_elements"] = sum(p.numel() for p in unet.parameters())
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        state = init_state(config, unet)
        if mode:
            state = dist.apply_shard_strategy(state, mode, param_fields=("params", "ema"),
                                              opt_fields=("opt_state",), layout=layout)
            batch = dist.shard_batch(batch, layout.data_rank, layout.data_size)
            if mode == "sp":
                batch = dist.spatial_batch(batch, layout)
        setup_peak = torch.cuda.max_memory_allocated() / 1e9
        placed = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        opt = state.optimizer
        grad_stats: list = []
        grad_path = os.path.join(root, "grad.bin")
        if mode:
            _dist_capture_grads(opt, grad_stats,
                                lambda g: _whole_grad_cosine(opt.dp, g, grad_path))
        else:
            _dist_capture_grads(opt, grad_stats)
        losses = []
        torch.cuda.synchronize()
        reset_launch_counts()
        t1 = time.perf_counter()
        for i in range(DIST_STEPS):
            gen = torch.Generator(device="cuda").manual_seed(args.seed + 100 + i)
            state, m = step(state, batch, gen)
            make_ema_step(config)(state)
            losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        steps_s = time.perf_counter() - t1
        counts = launch_counts()
        row = {"loss": losses, "launches": counts, "steps_s": steps_s,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
               "placed_mem_gb": placed, "setup_peak_gb": setup_peak,
               "held_elements": sum(t.numel() for t in opt.params)}
        if mode:
            row["grad_cosine"], row["grad_sign_flip_share"] = grad_stats[0]
        else:
            _dist_flat_bf16(grad_path, grad_stats[0])
        row["s"] = time.perf_counter() - t0
        out["runs"][mode or "one"] = row
        del opt.step  # the wrapper, and with it the cycle
        del state, opt, grad_stats, unet, step, batch, m
        gc.collect()
        torch.cuda.empty_cache()
    if ranks:
        out["cli"] = _train_parallel_cli(args, root)
    tag = f"rank{dist.rank()}" if ranks else "ref"
    with open(os.path.join(root, f"{tag}.json"), "w") as f:
        json.dump(out, f)
    dist.shutdown()


def _train_parallel_check(ranks: list[dict], ref: dict) -> tuple[list[str], dict]:
    """Each rank's runs against the one process's (loss, gradient cosine,
    launches by the mode's rule, memory beside it) and its CLI runs."""
    bad, launches = [], {}
    one = ref["runs"]["one"]
    for r, res in enumerate(ranks):
        for mode in TRAIN_PARALLEL_MODES:
            run = res["runs"][mode]
            counts = run["launches"]
            rel = max(abs(a - b) / abs(b) for a, b in zip(run["loss"], one["loss"]))
            emit({"phase": "train_parallel", "mode": mode, "rank": r, "world": res["world"],
                  "backend": res["backend"], "global_batch": DIST_BATCH, "resolution": 512,
                  "steps": DIST_STEPS, "loss": run["loss"], "one_process_loss": one["loss"],
                  "loss_rel_err": rel, "grad_cosine": run["grad_cosine"],
                  "grad_sign_flip_share": run["grad_sign_flip_share"],
                  "steps_s": run["steps_s"], "one_process_steps_s": one["steps_s"],
                  "peak_mem_gb": run["peak_mem_gb"],
                  "one_process_peak_mem_gb": one["peak_mem_gb"],
                  "placed_mem_gb": run["placed_mem_gb"],
                  "one_process_placed_mem_gb": one["placed_mem_gb"],
                  "held_elements": run["held_elements"],
                  "one_process_held_elements": one["held_elements"],
                  "launches": {k: v for k, v in counts.items() if v},
                  "one_process_launches": {k: v for k, v in one["launches"].items() if v},
                  "s": run["s"]})
            if not (rel <= TRAIN_LOSS_RTOL and run["grad_cosine"] >= TRAIN_GRAD_COS_MIN):
                bad.append(f"rank {r} {mode}: loss rel {rel}, gradient cosine "
                           f"{run['grad_cosine']}")
            if mode == "tp":
                wrong = {k: (counts[k], one["launches"][k]) for k in TRAIN_TP_ATTENTION
                         if counts[k] != one["launches"][k] or not counts[k]}
                wrong.update({k: counts[k] for k in TRAIN_TP_OFF if counts[k]})
            else:
                wrong = {k: counts[k] for k in TRAIN_SP_KERNELS + PARALLEL_KERNELS
                         + TRAIN_PARALLEL_KERNELS if counts[k] == 0}
                wrong.update({k: counts[k] for k in TRAIN_SP_OFF if counts[k]})
            if wrong:
                bad.append(f"rank {r} {mode}: launches off the rule: {wrong}")
            if r == 0:
                launches[mode] = counts
        for mode, cli in res["cli"].items():
            emit({"phase": "train_parallel", "part": "cli", "mode": mode, "rank": r, **cli})
            losses = list(cli["losses"].values())
            if not (cli["global_step"] == 2 and losses
                    and all(math.isfinite(v) for v in losses)):
                bad.append(f"rank {r} cli {mode}: {cli}")
            if r == 0 and cli.get("unet_elements") != ref["unet_elements"]:
                bad.append(f"cli {mode}: the saved UNet holds {cli.get('unet_elements')} "
                           f"elements, the model {ref['unet_elements']}")
    return bad, launches


def phase_train_parallel(args, pipe_dir: str) -> dict[str, int]:
    """Stage-2 training under TP and SP (gmdx_torch.dist.tp, tpctx, the
    split GroupNorm backward) at SD-1.5 width: the one process, then
    TRAIN_PARALLEL_WORLD gloo ranks on the one card (NCCL refuses two ranks
    on one device), each child with a watchdog (killed past its limit: a
    rank that left the collectives' order would hang the others); then the
    CLI on phase cli's directory (``pipe_dir``) inside the ranks. Returns
    rank 0's launches of the SP run."""
    import shutil

    t_phase = time.perf_counter()
    root = os.path.join(os.path.dirname(pipe_dir), "train_parallel")
    os.makedirs(root)
    me = [sys.executable, os.path.join(REPO, "chip_smoke.py"), "--seed", str(args.seed),
          "--train-parallel-dir", root]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    logs, procs = [], []
    try:
        meta, _ = _train_cli_data(root, args.seed + 95)
        t0 = time.perf_counter()
        _dist_spawn(me + ["--train-parallel-job", "ref"], os.path.join(root, "ref.log"), 600,
                    env=env)
        ref_s = time.perf_counter() - t0
        port = _free_port()
        t0 = time.perf_counter()
        for r in range(TRAIN_PARALLEL_WORLD):
            logs.append(open(os.path.join(root, f"rank{r}.log"), "w"))
            procs.append(subprocess.Popen(
                me + ["--train-parallel-job", "ranks", "--train-parallel-rank", str(r),
                      "--train-parallel-port", str(port), "--train-parallel-pipe", pipe_dir,
                      "--train-parallel-meta", meta],
                stdout=logs[r], stderr=subprocess.STDOUT, cwd=REPO, env=env))
        deadline = time.perf_counter() + 900
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                break
        for r, p in enumerate(procs):
            if p.returncode != 0:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                with open(os.path.join(root, f"rank{r}.log")) as f:
                    tail = f.read()[-3000:]
                raise SystemExit(f"chip_smoke: train_parallel rank {r} failed "
                                 f"({p.returncode}):\n{tail}")
        ranks_s = time.perf_counter() - t0
        with open(os.path.join(root, "ref.json")) as f:
            ref = json.load(f)
        ranks = []
        for r in range(TRAIN_PARALLEL_WORLD):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        bad, launches = _train_parallel_check(ranks, ref)
        elapsed = time.perf_counter() - t_phase
        emit({"phase": "train_parallel", "elapsed_s": elapsed, "ref_s": ref_s,
              "ranks_s": ranks_s, "budget_s": TRAIN_PARALLEL_BUDGET_S,
              "within_budget": elapsed <= TRAIN_PARALLEL_BUDGET_S, "card": nvidia_smi_line()})
        if bad:
            raise SystemExit("chip_smoke: train_parallel failed its checks: " + "; ".join(bad))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
        shutil.rmtree(root, ignore_errors=True)
    return launches["sp"]


# --parallel-cards N, its CLI part: (name, script, width flag or None,
# steps, input folder) over one full-width directory; each parallel run is
# held against the one-card run of its script.
PARALLEL_CLI_RUNS = (("gen_one_card", "generate_hdr", None, 4, "sdr"),
                     ("gen_tp", "generate_hdr", "--tp_size", 4, "sdr"),
                     ("gen_sp", "generate_hdr", "--sp_size", 4, "sdr"),
                     ("up_one_card", "upconvert_hdrtv", None, 2, "hdrtv"),
                     ("up_sp", "upconvert_hdrtv", "--sp_size", 2, "hdrtv"))


def _parallel_cards_cli(args, root: str, env) -> dict:
    """The CLIs under torchrun on N cards (NCCL): scripts/torch/init_pipeline.py
    --size sd15 --dual writes one directory; generate_hdr on a 512^2 PNG at
    4 steps in one process on one card, at --tp_size N and at --sp_size N;
    upconvert_hdrtv on a 1024^2 PNG at 2 steps on one card and at
    --sp_size N. Each parallel run's PNGs >= 40 dB of the one-card run's,
    its .hdr files finite and of the same shape. Returns the rows' failures
    and walls."""
    import numpy as np
    import torch

    from gmdx_torch.io import read_hdr
    from gmdx_torch.io.png import read_png, write_png

    n = args.parallel_cards
    pipe_dir = os.path.join(root, "pipe")
    _script("init_pipeline").main(["--output_dir", pipe_dir, "--size", "sd15", "--dual",
                                   "--scheduler", "dpm++", "--seed", str(args.seed)])
    torch.cuda.empty_cache()
    rng = np.random.default_rng(args.seed + 61)
    for sub, side in (("sdr", 512), ("hdrtv", HDRTV_SIDE)):
        os.makedirs(os.path.join(root, sub))
        y, x = np.mgrid[0:side, 0:side]
        img = np.stack([np.sin(x / (17 + 5 * c) + y / 23) * 100 + 128 for c in range(3)], -1)
        img = img + rng.integers(-20, 20, (side, side, 3))
        write_png(os.path.join(root, sub, "frame0.png"), np.clip(img, 0, 255).astype(np.uint8))
    walls, bad = {}, []
    for name, script, flag, steps, sub in PARALLEL_CLI_RUNS:
        argv = [os.path.join(REPO, "scripts", "torch", f"{script}.py"),
                "--pretrained_model_name_or_path", pipe_dir, "--sdr_input_path",
                os.path.join(root, sub), "--output_dir", os.path.join(root, "out", name),
                "--num_inference_steps", str(steps), "--seed", str(args.seed)]
        if script == "generate_hdr":
            argv += ["--unet_ckpt", os.path.join(pipe_dir, "gm_unet")]
        if flag is None:
            argv = [sys.executable] + argv
        else:
            argv = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
                    "--nproc_per_node", str(n), "--master_addr", "localhost", "--master_port",
                    str(_free_port())] + argv + [flag, str(n)]
        t0 = time.perf_counter()
        _dist_spawn(argv, os.path.join(root, f"{name}.log"), 600, env=env)
        walls[name] = time.perf_counter() - t0
    for name, script, flag, _, _ in PARALLEL_CLI_RUNS:
        if flag is None:
            continue
        ref = next(r[0] for r in PARALLEL_CLI_RUNS if r[1] == script and r[2] is None)
        files = sorted(os.listdir(os.path.join(root, "out", ref)))
        row = {"phase": "parallel_cards", "part": "cli", "run": name, "script": script,
               "width": f"{flag} {n}", "wall_s": walls[name], "one_card_wall_s": walls[ref],
               "psnr_db": {}, "hdr_ok": {}}
        for f in files:
            a, b = (os.path.join(root, "out", d, f) for d in (name, ref))
            if not os.path.exists(a):
                bad.append(f"{name}: {f} not written")
            elif f.endswith(".png"):
                got, want = (torch.from_numpy(read_png(p).astype(np.float64) / 255) for p in (a, b))
                row["psnr_db"][f] = psnr01(got, want)
                if not row["psnr_db"][f] >= PSNR_MIN_DB:
                    bad.append(f"{name}: {f} {row['psnr_db'][f]} dB < {PSNR_MIN_DB}")
            else:
                got, want = read_hdr(a), read_hdr(b)
                row["hdr_ok"][f] = bool(got.shape == want.shape and np.isfinite(got).all())
                if not row["hdr_ok"][f]:
                    bad.append(f"{name}: {f} misshapen or not finite")
        emit(row)
    return bad


def _parallel_cards_train(args, root: str, env) -> list[str]:
    """train_gm_unet.py under torchrun on N cards (NCCL) for 2 steps at 512^2
    (EMA, remat, --train_batch_size 2: a global batch of 2 under both) on
    _parallel_cards_cli's directory: --shard_strategy tp --tp_size N and sp
    --sp_size N against one card. The step-1 loss within TRAIN_LOSS_RTOL of
    the one card's, 2 steps, the saved UNet as many elements. Returns the
    failures."""
    import torch

    from gmdx_torch.io.params import load_file

    n, pipe_dir = args.parallel_cards, os.path.join(root, "pipe")
    meta, _ = _train_cli_data(os.path.join(root, "train_data"), args.seed + 97)
    rows, bad = {}, []
    for name, mode in (("train_one_card", None), ("train_tp", "tp"), ("train_sp", "sp")):
        out = os.path.join(root, "out", name)
        argv = [os.path.join(REPO, "scripts", "torch", "train_gm_unet.py"),
                "--pretrained_model_name_or_path", pipe_dir, "--train_metadata", meta,
                "--output_dir", out, "--resolution", "512", "--train_batch_size", "2",
                "--max_train_steps", "2", "--seed", str(args.seed), "--center_crop",
                "--use_ema", "--gradient_checkpointing", "--dataloader_num_workers", "2"]
        if mode is None:
            argv = [sys.executable] + argv
        else:
            argv = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
                    "--nproc_per_node", str(n), "--master_addr", "localhost", "--master_port",
                    str(_free_port())] + argv + ["--shard_strategy", mode, f"--{mode}_size",
                                                 str(n)]
        t0 = time.perf_counter()
        _dist_spawn(argv, os.path.join(root, f"{name}.log"), 900, env=env)
        wall = time.perf_counter() - t0
        with open(os.path.join(out, "logs", "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        saved = load_file(os.path.join(out, "save_pipeline", "unet", "params.safetensors"))
        rows[name] = {"wall_s": wall, "losses": {m["step"]: m["train_loss"] for m in logged
                                                  if "train_loss" in m},
                      "unet_elements": sum(v.numel() if isinstance(v, torch.Tensor) else v.size
                                           for v in saved.values())}
        del saved
    one = rows["train_one_card"]
    for name in ("train_tp", "train_sp"):
        row = rows[name]
        rel = abs(row["losses"][1] - one["losses"][1]) / abs(one["losses"][1])
        emit({"phase": "parallel_cards", "part": "train_cli", "run": name, "cards": n,
              **row, "one_card": one, "loss_rel_err": rel, "rtol": TRAIN_LOSS_RTOL})
        if not (rel <= TRAIN_LOSS_RTOL and row["unet_elements"] == one["unet_elements"]):
            bad.append(f"{name}: step-1 loss rel {rel}, UNet elements {row['unet_elements']} "
                       f"vs {one['unet_elements']}")
    return bad


def phase_parallel_cards(args) -> None:
    """``--parallel-cards N`` (not part of the default run; N cards): a rank
    a card under NCCL (torchrun), TP = N and SP = N, against one process on
    one card: generate_hdr's path at 512^2, PNDM 50, as s/image under TP and
    SP; upconvert_hdrtv's at 1024^2, PNDM 50, as s/frame under SP; each
    after a 2-step warm-up; phase parallel's checks on every rank. Then the
    two CLIs themselves under torchrun (:func:`_parallel_cards_cli`), and
    the Stage-2 trainer under tp and sp (:func:`_parallel_cards_train`)."""
    import shutil

    root = tempfile.mkdtemp(prefix="gmdx_parallel_cards_")
    me = [os.path.join(REPO, "chip_smoke.py"), "--seed", str(args.seed), "--parallel-dir", root,
          "--parallel-cards", str(args.parallel_cards)]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    try:
        _dist_spawn([sys.executable] + me + ["--parallel-job", "ref"],
                    os.path.join(root, "ref.log"), 900, env=env)
        _dist_spawn([sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
                     "--nproc_per_node", str(args.parallel_cards), "--master_addr", "localhost",
                     "--master_port", str(_free_port())] + me + ["--parallel-job", "ranks"],
                    os.path.join(root, "ranks.log"), 1500, env=env)
        with open(os.path.join(root, "ref.json")) as f:
            ref = json.load(f)
        ranks = []
        for r in range(args.parallel_cards):
            with open(os.path.join(root, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        bad, _ = _parallel_check(ranks, ref, root, PARALLEL_CARDS_RUNS)
        summary = {}
        for name, mode, path, steps in PARALLEL_CARDS_RUNS:
            unit = "s_per_frame" if path == "hdrtv" else "s_per_image"
            summary[name] = {unit: max(r["runs"][name]["wall_s"] for r in ranks),
                             "one_card_" + unit: ref["runs"][name]["wall_s"],
                             "peak_mem_gb": max(r["runs"][name]["peak_mem_gb"] for r in ranks),
                             "one_card_peak_mem_gb": ref["runs"][name]["peak_mem_gb"]}
        emit({"phase": "parallel_cards", "cards": args.parallel_cards,
              "backend": ranks[0]["backend"], "world": ranks[0]["world"],
              "card": nvidia_smi_line(), **summary})
        bad += _parallel_cards_cli(args, root, env)
        bad += _parallel_cards_train(args, root, env)
        if bad:
            raise SystemExit("chip_smoke: parallel_cards failed its checks: " + "; ".join(bad))
    finally:
        shutil.rmtree(root, ignore_errors=True)


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
    # Phase dist's children (this script again): which part, and where.
    for flag in ("--dist-job", "--dist-dir", "--dist-pipe", "--dist-meta"):
        p.add_argument(flag, default=None, help=argparse.SUPPRESS)
    for flag in ("--dist-rank", "--dist-world", "--dist-port"):
        p.add_argument(flag, type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--dist-cards", type=int, default=0,
                   help="only the Stage-2 data-parallel check on this many cards, a rank a card "
                        "under NCCL, against one card, with s/step (not the default run)")
    # Phase parallel's children (this script again).
    for flag in ("--parallel-job", "--parallel-dir"):
        p.add_argument(flag, default=None, help=argparse.SUPPRESS)
    for flag in ("--parallel-rank", "--parallel-port"):
        p.add_argument(flag, type=int, default=0, help=argparse.SUPPRESS)
    # Phase train_parallel's children (this script again).
    for flag in ("--train-parallel-job", "--train-parallel-dir", "--train-parallel-pipe",
                 "--train-parallel-meta"):
        p.add_argument(flag, default=None, help=argparse.SUPPRESS)
    for flag in ("--train-parallel-rank", "--train-parallel-port"):
        p.add_argument(flag, type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--parallel-cards", type=int, default=0,
                   help="only tensor- and spatial-parallel serving over this many cards (TP = SP "
                        "= N), a rank a card under NCCL, against one card, with s/image and "
                        "s/frame at PNDM 50 (not the default run)")
    args = p.parse_args()

    if not os.path.isdir(os.path.join(REPO, "gmdx_torch")):
        raise SystemExit("chip_smoke: gmdx_torch/ not found beside this script")
    sys.path.insert(0, REPO)
    if args.dist_job:
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        {"ref": dist_job_ref, "ranks": dist_job_ranks, "cli": dist_job_cli}[args.dist_job](args)
        return 0
    if args.parallel_job or args.train_parallel_job:
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        (parallel_job if args.parallel_job else train_parallel_job)(args)
        return 0
    if args.parallel_cards:
        dev = phase_device()
        phase_build()
        phase_parallel_cards(args)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": dev["name"], "count": dev["count"]}}), flush=True)
        return 0
    if args.dist_cards:
        dev = phase_device()
        phase_build()
        phase_dist_cards(args)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": dev["name"], "count": dev["count"]}}), flush=True)
        return 0
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
    stage1_launches, stage1_per_pair = phase_stage1(args)
    phase_stage1_e2e(args)
    phase_stage1_e2e_d512_plain(args)
    phase_stage1_e2e_controls(args)
    phase_samplers(args)
    phase_samplers_e2e(args)
    workdir = tempfile.mkdtemp(prefix="gmdx_cli_")
    try:
        pipe_dir = phase_cli(args, workdir)
        phase_train_cli(args, pipe_dir, train_launches)
        phase_trainer_clis(args, pipe_dir, stage1_per_pair)
        phase_convert(args, pipe_dir)
        parallel_launches = phase_parallel(args)
        train_parallel_launches = phase_train_parallel(args, pipe_dir)
    finally:
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)

    summary = []
    for name, (source, replaces) in KERNELS.items():
        rows = [r for r in kernel_rows if r["name"] == name]
        head = rows[0]
        # Launches from the run of the path the kernel was ported for.
        n = (launches if name in INFERENCE_KERNELS
             else train_launches if name in TRAIN_KERNELS
             else hdrtv_launches if name in HDRTV_KERNELS
             else stage1_launches if name in STAGE1_KERNELS
             else parallel_launches if name in PARALLEL_KERNELS
             else train_parallel_launches if name in TRAIN_PARALLEL_KERNELS
             else sdr2hdr_launches)[name]
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
