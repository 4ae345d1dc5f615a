"""Save and restore times of the Stage-2 training state: the counterpart of
``scripts/tools/ckpt_timing.py``.

Measures the device->host rate into pageable and into pinned memory (one
256 MiB buffer each way), builds the Stage-2 state at ``--width`` times
SD-1.5's channel widths (the 8-channel GM UNet's fp32 parameters, AdamW's
two moments filled with seeded values, and with ``--with-ema`` the EMA
shadow), and times it through the port's own checkpoints
(``gmdx_torch.train.checkpoint``: ``make_manager``, ``save_state``,
``restore_state``): a synchronous save, an asynchronous one (the seconds
that block the training loop, and those until the files are durable), and
a restore into the state after its tensors were zeroed; the restored
state's ``state_digest`` must equal the saved one. Prints the state's size
and its full-width extrapolation (by the parameter count of the SD-1.5 GM
UNet), one JSON line, and the card's name and power limit.

    python scripts/torch/ckpt_timing.py [--width 0.3] [--with-ema] [--steps-during-save 20]
    python scripts/torch/ckpt_timing.py --width 0.1 --device cpu

``--out`` keeps the checkpoints there; by default they go to a temporary
directory, removed at the end.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import torch  # noqa: E402

FULL_WIDTHS = (320, 640, 1280, 1280)
PROBE_BYTES = 256 * 2**20


def scaled_config(width: float):
    """The SD-1.5 GM UNet's config at ``width`` times its channels (each a
    multiple of 32, at least 32), as the JAX tool scales it."""
    from gmdx_torch.models import SD15_GM_UNET_CONFIG

    widths = tuple(max(32, int(round(c * width / 32)) * 32) for c in FULL_WIDTHS)
    return dataclasses.replace(SD15_GM_UNET_CONFIG, block_out_channels=widths)


def d2h_rates(dev) -> dict:
    """MB/s of one 256 MiB device->host copy into pageable memory and into
    pinned memory (after one copy of each as a warm-up)."""
    src = torch.zeros(PROBE_BYTES // 4, dtype=torch.float32, device=dev)
    pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    rates = {}
    for kind, copy in (("pageable", lambda: src.cpu()),
                       ("pinned", lambda: pinned.copy_(src, non_blocking=True))):
        copy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        copy()
        torch.cuda.synchronize()
        rates[f"d2h_{kind}_mb_per_s"] = PROBE_BYTES / 2**20 / (time.perf_counter() - t0)
    return rates


def build_state(width: float, with_ema: bool, dev):
    """The Stage-2 state at ``width`` on ``dev``: parameters seeded, the
    moments filled with seeded values (so that a restore has bits to bring
    back), the EMA a copy of the parameters."""
    from gmdx_torch.models import UNet2DConditionModel
    from gmdx_torch.train import Stage2Config, init_state

    torch.manual_seed(0)
    with torch.device(dev):
        unet = UNet2DConditionModel(scaled_config(width))
    state = init_state(Stage2Config(use_ema=with_ema), unet)
    g = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        for mu, nu in zip(state.optimizer.mu, state.optimizer.nu):
            mu.copy_(torch.randn(mu.shape, generator=g, device=dev) * 1e-3)
            nu.copy_(mu.float() ** 2)
    return state


def full_width_params() -> int:
    """The SD-1.5 GM UNet's parameter count (built on the meta device)."""
    from gmdx_torch.models import SD15_GM_UNET_CONFIG, UNet2DConditionModel

    with torch.device("meta"):
        return sum(p.numel() for p in UNet2DConditionModel(SD15_GM_UNET_CONFIG).parameters())


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    from gmdx_torch import resolve_device
    from gmdx_torch.train import make_manager, restore_state, save_state
    from gmdx_torch.train.checkpoint import state_digest, state_tensors
    from gmdx_torch.utils import card_line

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--width", type=float, default=0.3)
    ap.add_argument("--out", default=None,
                    help="checkpoint directory to keep (default: a temporary one, removed)")
    ap.add_argument("--steps-during-save", type=int, default=0,
                    help="dispatch N 4096^2 bf16 matmuls on the card while the asynchronous "
                    "write streams, to show the loop keeps running")
    ap.add_argument("--with-ema", action="store_true",
                    help="an EMA shadow in the state (a third parameter-sized set)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    row = {"tool": "ckpt_timing", "width": args.width, "with_ema": args.with_ema,
           "device": str(dev), "card": card_line() if dev.type == "cuda" else None}
    if dev.type == "cuda":
        row.update(d2h_rates(dev))
        print(f"device->host: {row['d2h_pageable_mb_per_s']:.1f} MB/s pageable, "
              f"{row['d2h_pinned_mb_per_s']:.1f} MB/s pinned (256 MiB)", flush=True)

    state = build_state(args.width, args.with_ema, dev)
    tensors, _ = state_tensors(state)
    nbytes = sum(t.numel() * t.element_size() for t in tensors.values())
    params = sum(p.numel() for p in state.unet.parameters())
    full_gb = nbytes * full_width_params() / params / 1e9
    row.update(state_mb=nbytes / 2**20, state_tensors=len(tensors), unet_params=params,
               full_width_state_gb=full_gb)
    print(f"state at width {args.width:g}: {nbytes / 2**20:.1f} MB in {len(tensors)} tensors "
          f"(full width: {full_gb:.2f} GB)", flush=True)

    root = args.out or tempfile.mkdtemp(prefix="gmdx_ckpt_timing_")
    try:
        for mode in ("sync", "async"):
            out = os.path.join(root, mode)
            shutil.rmtree(out, ignore_errors=True)
            mgr = make_manager(out, async_checkpointing=(mode == "async"))
            _sync(dev)
            t0 = time.perf_counter()
            digest = save_state(mgr, 1, state, wait=(mode == "sync"))
            t_block = time.perf_counter() - t0
            if mode == "async" and args.steps_during_save and dev.type == "cuda":
                a = torch.randn(4096, 4096, device=dev, dtype=torch.bfloat16)
                t1 = time.perf_counter()
                for _ in range(args.steps_during_save):
                    a = (a @ a).tanh_()
                torch.cuda.synchronize(dev)
                row["steps_during_save_s"] = time.perf_counter() - t1
            mgr.wait_until_finished()
            t_total = time.perf_counter() - t0
            row[f"{mode}_save_block_s"], row[f"{mode}_save_durable_s"] = t_block, t_total
            print(f"{mode} save: blocks the loop {t_block:.3f} s, durable at {t_total:.3f} s "
                  f"({nbytes / 2**20 / t_total:.1f} MB/s)", flush=True)

        with torch.no_grad():  # the restore has every bit to bring back
            for t in tensors.values():
                t.zero_()
        _sync(dev)
        t0 = time.perf_counter()
        restore_state(mgr, 1, state)
        _sync(dev)
        row["restore_s"] = time.perf_counter() - t0
        row["round_trip_digest_equal"] = state_digest(state) == digest
        print(f"restore: {row['restore_s']:.3f} s "
              f"({nbytes / 2**20 / row['restore_s']:.1f} MB/s); round trip "
              f"{'verified' if row['round_trip_digest_equal'] else 'FAILED'}", flush=True)
    finally:
        if args.out is None:
            shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(row), flush=True)
    if not row["round_trip_digest_equal"]:
        raise SystemExit("ckpt_timing: the restored state's digest differs from the saved one")
    return row


if __name__ == "__main__":
    main()
