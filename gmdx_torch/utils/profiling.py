"""Profiling and step timing: the counterpart of ``gmdx/utils/profiling.py``.

  * :class:`AverageMeter`, :class:`StepTimer`: the JAX package's meters,
    field for field (data time, step time, samples/s).
  * :func:`trace`: ``torch.profiler`` over a block, CPU activity and, with a
    card, CUDA activity, written as one Chrome trace per process (named by
    its ``torch.distributed`` rank when a group is up).
  * :func:`annotate`: a named host span that nests inside the trace.
  * :func:`sync`: waits until the device of every tensor leaf is finished.
  * :func:`device_memory_stats`: live, peak and total memory of each card.
  * :func:`read_trace`: one reading of a finished trace: device time by
    category (:data:`PROFILE_CATEGORIES`) and by kernel, the device's busy
    share over the traced window, and its longest idle gaps, each named by
    the host op and the :func:`annotate` span open where it began.
  * :func:`profile_fn`: one call traced and read beside its unprofiled
    wall (``chip_smoke.py --profile``).

``enable_compilation_cache`` has no counterpart: the port compiles no graph.
"""

from __future__ import annotations

import bisect
import contextlib
import gzip
import json
import os
import subprocess
import tempfile
import time
from typing import Dict, List, Optional

import torch


class AverageMeter:
    """Running average (the reference's ``train_vqgan_lora.py:71-87``)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class StepTimer:
    """Data-wait against step time, with samples/s.

    Per iteration::

        timer.mark_data()    # after the batch is fetched
        ... run the step ...
        timer.mark_step(batch_size)
    """

    def __init__(self):
        self.data_time = AverageMeter()
        self.batch_time = AverageMeter()
        self._t = time.perf_counter()
        self._samples = 0
        self._t0 = self._t

    def mark_data(self):
        now = time.perf_counter()
        self.data_time.update(now - self._t)
        self._t = now

    def mark_step(self, batch_size: int):
        now = time.perf_counter()
        self.batch_time.update(now - self._t)
        self._t = now
        self._samples += batch_size

    @property
    def samples_per_sec(self) -> float:
        dt = time.perf_counter() - self._t0
        return self._samples / dt if dt > 0 else 0.0

    def scalars(self) -> Dict[str, float]:
        return {
            "data_time": self.data_time.avg,
            "batch_time": self.batch_time.avg,
            "samples_per_sec": self.samples_per_sec,
        }


@contextlib.contextmanager
def trace(log_dir: str, *, prefix: str = ""):
    """Profile the block with ``torch.profiler`` (CPU activity, plus CUDA
    activity when a card is in use) and write its Chrome trace under
    ``log_dir`` as ``<prefix>rank<r>.trace.json`` inside a
    ``torch.distributed`` group, else ``<prefix>process.trace.json``; the
    block receives that path. Wrap a few steady-state steps, not the first
    call (kernel builds, cuDNN's plans)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    dist = torch.distributed
    who = f"rank{dist.get_rank()}" if dist.is_available() and dist.is_initialized() else "process"
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{prefix}{who}.trace.json")
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def annotate(name: str):
    """A named host span, nested in the active trace (a no-op outside one)."""
    with torch.profiler.record_function(name):
        yield


def _tensor_leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for sub in tree for t in _tensor_leaves(sub)]
    return []


def sync(tree):
    """Wait until the device of every tensor leaf of ``tree`` (nested dicts,
    lists and tuples) has finished its queued work, then return ``tree``
    unchanged, so that a call can be wrapped inline. Other leaves are
    ignored; CPU tensors are ready when they exist."""
    devices = {t.device for t in _tensor_leaves(tree) if t.is_cuda}
    for dev in sorted(devices, key=str):
        torch.cuda.synchronize(dev)
    return tree


def card_line() -> Optional[str]:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them, to
    stand beside every number measured on it; None without a card."""
    if not torch.cuda.is_available():
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def device_memory_stats() -> List[Optional[Dict[str, int]]]:
    """For each local card: ``bytes_in_use`` (allocated by the caching
    allocator), ``peak_bytes_in_use`` (since its last reset) and
    ``bytes_limit`` (the card's memory). Empty without a card."""
    if not torch.cuda.is_available():
        return []
    return [{"bytes_in_use": torch.cuda.memory_allocated(i),
             "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
             "bytes_limit": torch.cuda.get_device_properties(i).total_memory}
            for i in range(torch.cuda.device_count())]


# Device kernels by name, for the breakdown: (category, substrings), the
# first match wins.
PROFILE_CATEGORIES = (
    ("flash_attention_bsc", ("flash_bsc_kernel",)),
    ("flash_attention_fwd_d512", ("flash_fwd_wide_kernel",)),
    ("flash_attention_bwd_d512", ("flash_bwd_wide_",)),
    ("flash_attention_bwd", ("flash_bwd_",)),
    ("flash_attention_fwd", ("train_fwd_sm90_kernel",)),
    ("attention_kv_resident", ("kvres_sm90_kernel",)),
    # The split backward's fixed-order folds (gn_fold_kernel) serve both of
    # its entries; the split forward's stats and apply passes are the
    # pair's kernels, and land in group_norm_silu.
    ("group_norm_bwd_sums", ("gn_bwd_sums_", "gn_fold_kernel")),
    ("group_norm_bwd_apply", ("gn_bwd_apply_",)),
    ("group_norm_silu_bwd", ("gn_bwd_",)),
    ("group_norm_moments", ("gn_moments_",)),
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
    ("nccl collectives", ("nccl",)),
    ("foreach (optimizer, grad norms)", ("multi_tensor_apply",)),
    ("memcpy and memset", ("Memcpy", "Memset")),
    ("copies and casts", ("copy",)),
    ("layernorm", ("layer_norm", "GammaBeta")),
    ("reductions", ("reduce_kernel",)),
)
OTHER_CATEGORY = "other elementwise"

# Chrome-trace categories: work on the device, and the host events that
# name an idle gap.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_OP_CAT, SPAN_CAT = "cpu_op", "user_annotation"


def category(name: str) -> str:
    """The :data:`PROFILE_CATEGORIES` entry a device kernel's name falls in."""
    for cat, keys in PROFILE_CATEGORIES:
        if any(k in name for k in keys):
            return cat
    return OTHER_CATEGORY


def _load_events(path: str) -> list:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)["traceEvents"]


def _open_at(events: list, starts: list, t: float) -> Optional[dict]:
    """The innermost of ``events`` (sorted by start, ``starts`` their
    starts) whose span holds ``t``: the latest-starting one still open."""
    for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
        ev = events[i]
        if ev["ts"] + ev["dur"] > t:
            return ev
    return None


def read_trace(path: str, *, top: int = 25, gaps: int = 5,
               only_category: Optional[str] = None) -> dict:
    """One reading of a Chrome trace that :func:`trace` wrote.

    - ``window_ms``: the traced window (the profiler's own span);
    - ``device_ms``: the device events' summed time (kernels, copies,
      sets), ``by_category`` and ``top`` (kernels by name, largest first;
      ``only_category`` keeps that category's), each with its share of
      ``device_ms`` and its count;
    - ``busy_ms`` and ``busy_share``: the union of the device events over
      the window (None without device events);
    - ``idle_gaps``: the ``gaps`` longest stretches of the window in which
      no device event ran (before the first, between events, after the
      last), each with where it began (ms into the window), the innermost
      host op (``cpu_op``) and :func:`annotate` span open at that moment
      (None where none was);
    - ``spans``: each :func:`annotate` span's host ms and count.
    """
    events = [e for e in _load_events(path) if e.get("ph") == "X" and "dur" in e]
    window = [e for e in events if e.get("cat") == "Trace"]
    if window:
        w0, w1 = window[0]["ts"], window[0]["ts"] + window[0]["dur"]
    else:
        w0 = min(e["ts"] for e in events)
        w1 = max(e["ts"] + e["dur"] for e in events)
    device = sorted((e for e in events if e.get("cat") in DEVICE_CATS), key=lambda e: e["ts"])
    by_name: dict[str, list] = {}
    for e in device:
        row = by_name.setdefault(e["name"], [0.0, 0])
        row[0] += e["dur"]
        row[1] += 1
    total = sum(us for us, _ in by_name.values())
    cats: dict[str, list] = {}
    for name, (us, n) in by_name.items():
        row = cats.setdefault(category(name), [0.0, 0])
        row[0] += us
        row[1] += n
    share = (lambda us: us / total) if total else (lambda us: None)
    kernels = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    if only_category is not None:
        kernels = [kv for kv in kernels if category(kv[0]) == only_category]

    # The device's busy intervals, merged over its streams.
    busy, idle, cursor = 0.0, [], w0
    for e in device:
        s, f = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if f <= cursor:
            continue
        if s > cursor:
            idle.append((s - cursor, cursor))
            busy += f - s
        else:
            busy += f - cursor
        cursor = f
    if device and w1 > cursor:
        idle.append((w1 - cursor, cursor))
    idle.sort(key=lambda g: -g[0])
    host = {}
    for cat in (HOST_OP_CAT, SPAN_CAT):
        evs = sorted((e for e in events if e.get("cat") == cat), key=lambda e: e["ts"])
        host[cat] = (evs, [e["ts"] for e in evs])
    idle_gaps = []
    for us, at in idle[:gaps]:
        op, span = (_open_at(*host[c], at) for c in (HOST_OP_CAT, SPAN_CAT))
        idle_gaps.append({"ms": us / 1e3, "at_ms": (at - w0) / 1e3,
                          "host_op": None if op is None else op["name"],
                          "span": None if span is None else span["name"]})
    spans: dict[str, list] = {}
    for e in host[SPAN_CAT][0]:
        row = spans.setdefault(e["name"], [0.0, 0])
        row[0] += e["dur"]
        row[1] += 1
    return {
        "window_ms": (w1 - w0) / 1e3,
        "device_ms": total / 1e3,
        "busy_ms": busy / 1e3 if device else None,
        "busy_share": busy / (w1 - w0) if device and w1 > w0 else None,
        "by_category": [{"category": c, "device_ms": us / 1e3, "share": share(us), "count": n}
                        for c, (us, n) in sorted(cats.items(), key=lambda kv: -kv[1][0])],
        "top": [{"name": k, "category": category(k), "device_ms": us / 1e3,
                 "share": share(us), "count": n} for k, (us, n) in kernels[:top]],
        "idle_gaps": idle_gaps,
        "spans": [{"name": k, "host_ms": us / 1e3, "count": n}
                  for k, (us, n) in sorted(spans.items(), key=lambda kv: -kv[1][0])],
    }


def profile_fn(phase: str, one_step) -> dict:
    """Device time by kernel over one call of ``one_step`` (traced after a
    warm-up call and one timed without the profiler), and the device's busy
    share against that call's unprofiled wall: ``chip_smoke.py
    --profile``'s rows."""
    def run():
        one_step()
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory(prefix="gmdx_profile_") as d:
        with trace(d) as path:
            run()
        reading = read_trace(path, top=40)
    total = reading["device_ms"]
    return {"phase": phase, "wall_ms": wall_ms, "device_ms": total,
            "device_busy_share": total / wall_ms, "by_category": [
                {k: row[k] for k in ("category", "device_ms", "share", "count")}
                for row in reading["by_category"]], "top": [
                {"name": row["name"][:80], "device_ms": row["device_ms"], "share": row["share"],
                 "count": row["count"]} for row in reading["top"]]}


__all__ = [
    "AverageMeter",
    "StepTimer",
    "PROFILE_CATEGORIES",
    "annotate",
    "card_line",
    "category",
    "device_memory_stats",
    "profile_fn",
    "read_trace",
    "sync",
    "trace",
]
