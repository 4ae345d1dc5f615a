"""gmdx_torch.utils.profiling against gmdx.utils.profiling, on the CPU.

The meters run the same updates under one patched clock and must hold the
same numbers as gmdx's; ``sync`` takes the cases of ``tests/test_utils.py``;
a CPU trace's ``annotate`` spans must reach the reader; the reader's busy
share and idle gaps are read off a trace written by hand; and every kernel
of ``gmdx_torch/csrc`` falls in the category of the launch count its
wrapper keeps.
"""

import json
import pathlib
import re
import time

import pytest
import torch

from gmdx.utils import AverageMeter as JaxAverageMeter
from gmdx.utils import StepTimer as JaxStepTimer
from gmdx_torch.kernels import LAUNCHES
from gmdx_torch.utils import (
    PROFILE_CATEGORIES, AverageMeter, StepTimer, annotate, category, device_memory_stats,
    read_trace, sync, trace,
)
from gmdx_torch.utils.profiling import OTHER_CATEGORY

CSRC = pathlib.Path(__file__).resolve().parent.parent / "gmdx_torch" / "csrc"

# The kernels each counted wrapper launches (kernels, or the GEMM core's
# instance structs, of gmdx_torch/csrc), and the category its device time
# lands in: the split GroupNorm's passes share the one-rank pair's kernels.
LAUNCH_KERNELS = {
    "attention_kv_resident": ("kvres_sm90_kernel",),
    "conv3x3": ("ConvOp", "splitk_reduce_kernel"),
    "group_norm_silu": ("gn_cluster_kernel", "gn_stats_kernel", "gn_apply_kernel"),
    "group_norm_moments": ("gn_moments_kernel",),
    "group_norm_apply": ("gn_apply_kernel",),
    "geglu_ff_ln": ("Gemm1Op", "Gemm2Op", "ln_rows_kernel"),
    "flash_attention_fwd": ("train_fwd_sm90_kernel",),
    "flash_attention_fwd_d512": ("flash_fwd_wide_kernel",),
    "flash_attention_bsc": ("flash_bsc_kernel",),
    "flash_attention_bwd": ("flash_bwd_dd_kernel", "flash_bwd_dkv_kernel", "flash_bwd_dq_kernel"),
    "flash_attention_bwd_d512": ("flash_bwd_wide_dv_kernel", "flash_bwd_wide_dk_kernel",
                                 "flash_bwd_wide_dq_kernel"),
    "group_norm_silu_bwd": ("gn_bwd_kernel",),
    "group_norm_bwd_sums": ("gn_bwd_sums_kernel", "gn_fold_kernel"),
    "group_norm_bwd_apply": ("gn_bwd_apply_kernel",),
    "cross_attention_shortk": ("xattn_sm90_kernel",),
    "add_layer_norm": ("add_ln_ring_kernel",),
    "geglu_ff": ("NoLnGegluOp", "NoLnOutOp"),
    "winograd4_conv3x3": ("wino4_input_kernel", "Wino4Op", "wino4_output_kernel"),
}
SHARED = {"group_norm_apply": "group_norm_silu"}


class _Clock:
    def __init__(self):
        self.now = 100.0

    def __call__(self):
        return self.now


def test_average_meter_matches_gmdx():
    ours, theirs = AverageMeter(), JaxAverageMeter()
    for val, n in ((2.0, 1), (4.0, 3), (0.5, 2), (7.25, 1)):
        ours.update(val, n)
        theirs.update(val, n)
        assert vars(ours) == vars(theirs)
    ours.reset()
    theirs.reset()
    assert vars(ours) == vars(theirs) == {"val": 0.0, "avg": 0.0, "sum": 0.0, "count": 0}


def test_step_timer_matches_gmdx(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(time, "perf_counter", clock)
    ours, theirs = StepTimer(), JaxStepTimer()
    for data_s, step_s, batch in ((0.25, 1.5, 8), (0.125, 1.25, 8), (0.5, 2.0, 4)):
        clock.now += data_s
        ours.mark_data()
        theirs.mark_data()
        clock.now += step_s
        ours.mark_step(batch)
        theirs.mark_step(batch)
        assert vars(ours.data_time) == vars(theirs.data_time)
        assert vars(ours.batch_time) == vars(theirs.batch_time)
        assert ours.scalars() == theirs.scalars()
    assert ours.samples_per_sec == theirs.samples_per_sec == 20 / 5.625
    assert ours.batch_time.count == 3 and ours.data_time.avg == pytest.approx(0.875 / 3)


def test_sync_returns_tree_unchanged():
    tree = {"a": torch.arange(4.0), "b": (torch.zeros(2, 3), None, 7)}
    assert sync(tree) is tree


def test_sync_blocks_on_computation():
    y = sync(torch.full((128,), 3.0) * 2.0)
    assert float(y[0]) == 6.0


def test_sync_empty_and_scalar_leaves():
    sync({"empty": torch.zeros(0, 4), "scalar": torch.tensor(1.5)})


def test_sync_non_array_leaves_ignored():
    tree = ["string", 3, None, {"k": torch.ones(2)}]
    assert sync(tree) is tree


def test_device_memory_stats_without_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert device_memory_stats() == []


def test_cpu_trace_spans_reach_the_reader(tmp_path):
    x = torch.randn(64, 64)
    with trace(str(tmp_path), prefix="t_") as path:
        with annotate("outer"):
            for _ in range(3):
                with annotate("inner"):
                    x = torch.tanh(x @ x)
    assert path == str(tmp_path / "t_process.trace.json")
    reading = read_trace(path)
    spans = {s["name"]: s for s in reading["spans"]}
    assert spans["outer"]["count"] == 1 and spans["inner"]["count"] == 3
    assert 0 < spans["inner"]["host_ms"] <= spans["outer"]["host_ms"] <= reading["window_ms"]
    assert reading["device_ms"] == 0.0 and reading["busy_share"] is None
    assert reading["idle_gaps"] == [] and reading["top"] == []


def _x(cat, name, ts, dur, **kw):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 0, **kw}


def test_reader_busy_share_and_idle_gaps(tmp_path):
    """Kernels on two streams overlap; the gaps are named by the host op and
    span open where each begins."""
    events = [
        _x("Trace", "PyTorch Profiler (0)", 1000.0, 100.0),
        _x("user_annotation", "step", 1000.0, 90.0),
        _x("cpu_op", "aten::conv2d", 1005.0, 10.0),
        _x("cpu_op", "aten::cat", 1030.0, 20.0),
        _x("cpu_op", "aten::copy_", 1035.0, 2.0),
        _x("kernel", "void ws_gemm_kernel<ConvOp<320>>(Args)", 1010.0, 20.0),
        _x("kernel", "kvres_sm90_kernel<40>", 1025.0, 10.0),  # overlaps the conv
        _x("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 1060.0, 5.0),
        _x("kernel", "elementwise_kernel", 1080.0, 10.0),
        {"ph": "i", "name": "marker", "ts": 1050.0},
    ]
    path = tmp_path / "hand.trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    r = read_trace(str(path), gaps=3)
    assert r["window_ms"] == pytest.approx(0.1)
    assert r["device_ms"] == pytest.approx(0.045)
    assert r["busy_ms"] == pytest.approx(0.04)  # 1010-1035, 1060-1065, 1080-1090
    assert r["busy_share"] == pytest.approx(0.4)
    gaps = [(g["ms"], g["at_ms"], g["host_op"], g["span"]) for g in r["idle_gaps"]]
    assert gaps == [(pytest.approx(0.025), pytest.approx(0.035), "aten::copy_", "step"),
                    (pytest.approx(0.015), pytest.approx(0.065), None, "step"),
                    (pytest.approx(0.01), pytest.approx(0.0), None, "step")]
    cats = {c["category"]: c for c in r["by_category"]}
    assert cats["conv3x3"]["device_ms"] == pytest.approx(0.02)
    assert cats["attention_kv_resident"]["count"] == 1
    assert cats["memcpy and memset"]["share"] == pytest.approx(5 / 45)
    assert [t["name"][:20] for t in r["top"]] == ["void ws_gemm_kernel<", "kvres_sm90_kernel<40",
                                                  "elementwise_kernel", "Memcpy DtoD (Device "]
    only = read_trace(str(path), only_category="conv3x3")["top"]
    assert [t["category"] for t in only] == ["conv3x3"]


def test_every_launch_count_has_a_category():
    """Every wrapper's kernels are kernels of csrc, and their device time
    lands in that wrapper's category (or the kernel's owner's)."""
    assert set(LAUNCH_KERNELS) == set(LAUNCHES)
    names = {c for c, _ in PROFILE_CATEGORIES}
    assert set(LAUNCHES) - set(SHARED) <= names
    source = "\n".join(p.read_text() for p in sorted(CSRC.glob("*.cu*")))
    for key, kernels in LAUNCH_KERNELS.items():
        for k in kernels:
            assert re.search(rf"(__global__[^;{{]*\b{k}\s*\(|struct {k}\b)", source), k
            assert category(k) == SHARED.get(key, key), (key, k, category(k))
    every = set(re.findall(r"__global__[^;{]*?\b(\w+_kernel)\s*\(", source))
    assert every - {"ws_gemm_kernel"} <= {k for ks in LAUNCH_KERNELS.values() for k in ks}
    assert category("ncclDevKernel_AllReduce_Sum_bf16_RING_LL") != OTHER_CATEGORY
