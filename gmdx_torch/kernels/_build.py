"""Build the CUDA sources under ``gmdx_torch/csrc`` and load them with ctypes.

Each ``csrc/*.cu`` is compiled by its own ``nvcc`` process, all started
together, into ``build/gmdx_torch/<hash>/lib<name>.so`` at the repository
root, where ``<hash>`` covers every source and header and the compiler flags:
a changed source rebuilds, an unchanged one loads at once. The libraries have
a plain C interface: pointers and the stream are ``c_void_p``, and every entry
point returns ``cudaGetLastError()``.

Nothing is built at import. :func:`library` builds on first use, so a process
that never launches a kernel never needs ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC.parent.parent / "build" / "gmdx_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# Each C entry point: (library it lives in, argtypes). A library lib<name>.so
# is built from csrc/<name>.cu.
ENTRY_POINTS = {
    "gmdx_attention": ("attention", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
    "gmdx_flash_bsc": ("attention", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
    "gmdx_xattn": ("attention", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P]),
    "gmdx_xattn_plan": ("attention", [_I, _I, _I, _I, _I, _P]),
    "gmdx_attention_sm90_plan": ("attention", [_I, _I, _I, _I, _I, _I, _P]),
    "gmdx_add_ln": ("add_ln", [_P, _P, _P, _P, _P, _P, _I, _I, _F, _P]),
    "gmdx_add_ln_plan": ("add_ln", [_I, _I, _P]),
    "gmdx_wino4": ("winograd4", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "gmdx_wino4_plan": ("winograd4", [_I, _I, _I, _I, _I, _P]),
    "gmdx_conv3x3": (
        "conv3x3",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    ),
    "gmdx_group_norm_silu": (
        "groupnorm",
        [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I, _P],
    ),
    "gmdx_group_norm_plan": ("groupnorm", [_I, _I, _I, _I, _P]),
    "gmdx_group_norm_moments": ("groupnorm", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    "gmdx_group_norm_apply": ("groupnorm", [*[_P] * 6, *[_I] * 7, _P]),
    "gmdx_group_norm_silu_bwd": ("groupnorm", [*[_P] * 13, *[_I] * 9, _P]),
    "gmdx_group_norm_bwd_plan": ("groupnorm", [_I, _I, _I, _I, _P]),
    "gmdx_geglu_ff_ln": (
        "geglu_ff",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _P],
    ),
    "gmdx_geglu_ff": (
        "geglu_ff", [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    ),
    "gmdx_flash_fwd": (
        "flash_attention", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    ),
    "gmdx_flash_bwd": (
        "flash_attention",
        [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _P],
    ),
    "gmdx_flash_bwd_dd": ("flash_attention", [_P, _P, _P, _I, _I, _I, _I, _P]),
    "gmdx_wide_plan": ("flash_attention", [_I, _I, _I, _I, _I, _P]),
}
LIBRARIES = sorted({lib for lib, _ in ENTRY_POINTS.values()})
# gemm_sm90.cuh's TMA_MAP_REFUSED: cuTensorMapEncodeTiled refused a map.
TMA_MAP_REFUSED = -1

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# What the last build did: seconds and the compiler's resource report.
build_info: dict[str, object] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Path:
    """Compile every source (in parallel) unless this hash is built; returns
    the build directory."""
    out_dir = BUILD_ROOT / _source_hash()
    targets = {name: out_dir / f"lib{name}.so" for name in LIBRARIES}
    if all(t.exists() for t in targets.values()):
        return out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, target in targets.items():
        tmp = target.with_suffix(f".so.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True
            ),
            tmp,
        )
    failed, reports = [], {}
    for name, (proc, tmp) in procs.items():
        out, err = proc.communicate()
        reports[name] = (out + err).strip()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (exit {proc.returncode})\n{err}")
        else:
            os.replace(tmp, targets[name])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    build_info["seconds"] = time.perf_counter() - t0
    build_info["ptxas"] = reports
    return out_dir


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, built on first use, with the
    argument types of its entry points set."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build_all() / f"lib{name}.so"))
            for fn_name, (lib_name, argtypes) in ENTRY_POINTS.items():
                if lib_name == name:
                    fn = getattr(lib, fn_name)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def call(fn_name: str, *args) -> None:
    """Launch the entry point ``fn_name`` and raise on a non-zero CUDA error."""
    err = getattr(library(ENTRY_POINTS[fn_name][0]), fn_name)(*args)
    if err == TMA_MAP_REFUSED:
        raise RuntimeError(f"{fn_name} failed: cuTensorMapEncodeTiled refused a TMA tensor map")
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {err}")
