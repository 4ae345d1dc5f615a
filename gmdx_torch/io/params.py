"""Param-tree files: safetensors with '/'-joined key paths, read and written
with numpy.

Counterpart of ``gmdx/io/params.py``, without the ``safetensors`` package
(which the card's machine lacks). The container: an 8-byte little-endian
header length, a JSON header mapping each key to its ``dtype``, ``shape``
and ``data_offsets`` (byte range in the buffer; an optional
``__metadata__`` of strings), padded with spaces to a multiple of 8, then
the raw little-endian buffer. The writer writes F32, F16, I32 and I64, and
BF16 from ``torch.bfloat16`` tensors; the reader takes the same (BF16 into
``torch.bfloat16``). Any other dtype raises.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any

import numpy as np
import torch

_NP_DTYPES = {"F32": np.float32, "F16": np.float16, "I32": np.int32, "I64": np.int64}
_WRITABLE = {np.dtype(np.float32): "F32", np.dtype(np.float16): "F16",
             np.dtype(np.int32): "I32", np.dtype(np.int64): "I64"}


def flatten_tree(tree: dict, sep: str = "/") -> dict[str, Any]:
    """Nested dicts -> {joined path: leaf}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}{sep}{p}": leaf for p, leaf in flatten_tree(v, sep).items()})
        else:
            out[str(k)] = v
    return out


def unflatten_tree(flat: dict[str, Any], sep: str = "/") -> dict:
    tree: dict = {}
    for path, value in flat.items():
        parts = path.split(sep)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return tree


def _as_numpy(key: str, value) -> tuple[np.ndarray, str]:
    """(little-endian C-contiguous array, safetensors dtype); a bfloat16
    tensor's bits come as uint16."""
    name = None
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            value, name = value.view(torch.int16), "BF16"
        value = value.numpy()
    arr = np.asarray(value)
    if name is None:
        if arr.dtype not in _WRITABLE:
            raise ValueError(f"{key}: dtype {arr.dtype} not writable (F32, F16, I32, I64, BF16)")
        name = _WRITABLE[arr.dtype]
    out = np.asarray(arr, dtype=arr.dtype.newbyteorder("<"))
    return (out if out.flags.c_contiguous else out.copy(order="C")), name  # keeps 0-d shapes


def save_file(tensors: dict[str, Any], path: str) -> None:
    """Write ``tensors`` (numpy arrays or torch tensors on any device) as one
    safetensors file."""
    header: dict[str, Any] = {}
    # Wider dtypes first, as the safetensors package orders them, so that
    # every buffer starts aligned to its element size.
    arrays = dict(sorted(((k, _as_numpy(k, v)) for k, v in tensors.items()),
                         key=lambda kv: (-kv[1][0].itemsize, kv[0])))
    offset = 0
    for k, (a, name) in arrays.items():
        header[k] = {"dtype": name, "shape": list(a.shape),
                     "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for a, _ in arrays.values():
            f.write(a.reshape(-1).data)


def load_file(path: str, pin_memory: bool = False) -> dict[str, Any]:
    """Read a safetensors file: {key: numpy array}, BF16 entries as
    ``torch.bfloat16`` tensors. An unknown dtype raises, naming the key.
    With ``pin_memory`` the arrays are views of one pinned buffer, so that
    copies of them to the card run at the link's rate."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        size = os.fstat(f.fileno()).st_size - 8 - n
        if pin_memory:
            buf = torch.empty(size, dtype=torch.uint8, pin_memory=True).numpy()
        else:
            buf = bytearray(size)
        f.readinto(buf)
    out = {}
    for key, info in header.items():
        if key == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        shape, dtype = tuple(info["shape"]), info["dtype"]
        # Writable views into one buffer: no copy per tensor.
        if dtype == "BF16":
            out[key] = torch.frombuffer(buf, dtype=torch.bfloat16, count=(end - begin) // 2,
                                        offset=begin).reshape(shape)
        elif dtype in _NP_DTYPES:
            le = np.dtype(_NP_DTYPES[dtype]).newbyteorder("<")
            out[key] = np.frombuffer(buf, le, count=(end - begin) // le.itemsize,
                                     offset=begin).reshape(shape)
        else:
            raise ValueError(f"{path}: tensor {key!r} has dtype {dtype!r}, which the reader "
                             f"does not take ({sorted(_NP_DTYPES) + ['BF16']})")
    return out


def save_params(path: str, params: Any) -> None:
    """Write a param tree (nested dicts) to a .safetensors file."""
    save_file(flatten_tree(params), path)


def load_params(path: str) -> dict:
    """Load a .safetensors file back into a nested dict of arrays."""
    return unflatten_tree(load_file(path))


__all__ = ["flatten_tree", "unflatten_tree", "save_file", "load_file", "save_params",
           "load_params"]
