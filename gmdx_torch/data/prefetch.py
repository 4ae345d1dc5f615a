"""Device prefetch: the next batches' host-to-device copies run while the
current step computes.

Counterpart of ``gmdx/data/prefetch.py``. A producer thread pins each host
batch and copies it to ``device`` with ``non_blocking`` on a side stream,
``depth`` batches ahead of the consumer; the consumer's stream waits on
each batch's copy (``wait_stream``) and each tensor is marked as used there
(``record_stream``), so neither the step nor the allocator can run ahead of
the copy. The pinned host buffers come from PyTorch's caching host
allocator, which hands a buffer out again only after the copies recorded
on it have ended. Loader
errors are raised in the consumer, and the producer stops when the
consumer leaves its loop. On the CPU the batches pass through as tensors.
In a process group a card request (``"cuda"``) means this rank's own card,
``cuda:<local rank>``, so each rank's rows land on its card.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from gmdx_torch import resolve_device
from gmdx_torch.dist.multihost import device as dist_device


def _tensor(value) -> torch.Tensor:
    return value if isinstance(value, torch.Tensor) else torch.from_numpy(np.asarray(value))


def device_prefetch(loader, device: str | torch.device = "cuda", depth: int = 2) -> Iterator:
    """Wrap an iterator of {name: array} host batches; yields {name: tensor}
    batches on ``device``, at most ``depth`` of them resident ahead."""
    if depth < 1:
        raise ValueError(f"depth must be >= 1, got {depth}")
    dev = dist_device(resolve_device(device))
    q: queue.Queue = queue.Queue(maxsize=depth)
    end = object()
    stop = threading.Event()
    copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def place(batch: dict):
        host = {k: _tensor(v) for k, v in batch.items()}
        if copy_stream is None:
            return host, None
        host = {k: v.pin_memory() for k, v in host.items()}
        with torch.cuda.stream(copy_stream):
            out = {k: v.to(dev, non_blocking=True) for k, v in host.items()}
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done

    def producer():
        try:
            for batch in loader:
                if not put(place(batch)):
                    return
        except BaseException as e:  # noqa: BLE001 -- raised in the consumer
            put(e)
        else:
            put(end)

    threading.Thread(target=producer, daemon=True).start()

    def gen():
        try:
            while True:
                item = q.get()
                if item is end:
                    return
                if isinstance(item, BaseException):
                    raise item
                batch, done = item
                if done is not None:
                    compute = torch.cuda.current_stream(dev)
                    compute.wait_event(done)
                    for t in batch.values():
                        t.record_stream(compute)
                yield batch
        finally:
            stop.set()
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass

    return gen()


__all__ = ["device_prefetch"]
