"""Profiling and timing helpers (the counterpart of ``gmdx.utils``)."""

from gmdx_torch.utils.profiling import (
    PROFILE_CATEGORIES,
    AverageMeter,
    StepTimer,
    annotate,
    card_line,
    category,
    device_memory_stats,
    profile_fn,
    read_trace,
    sync,
    trace,
)

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
