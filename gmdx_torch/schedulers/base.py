"""Shared scheduler tables: beta schedules, alphas_cumprod, timestep grids.

Counterpart of ``gmdx/schedulers/base.py`` (a copy of what the port needs).
Tables are float32 numpy arrays computed on the host, as the JAX package
computes them in float32; SD-1.5 defaults: scaled_linear betas
0.00085 -> 0.012 over 1000 train steps, epsilon prediction, steps_offset 1,
set_alpha_to_one False.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # "linear" | "scaled_linear" | "squaredcos_cap_v2"
    prediction_type: str = "epsilon"  # "epsilon" | "v_prediction" | "sample"
    steps_offset: int = 1
    set_alpha_to_one: bool = False


def make_betas(config: SchedulerConfig) -> np.ndarray:
    """The beta table (float32, [num_train_timesteps])."""
    n = config.num_train_timesteps
    if config.beta_schedule == "linear":
        return np.linspace(config.beta_start, config.beta_end, n, dtype=np.float32)
    if config.beta_schedule == "scaled_linear":
        return np.linspace(
            config.beta_start**0.5, config.beta_end**0.5, n, dtype=np.float32
        ) ** 2
    if config.beta_schedule == "squaredcos_cap_v2":
        def alpha_bar(t):
            return math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2

        return np.asarray(
            [min(1 - alpha_bar((i + 1) / n) / alpha_bar(i / n), 0.999) for i in range(n)],
            dtype=np.float32,
        )
    raise ValueError(f"unknown beta_schedule {config.beta_schedule!r}")


def alphas_cumprod_from_config(config: SchedulerConfig) -> np.ndarray:
    return np.cumprod(np.float32(1.0) - make_betas(config), dtype=np.float32)


def leading_timesteps(config: SchedulerConfig, num_inference_steps: int) -> tuple[np.ndarray, int]:
    """'leading' spacing: arange(N) * (T // N) + steps_offset, descending.
    Returns (timesteps[int64, N], step_ratio)."""
    step_ratio = config.num_train_timesteps // num_inference_steps
    ts = np.arange(num_inference_steps, dtype=np.int64) * step_ratio + config.steps_offset
    return ts[::-1].copy(), step_ratio


__all__ = [
    "SchedulerConfig",
    "make_betas",
    "alphas_cumprod_from_config",
    "leading_timesteps",
]
