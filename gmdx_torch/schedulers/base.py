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
import torch


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"  # "linear" | "scaled_linear" | "squaredcos_cap_v2"
    prediction_type: str = "epsilon"  # "epsilon" | "v_prediction" | "sample"
    steps_offset: int = 1
    set_alpha_to_one: bool = False
    clip_sample: bool = False
    clip_sample_range: float = 1.0
    timestep_spacing: str = "leading"  # "leading" | "linspace" | "trailing"


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


def _extract(table: torch.Tensor, t: torch.Tensor | int, ref: torch.Tensor) -> torch.Tensor:
    """Per-sample values of a 1-D table at ``t`` (scalar or leading-dim
    integers), on ``ref``'s device and right-padded to broadcast against it."""
    vals = torch.as_tensor(table, device=ref.device)[torch.as_tensor(t, device=ref.device)]
    return vals.reshape(vals.shape + (1,) * (ref.ndim - vals.ndim))


def add_noise(
    alphas_cumprod, original: torch.Tensor, noise: torch.Tensor, timesteps
) -> torch.Tensor:
    """Forward q(x_t | x_0): ``sqrt(acp_t) x0 + sqrt(1 - acp_t) eps``."""
    acp = torch.as_tensor(alphas_cumprod, dtype=torch.float32)
    a = _extract(acp.sqrt(), timesteps, original)
    s = _extract((1.0 - acp).sqrt(), timesteps, original)
    return a * original + s * noise


def get_velocity(
    alphas_cumprod, sample: torch.Tensor, noise: torch.Tensor, timesteps
) -> torch.Tensor:
    """v-prediction target ``sqrt(acp_t) eps - sqrt(1 - acp_t) x0``."""
    acp = torch.as_tensor(alphas_cumprod, dtype=torch.float32)
    a = _extract(acp.sqrt(), timesteps, sample)
    s = _extract((1.0 - acp).sqrt(), timesteps, sample)
    return a * noise - s * sample


def predict_x0(
    alphas_cumprod, sample: torch.Tensor, model_output: torch.Tensor, t, prediction_type: str
) -> torch.Tensor:
    """x0 from the model output under the configured parameterization."""
    a = _extract(torch.as_tensor(alphas_cumprod, dtype=torch.float32), t, sample)
    if prediction_type == "epsilon":
        return (sample - (1.0 - a).sqrt() * model_output) / a.sqrt()
    if prediction_type == "v_prediction":
        return a.sqrt() * sample - (1.0 - a).sqrt() * model_output
    if prediction_type == "sample":
        return model_output
    raise ValueError(f"unknown prediction_type {prediction_type!r}")


def predict_eps(
    alphas_cumprod, sample: torch.Tensor, model_output: torch.Tensor, t, prediction_type: str
) -> torch.Tensor:
    """eps from the model output under the configured parameterization."""
    a = _extract(torch.as_tensor(alphas_cumprod, dtype=torch.float32), t, sample)
    if prediction_type == "epsilon":
        return model_output
    if prediction_type == "v_prediction":
        return a.sqrt() * model_output + (1.0 - a).sqrt() * sample
    if prediction_type == "sample":
        return (sample - a.sqrt() * model_output) / (1.0 - a).sqrt()
    raise ValueError(f"unknown prediction_type {prediction_type!r}")


def x0_eps_at(
    alpha_prod_t: np.float32, sample: torch.Tensor, model_output: torch.Tensor,
    prediction_type: str,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(x0, eps) from the model output at one timestep whose alpha_cumprod is
    the host scalar ``alpha_prod_t``: the coefficients are float32 scalars,
    as the JAX package computes them, and no table goes to the device."""
    a = np.float32(alpha_prod_t)
    sa, sb = float(np.sqrt(a)), float(np.sqrt(np.float32(1.0) - a))
    if prediction_type == "epsilon":
        return (sample - sb * model_output) / sa, model_output
    if prediction_type == "v_prediction":
        return sa * sample - sb * model_output, sa * model_output + sb * sample
    if prediction_type == "sample":
        return model_output, (sample - sa * model_output) / sb
    raise ValueError(f"unknown prediction_type {prediction_type!r}")


def split_kwargs(kwargs: dict) -> tuple[SchedulerConfig, dict]:
    """JAX-style scheduler keyword arguments -> (the SchedulerConfig of its
    fields, the constructor's other arguments)."""
    names = {f.name for f in dataclasses.fields(SchedulerConfig)}
    return (SchedulerConfig(**{k: v for k, v in kwargs.items() if k in names}),
            {k: v for k, v in kwargs.items() if k not in names})


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
    "add_noise",
    "get_velocity",
    "predict_x0",
    "predict_eps",
    "leading_timesteps",
    "x0_eps_at",
    "split_kwargs",
]
