"""DDIM scheduler: deterministic (eta = 0) or partly stochastic sampling.

Counterpart of ``gmdx/schedulers/ddim.py``: leading timestep spacing,
``set_alpha_to_one`` for the alpha_cumprod below t = 0, the ``clip_sample``
branch (which recomputes eps from the clipped x0), and with ``eta`` > 0 the
noise ``std = eta * sqrt(variance)``. The step is plain Python over a small
state object; its noise comes from a ``torch.Generator`` or is passed in.
Coefficients are float32 host scalars, so a step on the card makes no
host synchronisation.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gmdx_torch.schedulers import base
from gmdx_torch.schedulers.base import SchedulerConfig


@dataclasses.dataclass
class DDIMState:
    timesteps: list[int]  # descending
    step_ratio: int
    step_index: int = 0

    @property
    def timestep(self) -> int:
        return self.timesteps[self.step_index]


class DDIMScheduler:
    init_noise_sigma = 1.0

    def __init__(self, config: SchedulerConfig = SchedulerConfig()):
        self.config = config
        self.betas = base.make_betas(config)
        self.alphas_cumprod = np.cumprod(np.float32(1.0) - self.betas, dtype=np.float32)
        self.final_alpha_cumprod = (
            np.float32(1.0) if config.set_alpha_to_one else self.alphas_cumprod[0]
        )

    def add_noise(self, original: torch.Tensor, noise: torch.Tensor, timesteps) -> torch.Tensor:
        return base.add_noise(self.alphas_cumprod, original, noise, timesteps)

    def init_state(self, num_inference_steps: int) -> DDIMState:
        ts, step_ratio = base.leading_timesteps(self.config, num_inference_steps)
        return DDIMState(timesteps=[int(t) for t in ts], step_ratio=step_ratio)

    def step(
        self,
        state: DDIMState,
        model_output: torch.Tensor,
        sample: torch.Tensor,
        *,
        eta: float = 0.0,
        generator: torch.Generator | None = None,
        noise: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """One DDIM step; advances ``state`` and returns x_{t_prev}. With
        ``eta`` > 0 the fresh noise is ``noise`` or drawn from ``generator``."""
        t = state.timestep
        prev_t = t - state.step_ratio
        one = np.float32(1.0)
        alpha_t = self.alphas_cumprod[t]
        alpha_prev = self.alphas_cumprod[prev_t] if prev_t >= 0 else self.final_alpha_cumprod
        x0, eps = base.x0_eps_at(alpha_t, sample, model_output, self.config.prediction_type)
        if self.config.clip_sample:
            r = self.config.clip_sample_range
            x0 = x0.clamp(-r, r)
            eps = (sample - float(np.sqrt(alpha_t)) * x0) / float(np.sqrt(one - alpha_t))

        variance = (one - alpha_prev) / (one - alpha_t) * (one - alpha_t / alpha_prev)
        std = np.float32(eta) * np.sqrt(variance)
        prev_sample = (float(np.sqrt(alpha_prev)) * x0
                       + float(np.sqrt(one - alpha_prev - std**2)) * eps)
        if eta > 0.0:
            if noise is None:
                if generator is None:
                    raise ValueError(
                        "DDIMScheduler.step with eta > 0 needs a generator or an explicit "
                        "noise tensor (a fixed default would reuse one draw across all steps)"
                    )
                noise = torch.randn(sample.shape, generator=generator, device=sample.device,
                                    dtype=sample.dtype)
            prev_sample = prev_sample + float(std) * noise
        state.step_index += 1
        return prev_sample


__all__ = ["DDIMScheduler", "DDIMState"]
