"""DDPM (ancestral) scheduler: the training noising table and the sampler step.

Counterpart of ``gmdx/schedulers/ddpm.py``: fixed-small posterior variance,
leading timestep spacing, and below t = 0 an alpha_cumprod of 1, as
diffusers' DDPMScheduler has it. The step is plain Python over a small state
object; its ancestral noise comes from a ``torch.Generator`` or is passed in.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gmdx_torch.schedulers import base
from gmdx_torch.schedulers.base import SchedulerConfig


@dataclasses.dataclass
class DDPMState:
    timesteps: list[int]  # descending
    step_ratio: int
    step_index: int = 0

    @property
    def timestep(self) -> int:
        return self.timesteps[self.step_index]


class DDPMScheduler:
    """Stochastic ancestral sampler with fixed-small posterior variance; its
    ``alphas_cumprod`` (float32 numpy, [num_train_timesteps]) is the training
    noising table."""

    init_noise_sigma = 1.0

    def __init__(self, config: SchedulerConfig = SchedulerConfig(), *,
                 variance_type: str = "fixed_small"):
        if variance_type != "fixed_small":
            raise NotImplementedError("only variance_type='fixed_small'")
        self.config = config
        self.variance_type = variance_type
        self.betas = base.make_betas(config)
        self.alphas_cumprod = np.cumprod(np.float32(1.0) - self.betas, dtype=np.float32)
        self.final_alpha_cumprod = np.float32(1.0)

    def add_noise(self, original: torch.Tensor, noise: torch.Tensor, timesteps) -> torch.Tensor:
        return base.add_noise(self.alphas_cumprod, original, noise, timesteps)

    def get_velocity(self, sample: torch.Tensor, noise: torch.Tensor, timesteps) -> torch.Tensor:
        return base.get_velocity(self.alphas_cumprod, sample, noise, timesteps)

    def init_state(self, num_inference_steps: int) -> DDPMState:
        ts, step_ratio = base.leading_timesteps(self.config, num_inference_steps)
        return DDPMState(timesteps=[int(t) for t in ts], step_ratio=step_ratio)

    def step(
        self,
        state: DDPMState,
        model_output: torch.Tensor,
        sample: torch.Tensor,
        generator: torch.Generator | None = None,
        noise: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """One ancestral step; advances ``state`` and returns x_{t_prev}.
        The fresh noise is ``noise`` or drawn from ``generator``."""
        t = state.timestep
        prev_t = t - state.step_ratio
        acp = self.alphas_cumprod
        alpha_t = acp[t]
        alpha_prev = acp[prev_t] if prev_t >= 0 else self.final_alpha_cumprod
        beta_t, beta_prev = np.float32(1.0) - alpha_t, np.float32(1.0) - alpha_prev
        current_alpha = alpha_t / alpha_prev
        current_beta = np.float32(1.0) - current_alpha

        x0 = base.predict_x0(acp, sample, model_output, t, self.config.prediction_type)
        if self.config.clip_sample:
            r = self.config.clip_sample_range
            x0 = x0.clamp(-r, r)
        x0_coeff = float(np.sqrt(alpha_prev) * current_beta / beta_t)
        xt_coeff = float(np.sqrt(current_alpha) * beta_prev / beta_t)
        prev_sample = x0_coeff * x0 + xt_coeff * sample

        variance = max(float(beta_prev / beta_t * current_beta), 1e-20)
        if noise is None:
            if generator is None:
                raise ValueError(
                    "DDPMScheduler.step needs a generator or an explicit noise tensor "
                    "(ancestral sampling adds fresh noise each step)"
                )
            noise = torch.randn(sample.shape, generator=generator, device=sample.device,
                                dtype=sample.dtype)
        state.step_index += 1
        return prev_sample + (variance**0.5 if t > 0 else 0.0) * noise


__all__ = ["DDPMScheduler", "DDPMState"]
