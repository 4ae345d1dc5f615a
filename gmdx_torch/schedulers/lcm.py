"""Latent Consistency Model scheduler: 1-8 step sampling.

Counterpart of ``gmdx/schedulers/lcm.py``. The timesteps are a strided
subset of the ``original_inference_steps`` origin grid (k * i - 1,
descending); each step takes the consistency boundary scalings

    c_skip = sigma_data^2 / ((t * s)^2 + sigma_data^2)
    c_out  = (t * s) / sqrt((t * s)^2 + sigma_data^2)

to ``denoised = c_out * x0 + c_skip * sample`` and re-noises it to the next
timestep on every step but the last, which returns ``denoised``. The
re-noise comes from a ``torch.Generator`` or is passed in. Coefficients are
float32 host scalars: a step on the card makes no host synchronisation.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gmdx_torch.schedulers import base
from gmdx_torch.schedulers.base import SchedulerConfig


@dataclasses.dataclass
class LCMState:
    timesteps: list[int]  # descending
    step_index: int = 0

    @property
    def timestep(self) -> int:
        return self.timesteps[self.step_index]


class LCMScheduler:
    init_noise_sigma = 1.0

    def __init__(
        self,
        config: SchedulerConfig = SchedulerConfig(),
        *,
        original_inference_steps: int = 50,
        timestep_scaling: float = 10.0,
        sigma_data: float = 0.5,
    ):
        self.config = config
        self.original_inference_steps = original_inference_steps
        self.timestep_scaling = timestep_scaling
        self.sigma_data = sigma_data
        self.betas = base.make_betas(config)
        self.alphas_cumprod = np.cumprod(np.float32(1.0) - self.betas, dtype=np.float32)

    def add_noise(self, original: torch.Tensor, noise: torch.Tensor, timesteps) -> torch.Tensor:
        return base.add_noise(self.alphas_cumprod, original, noise, timesteps)

    def timesteps(self, num_inference_steps: int) -> list[int]:
        """Strided subset of the origin grid (k * i - 1, i = 1..orig), descending."""
        orig = self.original_inference_steps
        if num_inference_steps > orig:
            raise ValueError(
                f"num_inference_steps ({num_inference_steps}) must be <= "
                f"original_inference_steps ({orig})"
            )
        k = self.config.num_train_timesteps // orig
        grid = (np.arange(1, orig + 1) * k - 1)[::-1]
        idx = np.linspace(0, len(grid), num=num_inference_steps, endpoint=False).astype(np.int64)
        return [int(t) for t in grid[idx]]

    def init_state(self, num_inference_steps: int) -> LCMState:
        return LCMState(timesteps=self.timesteps(num_inference_steps))

    def scalings_for_boundary_conditions(self, t: int) -> tuple[np.float32, np.float32]:
        st = np.float32(t) * np.float32(self.timestep_scaling)
        sd2 = np.float32(self.sigma_data**2)
        return sd2 / (st**2 + sd2), st / np.sqrt(st**2 + sd2)

    def step(
        self,
        state: LCMState,
        model_output: torch.Tensor,
        sample: torch.Tensor,
        *,
        generator: torch.Generator | None = None,
        noise: torch.Tensor | None = None,
    ) -> torch.Tensor:
        """One consistency step; advances ``state`` and returns x_{t_prev}
        (``denoised`` on the last step). The re-noise is ``noise`` or drawn
        from ``generator``; the last step needs neither."""
        i, ts = state.step_index, state.timesteps
        t = ts[i]
        is_last = i == len(ts) - 1
        x0, _ = base.x0_eps_at(self.alphas_cumprod[t], sample, model_output,
                               self.config.prediction_type)
        if self.config.clip_sample:
            r = self.config.clip_sample_range
            x0 = x0.clamp(-r, r)
        c_skip, c_out = self.scalings_for_boundary_conditions(t)
        denoised = float(c_out) * x0 + float(c_skip) * sample
        state.step_index += 1
        if is_last:
            return denoised
        if noise is None:
            if generator is None:
                raise ValueError(
                    "LCMScheduler.step needs a generator or an explicit noise tensor "
                    "(each step but the last re-noises)"
                )
            noise = torch.randn(sample.shape, generator=generator, device=sample.device,
                                dtype=sample.dtype)
        alpha_prev = self.alphas_cumprod[ts[i + 1]]
        return (float(np.sqrt(alpha_prev)) * denoised
                + float(np.sqrt(np.float32(1.0) - alpha_prev)) * noise)


__all__ = ["LCMScheduler", "LCMState"]
