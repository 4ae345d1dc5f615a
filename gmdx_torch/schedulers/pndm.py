"""PNDM scheduler (PLMS path, skip_prk_steps=True).

Counterpart of ``gmdx/schedulers/pndm.py``. The JAX package keeps the PLMS
history as a fixed (4, ...) ring in a scan carry and picks each step's
coefficients with ``jnp.where``; here the loop is plain Python, so the state
is a small object the step updates in place, with the same ring (index 0
newest, no push on the replay step) and the same coefficient table.

PLMS algebra:
  step 0:  eps_eff = e0                       (Euler, sample stashed)
  step 1:  eps_eff = (e_new + e0) / 2         (replay of step 0 from the
                                               stashed sample, the duplicated
                                               timestep)
  step 2:  eps_eff = (3 e1 - e0) / 2
  step 3:  eps_eff = (23 e2 - 16 e1 + 5 e0) / 12
  step 4+: eps_eff = (55 e3 - 59 e2 + 37 e1 - 9 e0) / 24
transfer: x_prev = sqrt(a_prev/a_t) x - (a_prev - a_t) eps_eff /
          (a_t sqrt(b_prev) + sqrt(a_t b_t a_prev))
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gmdx_torch.schedulers.base import (
    SchedulerConfig,
    alphas_cumprod_from_config,
    leading_timesteps,
)

# eps_eff = C[k, 0] * e_new + sum_i C[k, 1+i] * ets[i] (ets[0] newest), row
# k = min(counter, 4). Except on the replay step (counter 1) e_new is pushed
# into ets[0] first, so column 0 is used by that row only.
_PLMS_COEFFS = np.array(
    [
        [0.0, 1.0, 0.0, 0.0, 0.0],
        [0.5, 0.5, 0.0, 0.0, 0.0],
        [0.0, 3.0 / 2.0, -1.0 / 2.0, 0.0, 0.0],
        [0.0, 23.0 / 12.0, -16.0 / 12.0, 5.0 / 12.0, 0.0],
        [0.0, 55.0 / 24.0, -59.0 / 24.0, 37.0 / 24.0, -9.0 / 24.0],
    ],
    dtype=np.float32,
)


@dataclasses.dataclass
class PNDMState:
    timesteps: list[int]  # descending, PLMS spacing (2nd-to-last duplicated)
    step_ratio: int
    step_index: int = 0
    counter: int = 0
    ets: list[torch.Tensor] = dataclasses.field(default_factory=list)  # newest first, <= 4
    cur_sample: torch.Tensor | None = None  # x_t stashed for the replay step

    @property
    def timestep(self) -> int:
        return self.timesteps[self.step_index]


class PNDMScheduler:
    """PLMS only (the reference's skip_prk_steps=True); its model input
    needs no scaling, so there is no scale_model_input."""

    init_noise_sigma = 1.0

    def __init__(self, config: SchedulerConfig = SchedulerConfig(), *,
                 skip_prk_steps: bool = True):
        if not skip_prk_steps:
            raise NotImplementedError(
                "Runge-Kutta warmup (skip_prk_steps=False) is not used anywhere in the "
                "reference; only the PLMS path is implemented."
            )
        self.config = config
        self.alphas_cumprod = alphas_cumprod_from_config(config)
        self.final_alpha_cumprod = (
            np.float32(1.0) if self.config.set_alpha_to_one else self.alphas_cumprod[0]
        )

    def timesteps(self, num_inference_steps: int) -> list[int]:
        """Leading grid with the 2nd-to-last entry duplicated, descending."""
        ts, _ = leading_timesteps(self.config, num_inference_steps)
        asc = ts[::-1]
        plms = np.concatenate([asc[:-1], asc[-2:-1], asc[-1:]])
        return [int(t) for t in plms[::-1]]

    def num_steps(self, num_inference_steps: int) -> int:
        """Length of the step loop (one longer than N: the duplicated entry)."""
        return num_inference_steps + 1 if num_inference_steps > 1 else 1

    def init_state(self, num_inference_steps: int) -> PNDMState:
        return PNDMState(
            timesteps=self.timesteps(num_inference_steps),
            step_ratio=self.config.num_train_timesteps // num_inference_steps,
        )

    def step(self, state: PNDMState, model_output: torch.Tensor, sample: torch.Tensor) -> torch.Tensor:
        """One PLMS step; advances ``state`` and returns x_{t_prev}."""
        t = state.timestep
        replay = state.counter == 1
        if not replay:
            state.ets = [model_output] + state.ets[:3]
        if state.counter == 0:
            state.cur_sample = sample
        sample_eff = state.cur_sample if replay else sample

        c = _PLMS_COEFFS[min(state.counter, 4)]
        eps_eff = float(c[0]) * model_output
        for coef, e in zip(c[1:], state.ets):
            if coef != 0.0:
                eps_eff = eps_eff + float(coef) * e

        t_eff, prev_t = (t + state.step_ratio, t) if replay else (t, t - state.step_ratio)
        state.step_index += 1
        state.counter += 1
        return self._transfer(sample_eff, t_eff, prev_t, eps_eff)

    def _transfer(self, sample, t: int, prev_t: int, eps):
        """PNDM Eq. (9) transfer from x_t to x_{t_prev}; coefficients in
        float32 as the JAX package computes them."""
        alpha_t = self.alphas_cumprod[t]
        alpha_prev = self.alphas_cumprod[prev_t] if prev_t >= 0 else self.final_alpha_cumprod
        beta_t = np.float32(1.0) - alpha_t
        beta_prev = np.float32(1.0) - alpha_prev
        if self.config.prediction_type == "v_prediction":
            eps = float(np.sqrt(alpha_t)) * eps + float(np.sqrt(beta_t)) * sample
        elif self.config.prediction_type != "epsilon":
            raise ValueError(
                f"PNDM supports epsilon/v_prediction, got {self.config.prediction_type!r}"
            )
        sample_coeff = np.sqrt(alpha_prev / alpha_t)
        denom = alpha_t * np.sqrt(beta_prev) + np.sqrt(alpha_t * beta_t * alpha_prev)
        return float(sample_coeff) * sample - float(alpha_prev - alpha_t) * eps / float(denom)


__all__ = ["PNDMScheduler", "PNDMState"]
