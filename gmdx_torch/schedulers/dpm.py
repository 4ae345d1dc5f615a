"""DPM-Solver++ multistep scheduler (orders 1 and 2, midpoint).

Counterpart of ``gmdx/schedulers/dpm.py`` (the reference's "improved"
experiments sample with algorithm_type="dpmsolver++", solver_order=2,
thresholding off): linspace timesteps or Karras sigmas mapped back onto the
discrete grid; the first step is first order (the multistep warm-up), and
so is the last when ``lower_order_final`` and fewer than 15 steps; with
``final_sigmas_type="zero"`` the last step returns the x0 prediction, with
``"sigma_min"`` it transfers to t = 0. The previous step's x0 lives in the
state (allocated at the first step; the JAX package zero-fills it).
Coefficients are float32 host scalars: a step on the card makes no host
synchronisation.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from gmdx_torch.schedulers import base
from gmdx_torch.schedulers.base import SchedulerConfig


@dataclasses.dataclass
class DPMState:
    timesteps: list[int]  # descending
    step_index: int = 0
    prev_x0: torch.Tensor | None = None  # the previous step's x0 prediction

    @property
    def timestep(self) -> int:
        return self.timesteps[self.step_index]


class DPMSolverMultistepScheduler:
    init_noise_sigma = 1.0

    def __init__(
        self,
        config: SchedulerConfig = SchedulerConfig(timestep_spacing="linspace"),
        *,
        solver_order: int = 2,
        algorithm_type: str = "dpmsolver++",
        thresholding: bool = False,
        lower_order_final: bool = True,
        use_karras_sigmas: bool = False,
        final_sigmas_type: str = "zero",
    ):
        if final_sigmas_type not in ("zero", "sigma_min"):
            raise ValueError(
                f"final_sigmas_type must be 'zero' or 'sigma_min', got {final_sigmas_type!r}"
            )
        if algorithm_type != "dpmsolver++":
            raise NotImplementedError("only algorithm_type='dpmsolver++'")
        if solver_order not in (1, 2):
            raise NotImplementedError("solver_order must be 1 or 2")
        if thresholding:
            raise NotImplementedError(
                "dynamic thresholding is disabled in every reference config "
                "('for HDR preservation')"
            )
        self.config = config
        self.solver_order = solver_order
        self.algorithm_type = algorithm_type
        self.lower_order_final = lower_order_final
        self.use_karras_sigmas = use_karras_sigmas
        self.final_sigmas_type = final_sigmas_type
        self.betas = base.make_betas(config)
        self.alphas_cumprod = np.cumprod(np.float32(1.0) - self.betas, dtype=np.float32)
        # VP-SDE half-log-SNR parameterization.
        self.alpha_t = np.sqrt(self.alphas_cumprod)
        self.sigma_t = np.sqrt(np.float32(1.0) - self.alphas_cumprod)
        self.lambda_t = np.log(self.alpha_t) - np.log(self.sigma_t)

    def add_noise(self, original: torch.Tensor, noise: torch.Tensor, timesteps) -> torch.Tensor:
        return base.add_noise(self.alphas_cumprod, original, noise, timesteps)

    def timesteps(self, num_inference_steps: int) -> list[int]:
        if self.use_karras_sigmas:
            # Karras rho = 7 sigma grid, each mapped to the nearest discrete sigma.
            sigmas = self.sigma_t / self.alpha_t  # ascending in t
            rho = 7.0
            smin, smax = float(sigmas[0]), float(sigmas[-1])
            ramp = np.linspace(0.0, 1.0, num_inference_steps, dtype=np.float32)
            ks = (smax ** (1 / rho) + ramp * (smin ** (1 / rho) - smax ** (1 / rho))) ** rho
            return [int(t) for t in np.argmin(np.abs(sigmas[None, :] - ks[:, None]), axis=1)]
        ts = np.linspace(0, self.config.num_train_timesteps - 1, num_inference_steps + 1,
                         dtype=np.float32)
        return [int(t) for t in np.round(ts)[::-1][:-1]]

    def init_state(self, num_inference_steps: int) -> DPMState:
        return DPMState(timesteps=self.timesteps(num_inference_steps))

    def step(
        self, state: DPMState, model_output: torch.Tensor, sample: torch.Tensor
    ) -> torch.Tensor:
        """One multistep transfer; advances ``state`` and returns x_{t_prev}."""
        i, ts = state.step_index, state.timesteps
        n = len(ts)
        t = ts[i]
        t_prev = ts[i + 1] if i + 1 < n else 0
        t_pp = ts[max(i - 1, 0)]
        x0, _ = base.x0_eps_at(self.alphas_cumprod[t], sample, model_output,
                               self.config.prediction_type)

        lam = self.lambda_t
        h = lam[t_prev] - lam[t]
        em1 = np.expm1(-h)
        alp_prev = self.alpha_t[t_prev]
        # First-order (DPM-Solver++ 1S) update.
        out = (float(self.sigma_t[t_prev] / self.sigma_t[t]) * sample
               - float(alp_prev * em1) * x0)
        use_first = i < 1 or (self.lower_order_final and n < 15 and i == n - 1)
        if self.solver_order == 2 and not use_first:
            # Second-order (2M, midpoint) update from the previous x0.
            h0 = lam[t] - lam[t_pp]
            r0 = h0 / (h if h != 0 else np.float32(1.0))
            d1 = (x0 - state.prev_x0) / float(r0 if r0 != 0 else np.float32(1.0))
            out = out - float(np.float32(0.5) * alp_prev * em1) * d1
        if self.final_sigmas_type == "zero" and i == n - 1:
            # The last transfer targets sigma = 0, where the update is x0.
            out = x0
        state.prev_x0 = x0
        state.step_index += 1
        return out


__all__ = ["DPMSolverMultistepScheduler", "DPMState"]
