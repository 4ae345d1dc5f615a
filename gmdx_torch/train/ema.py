"""Exponential moving average of the trained parameters.

Counterpart of ``gmdx/train/ema.py`` (diffusers' ``EMAModel`` ramp):
  * warmup (default): decay_t = 1 - (1 + step / inv_gamma)^(-power)
  * classic:          decay_t = (1 + step) / (10 + step)
clamped to [min_decay, max_decay]. The shadow is a copy that never aliases
the live parameters; unlike the JAX package, the update writes it in place.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch


@dataclasses.dataclass(frozen=True)
class EMAConfig:
    max_decay: float = 0.9999
    min_decay: float = 0.0
    use_warmup: bool = True
    inv_gamma: float = 1.0
    power: float = 2.0 / 3.0


@dataclasses.dataclass
class EMAState:
    shadow: list[torch.Tensor]
    step: int = 0


def ema_init(params: Sequence[torch.Tensor]) -> EMAState:
    return EMAState(shadow=[p.detach().clone() for p in params], step=0)


def ema_decay_for_step(config: EMAConfig, step: int) -> float:
    if config.use_warmup:
        decay = 1.0 - (1.0 + step / config.inv_gamma) ** -config.power
    else:
        decay = (1.0 + step) / (10.0 + step)
    return min(max(decay, config.min_decay), config.max_decay)


@torch.no_grad()
def ema_update(config: EMAConfig, state: EMAState, params: Sequence[torch.Tensor]) -> EMAState:
    """shadow = decay * shadow + (1 - decay) * params, at the next step's
    decay; returns ``state``, advanced."""
    state.step += 1
    decay = ema_decay_for_step(config, state.step)
    torch._foreach_mul_(state.shadow, decay)
    torch._foreach_add_(state.shadow, [p.to(s.dtype) for p, s in zip(params, state.shadow)],
                        alpha=1.0 - decay)
    return state


__all__ = ["EMAConfig", "EMAState", "ema_init", "ema_update", "ema_decay_for_step"]
