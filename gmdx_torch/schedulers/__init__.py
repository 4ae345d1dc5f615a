"""Schedulers of the port (counterpart of ``gmdx.schedulers``).

Each constructor takes a ``SchedulerConfig`` and its own keyword extras;
:func:`get_scheduler` takes the JAX package's flat keyword arguments and
names (``"dpm++"`` and ``"dpmsolver++"`` are one class).
"""

from gmdx_torch.schedulers.base import SchedulerConfig, split_kwargs
from gmdx_torch.schedulers.ddim import DDIMScheduler, DDIMState
from gmdx_torch.schedulers.ddpm import DDPMScheduler, DDPMState
from gmdx_torch.schedulers.dpm import DPMSolverMultistepScheduler, DPMState
from gmdx_torch.schedulers.lcm import LCMScheduler, LCMState
from gmdx_torch.schedulers.pndm import PNDMScheduler, PNDMState

SCHEDULERS = {
    "ddpm": DDPMScheduler,
    "ddim": DDIMScheduler,
    "pndm": PNDMScheduler,
    "dpm++": DPMSolverMultistepScheduler,
    "dpmsolver++": DPMSolverMultistepScheduler,
    "lcm": LCMScheduler,
}


def get_scheduler(name: str, **kwargs):
    """The scheduler ``name`` built from JAX-style keyword arguments: the
    ``SchedulerConfig`` fields go to its config, the rest to its
    constructor. DPM-Solver++'s spacing defaults to "linspace"."""
    try:
        cls = SCHEDULERS[name.lower()]
    except KeyError:
        raise ValueError(f"unknown scheduler '{name}'; have {sorted(SCHEDULERS)}")
    if cls is DPMSolverMultistepScheduler:
        kwargs.setdefault("timestep_spacing", "linspace")
    config, extras = split_kwargs(kwargs)
    return cls(config, **extras)


__all__ = [
    "SchedulerConfig",
    "DDIMScheduler",
    "DDIMState",
    "DDPMScheduler",
    "DDPMState",
    "DPMSolverMultistepScheduler",
    "DPMState",
    "LCMScheduler",
    "LCMState",
    "PNDMScheduler",
    "PNDMState",
    "SCHEDULERS",
    "get_scheduler",
]
