"""Schedulers of the port (counterpart of ``gmdx.schedulers``)."""

from gmdx_torch.schedulers.base import SchedulerConfig
from gmdx_torch.schedulers.ddpm import DDPMScheduler, DDPMState
from gmdx_torch.schedulers.pndm import PNDMScheduler, PNDMState

__all__ = ["SchedulerConfig", "DDPMScheduler", "DDPMState", "PNDMScheduler", "PNDMState"]
