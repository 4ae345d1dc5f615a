"""Training of the port (counterpart of ``gmdx.train``): Stage-1 VAE-LoRA +
GAN training of the gain-map head, Stage-2 GM-UNet fine-tuning, ControlNet
training against the frozen SD UNet, their optimizer, schedules and EMA,
checkpoints of all three states (the port's own format), the latent cache
and the metrics logger. The Stage-1 names live in
``gmdx_torch.train.stage1`` (``make_ema_step`` and ``init_state`` are the
Stage-2 step's here)."""

from gmdx_torch.train.checkpoint import (
    CheckpointManager,
    make_manager,
    resolve_resume_step,
    restore_state,
    save_state,
)
from gmdx_torch.train.controlnet import (
    ControlNetState,
    ControlNetTrainConfig,
    controlnet_loss,
    init_controlnet_state,
    make_controlnet_ema_step,
    make_controlnet_train_step,
)
from gmdx_torch.train.ema import EMAConfig, EMAState, ema_decay_for_step, ema_init, ema_update
from gmdx_torch.train.latent_cache import (
    compute_latent_cache,
    latent_cache_fingerprint,
    load_latent_cache,
    save_latent_cache,
)
from gmdx_torch.train.metrics import MetricsLogger
from gmdx_torch.train.optim import AdamW, MultiSteps, get_lr_schedule, make_adamw
from gmdx_torch.train.stage2 import (
    Stage2Config,
    Stage2State,
    init_state,
    make_ema_step,
    make_optimizer,
    make_train_step,
    stage2_loss,
)

__all__ = [
    "CheckpointManager",
    "ControlNetState",
    "ControlNetTrainConfig",
    "controlnet_loss",
    "init_controlnet_state",
    "make_controlnet_ema_step",
    "make_controlnet_train_step",
    "make_manager",
    "save_state",
    "restore_state",
    "resolve_resume_step",
    "compute_latent_cache",
    "save_latent_cache",
    "load_latent_cache",
    "latent_cache_fingerprint",
    "MetricsLogger",
    "EMAConfig",
    "EMAState",
    "ema_decay_for_step",
    "ema_init",
    "ema_update",
    "AdamW",
    "MultiSteps",
    "get_lr_schedule",
    "make_adamw",
    "Stage2Config",
    "Stage2State",
    "init_state",
    "make_ema_step",
    "make_optimizer",
    "make_train_step",
    "stage2_loss",
]
