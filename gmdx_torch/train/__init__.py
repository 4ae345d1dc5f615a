"""Training of the port (counterpart of ``gmdx.train``): Stage-1 VAE-LoRA +
GAN training of the gain-map head, Stage-2 GM-UNet fine-tuning, their
optimizer, schedules and EMA. The Stage-1 names live in
``gmdx_torch.train.stage1`` (``make_ema_step`` and ``init_state`` are the
Stage-2 step's here)."""

from gmdx_torch.train.ema import EMAConfig, EMAState, ema_decay_for_step, ema_init, ema_update
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
