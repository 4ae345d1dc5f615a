"""Scalar and image metrics: JSONL always, tensorboard or wandb beside it.

Counterpart of ``gmdx/train/metrics.py``. ``metrics.jsonl`` and
``<project>_config.json`` are always written. ``tensorboard`` (the default)
writes event files through ``torch.utils.tensorboard`` when it can be
imported and JSONL alone when it cannot (the card's machine has no
tensorboard), as the JAX logger does; ``wandb`` raises when the package is
missing; any other backend (the reference's ``comet``) raises. Across
ranks only rank 0 writes (the others' loggers do nothing); the trainers
log values already averaged over the ranks.
"""

from __future__ import annotations

import json
import os
import time


class MetricsLogger:
    def __init__(self, log_dir: str, *, backend: str = "tensorboard", project: str = "gmdx",
                 config: dict | None = None):
        from gmdx_torch.dist.multihost import is_main_process

        self.enabled = is_main_process()
        self._jsonl = self._tb = self._wandb = None
        if not self.enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")
        self._tb = None
        self._wandb = None
        if backend == "tensorboard":
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir)
            except ImportError:  # tensorboard is optional; the JSONL always works
                self._tb = None
        elif backend == "wandb":
            try:
                import wandb
            except ImportError as e:
                raise RuntimeError(
                    "--report_to wandb requested but the wandb package is not installed; "
                    "install wandb or use tensorboard (metrics.jsonl is always written)"
                ) from e
            self._wandb = wandb.init(project=project, dir=log_dir, config=config or {})
        else:
            raise ValueError(
                f"unsupported --report_to backend {backend!r}: gmdx supports 'tensorboard' "
                "(default) and 'wandb'. The reference also advertises 'comet' via accelerate "
                "but ships no comet config; gmdx rejects it loudly rather than silently "
                "logging nowhere.")
        if config is not None:
            with open(os.path.join(log_dir, f"{project}_config.json"), "w") as f:
                json.dump({k: v for k, v in config.items() if _jsonable(v)}, f, indent=2)

    def log(self, step: int, scalars: dict[str, float]) -> None:
        if not self.enabled:
            return
        values = {k: float(v) for k, v in scalars.items()}
        self._jsonl.write(json.dumps({"step": int(step), "time": time.time(), **values}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in values.items():
                self._tb.add_scalar(k, v, step)
        if self._wandb is not None:
            self._wandb.log(values, step=int(step))

    def log_images(self, step: int, images: dict) -> None:
        """HWC images (uint8, or float in [0, 1]) to the live backend; the
        validation code writes the files itself."""
        if self._tb is not None:
            for k, v in images.items():
                self._tb.add_image(k, v, step, dataformats="HWC")
        if self._wandb is not None:
            import wandb

            self._wandb.log({k: wandb.Image(v) for k, v in images.items()}, step=int(step))

    def close(self) -> None:
        if not self.enabled:
            return
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        if self._wandb is not None:
            self._wandb.finish()


def _jsonable(v) -> bool:
    try:
        json.dumps(v)
        return True
    except TypeError:
        return False


__all__ = ["MetricsLogger"]
