"""Learning-rate schedules and the clipped AdamW of Stage-2 training.

Counterpart of ``gmdx/train/optim.py``: the six diffusers schedule names with
the same shapes, and ``make_adamw`` = global-norm clipping, then AdamW, the
same update as ``optax.chain(optax.clip_by_global_norm, optax.adamw)``:

    mu = b1 mu + (1 - b1) g,   nu = b2 nu + (1 - b2) g^2,   n += 1
    p -= lr(n - 1) * (mu / (1 - b1^n) / (sqrt(nu / (1 - b2^n)) + eps) + wd p)

The decay is decoupled and applied as ``lr * wd * p``. ``low_precision_moments``
stores the first moment in bf16 (the update still uses the fp32 value of this
step), as optax's ``mu_dtype="bfloat16"``. :class:`MultiSteps` is
``optax.MultiSteps``: the mean of k micro-batch gradients, one update every
k-th call. Unlike optax, both update the parameters in place.

Across ranks (:meth:`AdamW.distribute`, a ``gmdx_torch.dist.DataParallel``)
the optimizer takes local gradients through :meth:`AdamW.reduce` (their
mean over the ranks: full under ddp, this rank's pieces of the flat layout
under zero1 and fsdp), clips by the norm over every rank's pieces, steps
its pieces (``params``: views into the module's tensors under zero1, into
the master shard under fsdp) and hands the result to the collectives
(zero1: all-gather). :class:`MultiSteps` accumulates local gradients and
reduces their mean once, at the update.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Sequence

import torch

Schedule = Callable[[int], float]


def get_lr_schedule(
    name: str,
    learning_rate: float,
    *,
    num_warmup_steps: int = 0,
    num_training_steps: int | None = None,
    num_cycles: float = 0.5,
    power: float = 1.0,
) -> Schedule:
    """diffusers ``get_scheduler`` parity: step (0-based update count) -> lr."""
    name = name.lower()

    def warmup(step: int) -> float:
        return 1.0 if num_warmup_steps <= 0 else min(1.0, (step + 1) / num_warmup_steps)

    if name == "constant":
        return lambda step: learning_rate
    if name == "constant_with_warmup":
        return lambda step: learning_rate * warmup(step)
    if num_training_steps is None:
        raise ValueError(f"schedule {name!r} needs num_training_steps")

    def progress(step: int) -> float:
        span = max(1, num_training_steps - num_warmup_steps)
        return min(1.0, max(0.0, (step - num_warmup_steps) / span))

    def linear(step):
        return learning_rate * warmup(step) * (1.0 - progress(step))

    def cosine(step):
        return (learning_rate * warmup(step) * 0.5
                * (1.0 + math.cos(math.pi * 2.0 * num_cycles * progress(step))))

    def cosine_with_restarts(step):
        prog = progress(step)
        if prog >= 1.0:
            return 0.0
        return learning_rate * warmup(step) * 0.5 * (1.0 + math.cos(math.pi * ((prog * num_cycles) % 1.0)))

    def polynomial(step):
        return learning_rate * warmup(step) * (1.0 - progress(step)) ** power

    table = {
        "linear": linear,
        "cosine": cosine,
        "cosine_with_restarts": cosine_with_restarts,
        "polynomial": polynomial,
    }
    if name not in table:
        raise ValueError(f"unknown lr schedule {name!r}")
    return table[name]


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element of ``tensors`` (fp32,
    on their device, no host sync)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class AdamW:
    """Clip by global norm, then AdamW, over ``params`` (updated in place)."""

    def __init__(
        self,
        params: Sequence[torch.Tensor],
        schedule: Schedule,
        *,
        beta1: float = 0.9,
        beta2: float = 0.999,
        weight_decay: float = 1e-2,
        epsilon: float = 1e-8,
        max_grad_norm: float | None = 1.0,
        low_precision_moments: bool = False,
    ):
        self.params = list(params)
        self.schedule = schedule
        self.beta1, self.beta2 = beta1, beta2
        self.weight_decay, self.epsilon = weight_decay, epsilon
        self.max_grad_norm = max_grad_norm
        mu_dtype = torch.bfloat16 if low_precision_moments else None
        self.mu = [torch.zeros_like(p, dtype=mu_dtype) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0
        self.dp = None  # a gmdx_torch.dist.DataParallel once distributed
        self.model_params = self.params

    def distribute(self, dp) -> None:
        """Step across the ranks of ``dp`` (built on ``model_params``);
        under zero1 and fsdp the moments become this rank's shard (kept
        as they were on its part) and ``params`` its pieces."""
        self.dp = dp
        if not dp.sharded:
            return
        # One moment at a time, so that only one full copy is ever held.
        self.mu_flat = dp.shard_of(self.mu)
        self.mu = dp.pieces(self.mu_flat)
        self.nu_flat = dp.shard_of(self.nu)
        self.nu = dp.pieces(self.nu_flat)
        self.params = (dp.pieces(dp.master) if dp.master is not None
                       else dp.views(self.model_params))

    def reslice(self, params: Sequence[torch.Tensor], fn) -> None:
        """Step ``params`` (new tensors, one for each old parameter: tensor
        parallelism's slices) with each moment ``fn(i, moment)``."""
        self.params = self.model_params = list(params)
        self.mu = [fn(i, m) for i, m in enumerate(self.mu)]
        self.nu = [fn(i, v) for i, v in enumerate(self.nu)]

    @property
    def master_params(self) -> list[torch.Tensor]:
        """The fp32 values the EMA follows and checkpoints keep: the
        module's tensors, or this rank's master pieces under fsdp."""
        return self.params if self.dp is not None and self.dp.master is not None \
            else self.model_params

    def gathered(self):
        """A block in which ``model_params`` hold the full parameters."""
        return self.dp.gathered() if self.dp is not None else contextlib.nullcontext()

    def reduce(self, grads: list) -> list[torch.Tensor]:
        """Local gradients -> the ones :meth:`step` takes (their mean over
        the ranks, the list emptied as it goes; ``grads`` in one process)."""
        return grads if self.dp is None else self.dp.reduce(grads)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor],
             grad_norm: torch.Tensor | None = None) -> None:
        """One update from ``grads`` (one per parameter, in order; across
        ranks, :meth:`reduce`'s output); ``grad_norm``, their global norm
        where the caller already has it, spares the clip its own pass over
        them."""
        grads = [g.to(p.dtype) for g, p in zip(grads, self.params)]
        if self.max_grad_norm is not None and self.max_grad_norm > 0:
            if grad_norm is not None:
                g_norm = grad_norm
            else:
                g_norm = global_norm(grads) if self.dp is None else self.dp.global_norm(grads)
            coef = torch.where(g_norm < self.max_grad_norm, 1.0, self.max_grad_norm / g_norm)
            grads = torch._foreach_mul(grads, coef)
        b1, b2 = self.beta1, self.beta2
        lr = self.schedule(self.count)
        self.count += 1
        # b1 * mu is taken in mu's own dtype, b1 rounded to it first (bf16
        # with low-precision moments), as optax's weakly typed product is.
        # An fp32 mu and nu are updated in place; the update itself takes
        # two temporaries the size of the parameters.
        if self.mu and self.mu[0].dtype != torch.float32:
            b1_mu = torch.tensor(b1, dtype=self.mu[0].dtype).item()
            mu = [m.float() for m in torch._foreach_mul(self.mu, b1_mu)]
        else:
            mu = self.mu
            torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, grads, alpha=1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - b2)
        denom = torch._foreach_div(self.nu, 1.0 - b2**self.count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.epsilon)
        upd = torch._foreach_div(mu, 1.0 - b1**self.count)
        torch._foreach_div_(upd, denom)
        del denom
        if self.weight_decay:
            torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-lr)
        if mu is not self.mu:
            for m, new in zip(self.mu, mu):
                m.copy_(new)
        if self.dp is not None:
            self.dp.after_update()


class MultiSteps:
    """Gradient accumulation: the running mean of ``k`` calls' gradients goes
    to ``opt`` on every k-th call; the other calls leave the parameters as
    they are."""

    def __init__(self, opt: AdamW, k: int):
        self.opt, self.k = opt, k
        self.acc = [torch.zeros_like(p) for p in opt.model_params]
        self.mini_step = 0

    @property
    def params(self) -> list[torch.Tensor]:
        return self.opt.params

    @property
    def model_params(self) -> list[torch.Tensor]:
        return self.opt.model_params

    @property
    def master_params(self) -> list[torch.Tensor]:
        return self.opt.master_params

    def gathered(self):
        return self.opt.gathered()

    @property
    def dp(self):
        return self.opt.dp

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor],
             grad_norm: torch.Tensor | None = None) -> bool:
        """Accumulate ``grads``; returns whether the parameters moved.
        ``grad_norm`` is the micro-batch's and is not used: the clip takes
        the norm of the mean."""
        for a, g in zip(self.acc, grads):
            a.add_((g - a) / (self.mini_step + 1))
        if self.mini_step < self.k - 1:
            self.mini_step += 1
            return False
        self.opt.step(self.opt.reduce(list(self.acc)))
        for a in self.acc:
            a.zero_()
        self.mini_step = 0
        return True


# The steps' side of distribution. An optimizer is any object with
# ``params`` and ``step(grads, grad_norm)``; one that :meth:`AdamW.distribute`
# gave a DataParallel also gathers, reduces and takes norms across ranks.


def data_parallel(opt):
    """``opt``'s ``gmdx_torch.dist.DataParallel``, None if it has none."""
    return getattr(opt, "dp", None)


@contextlib.contextmanager
def gathered(*opts):
    """The block with the full parameters of every optimizer in ``opts``
    that shards them (fsdp)."""
    with contextlib.ExitStack() as stack:
        for opt in opts:
            if data_parallel(opt) is not None:
                stack.enter_context(opt.gathered())
        yield


def reduce_gradients(opt, grads: list) -> list:
    """The gradients ``opt.step`` takes: the mean over the ranks (the list
    emptied as it goes); local ones for :class:`MultiSteps`, which reduces
    at its update, and in one process."""
    if data_parallel(opt) is None or isinstance(opt, MultiSteps):
        return grads
    return opt.reduce(grads)


def param_sq_norms(opt, grads) -> torch.Tensor:
    """Each parameter's squared norm of a :func:`reduce_gradients` output
    (summed over the ranks' pieces when sharded)."""
    if data_parallel(opt) is None or isinstance(opt, MultiSteps):
        return torch.stack(torch._foreach_norm([g.float() for g in grads])) ** 2
    return opt.dp.sq_norms(grads)


def master_params(opt) -> list[torch.Tensor]:
    """What the EMA follows: ``opt.master_params`` where it has them."""
    return getattr(opt, "master_params", None) or opt.params


def model_params(opt) -> list[torch.Tensor]:
    """The module's own (full) trainable tensors of ``opt``."""
    return getattr(opt, "model_params", None) or opt.params


def run_sizes(*, n_samples: int, train_batch_size: int, n_dev: int,
              gradient_accumulation_steps: int = 1, max_train_steps: int | None = None,
              num_train_epochs: int = 1) -> dict[str, int]:
    """A trainer's sizes over ``n_dev`` ranks of ``train_batch_size`` rows,
    as the JAX trainers compute them: ``global_batch``,
    ``batches_per_epoch`` (the ragged tail dropped), ``steps_per_epoch``
    (optimizer updates, ceil over the accumulation) and
    ``max_train_steps``."""
    ga = gradient_accumulation_steps
    global_batch = train_batch_size * n_dev
    batches_per_epoch = max(1, n_samples // global_batch)
    steps_per_epoch = max(1, -(-batches_per_epoch // ga))
    return {"global_batch": global_batch,
            "batches_per_epoch": batches_per_epoch, "steps_per_epoch": steps_per_epoch,
            "max_train_steps": max_train_steps or num_train_epochs * steps_per_epoch}


# The JAX package's constructor name; the same signature.
make_adamw = AdamW


__all__ = [
    "get_lr_schedule",
    "global_norm",
    "make_adamw",
    "run_sizes",
    "data_parallel",
    "gathered",
    "reduce_gradients",
    "param_sq_norms",
    "master_params",
    "model_params",
    "AdamW",
    "MultiSteps",
]
