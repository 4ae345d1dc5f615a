"""LoRA as functions over a module's parameters.

Counterpart of ``gmdx/models/lora.py``. The JAX package keeps LoRA out of
the modules: factors for every Dense and Conv kernel, merged into a new
parameter tree (``kernel + scale * a @ b``) that the unchanged model runs
with. Here the factors are keyed by the diffusers parameter name of the
weight they adapt and laid out as the port's weights are, out-channels
first (PEFT's ``lora_A`` / ``lora_B``):

* a Linear weight (out, in): ``a`` (r, in), ``b`` (out, r), delta ``b @ a``;
* a conv weight (out, in, kh, kw): ``a`` (r, in, kh, kw), ``b`` (out, r, 1,
  1), delta ``einsum("orxy,rihw->oihw", b, a)``: the JAX package's
  ``einsum("hwir,xyro->hwio")`` in OIHW.

:func:`merge_lora` returns a name -> tensor mapping for
``torch.func.functional_call``; it is differentiable in the factors.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 64
    alpha: float = 64.0

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def lora_targets(module: nn.Module) -> dict[str, torch.Tensor]:
    """The weights LoRA adapts, by parameter name: every Linear (2-D) and
    conv (4-D) weight; norms and biases are not."""
    return {n: p for n, p in module.named_parameters()
            if n.endswith("weight") and p.ndim in (2, 4)}


def init_lora_params(
    generator: torch.Generator, module: nn.Module, config: LoRAConfig = LoRAConfig(),
) -> dict[str, dict[str, torch.Tensor]]:
    """Factors for every target, fp32 on the generator's device, in sorted
    name order: ``a`` ~ N(0, 1/r), ``b`` zeros (the delta starts at 0)."""
    dev, r = generator.device, config.rank
    lora = {}
    for name, w in sorted(lora_targets(module).items()):
        d_out, d_in = w.shape[:2]
        tail = tuple(w.shape[2:])
        a = torch.randn((r, d_in, *tail), generator=generator, device=dev) / math.sqrt(r)
        b = torch.zeros((d_out, r, *(1 for _ in tail)), device=dev)
        lora[name] = {"a": a, "b": b}
    return lora


def _delta(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The weight delta of one factor pair, in the weight's layout."""
    if a.ndim == 2:
        return b @ a
    return torch.einsum("orxy,rihw->oihw", b, a)


def merge_lora(
    params: Mapping[str, torch.Tensor], lora: Mapping[str, Mapping[str, torch.Tensor]],
    scale: float,
) -> dict[str, torch.Tensor]:
    """``params`` with ``weight + scale * delta`` at every adapted name (the
    delta cast to the weight's dtype); the others as they are."""
    out = dict(params)
    for name, f in lora.items():
        w = out[name]
        out[name] = w + scale * _delta(f["a"], f["b"]).to(w.dtype)
    return out


__all__ = [
    "LoRAConfig",
    "lora_targets",
    "init_lora_params",
    "merge_lora",
]
