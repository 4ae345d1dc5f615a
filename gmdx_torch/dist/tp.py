"""Tensor-parallel (Megatron-style) slices of the UNet, VAE and ControlNet.

Counterpart of ``gmdx/dist/tp.py``. The JAX package annotates each parameter
with a PartitionSpec over its ``model`` mesh axis and lets GSPMD place the
collectives; the port gives each rank of the model axis its slice of each
parameter (:func:`tp_shard_state_dict`, :func:`tp_shard_module`) and the
layers write their collectives out (``gmdx_torch.models.layers``). The rule
is the JAX package's, matched on the parameter's name, in torch layouts
(``nn.Linear`` is (out, in) where flax's kernel is (in, out); conv weights
are OIHW where flax's are HWIO):

* column-parallel, output dimension sharded (torch dim 0), no collective:
  ``to_q``/``to_k``/``to_v``, the GEGLU ``ff.net.0.proj`` (flax
  ``ff/proj_in``), ``time_emb_proj``, ``linear_1``, and a resnet's
  ``conv1`` on its output channels; their biases too;
* row-parallel, input dimension sharded (torch dim 1), the products summed
  over the ranks: ``to_out.0``, ``ff.net.2`` (flax ``ff/proj_out``),
  ``linear_2``, and ``conv2`` on its input channels; their biases are
  added once, after the sum, and replicated;
* replicated: norms, the 1x1 transformer ``proj_in``/``proj_out`` weights,
  and every leaf whose sharded dimension does not divide by the ranks.

Two consequences of matching by name, as in the JAX package: the rule
reaches the VAE's and the ControlNet's resnets and attentions, and the bias
of the transformer's 1x1 ``proj_in`` is sharded although its weight is not
(the layer gathers it at use). ``GEGLU.proj`` emits ``[hidden | gate]``;
where GSPMD reshards a contiguous column split silently, the port slices
each half by rank, so that a rank's hidden and gate columns belong together
and ``ff.net.2``'s rows match them.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.distributed as dist
from torch import nn

from gmdx_torch.dist.mesh import gather_rows

# Column-parallel 2-D weights: torch (out, in), OUT sharded.
_COL2D = ("to_q", "to_k", "to_v", "proj_in", "time_emb_proj", "linear_1")
# Row-parallel 2-D weights: torch (out, in), IN sharded; the partial
# products are summed over the ranks.
_ROW2D = ("to_out", "proj_out", "linear_2")
# Biases of the column-parallel layers (and conv1) carry their slice.
_COL_BIAS = _COL2D + ("conv1",)


def _parent_leaf(key: str) -> tuple[str, str]:
    """The flax (parent, leaf) names of a port key: ``ff.net.0.proj`` is
    ``proj_in``, ``ff.net.2`` is ``proj_out``, numeric parts (``to_out.0``)
    are skipped."""
    parts = key.split(".")
    leaf = parts[-1]
    if parts[-3:-1] == ["net", "2"]:
        return "proj_out", leaf
    if parts[-4:-1] == ["net", "0", "proj"]:
        return "proj_in", leaf
    names = [p for p in parts[:-1] if not p.isdigit()]
    return (names[-1] if names else ""), leaf


def is_geglu_proj(key: str) -> bool:
    """Whether ``key`` is a GEGLU's fused [hidden | gate] projection."""
    return key.split(".")[-4:-1] == ["net", "0", "proj"]


def tp_spec_for_key(key: str, shape, n_shards: int) -> int | None:
    """The torch dimension of ``key``'s tensor that tensor parallelism over
    ``n_shards`` ranks shards, or None where it replicates
    (``gmdx/dist/tp.py:tp_spec_for_path``'s rule in torch layouts)."""
    if n_shards <= 1:
        return None
    parent, leaf = _parent_leaf(key)
    nd = len(shape)

    def div(d: int) -> bool:
        return shape[d] % n_shards == 0

    if leaf == "weight":
        if nd == 2 and parent in _COL2D and div(0):
            return 0
        if nd == 2 and parent in _ROW2D and div(1):
            return 1
        # The resnet 3x3 pair (OIHW): conv1 on O, conv2 on I. The 1x1
        # transformer proj_in/proj_out are 4-D too and replicate.
        if nd == 4 and parent == "conv1" and div(0):
            return 0
        if nd == 4 and parent == "conv2" and div(1):
            return 1
    elif leaf == "bias" and nd == 1 and parent in _COL_BIAS and div(0):
        return 0
    return None


def tp_slice(key: str, t: torch.Tensor, rank: int, n_shards: int) -> torch.Tensor:
    """Rank ``rank``'s slice of ``key``'s full tensor ``t`` (a contiguous
    copy; ``t`` itself where the rule replicates). A GEGLU projection gives
    each rank the matching slices of its hidden and its gate halves."""
    d = tp_spec_for_key(key, t.shape, n_shards)
    if d is None:
        return t
    if is_geglu_proj(key):
        if t.shape[0] % (2 * n_shards):
            raise ValueError(f"{key}: GEGLU halves of {t.shape[0] // 2} rows do not split "
                             f"over {n_shards} ranks")
        return torch.cat([h.chunk(n_shards, dim=0)[rank] for h in t.chunk(2, dim=0)]).contiguous()
    return t.chunk(n_shards, dim=d)[rank].contiguous()


def tp_shard_state_dict(sd: Mapping[str, torch.Tensor], rank: int,
                        n_shards: int) -> dict[str, torch.Tensor]:
    """This rank's slices of a full state dict (a new dict; replicated
    entries are the same tensors)."""
    return {k: tp_slice(k, v, rank, n_shards) for k, v in sd.items()}


def assign_state_dict(module: nn.Module, sd: Mapping[str, torch.Tensor]) -> nn.Module:
    """Make ``sd``'s tensors the module's parameters and buffers, whatever
    their shapes (``load_state_dict`` refuses a slice's shape); the keys
    must be the module's own, all of them."""
    own = dict(module.state_dict(keep_vars=True))
    missing, unknown = sorted(set(own) - set(sd)), sorted(set(sd) - set(own))
    if missing or unknown:
        raise KeyError(f"state dict: missing {missing[:5]}, unknown {unknown[:5]}")
    for key, value in sd.items():
        path, _, leaf = key.rpartition(".")
        sub = module.get_submodule(path) if path else module
        if leaf in sub._parameters:
            sub._parameters[leaf] = nn.Parameter(value, requires_grad=own[key].requires_grad)
        else:
            sub._buffers[leaf] = value
    return module


def tp_shard_module(module: nn.Module, rank: int, n_shards: int) -> nn.Module:
    """Replace the module's parameters by this rank's slices, in place."""
    sd = tp_shard_state_dict({k: v.detach() for k, v in module.state_dict().items()},
                             rank, n_shards)
    return assign_state_dict(module, sd)


def all_reduce(t: torch.Tensor, ctx) -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``ctx``'s group, in place."""
    dist.all_reduce(t, group=ctx.group)
    return t


def gather_full(t: torch.Tensor, full_shape, ctx) -> torch.Tensor:
    """The full tensor of shape ``full_shape`` of which ``t`` is this rank's
    contiguous slice along one dimension (``t`` itself when whole)."""
    if tuple(t.shape) == tuple(full_shape):
        return t
    d = next(i for i, (a, b) in enumerate(zip(t.shape, full_shape)) if a != b)
    return gather_rows(t, ctx, d)


__all__ = ["tp_spec_for_key", "tp_slice", "tp_shard_state_dict", "tp_shard_module",
           "assign_state_dict", "is_geglu_proj", "all_reduce", "gather_full"]
