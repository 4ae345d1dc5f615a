"""Tensor parallelism of the port (``gmdx_torch.dist.tp``, ``tpctx``) on the
CPU, held against the JAX package's rule and forwards.

* ``tp_spec_for_key`` shards the same dimension as
  ``gmdx.dist.tp.tp_spec_for_path`` (or both replicate) on every leaf of the
  tiny and SD-1.5 UNet, VAE and ControlNet trees at 2, 4 and 8 ranks, each
  port key carried to its flax path and layout by the export map
  (``gmdx_torch.io.to_flax``); the tiny trees' flax paths are gmdx's own.
* The GEGLU projection's hidden and gate halves are sliced by rank, and the
  ranks' partial FF outputs sum to the whole FF.
* The tiny UNet, VAE and ControlNet at tp = 2 and 4 (gloo ranks,
  ``tests/torch_tp_ranks.py``) against gmdx's unsharded forwards at
  ``tests/test_tp.py``'s tolerance, rtol = atol = 3e-5; the tiny dual loop
  at tp = 2, 3 PNDM steps with CFG, against the port's one process (3e-5
  relative, and of the latents' peak).
* ``tp_route`` against ``_tp_route`` and the JAX dispatch's TP gates.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from gmdx.dist import make_mesh
from gmdx.dist.tp import tp_spec_for_path
from gmdx.dist.tpctx import tp_kernel_context
from gmdx_torch.dist.tp import tp_shard_state_dict, tp_slice, tp_spec_for_key
from gmdx_torch.io import to_flax
from gmdx_torch.kernels.attention import TP_LIBRARY_OPS, tp_route
from gmdx_torch.models import (
    SD15_CONTROLNET_CONFIG, SD15_GM_UNET_CONFIG, SD15_VAE_CONFIG, TINY_CONTROLNET_CONFIG,
    TINY_UNET_CONFIG, TINY_VAE_CONFIG, AutoencoderKL, ControlNetModel, UNet2DConditionModel,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from parallel_reference import (  # noqa: E402
    TOL, assert_forwards_close, jax_forwards, port_setup, tiny_setup,
)
from torch_dist_ranks import Ranks  # noqa: E402
from torch_tp_ranks import dual_run  # noqa: E402

TREES = {
    "unet": (UNet2DConditionModel, to_flax.convert_unet_state_dict),
    "vae": (AutoencoderKL, to_flax.convert_vae_state_dict),
    "controlnet": (ControlNetModel, to_flax.convert_controlnet_state_dict),
}
# A flax leaf's axis -> the torch dimension it becomes, by rank: Linear
# (in, out) -> (out, in); conv HWIO -> OIHW.
_AXIS = {1: {0: 0}, 2: {1: 0, 0: 1}, 4: {3: 0, 2: 1}}


@pytest.fixture(scope="module")
def tiny():
    s = tiny_setup(1)
    return s, jax_forwards(s)


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _leaves(kind, config):
    """(port key, torch shape, flax path, flax shape) of every leaf of the
    module's tree, through the export map, on the meta device."""
    cls, convert = TREES[kind]
    with torch.device("meta"):
        sd = cls(config).state_dict()
    for key, t in sd.items():
        ((path, leaf),) = _flat(convert({key: t}))
        yield key, tuple(t.shape), path, tuple(leaf.shape)


@pytest.mark.parametrize("kind,config", [
    ("unet", TINY_UNET_CONFIG), ("unet", SD15_GM_UNET_CONFIG), ("vae", TINY_VAE_CONFIG),
    ("vae", SD15_VAE_CONFIG), ("controlnet", TINY_CONTROLNET_CONFIG),
    ("controlnet", SD15_CONTROLNET_CONFIG),
], ids=["unet-tiny", "unet-sd15", "vae-tiny", "vae-sd15", "controlnet-tiny",
        "controlnet-sd15"])
def test_spec_for_key_agrees_with_jax_rule(tiny, kind, config):
    leaves = list(_leaves(kind, config))
    if config in (TINY_UNET_CONFIG, TINY_VAE_CONFIG, TINY_CONTROLNET_CONFIG):
        params = tiny[0]["params"][kind]
        assert sorted(p for p, _, _, _ in ((p, 0, 0, 0) for p, _ in _flat(params))) == \
            sorted(path for _, _, path, _ in leaves)
    for n in (2, 4, 8):
        split = 0
        for key, shape, path, fshape in leaves:
            spec = tuple(tp_spec_for_path(path, fshape, n))
            axis = spec.index("model") if "model" in spec else None
            want = None if axis is None else _AXIS[len(fshape)][axis]
            assert tp_spec_for_key(key, shape, n) == want, (key, path, n)
            split += want is not None
        assert split >= (20 if n == 2 else 1), (kind, n, split)


def test_geglu_halves_are_sliced_by_rank():
    """Rank r holds rows r of each half of ``ff.net.0.proj`` (hidden, then
    gate) and the matching columns of ``ff.net.2``: each rank's GEGLU is a
    whole part of the FF, and the ranks' partial outputs sum to it."""
    g = torch.Generator().manual_seed(0)
    dim, inner, n = 16, 64, 4
    pre = "down_blocks.0.attentions.0.transformer_blocks.0.ff."
    sd = {pre + "net.0.proj.weight": torch.randn(2 * inner, dim, generator=g),
          pre + "net.0.proj.bias": torch.randn(2 * inner, generator=g),
          pre + "net.2.weight": torch.randn(dim, inner, generator=g),
          pre + "net.2.bias": torch.randn(dim, generator=g)}
    x = torch.randn(3, dim, generator=g)

    def ff(w1, b1, w2, b2=None):
        hidden, gate = F.linear(x, w1, b1).chunk(2, dim=-1)
        return F.linear(hidden * F.gelu(gate), w2, b2)

    total = 0
    for r in range(n):
        local = tp_shard_state_dict(sd, r, n)
        w1 = local[pre + "net.0.proj.weight"]
        rows = slice(r * inner // n, (r + 1) * inner // n)
        assert torch.equal(w1[:inner // n], sd[pre + "net.0.proj.weight"][rows])
        assert torch.equal(w1[inner // n:], sd[pre + "net.0.proj.weight"][inner:][rows])
        assert torch.equal(local[pre + "net.2.weight"], sd[pre + "net.2.weight"][:, rows])
        assert local[pre + "net.2.bias"] is sd[pre + "net.2.bias"]  # added once, after
        total = total + ff(w1, local[pre + "net.0.proj.bias"], local[pre + "net.2.weight"])
    want = ff(*(sd[pre + k] for k in ("net.0.proj.weight", "net.0.proj.bias", "net.2.weight",
                                      "net.2.bias")))
    np.testing.assert_allclose((total + sd[pre + "net.2.bias"]).numpy(), want.numpy(),
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="GEGLU halves"):
        tp_slice(pre + "net.0.proj.weight", torch.zeros(12, dim), 0, 4)


@pytest.mark.parametrize("world", [2, 4])
def test_forwards_with_weight_slices_match_gmdx(tmp_path, tiny, world):
    """tp = 2: every resnet, attention, FF and the time MLP split (heads / 2
    on the head-parallel route); tp = 4: the tiny model's 2 heads do not
    split, so its attentions take the whole route from gathered weights."""
    s, want = tiny
    for r in Ranks("tp_models", world, tmp_path, port_setup(s, mode="tp")).results():
        assert_forwards_close(r, want)


def test_dual_loop_at_tp2_matches_one_process(tmp_path, tiny):
    """CFG at 7.5 scales the eps's rounding (the partial sums' order) into
    latents of magnitude ~10: the bound is 3e-5 relative, and 3e-5 of the
    latents' peak absolute."""
    s, _ = tiny
    rng = np.random.default_rng(7)
    torch.manual_seed(7)
    gm = UNet2DConditionModel(dataclasses.replace(TINY_UNET_CONFIG, in_channels=8))
    setup = {"unet_sd": s["unet_sd"], "vae_sd": s["vae_sd"],
             "gm_unet_sd": {k: v.numpy() for k, v in gm.state_dict().items()},
             "cond": rng.standard_normal((1, 7, 32)).astype(np.float32),
             "uncond": rng.standard_normal((1, 7, 32)).astype(np.float32),
             "latents": rng.standard_normal((1, 4, 8, 8)).astype(np.float32)}
    ranks = Ranks("tp_dual", 2, tmp_path, {**setup, "mode": "tp"})
    want = dual_run(setup, None)
    for r in ranks.results():
        for k in ("sdr", "gm"):
            np.testing.assert_allclose(r[k], want[k], rtol=TOL,
                                       atol=TOL * float(np.abs(want[k]).max()), err_msg=k)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("heads,widths", [
    (8, (320, 320, 320)), (8, (640, 640, 640)), (2, (32, 32, 32)), (1, (512, 512, 512)),
    (7, (63, 63, 63)), (4, (40, 40, 48)), (6, (48, 48, 48)),
])
def test_tp_route_agrees_with_jax(n, heads, widths):
    """The head-parallel route exactly where gmdx's ``_tp_route`` gives its
    shard_map; GroupNorm, the conv and the FF on library calls exactly where
    gmdx's dispatch sees an active TP context."""
    import importlib

    from gmdx.kernels.attention import _tp_route
    from gmdx.kernels.winograd import winograd_eligible
    from gmdx.models import layers as jax_layers

    q, k, v = (jnp.zeros((2, 4, w)) for w in widths)
    mesh = make_mesh(n, ("data", "model"), shape=(1, n))
    jax_ff = importlib.import_module("gmdx.kernels.geglu_ff")
    with tp_kernel_context(mesh):
        jax_heads = _tp_route(q, k, v, heads) is not None
        gates = (jax_layers._tp_active(), jax_ff._tp_active(),
                 not winograd_eligible((8, 64, 64, 64), 64, 2))
    route = tp_route("attention", n, heads=heads, widths=widths)
    assert (route == "heads") == jax_heads
    assert route == ("kernel" if n == 1 else "heads" if jax_heads else "whole")
    for op in TP_LIBRARY_OPS:
        assert (tp_route(op, n) == "library") == (n > 1)
    if n > 1:
        assert all(g is not None and g is not False for g in gates)
    with pytest.raises(ValueError):
        tp_route("softmax", n)
