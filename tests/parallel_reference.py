"""The JAX side of the tensor- and spatial-parallel tests: the tiny UNet, VAE
and ControlNet of ``gmdx`` with seeded weights (the ControlNet's zero convs
and embedder output made non-zero), their state dicts for the port, numpy
inputs, and gmdx's unsharded forwards on them at full fp32 precision.
Imported by ``tests/test_torch_tp.py`` and ``tests/test_torch_sp.py``."""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from gmdx.models import TINY_CONTROLNET_CONFIG as J_CNET
from gmdx.models import TINY_UNET_CONFIG as J_UNET
from gmdx.models import TINY_VAE_CONFIG as J_VAE
from gmdx.models import AutoencoderKL as JaxVAE
from gmdx.models import ControlNetModel as JaxControlNet
from gmdx.models import UNet2DConditionModel as JaxUNet
from gmdx.models import controlnet_params_from_unet
from gmdx_torch.io.convert import (
    controlnet_state_dict_from_flax, unet_state_dict_from_flax, vae_state_dict_from_flax,
)

# The parallel tests' tolerance: tests/test_tp.py's for GSPMD's shardings.
TOL = 3e-5
LATENT, IMAGE, CTX = 16, 32, (7, 32)


def _randomize(tree, rng, scale=0.05):
    return jax.tree.map(lambda v: (scale * rng.standard_normal(v.shape)).astype(np.float32), tree)


def tiny_setup(seed: int = 0) -> dict:
    """Flax params of the three tiny models, their port state dicts and the
    inputs: latents (2, 4, 16, 16), a timestep, a (2, 7, 32) context, an
    image (1, 3, 32, 32) in [-1, 1], a latent to decode (1, 4, 16, 16) and a
    (2, 3, 128, 128) control image in [0, 1]."""
    rng = np.random.default_rng(seed)
    x = jnp.zeros((1, 4, 8, 8))
    ctx = jnp.zeros((1,) + CTX)
    unet, vae, cnet = JaxUNet(J_UNET), JaxVAE(J_VAE), JaxControlNet(J_CNET)
    unet_params = jax.jit(unet.init)(jax.random.key(seed), x, jnp.array(1.0), ctx)["params"]
    cnet_init = jax.jit(cnet.init)(jax.random.key(seed + 1), x, jnp.array(1.0), ctx,
                                   jnp.zeros((1, 3, 64, 64)))["params"]
    cnet_params = jax.tree.map(np.asarray, controlnet_params_from_unet(cnet_init, unet_params))
    for name in list(cnet_params):
        if name.startswith(("controlnet_down_", "controlnet_mid")):
            cnet_params[name] = _randomize(cnet_params[name], rng)
    emb = dict(cnet_params["cond_embedding"])
    emb["conv_out"] = _randomize(emb["conv_out"], rng)
    cnet_params["cond_embedding"] = emb
    params = jax.tree.map(np.asarray, {
        "unet": unet_params, "controlnet": cnet_params,
        "vae": jax.jit(vae.init)(jax.random.key(seed + 2), jnp.zeros((1, 3, 32, 32)),
                                 jax.random.key(seed + 3))["params"],
    })
    return {
        "params": params, "modules": {"unet": unet, "vae": vae, "cnet": cnet},
        "unet_sd": unet_state_dict_from_flax(params["unet"]),
        "vae_sd": vae_state_dict_from_flax(params["vae"]),
        "cnet_sd": controlnet_state_dict_from_flax(params["controlnet"]),
        "x": rng.standard_normal((2, 4, LATENT, LATENT)).astype(np.float32),
        "t": 501,
        "ctx": rng.standard_normal((2,) + CTX).astype(np.float32),
        "img": rng.uniform(-1, 1, (1, 3, IMAGE, IMAGE)).astype(np.float32),
        "z": rng.standard_normal((1, 4, LATENT, LATENT)).astype(np.float32),
        "cond": rng.uniform(0, 1, (2, 3, 8 * LATENT, 8 * LATENT)).astype(np.float32),
    }


def port_setup(s: dict, **extra) -> dict:
    """What the ranks need (numpy and plain values only)."""
    keys = ("unet_sd", "vae_sd", "cnet_sd", "x", "t", "ctx", "img", "z", "cond")
    return {**{k: s[k] for k in keys}, **extra}


def jax_forwards(s: dict) -> dict:
    """gmdx's unsharded forwards on the setup's inputs, as numpy (NHWC
    ControlNet residuals, as the port's)."""
    m, p = s["modules"], s["params"]

    def run(p, x, t, ctx, img, z, cond):
        post = m["vae"].apply({"params": p["vae"]}, img, method=m["vae"].encode)
        return {"unet": m["unet"].apply({"params": p["unet"]}, x, t, ctx),
                "vae_mean": post.mean, "vae_std": post.std,
                "vae_decode": m["vae"].apply({"params": p["vae"]}, z, method=m["vae"].decode),
                "cnet": m["cnet"].apply({"params": p["controlnet"]}, x, t, ctx, cond)}

    with jax.default_matmul_precision("highest"):
        out = jax.jit(run)(p, jnp.asarray(s["x"]), jnp.array(float(s["t"])),
                           *(jnp.asarray(s[k]) for k in ("ctx", "img", "z", "cond")))
    down, mid = out.pop("cnet")
    return {**{k: np.asarray(v) for k, v in out.items()},
            "cnet_down": [np.asarray(d) for d in down], "cnet_mid": np.asarray(mid)}


def assert_forwards_close(got: dict, want: dict, tol: float = TOL) -> None:
    for key in want:
        pairs = zip(got[key], want[key]) if isinstance(want[key], list) else [(got[key], want[key])]
        for i, (a, b) in enumerate(pairs):
            assert float(np.abs(b).max()) > 0.0, key
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=f"{key} {i}")
