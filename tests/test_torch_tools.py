"""The port's measurement tools on the CPU: ``scripts/torch/scan_bench.py``'s
chained bodies against the JAX tool's under ``lax.scan``, ``ckpt_timing``'s
round trip and ``profile_step``'s trace.

Each scan_bench body runs 3 chained iterations on the same weights (seeded
flax params in gmdx's tree, carried across by ``gmdx_torch.io.convert``)
and the same numpy
inputs as gmdx's ``lax.scan`` of the same body at the tiny widths, fp32;
the two must agree to >= 100 dB PSNR. gmdx's kernels run as its own CPU
tests run them: the conv through ``winograd_conv3x3(..., interpret=True)``
(the direct conv where it declines the shape), attention through
``attention_packed``'s CPU dispatch.
"""

import dataclasses
import importlib.util
import json
import os
import pathlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gmdx.kernels.attention import attention_packed as jax_attention_packed
from gmdx.kernels.winograd import winograd_conv3x3
from gmdx.models import TINY_UNET_CONFIG as JAX_TINY_UNET
from gmdx.models import TINY_VAE_CONFIG as JAX_TINY_VAE
from gmdx.models import AutoencoderKL as JaxVAE
from gmdx.models import UNet2DConditionModel as JaxUNet
from gmdx_torch.io.convert import (
    load_unet, load_vae, unet_state_dict_from_flax, vae_state_dict_from_flax,
)
from gmdx_torch.models import TINY_UNET_CONFIG, TINY_VAE_CONFIG
from gmdx_torch.models.layers import Conv3x3

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "scripts" / "torch"
PSNR_MIN_DB = 100.0
ITERS = 3


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"tools_{name}", TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


sb = _load("scan_bench")


def psnr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    peak = max(np.abs(a).max(), np.abs(b).max(), 1e-9)
    mse = float(np.mean((a - b) ** 2))
    return float("inf") if mse == 0.0 else 10.0 * np.log10(peak**2 / mse)


def jax_scan(body, carry, n: int = ITERS):
    """The JAX tool's chaining: ``n`` iterations of ``body`` in one jitted
    ``lax.scan``."""
    @jax.jit
    def run(c):
        return jax.lax.scan(lambda c, _: (body(c), None), c, None, length=n)[0]

    return np.asarray(run(jnp.asarray(carry)))


@torch.no_grad()
def torch_chain(body, carry, n: int = ITERS):
    return sb.chain(body, torch.from_numpy(carry), n).numpy()


def seeded_params(model, seed: int, *init_args) -> dict:
    """Flax params of ``model`` drawn with numpy (the tree's shapes from
    ``jax.eval_shape`` of its init, which compiles nothing): norm scales
    near 1, biases near 0, kernels at 1/sqrt(fan-in)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.key(0), *init_args)["params"]

    def draw(path, leaf):
        name = path[-1].key
        noise = rng.standard_normal(leaf.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.1 * noise
        if name == "bias":
            return 0.05 * noise
        return noise / np.sqrt(max(1, int(np.prod(leaf.shape[:-1]))))

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def gm_unet():
    model = JaxUNet(dataclasses.replace(JAX_TINY_UNET, in_channels=8))
    params = seeded_params(model, 0, jnp.zeros((1, 8, 8, 8)), jnp.array(1.0),
                           jnp.zeros((1, 77, 32)))
    unet = load_unet(unet_state_dict_from_flax(params),
                     dataclasses.replace(TINY_UNET_CONFIG, in_channels=8),
                     device="cpu", dtype=torch.float32)
    return model, params, unet


@pytest.mark.parametrize("channels_last", [False, True], ids=["nchw", "nhwc"])
def test_unet_fwd_body_matches_jax_scan(gm_unet, channels_last):
    model, params, unet = gm_unet
    rng = np.random.default_rng(1)
    shape = (2, 8, 8, 8)
    x = rng.standard_normal(shape).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 32)).astype(np.float32)
    ax = -1 if channels_last else 1

    def body(c):
        eps = model.apply({"params": params}, c, jnp.array(501, jnp.int32), jnp.asarray(ctx),
                          channels_last=channels_last)
        return jnp.concatenate([eps, eps], axis=ax) * 0.5 + c * 0.5

    want = jax_scan(body, x)
    got = torch_chain(sb.unet_fwd_body(unet, torch.tensor(501, dtype=torch.int32),
                                       torch.from_numpy(ctx), channels_last), x)
    assert psnr(got, want) >= PSNR_MIN_DB


def test_vae_decode_body_matches_jax_scan():
    model = JaxVAE(JAX_TINY_VAE)
    params = seeded_params(model, 1, jnp.zeros((1, 3, 32, 32)), jax.random.key(2))
    vae = load_vae(vae_state_dict_from_flax(params), TINY_VAE_CONFIG, device="cpu",
                   dtype=torch.float32)
    f = sb.vae_factor(vae)
    assert f == 2
    z = np.random.default_rng(2).standard_normal((2, 4, 8, 8)).astype(np.float32)

    def body(c):
        pooled = model.apply({"params": params}, c, method=model.decode)[:, :, ::f, ::f]
        return c * 0.9 + 0.1 * jnp.concatenate([pooled, pooled[:, :1]], axis=1)

    assert psnr(torch_chain(sb.vae_decode_body(vae), z), jax_scan(body, z)) >= PSNR_MIN_DB


@pytest.mark.parametrize("c,o", [(32, 16), (16, 32)], ids=["tiled", "cut"])
def test_conv3x3_body_matches_jax_scan(c, o):
    rng = np.random.default_rng(3)
    kernel = (rng.standard_normal((3, 3, c, o)) * 0.02).astype(np.float32)  # HWIO
    bias = (rng.standard_normal(o) * 0.1).astype(np.float32)
    x = rng.standard_normal((2, 16, 16, c)).astype(np.float32)

    def body(xc):
        out = winograd_conv3x3(xc, jnp.asarray(kernel), jnp.asarray(bias), interpret=True)
        if out is None:
            out = jax.lax.conv_general_dilated(
                xc, jnp.asarray(kernel), (1, 1), ((1, 1), (1, 1)),
                dimension_numbers=("NHWC", "HWIO", "NHWC")) + bias
        reps = c // o
        chained = jnp.concatenate([out] * reps, axis=-1) if reps > 1 else out
        return xc * 0.5 + 0.5 * chained[..., :c]

    conv = Conv3x3(c, o)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()))
        conv.bias.copy_(torch.from_numpy(bias))
    assert psnr(torch_chain(sb.conv3x3_body(conv), x), jax_scan(body, x)) >= PSNR_MIN_DB


@pytest.mark.parametrize("seq", [64, 256], ids=["xla_route", "kv_resident_route"])
def test_attention_body_matches_jax_scan(seq):
    heads, d = 2, 40
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, seq, heads * d)).astype(np.float32) for _ in range(3))

    def body(qc):
        out = jax_attention_packed(qc, jnp.asarray(k), jnp.asarray(v), heads)
        return (qc * 0.5 + 0.5 * out).astype(qc.dtype)

    got = torch_chain(sb.attention_body(torch.from_numpy(k), torch.from_numpy(v), heads), q)
    assert psnr(got, jax_scan(body, q)) >= PSNR_MIN_DB


@pytest.mark.parametrize("workload", sorted(sb.WORKLOADS))
def test_scan_bench_runs_eager_only_on_cpu(workload, capsys):
    row = sb.main(["--workload", workload, "--size", "tiny", "--res", "64", "--batch", "1",
                   "--iters", "2", "--device", "cpu", "--in-ch", "32",
                   "--out-ch", "16", "--seq", "64", "--heads", "2", "--head-dim", "40"])
    assert row["eager_s_per_iter"] > 0 and row["card"] is None
    assert "s_per_iter" not in row and "captured_launches" not in row
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == row


def test_ckpt_timing_round_trip(tmp_path, capsys):
    ct = _load("ckpt_timing")
    row = ct.main(["--width", "0.05", "--with-ema", "--device", "cpu", "--out", str(tmp_path)])
    assert row["round_trip_digest_equal"]
    assert row["state_tensors"] == 4 * len(list(ct.build_state(0.05, False, torch.device(
        "cpu")).unet.parameters()))
    for mode in ("sync", "async"):
        assert (tmp_path / mode / "checkpoint_1").is_dir()
        assert row[f"{mode}_save_durable_s"] >= row[f"{mode}_save_block_s"] > 0
    assert 13.0 < row["full_width_state_gb"] < 14.5  # params + two moments + EMA, fp32
    out = capsys.readouterr().out
    assert "round trip verified" in out and "d2h" not in json.loads(out.splitlines()[-1])


def test_profile_step_writes_trace_and_reading(tmp_path, capsys):
    ps = _load("profile_step")
    row = ps.main(["--workload", "gm_unet_fwd", "--size", "tiny", "--res", "64", "--batch", "1",
                   "--iters", "2", "--dtype", "float32", "--device", "cpu", "--out",
                   str(tmp_path)])
    assert row["trace"] == str(tmp_path / "gm_unet_fwd_process.trace.json")
    assert os.path.getsize(row["trace"]) > 0
    assert {s["name"]: s["count"] for s in row["spans"]} == {"gm_unet_fwd[0]": 1,
                                                             "gm_unet_fwd[1]": 1}
    assert row["by_category"] == [] and row["busy_share"] is None  # no device on the CPU
    out = capsys.readouterr().out
    assert "== by category ==" in out and "== longest idle gaps ==" in out
    assert json.loads(out.strip().splitlines()[-1]) == row
