"""gmdx_torch models against the JAX package on the CPU, fp32.

The same flax params go to both packages: the JAX package's own init, carried
across by ``gmdx_torch.io.convert`` (held key-for-key and value-for-value to
``gmdx.io.torch_import``'s export) and loaded with ``strict=True``. The same
numpy inputs then go through both forwards, which must agree to >= 100 dB
PSNR (peak = the larger absolute maximum of the two outputs).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gmdx.io.torch_import import (
    export_clip_text_state_dict,
    export_unet_state_dict,
    export_vae_state_dict,
)
from gmdx.models import CLIPTextModel as JaxCLIP
from gmdx.models import TINY_CLIP_CONFIG as JAX_TINY_CLIP
from gmdx.models import AutoencoderKL as JaxVAE
from gmdx.models import TINY_UNET_CONFIG as JAX_TINY_UNET
from gmdx.models import TINY_VAE_CONFIG as JAX_TINY_VAE
from gmdx.models import UNet2DConditionModel as JaxUNet
from gmdx.models.layers import timestep_embedding as jax_timestep_embedding
from gmdx_torch.io.convert import (
    clip_text_state_dict_from_flax,
    load_clip_text,
    load_unet,
    load_vae,
    unet_state_dict_from_flax,
    vae_state_dict_from_flax,
)
from gmdx_torch.models import (
    TINY_CLIP_CONFIG,
    TINY_UNET_CONFIG,
    TINY_VAE_CONFIG,
    UNet2DConditionModel,
)
from gmdx_torch.models.layers import timestep_embedding

PSNR_MIN_DB = 100.0


def psnr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    peak = max(np.abs(a).max(), np.abs(b).max(), 1e-9)
    mse = float(np.mean((a - b) ** 2))
    return float("inf") if mse == 0.0 else 10.0 * np.log10(peak**2 / mse)


@pytest.fixture(scope="module", params=[4, 8], ids=["sdr_unet", "gm_unet"])
def unet_pair(request):
    in_ch = request.param
    jcfg = dataclasses.replace(JAX_TINY_UNET, in_channels=in_ch)
    model = JaxUNet(jcfg)
    params = model.init(
        jax.random.key(in_ch), jnp.zeros((1, in_ch, 16, 16)), jnp.array(1.0),
        jnp.zeros((1, 7, 32)),
    )["params"]
    params = jax.tree.map(np.asarray, params)
    cfg = dataclasses.replace(TINY_UNET_CONFIG, in_channels=in_ch)
    return model, params, cfg


@pytest.fixture(scope="module")
def vae_pair():
    model = JaxVAE(JAX_TINY_VAE)
    params = model.init(
        jax.random.key(1), jnp.zeros((1, 3, 32, 32)), jax.random.key(2)
    )["params"]
    return model, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def clip_pair():
    model = JaxCLIP(JAX_TINY_CLIP)
    params = model.init(jax.random.key(4), jnp.zeros((1, 7), jnp.int32))["params"]
    return model, jax.tree.map(np.asarray, params)


def test_configs_match_jax():
    from gmdx.models import SD15_GM_UNET_CONFIG as J_GM
    from gmdx.models import SD15_UNET_CONFIG as J_SDR
    from gmdx.models import SD15_VAE_CONFIG as J_VAE
    from gmdx.models import CLIP_VIT_L_CONFIG as J_CLIP
    from gmdx_torch.models import (
        CLIP_VIT_L_CONFIG, SD15_GM_UNET_CONFIG, SD15_UNET_CONFIG, SD15_VAE_CONFIG,
    )

    for ours, theirs in (
        (SD15_UNET_CONFIG, J_SDR), (SD15_GM_UNET_CONFIG, J_GM),
        (TINY_UNET_CONFIG, JAX_TINY_UNET), (SD15_VAE_CONFIG, J_VAE),
        (TINY_VAE_CONFIG, JAX_TINY_VAE), (CLIP_VIT_L_CONFIG, J_CLIP),
        (TINY_CLIP_CONFIG, JAX_TINY_CLIP),
    ):
        mine = dataclasses.asdict(ours)
        ref = {k: v for k, v in dataclasses.asdict(theirs).items() if k in mine}
        assert mine == ref


def test_timestep_embedding_matches_jax():
    t = np.array([1, 250, 981], np.int32)
    want = jax_timestep_embedding(jnp.asarray(t), 320)
    got = timestep_embedding(torch.from_numpy(t), 320)
    # Arguments reach ~981 rad, where one fp32 ulp is 6e-5: the two sin/cos
    # implementations reduce them differently by about that much.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_unet_state_dict_matches_export(unet_pair):
    _, params, cfg = unet_pair
    sd = unet_state_dict_from_flax(params)
    ref = export_unet_state_dict(params)
    assert sorted(sd) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(sd[k], ref[k], err_msg=k)
    # strict=True: every key of the port's module tree, and nothing else.
    model = load_unet(sd, cfg, device="cpu", dtype=torch.float32)
    assert set(model.state_dict()) == set(sd)


def test_vae_state_dict_matches_export(vae_pair):
    """Encoder, quant_conv, decoder and post_quant_conv, key for key."""
    _, params = vae_pair
    sd = vae_state_dict_from_flax(params)
    ref = export_vae_state_dict(params)
    assert sorted(sd) == sorted(ref)
    assert any(k.startswith("encoder.") for k in sd) and "quant_conv.weight" in sd
    for k in sd:
        np.testing.assert_array_equal(sd[k], ref[k], err_msg=k)
    model = load_vae(sd, TINY_VAE_CONFIG, device="cpu", dtype=torch.float32)
    assert set(model.state_dict()) == set(sd)


def test_clip_text_state_dict_matches_export(clip_pair):
    _, params = clip_pair
    sd = clip_text_state_dict_from_flax(params)
    ref = export_clip_text_state_dict(params)
    assert sorted(sd) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(sd[k], ref[k], err_msg=k)
    model = load_clip_text(sd, TINY_CLIP_CONFIG, device="cpu", dtype=torch.float32)
    assert set(model.state_dict()) == set(sd)


def test_unet_forward_matches_jax(unet_pair):
    jmodel, params, cfg = unet_pair
    rng = np.random.default_rng(cfg.in_channels)
    x = rng.standard_normal((2, cfg.in_channels, 16, 16)).astype(np.float32)
    ctx = rng.standard_normal((2, 7, 32)).astype(np.float32)
    t = np.array([10, 981], np.int32)
    with jax.default_matmul_precision("highest"):
        want = jmodel.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(ctx))
    model = load_unet(unet_state_dict_from_flax(params), cfg, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(ctx))
        got_nhwc = model(
            torch.from_numpy(x).permute(0, 2, 3, 1), torch.from_numpy(t),
            torch.from_numpy(ctx), channels_last=True,
        )
    assert got.shape == x.shape[:1] + (4,) + x.shape[2:]
    assert psnr(got.numpy(), want) >= PSNR_MIN_DB
    np.testing.assert_array_equal(got_nhwc.permute(0, 3, 1, 2).numpy(), got.numpy())


def test_vae_decode_matches_jax(vae_pair):
    jmodel, params = vae_pair
    z = np.random.default_rng(5).standard_normal((2, 4, 8, 8)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jmodel.apply({"params": params}, jnp.asarray(z), method=jmodel.decode)
    model = load_vae(vae_state_dict_from_flax(params), TINY_VAE_CONFIG, device="cpu",
                     dtype=torch.float32)
    with torch.no_grad():
        got = model.decode(torch.from_numpy(z))
    assert got.shape == (2, 3, 16, 16)
    assert psnr(got.numpy(), want) >= PSNR_MIN_DB


def test_vae_encode_matches_jax(vae_pair):
    """The posterior's mean and std (encoder with its asymmetric-pad
    downsamplers and plain mid attention, then quant_conv)."""
    jmodel, params = vae_pair
    x = np.random.default_rng(6).uniform(-1, 1, (2, 3, 32, 32)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jmodel.apply({"params": params}, jnp.asarray(x), method=jmodel.encode)
    model = load_vae(vae_state_dict_from_flax(params), TINY_VAE_CONFIG, device="cpu",
                     dtype=torch.float32)
    with torch.no_grad():
        got = model.encode(torch.from_numpy(x))
    assert got.mean.shape == (2, 4, 16, 16) and got.mean.dtype == torch.float32
    assert psnr(got.mean.numpy(), want.mean) >= PSNR_MIN_DB
    assert psnr(got.std.numpy(), want.std) >= PSNR_MIN_DB
    np.testing.assert_allclose(got.kl().numpy(), np.asarray(want.kl()), rtol=1e-4)
    assert torch.equal(got.mode(), got.mean)
    z = got.sample(torch.Generator().manual_seed(0))
    assert z.shape == got.mean.shape and torch.isfinite(z).all()


@pytest.mark.parametrize("clip_skip", [None, 0])
def test_clip_text_matches_jax(clip_pair, clip_skip):
    jmodel, params = clip_pair
    ids = np.random.default_rng(7).integers(0, JAX_TINY_CLIP.vocab_size, (2, 7)).astype(np.int32)
    with jax.default_matmul_precision("highest"):
        want = jmodel.apply({"params": params}, jnp.asarray(ids), clip_skip)
    model = load_clip_text(clip_text_state_dict_from_flax(params), TINY_CLIP_CONFIG,
                           device="cpu", dtype=torch.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(ids).long(), clip_skip)
    assert got.shape == (2, 7, 32) and got.dtype == torch.float32
    assert psnr(got.numpy(), want) >= PSNR_MIN_DB


def test_use_kernels_false_is_the_plain_path_on_cpu(unet_pair):
    """On the CPU the kernel wrappers run the plain versions, so routing the
    model to the plain functions explicitly changes nothing."""
    from gmdx_torch.models import set_use_kernels

    _, params, cfg = unet_pair
    model = load_unet(unet_state_dict_from_flax(params), cfg, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((1, cfg.in_channels, 8, 8)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((1, 7, 32)).astype(np.float32))
    with torch.no_grad():
        a = model(x, 500, ctx)
        set_use_kernels(model, False)
        b = model(x, 500, ctx)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_loaders_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no card"):
        load_vae({}, TINY_VAE_CONFIG)
    with pytest.raises(RuntimeError, match="no card"):
        load_unet({}, TINY_UNET_CONFIG)
    with pytest.raises(RuntimeError, match="no card"):
        load_clip_text({}, TINY_CLIP_CONFIG)


def test_bf16_model_keeps_layout_on_cpu():
    """A bf16 model runs its plain versions on the CPU in bf16 and returns
    fp32, like the card's path."""
    torch.manual_seed(0)
    model = UNet2DConditionModel(TINY_UNET_CONFIG).to(torch.bfloat16)
    x = torch.randn(1, 4, 8, 8)
    with torch.no_grad():
        out = model(x, 10, torch.randn(1, 7, 32))
    assert out.dtype == torch.float32 and out.shape == x.shape
    assert torch.isfinite(out).all()


def test_fp32_params_bf16_compute_grads_land_in_fp32():
    """flax's ``dtype=``: fp32 parameters, bf16 activations; the casts at use
    stay in the graph, so every parameter gets an fp32 gradient."""
    torch.manual_seed(0)
    model = UNet2DConditionModel(TINY_UNET_CONFIG, dtype=torch.bfloat16)
    out = model(torch.randn(1, 4, 16, 16), torch.tensor([10]), torch.randn(1, 7, 32))
    assert out.dtype == torch.float32
    out.square().mean().backward()
    for n, p in model.named_parameters():
        assert p.dtype == torch.float32 and p.grad is not None and p.grad.dtype == torch.float32, n
        assert torch.isfinite(p.grad).all(), n


def test_conv_packed_weight_follows_optimizer_updates():
    """The conv kernel's packed weight is rebuilt after an in-place update
    (an optimizer step), never served stale."""
    from gmdx_torch.models.layers import Conv3x3

    torch.manual_seed(0)
    conv = Conv3x3(8, 8)
    x = torch.randn(1, 6, 6, 8)
    with torch.no_grad():
        before = conv.packed_weight(torch.float32).clone()
        conv.weight.add_(1.0)
        after = conv.packed_weight(torch.float32)
        y = conv(x)
        ref = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), conv.weight, conv.bias, padding=1)
    assert not torch.equal(before, after)
    np.testing.assert_allclose(y.numpy(), ref.permute(0, 2, 3, 1).numpy(), atol=1e-5)
