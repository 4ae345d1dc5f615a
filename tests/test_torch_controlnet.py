"""gmdx_torch's ControlNet slice against the JAX package on the CPU, fp32.

The same flax params go to both packages (the ControlNet's zero convs set to
random, non-zero weights first: fresh zero convs make every residual 0 and
would pass a broken ControlNet), carried across by
``gmdx_torch.io.convert`` and loaded with ``strict=True``. The same numpy
inputs then go through the ControlNet, the UNet with its residual hooks, the
ControlNet pipeline (3 PNDM steps, CFG 7.5, batched and sequential CFG),
the decode, Eq. (1), ``upconvert_sdr_to_hdrtv`` and ``__call__`` from
prompts; every output must agree to >= 100 dB PSNR (peak = the larger
absolute maximum of the two).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from gmdx.models import CLIPTextModel as JaxCLIP
from gmdx.models import CLIPTokenizer as JaxTokenizer
from gmdx.models import ControlNetModel as JaxControlNet
from gmdx.models import AutoencoderKL as JaxVAE
from gmdx.models import TINY_CLIP_CONFIG as J_CLIP
from gmdx.models import TINY_CONTROLNET_CONFIG as J_CNET
from gmdx.models import TINY_UNET_CONFIG as J_UNET
from gmdx.models import TINY_VAE_CONFIG as J_VAE
from gmdx.models import UNet2DConditionModel as JaxUNet
from gmdx.models import controlnet_params_from_unet
from gmdx.ops import apply_gm_to_sdr as jax_apply_gm_to_sdr
from gmdx.pipelines import StableDiffusionControlNetHDRPipeline as JaxControlPipe
from gmdx.pipelines import upconvert_sdr_to_hdrtv as jax_upconvert
from gmdx.schedulers import PNDMScheduler as JaxPNDM
from gmdx_torch.io.convert import (
    clip_text_state_dict_from_flax,
    controlnet_state_dict_from_flax,
    controlnet_state_dict_from_unet,
    load_clip_text,
    load_controlnet,
    load_unet,
    load_vae,
    unet_state_dict_from_flax,
    vae_state_dict_from_flax,
)
from gmdx_torch.models import (
    TINY_CLIP_CONFIG,
    TINY_CONTROLNET_CONFIG,
    TINY_UNET_CONFIG,
    TINY_VAE_CONFIG,
    CLIPTokenizer,
    ControlNetModel,
)
from gmdx_torch.ops import apply_gm_to_sdr
from gmdx_torch.pipelines import StableDiffusionControlNetHDRPipeline, upconvert_sdr_to_hdrtv
from gmdx_torch.schedulers import PNDMScheduler

PSNR_MIN_DB = 100.0
B, SIDE, CTX = 2, 32, (77, 32)  # latents 4x4; the embedder downsamples 8x
ZERO_CONVS = ("controlnet_down_", "controlnet_mid")


def psnr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    peak = max(np.abs(a).max(), np.abs(b).max(), 1e-9)
    mse = float(np.mean((a - b) ** 2))
    return float("inf") if mse == 0.0 else 10.0 * np.log10(peak**2 / mse)


def _assert_close(name, got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    db = psnr(got, np.asarray(want))
    assert db >= PSNR_MIN_DB, f"{name}: {db:.1f} dB"


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


@pytest.fixture(scope="module")
def tiny():
    """Flax params of the tiny ControlNet slice (the ControlNet copied from
    the SDR UNet, its zero convs and embedder output conv random), and
    numpy inputs."""
    rng = np.random.default_rng(0)
    x = jnp.zeros((1, 4, 4, 4))
    ctx = jnp.zeros((1,) + CTX)
    unet, cnet = JaxUNet(J_UNET), JaxControlNet(J_CNET)
    gm_unet = JaxUNet(dataclasses.replace(J_UNET, in_channels=8))
    vae, text = JaxVAE(J_VAE), JaxCLIP(J_CLIP)
    unet_params = unet.init(jax.random.key(0), x, jnp.array(1.0), ctx)["params"]
    cnet_init = cnet.init(jax.random.key(1), x, jnp.array(1.0), ctx,
                          jnp.zeros((1, 3, SIDE, SIDE)))["params"]
    cnet_params = jax.tree.map(np.asarray, controlnet_params_from_unet(cnet_init, unet_params))
    for name in cnet_params:
        if name.startswith(ZERO_CONVS):
            cnet_params[name] = {k: (0.05 * rng.standard_normal(v.shape)).astype(np.float32)
                                 for k, v in cnet_params[name].items()}
    emb = dict(cnet_params["cond_embedding"])
    emb["conv_out"] = {k: (0.05 * rng.standard_normal(v.shape)).astype(np.float32)
                       for k, v in emb["conv_out"].items()}
    cnet_params["cond_embedding"] = emb
    params = {
        "unet": unet_params,
        "controlnet": cnet_params,
        "gm_unet": gm_unet.init(jax.random.key(2), jnp.zeros((1, 8, 4, 4)), jnp.array(1.0),
                                ctx)["params"],
        "vae": vae.init(jax.random.key(3), jnp.zeros((1, 3, 32, 32)),
                        jax.random.key(4))["params"],
        "text_encoder": text.init(jax.random.key(5), jnp.zeros((1, 77), jnp.int32))["params"],
    }
    params = jax.tree.map(np.asarray, params)
    j_pipe = JaxControlPipe(unet, vae, text, JaxTokenizer.tiny(), JaxPNDM(), gm_unet=gm_unet,
                            controlnet=cnet)
    inputs = {
        "cond": rng.standard_normal((B,) + CTX).astype(np.float32),
        "uncond": rng.standard_normal((B,) + CTX).astype(np.float32),
        "latents": rng.standard_normal((B, 4, 4, 4)).astype(np.float32),
        "control": rng.uniform(0.0, 1.0, (B, 3, SIDE, SIDE)).astype(np.float32),
    }
    return {"pipe": j_pipe, "params": params, "cnet_init": jax.tree.map(np.asarray, cnet_init),
            "cnet": cnet, "unet": unet, **inputs}


def _port_pipeline(params):
    kw = dict(device="cpu", dtype=torch.float32)
    sdr = load_unet(unet_state_dict_from_flax(params["unet"]), TINY_UNET_CONFIG, **kw)
    gm = load_unet(unet_state_dict_from_flax(params["gm_unet"]),
                   dataclasses.replace(TINY_UNET_CONFIG, in_channels=8), **kw)
    vae = load_vae(vae_state_dict_from_flax(params["vae"]), TINY_VAE_CONFIG, **kw)
    cnet = load_controlnet(controlnet_state_dict_from_flax(params["controlnet"]),
                           TINY_CONTROLNET_CONFIG, **kw)
    text = load_clip_text(clip_text_state_dict_from_flax(params["text_encoder"]),
                          TINY_CLIP_CONFIG, **kw)
    return StableDiffusionControlNetHDRPipeline(
        sdr, vae, PNDMScheduler(), gm, cnet, text_encoder=text, tokenizer=CLIPTokenizer.tiny(),
        device="cpu")


@pytest.fixture(scope="module")
def port_pipe(tiny):
    return _port_pipeline(tiny["params"])


# ---------------------------------------------------------------------------
# the model and its weights
# ---------------------------------------------------------------------------


def test_controlnet_configs_match_jax():
    from gmdx.models import SD15_CONTROLNET_CONFIG as J_SD15
    from gmdx_torch.models import SD15_CONTROLNET_CONFIG

    for ours, theirs in ((SD15_CONTROLNET_CONFIG, J_SD15), (TINY_CONTROLNET_CONFIG, J_CNET)):
        mine = dataclasses.asdict(ours)
        ref = dataclasses.asdict(theirs)
        ref["unet"] = {k: v for k, v in ref["unet"].items() if k in mine["unet"]}
        assert mine == ref


def test_controlnet_state_dict_covers_every_leaf(tiny):
    """Each leaf of the flax tree lands on exactly one key of the port's
    module, with its shape, and the port loads it with strict=True."""
    params = tiny["params"]["controlnet"]
    sd = controlnet_state_dict_from_flax(params)
    assert len(sd) == len(_leaves(params))
    want = {k: tuple(v.shape) for k, v in ControlNetModel(TINY_CONTROLNET_CONFIG).state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert sum(v.size for v in sd.values()) == sum(v.size for v in _leaves(params))
    load_controlnet(sd, TINY_CONTROLNET_CONFIG, device="cpu", dtype=torch.float32)


def test_controlnet_state_dict_from_unet_matches_jax(tiny):
    unet_params = tiny["params"]["unet"]
    want = controlnet_state_dict_from_flax(
        jax.tree.map(np.asarray, controlnet_params_from_unet(tiny["cnet_init"], unet_params)))
    got = controlnet_state_dict_from_unet(controlnet_state_dict_from_flax(tiny["cnet_init"]),
                                          unet_state_dict_from_flax(unet_params))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("scale", [1.0, 0.5])
def test_controlnet_matches_jax(tiny, port_pipe, scale):
    x, ctrl = tiny["latents"], tiny["control"]
    with jax.default_matmul_precision("highest"):
        j_down, j_mid = tiny["cnet"].apply(
            {"params": tiny["params"]["controlnet"]}, jnp.asarray(x), jnp.array(501.0),
            jnp.asarray(tiny["cond"]), jnp.asarray(ctrl), scale)
    with torch.no_grad():
        down, mid = port_pipe.controlnet(torch.from_numpy(x), 501, torch.from_numpy(tiny["cond"]),
                                         torch.from_numpy(ctrl), scale)
    assert len(down) == len(j_down)
    for i, (a, b) in enumerate(zip(down, j_down)):
        assert float(np.abs(np.asarray(b)).max()) > 0.0
        _assert_close(f"down residual {i}", a, b)
    _assert_close("mid residual", mid, j_mid)


def test_unet_residual_hooks_match_jax(tiny, port_pipe):
    rng = np.random.default_rng(1)
    x = tiny["latents"]
    with torch.no_grad():
        down, mid = port_pipe.controlnet(torch.from_numpy(x), 501, torch.from_numpy(tiny["cond"]),
                                         torch.from_numpy(tiny["control"]))
    down = [d + torch.from_numpy(rng.standard_normal(d.shape).astype(np.float32)) for d in down]
    with jax.default_matmul_precision("highest"):
        want = tiny["unet"].apply(
            {"params": tiny["params"]["unet"]}, jnp.asarray(x), jnp.array(501.0),
            jnp.asarray(tiny["cond"]), down_block_additional_residuals=[d.numpy() for d in down],
            mid_block_additional_residual=mid.numpy())
    unet = port_pipe.unet
    t = torch.from_numpy
    with torch.no_grad():
        got = unet(t(x), 501, t(tiny["cond"]), down_block_additional_residuals=down,
                   mid_block_additional_residual=mid)
        plain = unet(t(x), 501, t(tiny["cond"]))
    _assert_close("unet with residuals", got, want)
    assert float((got - plain).abs().max()) > 1e-3
    with pytest.raises(ValueError, match="down residuals"):
        unet(t(x), 501, t(tiny["cond"]), down_block_additional_residuals=down[:-1])


# ---------------------------------------------------------------------------
# the pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("low_memory", [False, True], ids=["cfg_batch", "sequential_cfg"])
def test_controlnet_pipeline_decode_hdr_matches_jax(tiny, port_pipe, low_memory):
    j_pipe, params = tiny["pipe"], tiny["params"]
    a = {k: tiny[k] for k in ("cond", "uncond", "latents", "control")}
    with jax.default_matmul_precision("highest"):
        j_sdr, j_gm = j_pipe.denoise_dual(
            params, jnp.asarray(a["cond"]), jnp.asarray(a["uncond"]), jnp.asarray(a["latents"]),
            control_image=jnp.asarray(a["control"]), num_inference_steps=3, guidance_scale=7.5,
            low_memory=low_memory)
        j_img = np.asarray(j_pipe.decode_latents(params, jnp.concatenate([j_sdr, j_gm])))
    j01 = np.clip(j_img / 2.0 + 0.5, 0.0, 1.0)
    j_hdr = np.asarray(jax_apply_gm_to_sdr(j01[B:], j01[:B], 99.0, clip_output=False))

    t = torch.from_numpy
    sdr, gm = port_pipe.denoise_dual(
        t(a["cond"]), t(a["uncond"]), t(a["latents"]), control_image=t(a["control"]),
        num_inference_steps=3, guidance_scale=7.5, low_memory=low_memory)
    img = port_pipe.decode_latents(torch.cat([sdr, gm]))
    p01 = (img / 2.0 + 0.5).clamp(0.0, 1.0)
    hdr = apply_gm_to_sdr(p01[B:], p01[:B], 99.0, clip_output=False)
    for name, got, want in (("sdr latents", sdr, j_sdr), ("gm latents", gm, j_gm),
                            ("decoded", img, j_img), ("hdr", hdr, j_hdr)):
        _assert_close(name, got, want)
    # The adapter acts: without the control image the SDR branch differs.
    plain_sdr, _ = port_pipe.denoise_dual(
        t(a["cond"]), t(a["uncond"]), t(a["latents"]), num_inference_steps=3,
        guidance_scale=7.5, low_memory=low_memory)
    assert float((plain_sdr - sdr).abs().max()) > 1e-3


def _shared_noise(pipe, noise, to):
    """Test-side override: both packages' pipelines draw the same noise."""
    pipe.prepare_latents = lambda *args, **kwargs: to(noise)


def test_upconvert_sdr_to_hdrtv_matches_jax(tiny):
    j_pipe = dataclasses.replace(tiny["pipe"])
    pipe = _port_pipeline(tiny["params"])
    _shared_noise(j_pipe, tiny["latents"], jnp.asarray)
    _shared_noise(pipe, tiny["latents"], torch.from_numpy)
    kw = dict(num_inference_steps=3, qmax=99.0)
    with jax.default_matmul_precision("highest"):
        want = jax_upconvert(j_pipe, tiny["params"], jnp.asarray(tiny["control"]),
                             prompt_embeds=jnp.asarray(tiny["cond"]),
                             negative_prompt_embeds=jnp.asarray(tiny["uncond"]), **kw)
    got = upconvert_sdr_to_hdrtv(pipe, torch.from_numpy(tiny["control"]),
                                 prompt_embeds=torch.from_numpy(tiny["cond"]),
                                 negative_prompt_embeds=torch.from_numpy(tiny["uncond"]), **kw)
    # The tiny VAE decodes 4x4 latents to 8x8: the gain map is resized to
    # the 32x32 input before Eq. (1).
    assert got[1].shape == (B, 8, 8, 3) and got[2].shape == (B, 3, SIDE, SIDE)
    for name, a, b in zip(("sdr01", "gm01", "hdr"), got, want):
        _assert_close(name, a, b)


def test_upconvert_rejects_sides_not_divisible_by_8(tiny, port_pipe):
    frame = np.zeros((1, 3, 36, 36), np.float32)
    emb = {"prompt_embeds": tiny["cond"][:1], "negative_prompt_embeds": tiny["uncond"][:1]}
    with pytest.raises(ValueError, match="divisible by 8"):
        jax_upconvert(tiny["pipe"], tiny["params"], jnp.asarray(frame),
                      **{k: jnp.asarray(v) for k, v in emb.items()})
    with pytest.raises(ValueError, match="divisible by 8"):
        upconvert_sdr_to_hdrtv(port_pipe, torch.from_numpy(frame),
                               **{k: torch.from_numpy(v) for k, v in emb.items()})


def test_call_from_prompts_matches_jax(tiny, port_pipe):
    """Prompts through the tiny tokenizer and CLIP text encoder, a negative
    prompt, the control image and the same initial latents: decoded SDR and
    GM images."""
    prompts, negative = ["a bright scene", "hdr sunset"], "blurry"
    kw = dict(negative_prompt=negative, height=SIDE, width=SIDE, num_inference_steps=3,
              guidance_scale=7.5)
    with jax.default_matmul_precision("highest"):
        want = tiny["pipe"](tiny["params"], prompts, control_image=jnp.asarray(tiny["control"]),
                            latents=jnp.asarray(tiny["latents"]), **kw)
    got = port_pipe(prompts, control_image=torch.from_numpy(tiny["control"]),
                    latents=torch.from_numpy(tiny["latents"]), **kw)
    for name, a, b in zip(("sdr01", "gm01"), got, want):
        assert a.shape == (B, 8, 8, 3)
        _assert_close(name, a, b)


def test_call_rejects_unported_options(port_pipe, tiny):
    """The options the JAX package's dual ``__call__`` takes are taken:
    custom schedules raise ValueError as its do; a legacy callback and a
    LoRA scale without factors leave the output as it is;
    ``return_intermediates`` adds the per-step (SDR, GM) stacks."""
    emb = {"prompt_embeds": torch.from_numpy(tiny["cond"]),
           "negative_prompt_embeds": torch.from_numpy(tiny["uncond"])}
    kw = dict(height=SIDE, width=SIDE, num_inference_steps=2, output_type="latent", **emb)
    with pytest.raises(ValueError, match="custom"):
        port_pipe(timesteps=[999, 500], **kw)
    base = port_pipe(**kw)
    calls = []
    for opt in ({"callback": lambda i, t, lat: calls.append(i)},
                {"cross_attention_kwargs": {"scale": 0.5}}):
        out = port_pipe(**kw, **opt)
        assert all(torch.equal(a, b) for a, b in zip(out, base))
    assert calls == list(range(port_pipe.scheduler.num_steps(2)))
    out, inter = port_pipe(return_intermediates=True, **kw)
    for a, b, stack in zip(out, base, inter):
        assert torch.equal(a, b) and torch.equal(stack[-1], a)
    with pytest.raises(ValueError, match="negative_prompt_embeds"):
        port_pipe(height=SIDE, width=SIDE, prompt_embeds=emb["prompt_embeds"])


def test_controlnet_pipeline_defaults_to_cuda(port_pipe):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no card"):
        StableDiffusionControlNetHDRPipeline(port_pipe.unet, port_pipe.vae, PNDMScheduler(),
                                             port_pipe.gm_unet, port_pipe.controlnet)
    with pytest.raises(RuntimeError, match="no card"):
        load_controlnet(port_pipe.controlnet.state_dict(), TINY_CONTROLNET_CONFIG)
