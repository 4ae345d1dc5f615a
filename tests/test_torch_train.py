"""gmdx_torch's Stage-2 training against the JAX package on the CPU, fp32.

The loss and every parameter gradient of the tiny GM UNet, given the same
latents, noise and timesteps, against ``jax.value_and_grad`` of
``gmdx.train.stage2.stage2_loss`` (the JAX gradient tree mapped to the
port's names by the weight export); the clipped AdamW update, its bf16
first moment, gradient accumulation, the LR schedules, EMA and the DDPM
tables against ``gmdx.train``/``optax``/``gmdx.schedulers``; and the port's
train step end to end on the CPU in both batch forms.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from gmdx.models import TINY_UNET_CONFIG as JAX_TINY_UNET
from gmdx.models import UNet2DConditionModel as JaxUNet
from gmdx.models.unet2d import inflate_conv_in as jax_inflate_conv_in
from gmdx.schedulers import DDPMScheduler as JaxDDPM
from gmdx.schedulers.base import add_noise as jax_add_noise
from gmdx.schedulers.base import get_velocity as jax_get_velocity
from gmdx.train.ema import EMAConfig as JaxEMAConfig
from gmdx.train.ema import ema_decay_for_step as jax_ema_decay
from gmdx.train.ema import ema_init as jax_ema_init
from gmdx.train.ema import ema_update as jax_ema_update
from gmdx.train.optim import get_lr_schedule as jax_lr_schedule
from gmdx.train.optim import make_adamw as jax_make_adamw
from gmdx.train.stage2 import Stage2Config as JaxStage2Config
from gmdx.train.stage2 import stage2_loss as jax_stage2_loss
from gmdx_torch.io.convert import load_unet, unet_state_dict_from_flax
from gmdx_torch.models import (
    TINY_CLIP_CONFIG,
    TINY_UNET_CONFIG,
    TINY_VAE_CONFIG,
    AutoencoderKL,
    CLIPTextModel,
    UNet2DConditionModel,
    inflate_conv_in,
)
from gmdx_torch.schedulers import DDPMScheduler
from gmdx_torch.schedulers.base import add_noise, get_velocity
from gmdx_torch.train import (
    EMAConfig,
    MultiSteps,
    Stage2Config,
    ema_decay_for_step,
    ema_init,
    ema_update,
    get_lr_schedule,
    init_state,
    make_adamw,
    make_ema_step,
    make_train_step,
    stage2_loss,
)
from gmdx_torch.train.optim import global_norm
from gmdx_torch.train.stage2 import module_key

LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def gm_unet():
    cfg = dataclasses.replace(JAX_TINY_UNET, in_channels=8)
    model = JaxUNet(cfg)
    params = model.init(
        jax.random.key(3), jnp.zeros((1, 8, 16, 16)), jnp.array(1.0), jnp.zeros((1, 7, 32))
    )["params"]
    return model, jax.tree.map(np.asarray, params)


def _loss_inputs(seed=0, b=2, hw=16):
    rng = np.random.default_rng(seed)
    return {
        "sdr_latents": rng.standard_normal((b, 4, hw, hw)).astype(np.float32),
        "gm_latents": rng.standard_normal((b, 4, hw, hw)).astype(np.float32),
        "encoder_hidden_states": rng.standard_normal((b, 7, 32)).astype(np.float32),
        "noise": rng.standard_normal((b, 4, hw, hw)).astype(np.float32),
        "timesteps": np.array([17, 903], np.int32)[:b],
    }


@pytest.mark.parametrize("prediction_type,snr_gamma", [
    ("epsilon", None), ("v_prediction", None), ("epsilon", 5.0), ("v_prediction", 5.0),
])
def test_stage2_loss_and_grads_match_jax(gm_unet, prediction_type, snr_gamma):
    jmodel, params = gm_unet
    inputs = _loss_inputs()
    acp = np.asarray(JaxDDPM().alphas_cumprod)
    jcfg = JaxStage2Config(prediction_type=prediction_type, snr_gamma=snr_gamma)

    def jloss(p):
        return jax_stage2_loss(
            lambda p_, *a: jmodel.apply({"params": p_}, *a), p,
            **{k: jnp.asarray(v) for k, v in inputs.items()},
            alphas_cumprod=jnp.asarray(acp), config=jcfg,
        )

    with jax.default_matmul_precision("highest"):
        want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(params)
    want = unet_state_dict_from_flax(jax.tree.map(np.asarray, want_grads))

    cfg = dataclasses.replace(TINY_UNET_CONFIG, in_channels=8)
    unet = load_unet(unet_state_dict_from_flax(params), cfg, device="cpu", dtype=torch.float32)
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    t["timesteps"] = t["timesteps"].long()
    config = Stage2Config(prediction_type=prediction_type, snr_gamma=snr_gamma)
    loss = stage2_loss(unet, **t, alphas_cumprod=torch.from_numpy(acp), config=config)
    loss.backward()
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    got = {n: p.grad.numpy() for n, p in unet.named_parameters()}
    assert sorted(got) == sorted(want)
    total = np.sqrt(sum(float(np.sum(np.square(w, dtype=np.float64))) for w in want.values()))
    for n, w in want.items():
        if np.linalg.norm(w) > 1e-6 * total:
            assert _rel_l2(got[n], w) <= GRAD_REL_L2, n
        else:
            # Zero up to rounding in both packages: a bias right before a
            # GroupNorm of one channel per group (the tiny config's 32 / 32),
            # which the normalisation removes. Held to the same 1e-6 share of
            # the whole gradient as the others' rounding.
            assert np.linalg.norm(got[n] - w) <= 1e-6 * total, n


def test_module_keys_are_the_jax_param_tree(gm_unet):
    _, params = gm_unet
    unet = UNet2DConditionModel(dataclasses.replace(TINY_UNET_CONFIG, in_channels=8))
    assert {module_key(n) for n, _ in unet.named_parameters()} == set(params)


def test_inflate_conv_in_matches_jax():
    model = JaxUNet(JAX_TINY_UNET)
    params = jax.tree.map(np.asarray, model.init(
        jax.random.key(0), jnp.zeros((1, 4, 8, 8)), jnp.array(1.0), jnp.zeros((1, 7, 32))
    )["params"])
    want = unet_state_dict_from_flax(jax.tree.map(np.asarray, jax_inflate_conv_in(params, 8)))
    sd = {k: torch.from_numpy(v) for k, v in unet_state_dict_from_flax(params).items()}
    got = inflate_conv_in(sd, 8)
    assert got["conv_in.weight"].shape == (32, 8, 3, 3)
    np.testing.assert_allclose(got["conv_in.weight"].numpy(), want["conv_in.weight"], rtol=1e-7)
    assert sd["conv_in.weight"].shape == (32, 4, 3, 3)  # the input is left as it was
    UNet2DConditionModel(dataclasses.replace(TINY_UNET_CONFIG, in_channels=8)).load_state_dict(
        got, strict=True)


_SCHEDULES = ["constant", "constant_with_warmup", "linear", "cosine",
              "cosine_with_restarts", "polynomial"]


@pytest.mark.parametrize("name", _SCHEDULES)
def test_lr_schedules_match_jax(name):
    kw = dict(num_warmup_steps=10, num_training_steps=100, num_cycles=1.5, power=2.0)
    ours, theirs = get_lr_schedule(name, 3e-4, **kw), jax_lr_schedule(name, 3e-4, **kw)
    for step in (0, 1, 5, 9, 10, 11, 37, 50, 99, 100, 150):
        np.testing.assert_allclose(ours(step), float(theirs(step)), rtol=1e-5, atol=1e-12,
                                   err_msg=f"{name} @ {step}")


def _param_tree(seed):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((4, 3)).astype(np.float32),
            "b": rng.standard_normal((5,)).astype(np.float32)}


def _grad_seq(n, seed=10):
    # Alternately above and below the clipping norm of 1.
    return [jax.tree.map(lambda x, s=(3.0 if i % 2 == 0 else 0.05): x * s, _param_tree(seed + i))
            for i in range(n)]


def _run_jax(opt, params, grads):
    state = opt.init(params)
    out = []
    for g in grads:
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
        out.append(jax.tree.map(np.asarray, params))
    return out


@pytest.mark.parametrize("low_precision_moments", [False, True])
def test_clipped_adamw_matches_optax(low_precision_moments):
    sched = dict(num_warmup_steps=2, num_training_steps=10)
    kw = dict(weight_decay=0.1, max_grad_norm=1.0, low_precision_moments=low_precision_moments)
    params, grads = _param_tree(0), _grad_seq(4)
    want = _run_jax(jax_make_adamw(jax_lr_schedule("linear", 1e-2, **sched), **kw), params, grads)
    tp = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    opt = make_adamw(tp, get_lr_schedule("linear", 1e-2, **sched), **kw)
    if low_precision_moments:
        assert all(m.dtype == torch.bfloat16 for m in opt.mu)
    for g, w in zip(grads, want):
        opt.step([torch.from_numpy(g[k]) for k in ("a", "b")])
        for p, k in zip(tp, ("a", "b")):
            np.testing.assert_allclose(p.numpy(), w[k], rtol=2e-6, atol=1e-7)


def test_clipped_adamw_with_given_norm_matches_optax():
    # The train step hands the clip the norm it took for its metrics.
    params, grads = _param_tree(3), _grad_seq(4, seed=40)
    sched = dict(num_warmup_steps=2, num_training_steps=10)
    want = _run_jax(jax_make_adamw(jax_lr_schedule("linear", 1e-2, **sched), weight_decay=0.1),
                    params, grads)
    tp = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    opt = make_adamw(tp, get_lr_schedule("linear", 1e-2, **sched), weight_decay=0.1)
    for g, w in zip(grads, want):
        tg = [torch.from_numpy(g[k]) for k in ("a", "b")]
        opt.step(tg, global_norm(tg))
        for p, k in zip(tp, ("a", "b")):
            np.testing.assert_allclose(p.numpy(), w[k], rtol=2e-6, atol=1e-7)


def test_gradient_accumulation_matches_optax_multisteps():
    params, grads = _param_tree(1), _grad_seq(6, seed=20)
    sched = jax_lr_schedule("constant", 1e-2)
    want = _run_jax(optax.MultiSteps(jax_make_adamw(sched), 2), params, grads)
    tp = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    opt = MultiSteps(make_adamw(tp, get_lr_schedule("constant", 1e-2)), 2)
    for i, (g, w) in enumerate(zip(grads, want)):
        moved = opt.step([torch.from_numpy(g[k]) for k in ("a", "b")])
        assert moved == (i % 2 == 1)
        for p, k in zip(tp, ("a", "b")):
            np.testing.assert_allclose(p.numpy(), w[k], rtol=2e-6, atol=1e-7)


@pytest.mark.parametrize("use_warmup", [True, False])
def test_ema_matches_jax(use_warmup):
    cfg, jcfg = EMAConfig(use_warmup=use_warmup), JaxEMAConfig(use_warmup=use_warmup)
    for step in (0, 1, 2, 10, 1000, 10**6):
        np.testing.assert_allclose(ema_decay_for_step(cfg, step),
                                   float(jax_ema_decay(jcfg, jnp.asarray(step))), rtol=1e-6)
    params = _param_tree(2)
    jstate = jax_ema_init(params)
    tp = [torch.from_numpy(params[k].copy()) for k in ("a", "b")]
    state = ema_init(tp)
    assert all(s.data_ptr() != p.data_ptr() for s, p in zip(state.shadow, tp))
    for i in range(3):
        new = _param_tree(30 + i)
        jstate = jax_ema_update(jcfg, jstate, new)
        for p, k in zip(tp, ("a", "b")):
            p.copy_(torch.from_numpy(new[k]))
        ema_update(cfg, state, tp)
    assert state.step == int(jstate.step) == 3
    for s, k in zip(state.shadow, ("a", "b")):
        np.testing.assert_allclose(s.numpy(), np.asarray(jstate.shadow[k]), rtol=1e-6, atol=1e-7)


def test_ddpm_tables_noising_and_step_match_jax():
    ours, theirs = DDPMScheduler(), JaxDDPM()
    np.testing.assert_allclose(ours.alphas_cumprod, np.asarray(theirs.alphas_cumprod),
                               rtol=1e-5, atol=0)
    rng = np.random.default_rng(4)
    x0, eps = (rng.standard_normal((3, 4, 8, 8)).astype(np.float32) for _ in range(2))
    t = np.array([0, 500, 999], np.int32)
    acp = np.asarray(theirs.alphas_cumprod)
    for ours_fn, jax_fn in ((add_noise, jax_add_noise), (get_velocity, jax_get_velocity)):
        got = ours_fn(acp, torch.from_numpy(x0), torch.from_numpy(eps), torch.from_numpy(t).long())
        want = jax_fn(jnp.asarray(acp), jnp.asarray(x0), jnp.asarray(eps), jnp.asarray(t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # Two ancestral steps with the same model outputs and noise.
    state, jstate = ours.init_state(10), theirs.init_state(10)
    assert state.timesteps == [int(v) for v in np.asarray(jstate.timesteps)]
    sample = x0
    jsample = jnp.asarray(x0)
    for _ in range(2):
        out = rng.standard_normal(x0.shape).astype(np.float32)
        z = rng.standard_normal(x0.shape).astype(np.float32)
        sample = ours.step(state, torch.from_numpy(out), torch.as_tensor(sample),
                           noise=torch.from_numpy(z)).numpy()
        jstate, jsample = theirs.step(jstate, jnp.asarray(out), jsample, noise=jnp.asarray(z))
        np.testing.assert_allclose(sample, np.asarray(jsample), rtol=1e-5, atol=1e-5)


def _tiny_trainer(config, seed=0):
    torch.manual_seed(seed)
    unet = UNet2DConditionModel(dataclasses.replace(TINY_UNET_CONFIG, in_channels=8))
    vae, text = AutoencoderKL(TINY_VAE_CONFIG), CLIPTextModel(TINY_CLIP_CONFIG)
    step = make_train_step(config, unet=unet, vae=vae, text_encoder=text, device="cpu")
    return unet, init_state(config, unet), step


def _batches(b=2):
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, TINY_CLIP_CONFIG.vocab_size, (b, 7), generator=g)
    pixel = {"sdr": torch.rand(b, 3, 32, 32, generator=g) * 2 - 1,
             "gm": torch.rand(b, 3, 32, 32, generator=g) * 2 - 1, "input_ids": ids}
    cached = {f"{p}_latent_{s}": torch.randn(b, 4, 4, 4, generator=g).abs() + (s == "std")
              for p in ("sdr", "gm") for s in ("mean", "std")}
    cached["input_ids"] = ids
    return pixel, cached


def test_train_step_runs_both_batch_forms_on_cpu():
    config = Stage2Config(learning_rate=1e-3, use_ema=True, noise_offset=0.1,
                          input_perturbation=0.1, snr_gamma=5.0)
    unet, state, step = _tiny_trainer(config)
    ema = make_ema_step(config)
    w0 = unet.conv_in.weight.detach().clone()
    gen = torch.Generator().manual_seed(0)
    for batch in _batches():
        state, metrics = step(state, batch, gen)
        state = ema(state)
        assert np.isfinite(float(metrics["loss"])) and float(metrics["grad_norm"]) > 0
    assert state.step == 2 and state.ema.step == 2
    assert not torch.equal(unet.conv_in.weight, w0)
    assert set(metrics["module_grad_norms"]) >= {"conv_in", "mid_attn", "down_0_resnet_0"}
    total = sum(float(v) ** 2 for v in metrics["module_grad_norms"].values()) ** 0.5
    np.testing.assert_allclose(total, float(metrics["grad_norm"]), rtol=1e-5)


def test_train_step_grad_norms_match_its_gradients():
    unet, state, step = _tiny_trainer(Stage2Config(learning_rate=1e-3))
    seen = {}
    opt_step = state.optimizer.step

    def spy(grads, grad_norm=None):
        seen["grads"], seen["norm"] = grads, grad_norm
        return opt_step(grads, grad_norm)

    state.optimizer.step = spy
    _, metrics = step(state, _batches()[1], torch.Generator().manual_seed(0))
    by_module = {}
    for (n, _), g in zip(unet.named_parameters(), seen["grads"]):
        by_module.setdefault(module_key(n), []).append(g.flatten().double())
    assert sorted(metrics["module_grad_norms"]) == sorted(by_module)
    for k, gs in by_module.items():
        np.testing.assert_allclose(float(metrics["module_grad_norms"][k]),
                                   float(torch.cat(gs).norm()), rtol=1e-5, err_msg=k)
    total = float(torch.cat([g.flatten().double() for g in seen["grads"]]).norm())
    np.testing.assert_allclose(float(metrics["grad_norm"]), total, rtol=1e-5)
    assert seen["norm"] is metrics["grad_norm"]  # the clip reuses it


def test_train_step_accumulates_k_calls():
    unet, state, step = _tiny_trainer(Stage2Config(learning_rate=1e-3,
                                                   gradient_accumulation_steps=2))
    gen = torch.Generator().manual_seed(0)
    _, cached = _batches()
    seen = [unet.conv_in.weight.detach().clone()]
    for _ in range(4):
        state, _ = step(state, cached, gen)
        seen.append(unet.conv_in.weight.detach().clone())
    moved = [not torch.equal(a, b) for a, b in zip(seen, seen[1:])]
    assert moved == [False, True, False, True]


def test_train_step_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    unet = UNet2DConditionModel(TINY_UNET_CONFIG)
    with pytest.raises(RuntimeError, match="no card"):
        make_train_step(Stage2Config(), unet=unet, vae=AutoencoderKL(TINY_VAE_CONFIG),
                        text_encoder=CLIPTextModel(TINY_CLIP_CONFIG))


@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction", "sample"])
def test_predict_x0_and_eps_match_jax(prediction_type):
    from gmdx.schedulers.base import predict_eps as jax_predict_eps
    from gmdx.schedulers.base import predict_x0 as jax_predict_x0
    from gmdx_torch.schedulers.base import predict_eps, predict_x0

    acp = np.asarray(JaxDDPM().alphas_cumprod)
    rng = np.random.default_rng(9)
    x, out = (rng.standard_normal((3, 4, 8, 8)).astype(np.float32) for _ in range(2))
    t = np.array([1, 400, 998], np.int32)
    for ours, theirs in ((predict_x0, jax_predict_x0), (predict_eps, jax_predict_eps)):
        got = ours(acp, torch.from_numpy(x), torch.from_numpy(out), torch.from_numpy(t).long(),
                   prediction_type)
        want = theirs(jnp.asarray(acp), jnp.asarray(x), jnp.asarray(out), jnp.asarray(t),
                      prediction_type)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
