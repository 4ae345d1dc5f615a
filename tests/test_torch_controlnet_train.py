"""gmdx_torch's ControlNet training against the JAX package on the CPU, fp32.

The loss and every ControlNet gradient on the tiny configs, given the same
noisy latents, timesteps, context, control image and noise, against
``jax.value_and_grad`` of the loss gmdx's ``make_controlnet_train_step``
takes (composed here from gmdx's ControlNet and UNet), with the ControlNet's
zero convs and embedder output set to seeded random values (at zero every
gradient but the adapters' is 0 and the check would hold almost nothing);
the control image's resize against ``jax.image.resize``; the port's step
end to end (no gradient reaches the frozen UNet; the optimizer and EMA move
only at optimizer-sync boundaries, the EMA as gmdx's ``ema_update``);
checkpoint round trips; and ``scripts/torch/train_controlnet.py``'s
artifacts (the ``controlnet/`` component loads in gmdx with the port's tree)
and exact resume.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import gmdx.io.pipeline as jax_pipeline
from gmdx.models import ControlNetModel as JaxControlNet
from gmdx.models import TINY_CONTROLNET_CONFIG as J_CNET
from gmdx.models import TINY_UNET_CONFIG as J_UNET
from gmdx.models import UNet2DConditionModel as JaxUNet
from gmdx.models import controlnet_params_from_unet
from gmdx.train.ema import EMAConfig as JaxEMAConfig
from gmdx.train.ema import ema_init as jax_ema_init
from gmdx.train.ema import ema_update as jax_ema_update
from gmdx_torch.data import write_parquet_dataset
from gmdx_torch.io.convert import (
    controlnet_state_dict_from_flax,
    load_controlnet,
    load_unet,
    unet_state_dict_from_flax,
)
from gmdx_torch.io.png import encode_png, write_png
from gmdx_torch.io.to_flax import convert_controlnet_state_dict, convert_unet_state_dict
from gmdx_torch.models import (
    TINY_CLIP_CONFIG,
    TINY_CONTROLNET_CONFIG,
    TINY_UNET_CONFIG,
    TINY_VAE_CONFIG,
    AutoencoderKL,
    CLIPTextModel,
    ControlNetModel,
    UNet2DConditionModel,
)
from gmdx_torch.train import (
    ControlNetTrainConfig,
    controlnet_loss,
    init_controlnet_state,
    make_controlnet_ema_step,
    make_controlnet_train_step,
    make_manager,
    restore_state,
    save_state,
)
from gmdx_torch.train.checkpoint import state_tensors, tensor_digest
from gmdx_torch.train.controlnet import resize_control

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-4
B, SIDE, CTX = 2, 32, (77, 32)  # latents 4x4; the embedder downsamples 8x
ADAPTERS = ("controlnet_down_", "controlnet_mid")


@pytest.fixture(autouse=True, scope="module")
def _card_like_host():
    """One torch thread (intra-op threads oversubscribe a parallel run) and
    no tensorboard (importing it here pulls in TensorFlow), as in the
    port's other trainer tests; both restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    saved = sys.modules.get("torch.utils.tensorboard", False)
    sys.modules["torch.utils.tensorboard"] = None
    yield
    torch.set_num_threads(n)
    if saved is False:
        del sys.modules["torch.utils.tensorboard"]
    else:
        sys.modules["torch.utils.tensorboard"] = saved


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_cli_{name}", os.path.join(REPO, "scripts", "torch", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tiny():
    """Flax params of the tiny UNet and of a ControlNet copied from it (by
    gmdx's controlnet_params_from_unet), its adapters (zero convs, embedder
    output conv) seeded random; numpy loss inputs. The initial weights are
    drawn by the port's modules and carried to Flax trees by
    ``gmdx_torch.io.to_flax`` (a JAX init of the tiny UNet compiles for
    ~17 s); a wrong mapping would make the two losses differ."""
    rng = np.random.default_rng(0)
    torch.manual_seed(0)
    unet_params = convert_unet_state_dict(UNet2DConditionModel(TINY_UNET_CONFIG).state_dict())
    cnet_init = convert_controlnet_state_dict(ControlNetModel(TINY_CONTROLNET_CONFIG).state_dict())
    as_np = lambda tree: jax.tree.map(lambda t: np.array(t.detach()), tree)  # noqa: E731
    unet_params, cnet_init = as_np(unet_params), as_np(cnet_init)
    cnet_params = jax.tree.map(np.asarray, controlnet_params_from_unet(cnet_init, unet_params))
    for name in cnet_params:
        if name.startswith(ADAPTERS):
            cnet_params[name] = {k: (0.05 * rng.standard_normal(v.shape)).astype(np.float32)
                                 for k, v in cnet_params[name].items()}
    emb = dict(cnet_params["cond_embedding"])
    emb["conv_out"] = {k: (0.05 * rng.standard_normal(v.shape)).astype(np.float32)
                       for k, v in emb["conv_out"].items()}
    cnet_params["cond_embedding"] = emb
    inputs = {
        "noisy_latents": rng.standard_normal((B, 4, 4, 4)).astype(np.float32),
        "timesteps": np.array([17, 903], np.int32),
        "encoder_hidden_states": rng.standard_normal((B,) + CTX).astype(np.float32),
        "control_image": rng.uniform(0.0, 1.0, (B, 3, SIDE, SIDE)).astype(np.float32),
        "noise": rng.standard_normal((B, 4, 4, 4)).astype(np.float32),
    }
    return {"unet": JaxUNet(J_UNET), "cnet": JaxControlNet(J_CNET), "unet_params": unet_params,
            "cnet_params": cnet_params, "inputs": inputs}


def _port_modules(tiny):
    kw = dict(device="cpu", dtype=torch.float32)
    unet = load_unet(unet_state_dict_from_flax(tiny["unet_params"]), TINY_UNET_CONFIG, **kw)
    cnet = load_controlnet(controlnet_state_dict_from_flax(tiny["cnet_params"]),
                           TINY_CONTROLNET_CONFIG, **kw)
    return unet.requires_grad_(False), cnet.train()


def test_controlnet_loss_and_grads_match_jax(tiny):
    """The port's loss within 1e-5 relative of gmdx's and every ControlNet
    gradient within 1e-4 relative L2 (zero up to rounding: within 1e-6 of
    the whole gradient's norm); the UNet takes none."""
    inputs = tiny["inputs"]
    j = {k: jnp.asarray(v) for k, v in inputs.items()}

    def jloss(params):
        downs, mid = tiny["cnet"].apply({"params": params}, j["noisy_latents"], j["timesteps"],
                                        j["encoder_hidden_states"], j["control_image"])
        pred = tiny["unet"].apply({"params": tiny["unet_params"]}, j["noisy_latents"],
                                  j["timesteps"], j["encoder_hidden_states"],
                                  down_block_additional_residuals=downs,
                                  mid_block_additional_residual=mid)
        return jnp.mean((pred.astype(jnp.float32) - j["noise"]) ** 2)

    with jax.default_matmul_precision("highest"):
        want_loss, want_grads = jax.jit(jax.value_and_grad(jloss))(tiny["cnet_params"])
    want = controlnet_state_dict_from_flax(jax.tree.map(np.asarray, want_grads))

    unet, cnet = _port_modules(tiny)
    t = {k: torch.from_numpy(v) for k, v in inputs.items()}
    t["timesteps"] = t["timesteps"].long()
    loss = controlnet_loss(cnet, unet, **t)
    names = [n for n, _ in cnet.named_parameters()]
    grads = torch.autograd.grad(loss, list(cnet.parameters()))
    assert abs(float(loss.detach()) - float(want_loss)) <= LOSS_RTOL * abs(float(want_loss))
    got = {n: g.numpy() for n, g in zip(names, grads)}
    assert sorted(got) == sorted(want)
    total = np.sqrt(sum(float(np.sum(np.square(w, dtype=np.float64))) for w in want.values()))
    nonzero = 0
    for n, w in want.items():
        if np.linalg.norm(w) > 1e-6 * total:
            nonzero += 1
            assert _rel_l2(got[n], w) <= GRAD_REL_L2, n
        else:
            assert np.linalg.norm(got[n] - w) <= 1e-6 * total, n
    # The encoder's copy takes gradient too (the adapters are not zero).
    assert nonzero > len(want) // 2
    assert all(p.grad is None for p in unet.parameters())


@pytest.mark.parametrize("src,dst", [((5, 7), (20, 28)), ((4, 4), (32, 32)), ((6, 6), (6, 6)),
                                     ((32, 40), (16, 20)), ((32, 40), (12, 17))])
def test_resize_control_matches_jax(src, dst):
    """Upsampling with half-pixel centres and edge clamping (the tiny VAE's
    2x grid asks the embedder for 4x the image) as jax.image.resize's
    bilinear, and shrinking with its widened (antialiased) kernel; the same
    size is left as it is."""
    x = np.random.default_rng(3).uniform(0, 1, (2, 3) + src).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (2, 3) + dst, "bilinear"))
    got = resize_control(torch.from_numpy(x), dst).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _tiny_trainer(tiny, ga=1, use_ema=False):
    unet, cnet = _port_modules(tiny)
    torch.manual_seed(0)
    vae, text = AutoencoderKL(TINY_VAE_CONFIG), CLIPTextModel(TINY_CLIP_CONFIG)
    cfg = ControlNetTrainConfig(learning_rate=1e-3, gradient_accumulation_steps=ga,
                                use_ema=use_ema)
    step = make_controlnet_train_step(cfg, unet=unet, vae=vae, text_encoder=text,
                                      controlnet=cnet, device="cpu")
    return cfg, step, init_controlnet_state(cfg, cnet), unet


def _batch(seed):
    rng = np.random.default_rng(seed)
    img = rng.uniform(-1, 1, (B, 3, 8, 8)).astype(np.float32)  # latents 4x4: cond 32x32
    return {"image": torch.from_numpy(img), "cond": torch.from_numpy(img),
            "input_ids": torch.from_numpy(rng.integers(0, 100, (B, 77)).astype(np.int64))}


def test_step_freezes_unet_and_gates_optimizer_and_ema(tiny):
    """ga = 2: the first micro-step of a window leaves the ControlNet as it
    is and the EMA where it was; the second moves both; the UNet's
    parameters never take a gradient or move. The EMA shadow equals
    gmdx's ema_update applied at each sync to the same parameters."""
    cfg, step, state, unet = _tiny_trainer(tiny, ga=2, use_ema=True)
    ema_step = make_controlnet_ema_step(cfg)
    unet_before = {k: v.clone() for k, v in unet.state_dict().items()}
    names = [n for n, _ in state.controlnet.named_parameters()]
    jema = jax_ema_init({n: p.detach().numpy().copy() for n, p in
                         zip(names, state.optimizer.params)})
    for i in range(4):
        before = [p.detach().clone() for p in state.optimizer.params]
        gen = torch.Generator().manual_seed(i)
        state, m = step(state, _batch(i), gen)
        assert np.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
        moved = any(not torch.equal(a, p) for a, p in zip(before, state.optimizer.params))
        assert moved == (i % 2 == 1), i
        if i % 2 == 1:
            ema_step(state)
            jema = jax_ema_update(JaxEMAConfig(), jema, {
                n: p.detach().numpy().copy() for n, p in zip(names, state.optimizer.params)})
        assert state.ema.step == (i + 1) // 2
    assert state.step == 4
    for n, s in zip(names, state.ema.shadow):
        np.testing.assert_allclose(s.numpy(), np.asarray(jema.shadow[n]), rtol=1e-6,
                                   atol=1e-7, err_msg=n)
    assert all(p.grad is None and not p.requires_grad for p in unet.parameters())
    for k, v in unet.state_dict().items():
        assert torch.equal(v, unet_before[k]), k


@pytest.mark.parametrize("ga", [1, 2])
def test_controlnet_checkpoint_round_trip(tiny, tmp_path, ga):
    """Parameters, moments, count, accumulator and phase, EMA shadow and
    step, saved and restored into a fresh state bit for bit, under the
    ControlNet format tag."""
    cfg, step, state, _ = _tiny_trainer(tiny, ga=ga, use_ema=True)
    for i in range(3):
        state, _ = step(state, _batch(i), torch.Generator().manual_seed(i))
        make_controlnet_ema_step(cfg)(state)
    want, want_scalars = state_tensors(state)
    frozen = {k: v.clone() for k, v in want.items()}
    manager = make_manager(str(tmp_path))
    digest = save_state(manager, 3, state)
    with open(tmp_path / "checkpoint_3" / "state.json") as f:
        assert json.load(f)["format"] == "gmdx_torch.controlnet.v1"
    _, _, fresh, _ = _tiny_trainer(tiny, ga=ga, use_ema=True)
    restore_state(manager, 3, fresh)
    got, got_scalars = state_tensors(fresh)
    assert got_scalars == want_scalars and sorted(got) == sorted(frozen)
    assert any(k.startswith("acc/") for k in got) == (ga > 1)
    for k in frozen:
        assert torch.equal(got[k], frozen[k]), k
    assert tensor_digest(got) == digest


# ---------------------------------------------------------------------------
# the trainer CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A tiny pipeline directory (the port's init_pipeline) and 6 pairs of
    40x48 PNGs in a parquet written by the port."""
    root = tmp_path_factory.mktemp("cn_cli")
    _script("init_pipeline").main(["--output_dir", str(root / "pipe"), "--size", "tiny",
                                   "--device", "cpu"])
    rng = np.random.default_rng(0)
    (root / "data").mkdir()
    paths, gms = [], []
    for i in range(6):
        p = str(root / "data" / f"sdr_{i}.png")
        write_png(p, rng.integers(0, 255, (40, 48, 3), dtype=np.uint8))
        paths.append(p)
        gms.append(encode_png(rng.integers(0, 255, (40, 48, 3), dtype=np.uint8)))
    meta = str(root / "train.parquet")
    write_parquet_dataset(meta, paths, gms, [f"test caption {i}" for i in range(6)])
    return root, meta


def _train(root, meta, out, *extra):
    return _script("train_controlnet").main([
        "--pretrained_model_name_or_path", str(root / "pipe"), "--train_metadata", meta,
        "--output_dir", str(out), "--resolution", "8", "--train_batch_size", "2",
        "--seed", "0", "--device", "cpu", *extra])


def test_trainer_artifacts_load_in_jax(workdir):
    """Two steps with EMA: checkpoint_2, train_loss in metrics.jsonl, and a
    controlnet/ component that gmdx's load_component builds, its tree the
    port's EMA shadow bit for bit."""
    root, meta = workdir
    out = root / "artifacts"
    r = _train(root, meta, out, "--max_train_steps", "2", "--checkpointing_steps", "2",
               "--use_ema")
    assert r["global_step"] == 2 and os.path.isdir(out / "checkpoint_2")
    with open(out / "logs" / "metrics.jsonl") as f:
        assert any("train_loss" in json.loads(line) for line in f)
    cnet, params = jax_pipeline.load_component(str(out / "controlnet"))
    assert type(cnet).__name__ == "ControlNetModel"
    state = r["state"]
    names = [n for n, _ in state.controlnet.named_parameters()]
    mine = convert_controlnet_state_dict(dict(zip(names, state.ema.shadow)))
    flat_j = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_m = dict(jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: t.numpy(), mine))[0])
    assert flat_j.keys() == flat_m.keys()
    for k in flat_j:
        np.testing.assert_array_equal(np.asarray(flat_j[k]), flat_m[k], err_msg=str(k))


def test_trainer_resume_is_exact(workdir):
    """A run restored from its step-2 checkpoint restores the saved bits and
    ends at step 4 in the uninterrupted run's state, bit for bit."""
    root, meta = workdir
    base = ["--checkpointing_steps", "2", "--use_ema", "--gradient_accumulation_steps", "2"]
    full = _train(root, meta, root / "full", *base, "--max_train_steps", "4")
    first = _train(root, meta, root / "part", *base, "--max_train_steps", "2")
    resumed = _train(root, meta, root / "part", *base, "--max_train_steps", "4",
                     "--resume_from_checkpoint", "latest")
    assert resumed["start_step"] == 2 and resumed["global_step"] == 4
    assert resumed["restored_digest"] == first["saved_digests"][2]
    assert (tensor_digest(state_tensors(resumed["state"])[0])
            == tensor_digest(state_tensors(full["state"])[0]))


def test_refused_flags(workdir):
    root, meta = workdir
    train = _script("train_controlnet")
    with pytest.raises(SystemExit):
        train.parse_args(["--pretrained_model_name_or_path", str(root / "pipe")])
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        _train(root, meta, root / "refused", "--shard_strategy", "tp")
    gm_pipe = root / "gm_pipe"
    _script("init_pipeline").main(["--output_dir", str(gm_pipe), "--size", "tiny", "--gm_only",
                                   "--device", "cpu"])
    with pytest.raises(SystemExit, match="4-channel"):
        train.main(["--pretrained_model_name_or_path", str(gm_pipe), "--train_metadata", meta,
                    "--output_dir", str(root / "refused_gm"), "--device", "cpu"])
