"""The port's Stage-2 training entry point against the JAX package on the
CPU at tiny size: checkpoints (exact round trips, ``resolve_resume_step``,
temporary directories, pruning, asynchronous saves), the latent cache both
ways between the packages, the metrics logger's backends,
``scripts/torch/train_gm_unet.py``'s artifacts (loaded by gmdx at >= 100
dB), exact resume with and without gradient accumulation, the refused
flags, and UNet / VAE remat against the plain backward."""

import dataclasses
import importlib.util
import json
import os
import runpy
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

import gmdx.io.pipeline as jax_pipeline
from gmdx.data import ParquetImageDataset as JaxDataset
from gmdx.train.checkpoint import resolve_resume_step as jax_resolve_resume_step
from gmdx.train.latent_cache import latent_cache_fingerprint as jax_fingerprint
from gmdx.train.latent_cache import load_latent_cache as jax_load_latent_cache
from gmdx_torch.data import write_parquet_dataset
from gmdx_torch.io import load_component
from gmdx_torch.io.convert import unet_state_dict_from_flax
from gmdx_torch.io.params import load_params
from gmdx_torch.models import (
    TINY_UNET_CONFIG,
    TINY_VAE_CONFIG,
    AutoencoderKL,
    UNet2DConditionModel,
)
from gmdx_torch.train import (
    MetricsLogger,
    Stage2Config,
    init_state,
    latent_cache_fingerprint,
    load_latent_cache,
    make_ema_step,
    make_manager,
    resolve_resume_step,
    restore_state,
    save_state,
)
from gmdx_torch.train.checkpoint import state_tensors, tensor_digest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PSNR_MIN_DB = 100.0


@pytest.fixture(autouse=True, scope="module")
def _card_like_host():
    """One torch thread (intra-op threads oversubscribe a parallel run),
    and no tensorboard, as on the card's machine (importing it here pulls
    in TensorFlow); both restored afterwards."""
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


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_cli_{name}", os.path.join(REPO, "scripts", "torch", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def psnr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    peak = max(np.abs(a).max(), np.abs(b).max(), 1e-9)
    mse = float(np.mean((a - b) ** 2))
    return float("inf") if mse == 0.0 else 10.0 * np.log10(peak**2 / mse)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _trained_state(seed, ga, eight_bit, steps=3):
    torch.manual_seed(seed)
    unet = UNet2DConditionModel(dataclasses.replace(TINY_UNET_CONFIG, in_channels=8))
    cfg = Stage2Config(learning_rate=1e-3, gradient_accumulation_steps=ga,
                       use_8bit_adam=eight_bit, use_ema=True)
    state = init_state(cfg, unet)
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        state.optimizer.step([torch.randn(p.shape, generator=gen)
                              for p in state.optimizer.params])
        state.step += 1
        make_ema_step(cfg)(state)
    return cfg, state


@pytest.mark.parametrize("ga,eight_bit", [(1, False), (2, True)])
@pytest.mark.parametrize("asynchronous", [False, True])
def test_checkpoint_round_trip_is_exact(tmp_path, ga, eight_bit, asynchronous):
    """Parameters, mu (bf16 under --use_8bit_adam), nu, count, the
    MultiSteps accumulator and phase, the EMA shadow and step: saved and
    restored into a fresh state bit for bit; an asynchronous save holds
    the state as it was when the call returned."""
    cfg, state = _trained_state(0, ga, eight_bit)
    want, want_scalars = state_tensors(state)
    assert any(t.dtype == torch.bfloat16 for t in want.values()) == eight_bit
    assert any(k.startswith("acc/") for k in want) == (ga > 1)
    frozen = {k: v.clone() for k, v in want.items()}
    manager = make_manager(str(tmp_path), async_checkpointing=asynchronous)
    digest = save_state(manager, 3, state, wait=not asynchronous)
    with torch.no_grad():  # the next update, in place, while the write may run
        for p in state.optimizer.params:
            p.add_(1.0)
    manager.wait_until_finished()
    _, fresh = _trained_state(1, ga, eight_bit, steps=1)
    restore_state(manager, 3, fresh)
    got, got_scalars = state_tensors(fresh)
    assert got_scalars == want_scalars and sorted(got) == sorted(frozen)
    for k in frozen:
        assert got[k].dtype == frozen[k].dtype and torch.equal(got[k], frozen[k]), k
    assert tensor_digest(got) == digest


def test_checkpoint_layout_pruning_and_leftovers(tmp_path):
    _, state = _trained_state(0, 1, False, steps=1)
    manager = make_manager(str(tmp_path), max_to_keep=2)
    for step in (1, 2, 3):
        save_state(manager, step, state)
    assert manager.all_steps() == [2, 3]
    assert sorted(os.listdir(tmp_path / "checkpoint_3")) == ["state.json", "state.safetensors"]
    leftover = tmp_path / ".checkpoint_9.tmp-123"
    leftover.mkdir()
    (leftover / "state.json").write_text("{}")
    assert manager.all_steps() == [2, 3]
    assert resolve_resume_step(str(tmp_path), "latest") == 3
    with open(tmp_path / "checkpoint_3" / "state.json") as f:
        meta = json.load(f)
    meta["digest"] = "0" * 32
    with open(tmp_path / "checkpoint_3" / "state.json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="digest"):
        restore_state(manager, 3, state)


def test_resolve_resume_step_matches_jax(tmp_path):
    empty, full, missing = tmp_path / "empty", tmp_path / "full", tmp_path / "missing"
    empty.mkdir()
    full.mkdir()
    for name in ("checkpoint_3", "checkpoint_12", "checkpoint-40", "checkpoint7", "notes",
                 "checkpoint_5.tmp", ".checkpoint_99.tmp-1"):
        (full / name).mkdir()
    cases = [None, "latest", "12", "abc", "checkpoint_5", "checkpoint-7/", "/x/checkpoint_21",
             "/x/checkpoint21", "checkpoint_"]
    for d in (empty, full, missing):
        for c in cases:
            assert resolve_resume_step(str(d), c) == jax_resolve_resume_step(str(d), c), (d, c)
    assert resolve_resume_step(str(full), "latest") == 12


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def test_metrics_logger_backends(tmp_path, monkeypatch):
    """JSONL and the config always; tensorboard through
    torch.utils.tensorboard when importable (a recording stand-in here),
    JSONL alone when not; wandb missing raises; comet raises."""
    calls = []

    class Writer:
        def __init__(self, log_dir):
            calls.append(("init", log_dir))

        def add_scalar(self, k, v, step):
            calls.append(("scalar", k, v, step))

        def add_image(self, k, v, step, dataformats):
            calls.append(("image", k, v.shape, step, dataformats))

        def close(self):
            calls.append(("close",))

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=Writer))
    log = MetricsLogger(str(tmp_path / "a"), project="p", config={"lr": 1e-4, "f": object()})
    log.log(3, {"train_loss": 0.5})
    log.log_images(3, {"gm": np.zeros((4, 4, 3), np.float32)})
    log.close()
    assert calls == [("init", str(tmp_path / "a")), ("scalar", "train_loss", 0.5, 3),
                     ("image", "gm", (4, 4, 3), 3, "HWC"), ("close",)]
    rec = json.loads((tmp_path / "a" / "metrics.jsonl").read_text())
    assert rec["step"] == 3 and rec["train_loss"] == 0.5
    assert json.loads((tmp_path / "a" / "p_config.json").read_text()) == {"lr": 1e-4}
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    log = MetricsLogger(str(tmp_path / "b"))
    log.log(1, {"x": 1})
    log.close()
    assert (tmp_path / "b" / "metrics.jsonl").exists()
    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.raises(RuntimeError, match="wandb"):
        MetricsLogger(str(tmp_path / "c"), backend="wandb")
    with pytest.raises(ValueError, match="comet"):
        MetricsLogger(str(tmp_path / "d"), backend="comet")


# ---------------------------------------------------------------------------
# the trainer and the latent cache
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A tiny pipeline directory (the port's init_pipeline), 8 pairs of
    64x64 PNGs in a parquet written by the port, and a validation PNG."""
    root = tmp_path_factory.mktemp("train_cli")
    _script("init_pipeline").main(["--output_dir", str(root / "pipe"), "--size", "tiny",
                                   "--device", "cpu"])
    rng = np.random.default_rng(0)
    (root / "data").mkdir()
    (root / "val").mkdir()
    paths, gms = [], []
    for i in range(8):
        p = str(root / "data" / f"sdr_{i}.png")
        Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(p)
        paths.append(p)
        path = root / "data" / f"gm_{i}.png"
        Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(path)
        gms.append(path.read_bytes())
    Image.fromarray(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)).save(root / "val" / "v.png")
    meta = str(root / "train.parquet")
    write_parquet_dataset(meta, paths, gms, [f"test caption {i}" for i in range(8)])
    return root, meta


@pytest.fixture(scope="module")
def caches(workdir):
    """The latent cache of the tiny set from each package's
    precompute_latents.py."""
    root, meta = workdir
    port_npz, jax_npz = str(root / "port.npz"), str(root / "jax.npz")
    _script("precompute_latents").main([
        "--train_metadata", meta, "--pretrained_model_name_or_path", str(root / "pipe"),
        "--resolution", "16", "--out", port_npz, "--batch", "3", "--device", "cpu"])
    argv, env = sys.argv, dict(os.environ)
    sys.argv = ["precompute_latents.py", "--train_metadata", meta,
                "--pretrained_model_name_or_path", str(root / "pipe"), "--resolution", "16",
                "--out", jax_npz, "--batch", "3"]
    # No persistent compile cache in this process; the JAX loader's PIL
    # path, which the port's loader equals (its C++ path differs by resize
    # rounding); fp32 products, as the port's on the CPU.
    os.environ.update(GMDX_COMPILE_CACHE="0", GMDX_NO_NATIVE="1")
    import jax

    try:
        with jax.default_matmul_precision("highest"):
            runpy.run_path(os.path.join(REPO, "scripts", "tools", "precompute_latents.py"),
                           run_name="__main__")
    finally:
        sys.argv = argv
        os.environ.clear()
        os.environ.update(env)
    return port_npz, jax_npz


def test_latent_cache_matches_jax(workdir, caches):
    """The port's cache equals gmdx's within fp16 rounding, with the same
    keys, captions, resolution and fingerprint, each package's loads in the
    other's, and the fingerprint of the port's VAE module equals the
    file's."""
    root, meta = workdir
    port_npz, jax_npz = caches
    with np.load(port_npz) as p, np.load(jax_npz) as j:
        assert sorted(p.files) == sorted(j.files)
        assert str(p["__fingerprint"]) == str(j["__fingerprint"])
        assert int(p["__resolution"]) == 16
        np.testing.assert_array_equal(p["input_ids"], j["input_ids"])
        for k in ("sdr_latent_mean", "sdr_latent_std", "gm_latent_mean", "gm_latent_std"):
            assert p[k].dtype == np.float16 and p[k].shape == (8, 4, 8, 8)
            # One fp16 step of the value (2^-10 relative at most), or the
            # two VAEs' fp32 difference (about 1.5e-6) where fp16 is finer.
            a, b = p[k].astype(np.float32), j[k].astype(np.float32)
            np.testing.assert_allclose(a, b, rtol=2.0**-10, atol=1e-5, err_msg=k)
    bundle = jax_pipeline.load_pipeline(str(root / "pipe"))
    fp = jax_fingerprint(meta, len(JaxDataset(meta)), bundle["params"]["vae"])
    assert set(jax_load_latent_cache(port_npz, resolution=16, fingerprint=fp)) == {
        "input_ids", "sdr_latent_mean", "sdr_latent_std", "gm_latent_mean", "gm_latent_std"}
    vae = load_component(str(root / "pipe" / "vae"), device="cpu")
    assert latent_cache_fingerprint(meta, 8, vae) == fp
    load_latent_cache(jax_npz, resolution=16, fingerprint=fp)
    with pytest.raises(ValueError, match="rebuild"):
        load_latent_cache(jax_npz, resolution=32)
    with pytest.raises(ValueError, match="different dataset or VAE"):
        load_latent_cache(jax_npz, resolution=16, fingerprint="0" * 16)


def _train(root, meta, out, *extra):
    return _script("train_gm_unet").main([
        "--pretrained_model_name_or_path", str(root / "pipe"), "--train_metadata", meta,
        "--output_dir", str(out), "--resolution", "16", "--seed", "0", "--device", "cpu",
        *extra])


def _metrics(out):
    with open(os.path.join(str(out), "logs", "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_trainer_artifacts_load_in_jax(workdir):
    """The pixel path with random flips and EMA: checkpoint_2, a validation
    image, metrics.jsonl with train_loss, and a pipeline directory whose
    UNet (in_channels 8) is the EMA shadow bit for bit and runs in gmdx at
    >= 100 dB against the port."""
    root, meta = workdir
    out = root / "artifacts"
    r = _train(root, meta, out, "--train_batch_size", "2", "--max_train_samples", "4",
               "--max_train_steps", "2", "--checkpointing_steps", "2", "--use_ema",
               "--random_flip", "--validation_image_dir", str(root / "val"),
               "--validation_epochs", "1")
    assert r["global_step"] == 2 and os.path.isdir(out / "checkpoint_2")
    assert sorted(os.listdir(out / "validation")) == ["gm_step2_0.png", "hdr_step2_0.hdr"]
    assert any("train_loss" in rec and rec["step"] == 1 for rec in _metrics(out))
    saved = out / "save_pipeline"
    with open(saved / "unet" / "config.json") as f:
        assert json.load(f)["in_channels"] == 8
    sd = unet_state_dict_from_flax(load_params(str(saved / "unet" / "params.safetensors")))
    names = [n for n, p in r["state"].unet.named_parameters() if p.requires_grad]
    for n, shadow in zip(names, r["state"].ema.shadow):
        assert torch.equal(torch.as_tensor(sd[n]), shadow), n
    import jax
    import jax.numpy as jnp

    bundle = jax_pipeline.load_pipeline(str(saved))
    assert sorted(bundle["modules"]) == ["text_encoder", "unet", "vae"]
    ours = load_component(str(saved / "unet"), device="cpu")
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 8, 8, 8)).astype(np.float32)
    ctx = rng.standard_normal((1, 77, 32)).astype(np.float32)
    with jax.default_matmul_precision("highest"), torch.no_grad():
        want = jax.jit(bundle["modules"]["unet"].apply)(
            {"params": bundle["params"]["unet"]}, jnp.asarray(x), jnp.array(501), jnp.asarray(ctx))
        got = ours(torch.from_numpy(x), 501, torch.from_numpy(ctx))
    assert psnr(got.numpy(), np.asarray(want)) >= PSNR_MIN_DB


def test_jax_latent_cache_trains_in_port(workdir, caches, caplog):
    root, meta = workdir
    out = root / "from_jax_cache"
    caplog.set_level("INFO")
    r = _train(root, meta, out, "--train_batch_size", "2", "--max_train_steps", "2",
               "--latent_cache_path", caches[1], "--center_crop")
    assert "loaded precomputed latent cache" in caplog.text
    assert r["global_step"] == 2 and np.isfinite(_metrics(out)[0]["train_loss"])


@pytest.mark.parametrize("ga", [1, 2])
def test_resume_continuity_matches_uninterrupted(workdir, caches, ga):
    """A run restored from its step-10 checkpoint logs the uninterrupted
    run's step-20 loss (rel 1e-5, the JAX package's bar) and ends in the
    same state, with and without gradient accumulation."""
    root, meta = workdir
    base = ["--train_batch_size", "1", "--latent_cache_path", caches[0], "--center_crop",
            "--checkpointing_steps", "10", "--gradient_accumulation_steps", str(ga), "--use_ema"]
    full = _train(root, meta, root / f"full_ga{ga}", *base, "--max_train_steps", "20")
    part = root / f"part_ga{ga}"
    first = _train(root, meta, part, *base, "--max_train_steps", "10")
    resumed = _train(root, meta, part, *base, "--max_train_steps", "20",
                     "--resume_from_checkpoint", "latest")
    assert resumed["restored_digest"] == first["saved_digests"][10]
    assert sorted(resumed["losses"]) == [20]
    assert resumed["losses"][20] == pytest.approx(full["losses"][20], rel=1e-5)
    assert (tensor_digest(state_tensors(resumed["state"])[0])
            == tensor_digest(state_tensors(full["state"])[0]))


def test_refused_flags(workdir):
    root, meta = workdir
    train = _script("train_gm_unet")
    common = ["--pretrained_model_name_or_path", str(root / "pipe"), "--device", "cpu",
              "--output_dir", str(root / "refused")]
    for flags in (["--dream_training"], ["--use_x0_conditioning"], ["--push_to_hub"],
                  ["--cache_latents"], ["--cache_latents", "--center_crop", "--random_flip"],
                  ["--latent_cache_path", "x.npz"], []):
        with pytest.raises(SystemExit):
            train.parse_args(common + flags + (["--train_metadata", meta] if flags else []))
    # One process is no data x model grid: the JAX trainer's check.
    with pytest.raises(ValueError, match="group size >= 2 dividing the device count"):
        train.main(common + ["--train_metadata", meta, "--shard_strategy", "tp"])
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        train.main(common + ["--dataset_name", "some/hub-set"])
    assert not os.path.exists(root / "refused")


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------


def _grads(model, loss_fn):
    model.zero_grad()
    loss = loss_fn(model)
    loss.backward()
    return float(loss.detach()), [p.grad.clone() for p in model.parameters()]


@pytest.mark.parametrize("kind", ["unet", "vae"])
def test_remat_matches_plain_backward(kind):
    """Remat recomputes each block in the backward pass (a resnet's forward
    runs twice a step) and leaves the loss and every gradient as the plain
    backward gives them (1e-6 relative); in eval mode it is off."""
    torch.manual_seed(0)
    if kind == "unet":
        cfg = dataclasses.replace(TINY_UNET_CONFIG, in_channels=8)
        plain, remat = (UNet2DConditionModel(c) for c in (cfg, dataclasses.replace(cfg, remat=True)))
        x, ctx = torch.randn(2, 8, 8, 8), torch.randn(2, 77, 32)

        def loss_fn(m):
            return (m(x, torch.tensor([10, 700]), ctx) ** 2).mean()

        block = remat.down_blocks[0].resnets[0]
    else:
        plain = AutoencoderKL(TINY_VAE_CONFIG)
        remat = AutoencoderKL(dataclasses.replace(TINY_VAE_CONFIG, remat=True))
        x = torch.randn(2, 3, 32, 32)

        def loss_fn(m):
            return (m.decode(m.encode(x).mean) ** 2).mean()

        block = remat.encoder.down_blocks[0].resnets[0]
    remat.load_state_dict(plain.state_dict())
    calls = []
    block.register_forward_pre_hook(lambda *a: calls.append(1))
    want_loss, want = _grads(plain.train(), loss_fn)
    got_loss, got = _grads(remat.train(), loss_fn)
    assert len(calls) == 2
    assert got_loss == pytest.approx(want_loss, rel=1e-6)
    for g, w in zip(got, want):
        assert float((g - w).norm()) <= 1e-6 * max(float(w.norm()), 1e-30)
    calls.clear()
    _grads(remat.eval(), loss_fn)
    assert len(calls) == 1
