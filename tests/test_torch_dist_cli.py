"""The port's trainer CLIs on two gloo ranks on the CPU at tiny size,
against the same CLIs in one process on the same global batch.

``scripts/torch/train_gm_unet.py`` under fsdp on the latent cache (built
once, by rank 0, into the output directory) and
``scripts/torch/train_controlnet.py`` under zero1 take two updates of a
global batch of 4 (2 a rank); their checkpoint after each update (the
one-process format, written by rank 0) equals the one-process run's to the
rounding of the sum over the ranks (1e-5 relative L2 a role), as do the
logged losses. A zero1 checkpoint of two ranks resumes in one process with
the digest it was saved with, and the resumed run's next checkpoint is the
uninterrupted run's. ``train_vqgan_lora.py`` under fsdp takes a generator
and a discriminator update on two ranks against one process. Only rank 0
writes logs, validation images and the final artifacts.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from gmdx_torch.data import write_parquet_dataset
from gmdx_torch.io.params import load_file
from gmdx_torch.io.png import encode_png

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_ranks import Ranks  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _card_like_host():
    """One torch thread and no tensorboard, as the other CLI tests run."""
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
        f"torch_dist_cli_{name}", os.path.join(REPO, "scripts", "torch", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _checkpoint(out, step) -> dict:
    return {k: np.asarray(v, np.float64) if not isinstance(v, torch.Tensor)
            else v.double().numpy()
            for k, v in load_file(os.path.join(str(out), f"checkpoint_{step}",
                                               "state.safetensors")).items()}


def _same_state(got: dict, want: dict, tol: float = TOL) -> None:
    """Every role (params, mu, nu, ema, ...) within ``tol`` relative L2."""
    assert sorted(got) == sorted(want)
    roles = sorted({k.split("/")[0] for k in want})
    for role in roles:
        keys = [k for k in sorted(want) if k.split("/")[0] == role]
        a = np.concatenate([got[k].ravel() for k in keys])
        b = np.concatenate([want[k].ravel() for k in keys])
        err = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        assert err <= tol, (role, err)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A tiny pipeline and an 8-pair parquet; the two-rank runs started,
    the one-process runs made meanwhile, then the one-process resume of
    the two-rank checkpoint."""
    root = tmp_path_factory.mktemp("dist_cli")
    _script("init_pipeline").main(["--output_dir", str(root / "pipe"), "--size", "tiny",
                                   "--device", "cpu"])
    rng = np.random.default_rng(0)
    (root / "data").mkdir()
    (root / "val").mkdir()
    paths, gms = [], []
    for i in range(8):
        p = root / "data" / f"sdr_{i}.png"
        p.write_bytes(encode_png(rng.integers(0, 255, (24, 24, 3), dtype=np.uint8)))
        paths.append(str(p))
        gms.append(encode_png(rng.integers(0, 255, (24, 24, 3), dtype=np.uint8)))
    (root / "val" / "v.png").write_bytes(
        encode_png(rng.integers(0, 255, (24, 24, 3), dtype=np.uint8)))
    meta = str(root / "train.parquet")
    write_parquet_dataset(meta, paths, gms, [f"test caption {i}" for i in range(8)])

    common = ["--pretrained_model_name_or_path", str(root / "pipe"), "--train_metadata", meta,
              "--resolution", "16", "--seed", "0", "--device", "cpu", "--center_crop",
              "--dataloader_num_workers", "1", "--max_train_steps", "2",
              "--checkpointing_steps", "1", "--use_ema"]
    s2 = ["--cache_latents", "--validation_image_dir", str(root / "val"),
          "--validation_epochs", "1"]
    s1 = ["--rank", "2", "--clip_pixel", "--log_steps", "1"]

    def argv(out, per_rank, *extra):
        return common + ["--output_dir", str(root / out), "--train_batch_size",
                         str(per_rank), *extra]

    two = [("s2_fsdp", "train_gm_unet", argv("s2_n2", 2, "--shard_strategy", "fsdp", *s2)),
           ("s2_zero1_one_step", "train_gm_unet",
            argv("resume", 2, "--shard_strategy", "zero1", "--max_train_steps", "1")),
           ("cn_zero1", "train_controlnet", argv("cn_n2", 2, "--shard_strategy", "zero1")),
           ("s1_fsdp", "train_vqgan_lora", argv("s1_n2", 1, "--shard_strategy", "fsdp", *s1))]
    ranks = Ranks("cli", 2, root, {"cli_runs": two})
    one = {
        "s2": _script("train_gm_unet").main(argv("s2_n1", 4, *s2)),
        "s2_pixels": _script("train_gm_unet").main(argv("s2_pixels_n1", 4)),
        "cn": _script("train_controlnet").main(argv("cn_n1", 4)),
        "s1": _script("train_vqgan_lora").main(argv("s1_n1", 2, *s1)),
    }
    two = ranks.results(timeout=600)
    resumed = _script("train_gm_unet").main(argv("resume", 4, "--resume_from_checkpoint",
                                                 "latest"))
    return {"root": root, "one": one, "two": two, "resumed": resumed}


@pytest.mark.parametrize("name,ref,out_two,out_one", [
    ("s2_fsdp", "s2", "s2_n2", "s2_n1"),
    ("cn_zero1", "cn", "cn_n2", "cn_n1"),
    ("s1_fsdp", "s1", "s1_n2", "s1_n1"),
])
def test_two_ranks_are_one_process_on_the_global_batch(runs, name, ref, out_two, out_one):
    """Each checkpoint (every tensor of the state, gathered to rank 0) and
    the logged losses of the two-rank run equal the one-process run's on
    the same global batch; both ranks report the same digests."""
    root = runs["root"]
    two = [r[name] for r in runs["two"]]
    one = runs["one"][ref]
    assert two[0]["global_step"] == two[1]["global_step"] == one["global_step"] == 2
    assert two[0]["saved_digests"] == two[1]["saved_digests"]
    assert two[0]["digest"] == two[1]["digest"]
    for step in (1, 2):
        _same_state(_checkpoint(root / out_two, step), _checkpoint(root / out_one, step))
    assert sorted(two[0]["losses"]) == sorted(one["losses"])
    for step, loss in one["losses"].items():
        np.testing.assert_allclose(two[0]["losses"][step], loss, rtol=TOL)
        np.testing.assert_allclose(two[1]["losses"][step], loss, rtol=TOL)


def test_rank_zero_writes_the_run(runs):
    """One metrics log (rank 0's; the trainer logs update 1 and every
    tenth), the latent
    cache built once into the output directory, the validation images and
    the final pipeline."""
    out = runs["root"] / "s2_n2"
    with open(out / "logs" / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows] == [1]
    assert (out / "latent_cache_16.npz").is_file()
    assert sorted(os.listdir(out / "validation")) == ["gm_step2_0.png", "hdr_step2_0.hdr"]
    assert (out / "save_pipeline" / "unet" / "params.safetensors").is_file()
    assert sorted(p for p in os.listdir(out) if p.startswith("checkpoint_")) == [
        "checkpoint_1", "checkpoint_2"]
    for d in ("finetuned_VAE", "discriminator"):
        assert (runs["root"] / "s1_n2" / d).is_dir()
    assert (runs["root"] / "cn_n2" / "controlnet").is_dir()


def test_final_pipeline_is_the_one_process_pipeline(runs):
    """The EMA shadow gathered from the fsdp shards into the final UNet."""
    root = runs["root"]
    got, want = (load_file(str(root / d / "save_pipeline" / "unet" / "params.safetensors"))
                 for d in ("s2_n2", "s2_n1"))
    flat = lambda sd: np.concatenate(  # noqa: E731
        [np.asarray(sd[k], np.float64).ravel() for k in sorted(sd)])
    assert sorted(got) == sorted(want)
    a, b = flat(got), flat(want)
    assert np.linalg.norm(a - b) / np.linalg.norm(b) <= TOL


def test_zero1_checkpoint_of_two_ranks_resumes_in_one_process(runs):
    """Saved at update 1 by two ranks under zero1, restored by one process
    under ddp with the digest it was saved with; the resumed update 2 is
    the uninterrupted one-process run's."""
    saved = runs["two"][0]["s2_zero1_one_step"]["saved_digests"][1]
    resumed = runs["resumed"]
    assert resumed["start_step"] == 1 and resumed["restored_digest"] == saved
    root = runs["root"]
    _same_state(_checkpoint(root / "resume", 2), _checkpoint(root / "s2_pixels_n1", 2))
