"""What ``tests/test_torch_tp_train.py`` and ``tests/test_torch_sp_train.py``
share: the runs of the tiny Stage 2 under one mode (two gloo ranks of
``tests/torch_tp_ranks.py``, the port's one process, gmdx's single-process
step) and of ``scripts/torch/train_gm_unet.py`` under it, and the checks
both hold them to."""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import torch

from parallel_reference import LOSS_RTOL, assert_grads_close, jax_stage2_step, rel_l2
from torch_dist_ranks import Ranks
from torch_tp_ranks import collectives_one_process, collectives_setup, train_run, train_setup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Two updates of the ranks against the one process's: the gradient's bar.
# Clipped AdamW's first update is lr * sign(g): an element whose gradient is
# zero up to rounding (the tiny config's biases before its one-channel
# GroupNorms) moves by +-lr in either run, whatever the ranks' sums.
STATE_REL_L2 = 1e-4


def stage2_runs(mode: str, work) -> dict:
    """The ranks' two updates (a checkpoint after the first, and one update
    resumed from the one process's), the one process's (a checkpoint after
    the first, and one update resumed from the ranks'), and gmdx's loss and
    gradients at the first update's draws."""
    setup = train_setup(mode, str(work))
    one = train_run(setup, None, save=(str(work / "ckpt_one"), 1))
    ranks = Ranks("tp_train", 2, work, setup)
    jax_loss, jax_grads = jax_stage2_step(setup, one["draws"][0])
    ranks = ranks.results()
    resumed = train_run(setup, None, steps=(1,), restore=(str(work / f"ckpt_{mode}"), 1))
    return {"one": one, "ranks": [r["run"] for r in ranks],
            "ranks_resumed": [r["resumed"] for r in ranks], "one_resumed": resumed,
            "jax": (jax_loss, jax_grads)}


def check_against_jax(runs: dict) -> None:
    """Each rank's first update against gmdx's single process: the loss
    1e-5 relative, every gradient 1e-4 relative L2."""
    loss, grads = runs["jax"]
    for r in runs["ranks"]:
        assert abs(r["loss"][0] - loss) <= LOSS_RTOL * abs(loss)
        assert_grads_close(r["grads"], grads)


def check_against_one_process(runs: dict) -> None:
    """Each rank's two updates against the port's one process on the global
    batch: losses and gradient norms 1e-5, module norms 1e-4, the first
    gradient 1e-4, every tensor of the state after them STATE_REL_L2; the
    steps and counts equal, one digest on every rank."""
    one = runs["one"]
    assert_grads_close(runs["ranks"][0]["grads"], one["grads"])
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["grad_norm"], one["grad_norm"], rtol=LOSS_RTOL)
        for k in range(2):
            for n, v in one["module_grad_norms"][k].items():
                np.testing.assert_allclose(r["module_grad_norms"][k][n], v, rtol=1e-4,
                                           atol=1e-7, err_msg=n)
        assert r["scalars"] == one["scalars"]
        assert sorted(r["tensors"]) == sorted(one["tensors"])
        for group in ("params/", "mu/", "nu/", "ema/"):
            keys = sorted(k for k in one["tensors"] if k.startswith(group))
            err = rel_l2(np.concatenate([r["tensors"][k].ravel() for k in keys]),
                         np.concatenate([one["tensors"][k].ravel() for k in keys]))
            assert err <= STATE_REL_L2, (group, err)
    assert len({r["digest"] for r in runs["ranks"]}) == 1


def check_checkpoints(runs: dict) -> None:
    """The ranks' checkpoint of update 1 restored in one process, and the
    one process's restored on the ranks: the saved digest each time, and
    the resumed update's loss the uninterrupted run's."""
    one, ranks = runs["one"], runs["ranks"]
    assert ranks[0]["saved"] and all(r["saved"] == ranks[0]["saved"] for r in ranks)
    assert runs["one_resumed"]["restored"] == ranks[0]["saved"]
    np.testing.assert_allclose(runs["one_resumed"]["loss"][0], ranks[0]["loss"][1],
                               rtol=LOSS_RTOL)
    for r in runs["ranks_resumed"]:
        assert r["restored"] == one["saved"]
        np.testing.assert_allclose(r["loss"][0], one["loss"][1], rtol=LOSS_RTOL)


def collectives(mode: str, work) -> tuple[list[dict], dict]:
    """The ranks' gradients through each autograd collective, and the one
    process's."""
    setup = collectives_setup(mode)
    return Ranks("tp_collectives", 2, work, setup).results(), collectives_one_process(setup)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_train_parallel_{name}", os.path.join(REPO, "scripts", "torch", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cli_runs(mode: str, work, flags: list[str]) -> dict:
    """``train_gm_unet.py`` with ``flags`` for 2 updates on the tiny
    pipeline and a parquet of 8 64^2 pairs: under ``mode`` (2 ranks,
    --shard_strategy MODE --MODE_size 2) and in one process; each run's
    result with the state's whole tensors, and each saved pipeline's UNet."""
    from gmdx_torch.data import write_parquet_dataset
    from gmdx_torch.io.params import load_file
    from gmdx_torch.io.png import encode_png, write_png
    from gmdx_torch.train.checkpoint import state_tensors

    _script("init_pipeline").main(["--output_dir", str(work / "pipe"), "--size", "tiny",
                                   "--device", "cpu"])
    rng = np.random.default_rng(0)
    (work / "data").mkdir()
    paths, gms = [], []
    for i in range(8):
        paths.append(str(work / "data" / f"sdr_{i}.png"))
        write_png(paths[-1], rng.integers(0, 255, (64, 64, 3), dtype=np.uint8))
        gms.append(encode_png(rng.integers(0, 255, (64, 64, 3), dtype=np.uint8)))
    meta = str(work / "train.parquet")
    write_parquet_dataset(meta, paths, gms, [f"test caption {i}" for i in range(8)])

    def argv(out, *extra):
        return ["--pretrained_model_name_or_path", str(work / "pipe"), "--train_metadata", meta,
                "--output_dir", str(work / out), "--resolution", "16", "--seed", "0",
                "--device", "cpu", "--train_batch_size", "2", "--max_train_steps", "2",
                "--dataloader_num_workers", "1", *flags, *extra]

    ranks = Ranks("tp_train_cli", 2, work, {"cli_runs": [
        ("run", argv(mode, "--shard_strategy", mode, f"--{mode}_size", "2"))]})
    one = _script("train_gm_unet").main(argv("one"))
    one["tensors"] = {k: v.detach().numpy()
                      for k, v in state_tensors(one.pop("state"))[0].items()}
    out = {"one": one, "ranks": [r["run"] for r in ranks.results()]}
    for name in ("one", mode):
        out[f"{name}_unet"] = load_file(
            os.path.join(str(work / name), "save_pipeline", "unet", "params.safetensors"))
    return out


def check_cli(runs: dict, mode: str) -> None:
    """The two updates through the CLI on each rank against one process: the
    logged loss 1e-5, the steps equal, every tensor of the state
    STATE_REL_L2; the saved pipeline's UNet whole, STATE_REL_L2 of the one
    process's."""
    one = runs["one"]
    for r in runs["ranks"]:
        assert r["global_step"] == one["global_step"] == 2
        assert sorted(r["losses"]) == sorted(one["losses"]) == [1]
        np.testing.assert_allclose(r["losses"][1], one["losses"][1], rtol=LOSS_RTOL)
        assert sorted(r["tensors"]) == sorted(one["tensors"])
        for k, v in one["tensors"].items():
            assert r["tensors"][k].shape == v.shape, k
        for group in ("params/", "ema/"):
            keys = sorted(k for k in one["tensors"] if k.startswith(group))
            err = rel_l2(np.concatenate([r["tensors"][k].ravel() for k in keys]),
                         np.concatenate([one["tensors"][k].ravel() for k in keys]))
            assert err <= STATE_REL_L2, (group, err)
    got, want = runs[f"{mode}_unet"], runs["one_unet"]
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).shape == np.asarray(want[k]).shape, k
    keys = sorted(want)
    err = rel_l2(np.concatenate([np.asarray(got[k]).ravel() for k in keys]),
                 np.concatenate([np.asarray(want[k]).ravel() for k in keys]))
    assert err <= STATE_REL_L2, err


def one_thread():
    """Pin torch to one thread for a module's tests (intra-op threads
    oversubscribe a parallel run), restoring it after; no tensorboard, as
    on the card's machine (importing it here pulls in TensorFlow)."""
    import sys

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
