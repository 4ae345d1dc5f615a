"""ControlNet training under tensor and spatial parallelism on the CPU: two
gloo ranks (``tests/torch_tp_ranks.py``) of one model group, TP = 2 and
SP = 2, the tiny SDR UNet, VAE, CLIP and a ControlNet copied from the UNet
(its zero convs and embedder output seeded non-zero) in fp32, a global
batch of 2 32^2 frames (16^2 latents; the control image resized to 128^2,
whole, then split under sp), held against gmdx's single-process loss and
gradients at the same draws and against the port's one process.

* A step's loss within 1e-5 relative and every ControlNet gradient within
  1e-4 relative L2 of gmdx's ``value_and_grad`` (the bars of
  ``tests/test_torch_controlnet_train.py``), and of the port's one process;
  two updates (clipped AdamW, EMA) against the one process's.
* The draws: the model group's tp ranks the global batch's, sp's each its
  rows of the whole image's.
* Under tp each rank holds exactly the slices gmdx's ``tp_param_specs``
  gives the ControlNet's leaves; under sp the whole.
* Checkpoints across tp / sp / one process restore bit-equal.
* ``scripts/torch/train_controlnet.py`` for 2 steps under tp and sp against
  one process (``controlnet/`` whole), and a run resumed across strategies
  bit-equal.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gmdx.dist.tp import tp_param_specs
from gmdx.models import ControlNetModel as JaxControlNet
from gmdx.models import TINY_CONTROLNET_CONFIG as J_CNET
from gmdx.models import TINY_UNET_CONFIG as J_UNET
from gmdx.models import UNet2DConditionModel as JaxUNet
from gmdx_torch.io.convert import controlnet_state_dict_from_flax, controlnet_state_dict_from_unet
from gmdx_torch.io.to_flax import convert_controlnet_state_dict, convert_unet_state_dict
from gmdx_torch.models import (
    TINY_CLIP_CONFIG, TINY_CONTROLNET_CONFIG, TINY_UNET_CONFIG, TINY_VAE_CONFIG, AutoencoderKL,
    CLIPTextModel, ControlNetModel, UNet2DConditionModel,
)

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_train_parallel as tpt  # noqa: E402
from parallel_reference import LOSS_RTOL, assert_grads_close, rel_l2  # noqa: E402
from torch_dist_ranks import Ranks  # noqa: E402
from torch_tp_ranks import cnet_train_run  # noqa: E402

MODES = ("tp", "sp")
BATCH, SIDE = 2, 32
ADAPTERS = ("controlnet_down_blocks.", "controlnet_mid_block.",
            "controlnet_cond_embedding.conv_out.")

_one_thread = pytest.fixture(autouse=True, scope="module")(tpt.one_thread)


def _setup() -> dict:
    """Seeded port inits of the tiny UNet, VAE, CLIP and the ControlNet
    copied from the UNet (adapters non-zero), the global batch (the frame
    is target and control, as the trainer feeds them), two steps' seeds."""
    torch.manual_seed(0)
    unet = UNet2DConditionModel(TINY_UNET_CONFIG)
    cnet = ControlNetModel(TINY_CONTROLNET_CONFIG)
    vae, text = AutoencoderKL(TINY_VAE_CONFIG), CLIPTextModel(TINY_CLIP_CONFIG)
    cnet_sd = controlnet_state_dict_from_unet(cnet.state_dict(), unet.state_dict())
    gen = torch.Generator().manual_seed(1)
    for k, v in cnet_sd.items():
        if k.startswith(ADAPTERS):
            cnet_sd[k] = 0.05 * torch.randn(v.shape, generator=gen)
    rng = np.random.default_rng(2)
    frames = rng.uniform(-1, 1, (BATCH, 3, SIDE, SIDE)).astype(np.float32)
    as_np = lambda sd: {k: v.detach().numpy() for k, v in sd.items()}  # noqa: E731
    return {"unet_sd": as_np(unet.state_dict()), "vae_sd": as_np(vae.state_dict()),
            "cnet_sd": as_np(cnet_sd), "text_sd": as_np(text.state_dict()),
            "cnet_batch": {"image": frames, "cond": frames,
                           "input_ids": rng.integers(0, 1000, (BATCH, 77)).astype(np.int64)},
            "seeds": [505, 606], "size": 2,
            "cnet_config": dict(learning_rate=3e-4, use_ema=True, max_grad_norm=1.0,
                                lr_warmup_steps=0)}


def _jax_step(setup: dict, draws: dict) -> tuple[float, dict]:
    """gmdx's single-process ControlNet loss and gradients (port names) at
    the one process's draws of the global batch."""
    unet_params = convert_unet_state_dict(setup["unet_sd"])
    cnet_params = convert_controlnet_state_dict(setup["cnet_sd"])
    unet, cnet = JaxUNet(J_UNET), JaxControlNet(J_CNET)
    j = {k: jnp.asarray(v) for k, v in draws.items()}
    j["timesteps"] = j["timesteps"].astype(jnp.int32)

    def loss_fn(params):
        downs, mid = cnet.apply({"params": params}, j["noisy_latents"], j["timesteps"],
                                j["encoder_hidden_states"], j["control_image"])
        pred = unet.apply({"params": unet_params}, j["noisy_latents"], j["timesteps"],
                          j["encoder_hidden_states"], down_block_additional_residuals=downs,
                          mid_block_additional_residual=mid)
        return jnp.mean((pred.astype(jnp.float32) - j["noise"]) ** 2)

    with jax.default_matmul_precision("highest"):
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(cnet_params)
    return float(loss), controlnet_state_dict_from_flax(jax.tree.map(np.asarray, grads))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one process's two updates (a checkpoint after the first), the
    ranks' under each mode (started before gmdx compiles), gmdx's loss and
    gradients at the first update's draws, the one process resumed from
    each mode's checkpoint."""
    setup = _setup()
    work = {m: tmp_path_factory.mktemp(f"cnet_{m}") for m in MODES}
    one = cnet_train_run(setup, None, save=(str(work["tp"] / "ckpt_one"), 1))
    import shutil

    shutil.copytree(work["tp"] / "ckpt_one", work["sp"] / "ckpt_one")
    ranks = {m: Ranks("cnet_train", 2, work[m], {**setup, "mode": m}) for m in MODES}
    jax_loss, jax_grads = _jax_step(setup, one["draws"][0])
    out = {"one": one, "jax": (jax_loss, jax_grads), "setup": setup}
    for m, r in ranks.items():
        res = r.results()
        out[m] = {"one": one, "ranks": [x["run"] for x in res],
                  "ranks_resumed": [x["resumed"] for x in res],
                  "one_resumed": cnet_train_run(setup, None, steps=(1,),
                                                restore=(str(work[m] / f"ckpt_{m}"), 1))}
    return out


@pytest.mark.parametrize("mode", MODES)
def test_step_matches_gmdx_single_process(runs, mode):
    """Each rank's first loss within 1e-5 relative of gmdx's, every
    ControlNet gradient (tp's slices gathered) within 1e-4 relative L2."""
    loss, grads = runs["jax"]
    for r in runs[mode]["ranks"]:
        assert abs(r["loss"][0] - loss) <= LOSS_RTOL * abs(loss)
        assert_grads_close(r["grads"], grads)


@pytest.mark.parametrize("mode", MODES)
def test_updates_match_one_process(runs, mode):
    """Two updates: each rank's losses and gradient norms 1e-5 of the one
    process's, its first gradient 1e-4, every group of the state after them
    the Stage-2 parallel tests' bar; the steps equal, one digest."""
    one = runs["one"]
    ranks = runs[mode]["ranks"]
    assert_grads_close(ranks[0]["grads"], one["grads"])
    for r in ranks:
        np.testing.assert_allclose(r["loss"], one["loss"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["grad_norm"], one["grad_norm"], rtol=LOSS_RTOL)
        assert r["scalars"] == one["scalars"]
        _assert_state_close(r["tensors"], one["tensors"])
    assert len({r["digest"] for r in ranks}) == 1


@pytest.mark.parametrize("mode", MODES)
def test_draws_are_the_global_batch(runs, mode):
    """tp: both ranks draw the one process's inputs bit for bit; sp: each
    rank's noise and control image are its H rows of them bit for bit, its
    noisy latents within rounding (the VAE encoded its rows, its GroupNorm
    statistics merged over the group), the text states and timesteps
    whole."""
    for k, want in enumerate(runs["one"]["draws"]):
        for n, v in want.items():
            got = [r["draws"][k][n] for r in runs[mode]["ranks"]]
            if mode == "sp" and v.ndim == 4:
                got = [np.concatenate(got, axis=2)]
            for g in got:
                if mode == "sp" and n == "noisy_latents":
                    np.testing.assert_allclose(g, v, rtol=1e-5, atol=1e-6, err_msg=f"{k} {n}")
                else:
                    np.testing.assert_array_equal(g, v, err_msg=f"{k} {n}")


def test_placed_state_matches_gmdx_tp_specs(runs):
    """Under tp each rank holds, leaf for leaf, the shape that gmdx's
    tp_param_specs gives the ControlNet's param tree over 2 shards (some
    sliced, some whole); under sp the one process's whole shapes."""
    tree = convert_controlnet_state_dict(runs["setup"]["cnet_sd"])
    specs = tp_param_specs(tree, 2)

    def local(v, spec):
        shape = list(np.shape(v))
        for d, axis in enumerate(tuple(spec)):
            if axis is not None:
                shape[d] //= 2
        return np.zeros(shape, np.float32)

    local_tree = jax.tree.map(local, tree, specs,
                              is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    want = {k: tuple(v.shape) for k, v in controlnet_state_dict_from_flax(local_tree).items()}
    whole = runs["one"]["held"]
    assert sum(want[k] != whole[k] for k in whole) > 10
    for r in runs["tp"]["ranks"]:
        assert r["held"] == want
    for r in runs["sp"]["ranks"]:
        assert r["held"] == whole


@pytest.mark.parametrize("mode", MODES)
def test_checkpoints_restore_across_modes_and_one_process(runs, mode):
    tpt.check_checkpoints(runs[mode])


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """train_controlnet.py on the tiny pipeline and 4 40x48 pairs at 16^2,
    the EMA on, a checkpoint at each step: on two ranks tp and sp for 2
    steps each, then sp resumed from tp's checkpoint of step 1 to step 2;
    the same 2 steps in one process."""
    from gmdx_torch.data import write_parquet_dataset
    from gmdx_torch.io.params import load_file
    from gmdx_torch.io.png import encode_png, write_png
    from gmdx_torch.train.checkpoint import state_tensors

    work = tmp_path_factory.mktemp("cnet_cli_parallel")
    tpt._script("init_pipeline").main(["--output_dir", str(work / "pipe"), "--size", "tiny",
                                       "--device", "cpu"])
    rng = np.random.default_rng(3)
    (work / "data").mkdir()
    paths, gms = [], []
    for i in range(4):
        paths.append(str(work / "data" / f"sdr_{i}.png"))
        write_png(paths[-1], rng.integers(0, 255, (40, 48, 3), dtype=np.uint8))
        gms.append(encode_png(rng.integers(0, 255, (40, 48, 3), dtype=np.uint8)))
    meta = str(work / "train.parquet")
    write_parquet_dataset(meta, paths, gms, [f"caption {i}" for i in range(4)])

    def argv(out, steps, *extra):
        return ["--pretrained_model_name_or_path", str(work / "pipe"), "--train_metadata", meta,
                "--output_dir", str(work / out), "--resolution", "16", "--train_batch_size",
                "2", "--seed", "0", "--use_ema", "--checkpointing_steps", "1",
                "--max_train_steps", str(steps), "--lr_warmup_steps", "0",
                "--dataloader_num_workers", "1", "--device", "cpu", *extra]

    sp = ("--shard_strategy", "sp", "--sp_size", "2")
    ranks = Ranks("trainer_cli", 2, work, {"cli_runs": [
        ("tp", "train_controlnet", argv("tp", 2, "--shard_strategy", "tp", "--tp_size", "2")),
        ("sp", "train_controlnet", argv("sp", 2, *sp)),
        ("sp_resumed", "train_controlnet", argv("across", 2, *sp, "--resume_from_checkpoint",
                                                "latest"),
         (str(work / "tp" / "checkpoint_1"), str(work / "across" / "checkpoint_1")))]})
    one = tpt._script("train_controlnet").main(argv("one", 2))
    one["tensors"] = {k: v.detach().numpy() for k, v in state_tensors(one.pop("state"))[0].items()}
    res = ranks.results()
    saved = {name: load_file(os.path.join(str(work / name), "controlnet", "params.safetensors"))
             for name in ("one", "tp", "sp", "across")}
    return {"one": one, "ranks": res, "saved": saved}


@pytest.mark.parametrize("mode", MODES)
def test_train_controlnet_cli_matches_one_process(cli, mode):
    """Two steps under the mode: the logged losses 1e-5 of the one
    process's, every group of the state (tp's slices gathered) the Stage-2
    CLI tests' bar, the saved controlnet/ whole and within that bar of the
    one process's."""
    one = cli["one"]
    for r in cli["ranks"]:
        run = r[mode]
        assert run["global_step"] == 2 and sorted(run["losses"]) == sorted(one["losses"])
        for k, v in run["losses"].items():
            np.testing.assert_allclose(v, one["losses"][k], rtol=LOSS_RTOL)
        _assert_state_close(run["tensors"], one["tensors"])
    got, want = cli["saved"][mode], cli["saved"]["one"]
    assert sorted(got) == sorted(want)
    keys = sorted(want)
    for k in keys:
        assert np.asarray(got[k]).shape == np.asarray(want[k]).shape, k
    err = rel_l2(np.concatenate([np.asarray(got[k]).ravel() for k in keys]),
                 np.concatenate([np.asarray(want[k]).ravel() for k in keys]))
    assert err <= tpt.STATE_REL_L2, err


def test_train_controlnet_resumes_across_strategies(cli):
    """sp resumed from tp's checkpoint of step 1 (the ControlNet's slices
    saved whole): its restored digest the saved one bit for bit, its state
    after step 2 the uninterrupted one process's within the Stage-2 CLI
    tests' bar."""
    for r in cli["ranks"]:
        resumed = r["sp_resumed"]
        assert resumed["start_step"] == 1 and resumed["global_step"] == 2
        assert resumed["restored_digest"] == r["tp"]["saved_digests"][1]
        _assert_state_close(resumed["tensors"], cli["one"]["tensors"])


def _assert_state_close(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for group in ("params/", "mu/", "nu/", "ema/"):
        keys = sorted(k for k in want if k.startswith(group))
        err = rel_l2(np.concatenate([got[k].ravel() for k in keys]),
                     np.concatenate([want[k].ravel() for k in keys]))
        assert err <= tpt.STATE_REL_L2, (group, err)
