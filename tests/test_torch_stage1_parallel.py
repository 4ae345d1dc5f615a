"""Stage-1 training (VAE-LoRA + GAN) under tensor and spatial parallelism on
the CPU: two gloo ranks (``tests/torch_tp_ranks.py``) of one model group,
TP = 2 and SP = 2, the tiny VAE in fp32 at 32^2 (SP: 16 rows a rank; the
depth-4 discriminator halves them to 1), held against gmdx's
single-process generator and discriminator steps on the global batch with
the same posterior draw, and against the port's one process.

* The loss parts (recon, perceptual, adversarial, the adaptive weight, the
  generator's loss; the hinge, the gradient penalty, the discriminator's
  loss) within 1e-5 relative of gmdx's, and every gradient of both steps
  within 1e-4 relative L2 (a learning rate of 0 keeps the state gmdx's
  steps see). The perceptual term is held to the port's one process: the
  port's own one-process value lies ~1e-5 from gmdx's (float32 sums over
  the VGG pyramid), whatever the ranks (``tests/test_torch_dist.py``).
* A pair (generator, EMA, discriminator) at a real rate against the one
  process: metrics 1e-5, every tensor of the state 1e-5 relative L2 (where
  the gradient is zero up to rounding, AdamW's first step moves either run
  by +-lr), the spectral-norm buffers bit for bit under tp.
* Each rank's placed state: gmdx's ``tp_param_specs`` slices none of the
  LoRA tree's or the discriminator's leaves, and each rank holds them whole.
* Checkpoints across tp / sp / one process restore bit-equal.
* The collectives twice differentiated, as the gradient penalty does,
  against one process.
* ``scripts/torch/train_vqgan_lora.py`` for 2 steps under tp and under sp
  against one process, a run resumed across strategies from the other's
  checkpoint bit-equal.
"""

import os
import shutil
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from gmdx.dist.tp import tp_param_specs
from gmdx.models import TINY_VAE_CONFIG as JAX_TINY_VAE_CONFIG
from gmdx.models import AutoencoderKL as JaxVAE
from gmdx.models.discriminator import Discriminator as JaxDiscriminator
from gmdx.models.lora import LoRAConfig as JaxLoRAConfig
from gmdx.models.vgg import VGG19Features as JaxVGG
from gmdx.ops import tmo as jax_tmo
from gmdx.train import stage1 as jax_stage1
from gmdx_torch.io.convert import (
    discriminator_state_dict_from_flax, stage1_trainables_from_flax, vae_state_dict_from_flax,
    vgg19_state_dict_from_flax,
)
from gmdx_torch.io.to_flax import convert_vae_state_dict
from gmdx_torch.models import TINY_VAE_CONFIG, AutoencoderKL
from gmdx_torch.train.stage1 import trainable_names

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_train_parallel as tpt  # noqa: E402
from parallel_reference import LOSS_RTOL, assert_grads_close, rel_l2  # noqa: E402
from torch_dist_ranks import Ranks  # noqa: E402
from torch_tp_ranks import (  # noqa: E402
    SECOND_ORDER, s1_train_run, second_order_run, second_order_setup,
)

MODES = ("tp", "sp")
BATCH, HW, VGG_RES, AW_MAX, LR = 2, 32, 32, 1e12, 1e-3
ONE_TOL = 1e-5

_one_thread = pytest.fixture(autouse=True, scope="module")(tpt.one_thread)


def _keep_grads():
    """An optax transformation that leaves the parameters as they are and
    keeps the gradient as its state: gmdx's step then reports its
    gradients exactly (no difference of two parameter trees)."""
    return optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))


def _jax_setup():
    """gmdx's tiny VAE (from a seeded port init), discriminator (depth 4,
    64 wide) and VGG19 inits, LoRA r = 2 with seeded non-zero b factors, a
    global batch of BATCH 32^2 pairs; the port's numpy setup."""
    jvae, jdisc, jvgg = JaxVAE(JAX_TINY_VAE_CONFIG), JaxDiscriminator(depth=4, hidden_channels=64),\
        JaxVGG()
    torch.manual_seed(0)
    vae_params = convert_vae_state_dict(
        {k: v.numpy() for k, v in AutoencoderKL(TINY_VAE_CONFIG).state_dict().items()})
    disc_vars = jax.jit(jdisc.init)(jax.random.key(2), jnp.zeros((1, 3, HW, HW)))
    vgg_params = jax.jit(jvgg.init)(jax.random.key(3), jnp.zeros((1, 3, VGG_RES, VGG_RES)))
    cfg = jax_stage1.Stage1Config(lora=JaxLoRAConfig(rank=2, alpha=2.0), vgg_resolution=VGG_RES,
                                  adaptive_weight_max=AW_MAX)
    trainables = jax_stage1.init_trainables(jax.random.key(4), vae_params, cfg)
    rng = np.random.default_rng(5)
    for f in trainables["lora"].values():
        f["b"] = jnp.asarray(0.05 * rng.standard_normal(f["b"].shape).astype(np.float32))
    trainables = jax.tree.map(np.asarray, trainables)
    disc_params = jax.tree.map(np.asarray, disc_vars["params"])
    disc_stats = jax.tree.map(np.asarray, {k: v for k, v in disc_vars.items() if k != "params"})
    batch = {"pixel_values": rng.uniform(-1, 1, (BATCH, 3, HW, HW)).astype(np.float32),
             "miss_pixel_values": rng.uniform(-1, 1, (BATCH, 3, HW, HW)).astype(np.float32)}
    setup = {"vae_sd": vae_state_dict_from_flax(jax.tree.map(np.asarray, vae_params)),
             "vgg_sd": vgg19_state_dict_from_flax(jax.tree.map(np.asarray,
                                                               vgg_params["params"])),
             "disc_sd": discriminator_state_dict_from_flax(disc_params, disc_stats),
             "trainables": trainables, "s1_batch": batch, "seeds": [404],
             "vgg_resolution": VGG_RES, "adaptive_weight_max": AW_MAX, "size": 2, "lr": LR}
    jax_side = {"vae": jvae, "disc": jdisc, "vgg": jvgg, "cfg": cfg, "vae_params": vae_params,
                "vgg_params": vgg_params["params"], "disc_params": disc_params,
                "disc_stats": disc_stats, "trainables": trainables}
    return setup, jax_side


def _jax_steps(setup: dict, j: dict) -> dict:
    """gmdx's generator and discriminator steps, each from the initial
    state on the global batch with the port's posterior draw: metrics and
    gradients, in the port's names."""
    seed = setup["seeds"][0]
    eps = torch.randn((BATCH, 4, HW // 2, HW // 2),
                      generator=torch.Generator().manual_seed(seed)).numpy()
    keep = _keep_grads()
    tr = j["trainables"]
    state = jax_stage1.Stage1State(
        trainables=tr, disc_params=j["disc_params"], disc_vars=j["disc_stats"],
        opt_state=keep.init(tr), disc_opt_state=keep.init(j["disc_params"]), ema=None,
        step=jnp.zeros((), jnp.int32))
    frozen = {"vae": j["vae_params"], "vgg": j["vgg_params"]}
    batch = {**{k: jnp.asarray(v) for k, v in setup["s1_batch"].items()},
             "encode_eps": jnp.asarray(eps)}
    kw = dict(vae=j["vae"], discriminator=j["disc"], tmo_fn=jax_tmo.fix_mulog_tmo,
              optimizer=keep, donate=False)
    with jax.default_matmul_precision("highest"):
        gen = jax_stage1.make_gen_step(j["cfg"], vgg=j["vgg"], **kw)
        g_state, g = gen(state, frozen, batch, jax.random.key(0))
        disc = jax_stage1.make_disc_step(j["cfg"], **kw)
        d_state, d = disc(state, frozen, batch, jax.random.key(0))
    gen_grads = stage1_trainables_from_flax(jax.tree.map(np.asarray, g_state.opt_state))
    names = trainable_names(gen_grads)
    lora = gen_grads["lora"]
    flat = [lora[n][k] for n in sorted(lora) for k in ("a", "b")] + [
        gen_grads["conv_out"]["weight"], gen_grads["conv_out"]["bias"]]
    disc_grads = discriminator_state_dict_from_flax(
        jax.tree.map(np.asarray, d_state.disc_opt_state), {})
    return {"gen": {k: float(v) for k, v in g.items() if k != "module_grad_norms"},
            "disc": {k: float(v) for k, v in d.items()},
            "gen_grads": {n: np.asarray(v) for n, v in zip(names, flat)},
            "disc_grads": {k: np.asarray(v) for k, v in disc_grads.items()}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The one process's pairs (rate 0, and the real rate, checkpointed),
    then the ranks under each mode (started before gmdx compiles), gmdx's
    steps, the one process resumed from each mode's checkpoint."""
    setup, j = _jax_setup()
    work = {m: tmp_path_factory.mktemp(f"s1_{m}") for m in MODES}
    one_dir = str(work["tp"] / "ckpt_one")
    one = {"grads": s1_train_run(setup, None, lr=0.0),
           "run": s1_train_run(setup, None, lr=LR, save=one_dir)}
    shutil.copytree(one_dir, work["sp"] / "ckpt_one")
    ranks = {m: Ranks("s1_train", 2, work[m], {**setup, "mode": m}) for m in MODES}
    jax_out = _jax_steps(setup, j)
    got = {m: r.results() for m, r in ranks.items()}
    resumed = {m: s1_train_run(setup, None, lr=LR, restore=(str(work[m] / f"ckpt_{m}"), 1))
               for m in MODES}
    return {"one": one, "ranks": got, "jax": jax_out, "one_resumed": resumed,
            "trainables": j["trainables"], "disc_params": j["disc_params"]}


@pytest.mark.parametrize("mode", MODES)
def test_generator_step_matches_gmdx(runs, mode):
    """Each rank's loss parts and adaptive weight within 1e-5 relative of
    gmdx's, the perceptual term of the one process's, and every gradient
    of the trainables within 1e-4 relative L2."""
    want = runs["jax"]
    for r in runs["ranks"][mode]:
        got = r["grads"]
        for k in ("adaptive_weight", "gen_loss", "recon", "adversarial", "grad_norm"):
            np.testing.assert_allclose(got["gen"][k], want["gen"][k], rtol=LOSS_RTOL, err_msg=k)
        np.testing.assert_allclose(got["gen"]["perceptual"],
                                   runs["one"]["grads"]["gen"]["perceptual"], rtol=LOSS_RTOL)
        assert_grads_close(got["gen_grads"], want["gen_grads"])


@pytest.mark.parametrize("mode", MODES)
def test_discriminator_step_matches_gmdx(runs, mode):
    """Each rank's hinge, gradient penalty (its second derivative through the
    collectives under sp) and loss within 1e-5 relative of gmdx's, every
    discriminator gradient within 1e-4 relative L2."""
    want = runs["jax"]
    for r in runs["ranks"][mode]:
        got = r["grads"]
        for k in ("hinge", "gp", "disc_loss", "grad_norm"):
            np.testing.assert_allclose(got["disc"][k], want["disc"][k], rtol=LOSS_RTOL, err_msg=k)
        assert_grads_close(got["disc_grads"], want["disc_grads"])


def _assert_state_close(got: dict, one: dict, lr: float, bar: float = ONE_TOL, groups=(
        "gen_params/", "disc_params/", "gen_mu/", "gen_nu/", "disc_mu/", "disc_nu/", "ema/")):
    """Each group of a Stage-1 state within ``bar`` relative L2 of the one
    process's. AdamW's first update is lr * sign(g): where the gradient is
    zero up to rounding (a conv bias before an InstanceNorm, which removes
    it) either run moves the element by +-lr, so such elements of the
    parameters and the EMA are held to 2 lr instead."""
    for group in groups:
        keys = sorted(k for k in one if k.startswith(group))
        a, b = (np.concatenate([t[k].ravel() for k in keys]) for t in (got, one))
        if group.endswith(("params/", "ema/")):
            moment = "disc_mu/" if "disc" in group else "gen_mu/"
            mu = np.concatenate([one[k.replace(group, moment)].ravel() for k in keys])
            live = np.abs(mu) > 1e-6 * np.linalg.norm(mu)
            assert np.abs(a - b)[~live].max(initial=0.0) <= 2 * lr * (1 + 1e-6), group
            a, b = a[live], b[live]
        err = rel_l2(a, b)
        assert err <= bar, (group, err)


@pytest.mark.parametrize("mode", MODES)
def test_pair_matches_one_process(runs, mode):
    """A pair at a real rate: each rank's metrics 1e-5 of the one process's,
    every group of the state 1e-5 relative L2, the spectral-norm buffers
    bit for bit under tp (1e-5 relative L2 under sp), one digest on both ranks."""
    one = runs["one"]["run"]
    ranks = [r["run"] for r in runs["ranks"][mode]]
    for got in ranks:
        for part in ("gen", "disc"):
            for k, v in one[part].items():
                np.testing.assert_allclose(got[part][k], v, rtol=ONE_TOL, atol=1e-7,
                                           err_msg=f"{part} {k}")
        assert got["scalars"] == one["scalars"]
        assert sorted(got["tensors"]) == sorted(one["tensors"])
        _assert_state_close(got["tensors"], one["tensors"], LR)
        for k in one["tensors"]:
            if k.startswith("disc_buffers/"):
                # tp's replicas step the one process's arithmetic; sp's
                # weights differ by the rounding of the group's sums.
                if mode == "tp":
                    np.testing.assert_array_equal(got["tensors"][k], one["tensors"][k], k)
                else:
                    assert rel_l2(got["tensors"][k], one["tensors"][k]) <= ONE_TOL, k
    assert len({r["digest"] for r in ranks}) == 1


def test_placed_state_matches_gmdx_tp_specs(runs):
    """gmdx's tp_param_specs slice none of Stage 1's leaves (the LoRA tree is
    keyed by path tuples, the discriminator's convs have no TP name): every
    rank of either mode holds every leaf whole, the one process's shapes."""
    for tree in (runs["trainables"], runs["disc_params"]):
        specs = jax.tree.leaves(tp_param_specs(tree, 2),
                                is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        assert specs and all(all(a is None for a in s) for s in specs)
    want = runs["one"]["run"]["held"]
    for mode in MODES:
        for r in runs["ranks"][mode]:
            assert r["run"]["held"] == want


@pytest.mark.parametrize("mode", MODES)
def test_checkpoints_restore_across_modes_and_one_process(runs, mode):
    """The mode's checkpoint restored in one process and the one process's
    on the ranks: the saved digest each time, bit-equal, and the resumed
    pair's metrics the same on both sides."""
    ranks = runs["ranks"][mode]
    saved = ranks[0]["run"]["saved"]
    assert saved and all(r["run"]["saved"] == saved for r in ranks)
    assert runs["one_resumed"][mode]["restored"] == saved
    for r in ranks:
        assert r["resumed"]["restored"] == runs["one"]["run"]["saved"]
        for part in ("gen", "disc"):
            for k, v in runs["one_resumed"][mode][part].items():
                np.testing.assert_allclose(r["resumed"][part][k], v, rtol=ONE_TOL, atol=1e-7)


@pytest.fixture(scope="module")
def second_order(tmp_path_factory):
    setup = second_order_setup()
    ranks = Ranks("second_order", 2, tmp_path_factory.mktemp("second_order"), setup)
    return ranks.results(), second_order_run(setup, None)


@pytest.mark.parametrize("name", sorted(SECOND_ORDER))
def test_collectives_differentiate_twice_as_one_process(second_order, name):
    """Through each spatial collective: each rank's input gradient under
    create_graph (its rows of one process's), the penalty's gradient of the
    rank's rows and, summed over the ranks, of a weight they share."""
    ranks, one = second_order
    h_dim = SECOND_ORDER[name][0]
    for key in ("dx", "gx"):
        got = np.concatenate([r[name][key] for r in ranks], axis=h_dim)
        np.testing.assert_allclose(got, one[name][key], rtol=1e-5, atol=1e-6, err_msg=key)
    np.testing.assert_allclose(sum(r[name]["gw"] for r in ranks), one[name]["gw"], rtol=1e-5,
                               atol=1e-6)


CLI_LR = 1e-4  # the CLI's default rates


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    """train_vqgan_lora.py on the tiny pipeline and 4 128x136 pairs (sp's
    rows must halve through the CLI's depth-6 discriminator: 64 a rank),
    --clip_pixel and the EMA on. On two ranks: tp for 1 step (a checkpoint),
    sp for 2 steps, then sp resumed from tp's checkpoint to step 2; in one
    process 2 steps with a checkpoint at each."""
    from gmdx_torch.data import write_parquet_dataset
    from gmdx_torch.io.png import encode_png, write_png

    work = tmp_path_factory.mktemp("s1_cli_parallel")
    tpt._script("init_pipeline").main(["--output_dir", str(work / "pipe"), "--size", "tiny",
                                       "--device", "cpu"])
    rng = np.random.default_rng(1)
    (work / "data").mkdir()
    paths, gms = [], []
    for i in range(4):
        paths.append(str(work / "data" / f"sdr_{i}.png"))
        write_png(paths[-1], rng.integers(0, 255, (128, 136, 3), dtype=np.uint8))
        gms.append(encode_png(rng.integers(0, 255, (128, 136, 3), dtype=np.uint8)))
    meta = str(work / "train.parquet")
    write_parquet_dataset(meta, paths, gms, [f"caption {i}" for i in range(4)])

    def argv(out, steps, *extra):
        return ["--pretrained_model_name_or_path", str(work / "pipe"), "--train_metadata", meta,
                "--output_dir", str(work / out), "--resolution", "128", "--train_batch_size",
                "1", "--rank", "2", "--seed", "0", "--clip_pixel", "--use_ema", "--log_steps",
                "1", "--checkpointing_steps", "1", "--max_train_steps", str(steps),
                "--dataloader_num_workers", "1", "--device", "cpu", *extra]

    sp = ("--shard_strategy", "sp", "--sp_size", "2")
    ranks = Ranks("trainer_cli", 2, work, {"cli_runs": [
        ("tp", "train_vqgan_lora", argv("across", 1, "--shard_strategy", "tp", "--tp_size", "2")),
        ("sp", "train_vqgan_lora", argv("sp", 2, *sp)),
        ("sp_resumed", "train_vqgan_lora", argv("across", 2, *sp, "--resume_from_checkpoint",
                                                "latest"))]})
    from gmdx_torch.train.checkpoint import state_tensors

    one = tpt._script("train_vqgan_lora").main(argv("one", 2))
    one["tensors"] = {k: v.detach().numpy() for k, v in state_tensors(one.pop("state"))[0].items()}
    return {"one": one, "ranks": ranks.results()}


@pytest.mark.parametrize("mode", MODES)
def test_train_vqgan_lora_cli_matches_one_process(cli, mode):
    """Under tp (1 step: the replicas' arithmetic is the one process's, its
    checkpoint's digest the one process's) and sp (2 steps: the logged
    losses 1e-5 of the one process's, every group of the state within the
    Stage-2 CLI tests' bar, tests/torch_train_parallel.py:STATE_REL_L2: the
    discriminator's step follows a generator update whose rounding-level
    elements moved by +-lr)."""
    one = cli["one"]
    for r in cli["ranks"]:
        run = r[mode]
        assert run["global_step"] == (1 if mode == "tp" else 2)
        for step, loss in run["losses"].items():
            np.testing.assert_allclose(loss, one["losses"][step], rtol=LOSS_RTOL)
        if mode == "tp":
            assert run["saved_digests"][1] == one["saved_digests"][1]
        else:
            assert sorted(run["losses"]) == [1, 2]
            _assert_state_close(run["tensors"], one["tensors"], CLI_LR, tpt.STATE_REL_L2)


def test_train_vqgan_lora_resumes_across_strategies(cli):
    """sp resumed from tp's checkpoint of step 1: its restored digest is the
    saved one bit for bit (and the one process's), and step 2's loss the
    uninterrupted one process's within 1e-5."""
    one = cli["one"]
    for r in cli["ranks"]:
        resumed = r["sp_resumed"]
        assert resumed["start_step"] == 1 and resumed["global_step"] == 2
        assert resumed["restored_digest"] == r["tp"]["saved_digests"][1] \
            == one["saved_digests"][1]
        np.testing.assert_allclose(resumed["losses"][2], one["losses"][2], rtol=LOSS_RTOL)


@pytest.mark.parametrize("world", [2, 4])
def test_sp_discriminator_penalty_matches_one_process(tmp_path, world):
    """The Paella discriminator (depth 6) split over ``world`` gloo ranks,
    each its rows of two 256^2 images (4 ranks: a middle rank reads a halo
    row from above and gives one below): the hinge plus gradient penalty
    (its second derivative through the halo and moment collectives), the
    per-image input-gradient norms and the discriminator's gradients
    against one process, in float64 to 1e-9; the loss (its fp32 sigmoid
    head) to 1e-7."""
    import torch_tp_ranks

    real = np.random.default_rng(4).uniform(0, 1, (2, 3, 256, 256)).astype(np.float32)
    setup = {"device": "cpu", "dtype": "float64", "seed": 3, "depth": 6, "hidden": 64,
             "real": real}
    ranks = Ranks("disc_gp", world, tmp_path, setup)
    want = torch_tp_ranks.disc_gp_run(setup, None)
    for got in ranks.results():
        np.testing.assert_allclose(got["gp"], want["gp"], rtol=1e-9)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-7)
        np.testing.assert_allclose(got["norm"], want["norm"], rtol=1e-9)
        assert rel_l2(got["grads"], want["grads"]) <= 1e-9
