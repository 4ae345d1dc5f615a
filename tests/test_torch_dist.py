"""gmdx_torch.dist on the CPU: data-parallel training over gloo processes,
held against the JAX package and against the port's own one-process run.

The ranks are spawned processes (``tests/torch_dist_ranks.py``) that import
``gmdx_torch`` only and hand numpy results back; this process computes the
JAX package's side on the 8-device CPU mesh of ``tests/conftest.py``, and
the port's one-rank side in-process. At the tiny sizes: the process-sharded
loader against ``gmdx.data.make_dataloader(process_shard=True, ...)``; a
Stage-2 run of two updates on a global batch of 8 under ddp, zero1 and fsdp
on two ranks against gmdx's update of the global batch (loss 1e-5, the
parameters 1e-4 relative L2, the first moment as the gradient's 1e-4) and
against the port's one-rank run (1e-5); the Stage-1 adaptive weight
against gmdx's global one (1e-5); checkpoints across world sizes (equal
digests, the uninterrupted run's loss within 1e-5); and the trainers'
sizes over ranks.
"""

import dataclasses
import importlib.util
import os
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from gmdx.data import ParquetImageDataset as JaxDataset
from gmdx.data import make_dataloader as jax_make_dataloader
from gmdx.dist import make_mesh, replicate, shard_batch
from gmdx.models import TINY_UNET_CONFIG as JAX_TINY_UNET
from gmdx.models import TINY_VAE_CONFIG as JAX_TINY_VAE_CONFIG
from gmdx.models import AutoencoderKL as JaxVAE
from gmdx.models import UNet2DConditionModel as JaxUNet
from gmdx.models.discriminator import Discriminator as JaxDiscriminator
from gmdx.models.lora import LoRAConfig as JaxLoRAConfig
from gmdx.models.tokenizer import CLIPTokenizer as JaxTokenizer
from gmdx.models.vgg import VGG19Features as JaxVGG
from gmdx.ops import tmo as jax_tmo
from gmdx.schedulers import DDPMScheduler as JaxDDPM
from gmdx.train import stage1 as jax_stage1
from gmdx.train.stage2 import Stage2Config as JaxStage2Config
from gmdx.train.stage2 import make_optimizer as jax_make_optimizer
from gmdx.train.stage2 import stage2_loss as jax_stage2_loss
from gmdx_torch import dist
from gmdx_torch.data import ParquetImageDataset, make_dataloader, write_parquet_dataset
from gmdx_torch.io.convert import (
    discriminator_state_dict_from_flax, unet_state_dict_from_flax, vae_state_dict_from_flax,
    vgg19_state_dict_from_flax,
)
from gmdx_torch.io.png import encode_png
from gmdx_torch.io.to_flax import convert_unet_state_dict, convert_vae_state_dict
from gmdx_torch.models import (
    TINY_CLIP_CONFIG, TINY_UNET_CONFIG, TINY_VAE_CONFIG, AutoencoderKL, CLIPTextModel,
    CLIPTokenizer, UNet2DConditionModel,
)
from gmdx_torch.train.optim import run_sizes

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_dist_ranks  # noqa: E402
from torch_dist_ranks import Ranks  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
PARAM_REL_L2 = 1e-4
ONE_RANK_TOL = 1e-5
STRATEGIES = ("ddp", "zero1", "fsdp")
GLOBAL_BATCH, LATENT = 8, 8
S1_BATCH, S1_HW, VGG_RES, AW_MAX = 4, 16, 32, 1e12


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _group_rel_l2(got: dict, want: dict, prefix: str) -> float:
    keys = sorted(k for k in want if k.startswith(prefix))
    assert keys and keys == sorted(k for k in got if k.startswith(prefix))
    return _rel_l2(np.concatenate([got[k].ravel() for k in keys]),
                   np.concatenate([want[k].ravel() for k in keys]))


# ---------------------------------------------------------------------------
# the process-sharded loader
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def parquet(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_data")
    rng = np.random.default_rng(4)
    paths, gms, texts = [], [], []
    for i in range(10):
        h, w = (40, 52) if i % 2 else (50, 38)
        p = str(d / f"sdr_{i}.png")
        with open(p, "wb") as f:
            f.write(encode_png(rng.integers(0, 255, (h, w, 3)).astype(np.uint8)))
        paths.append(p)
        gms.append(encode_png(rng.integers(0, 255, (h, w, 3)).astype(np.uint8)))
        texts.append(f"a photo number {i}")
    meta = str(d / "train.parquet")
    write_parquet_dataset(meta, paths, gms, texts)
    return meta


@pytest.mark.parametrize("count", [2, 4])
def test_process_sharded_loader_matches_jax(parquet, count):
    """Each process's rows and pixels (random crops and flips, seeded per
    process) bit-equal to gmdx's, over two epochs with a resume skip."""
    kw = dict(batch_size=4, resolution=32, random_flip=True, seed=3, num_epochs=2,
              num_workers=2, max_samples=9, skip_batches=1, process_shard=True,
              process_count=count)
    for index in range(count):
        got = list(make_dataloader(ParquetImageDataset(parquet), CLIPTokenizer.tiny(),
                                   process_index=index, **kw))
        want = list(jax_make_dataloader(JaxDataset(parquet), JaxTokenizer.tiny(),
                                        use_native=False, process_index=index, **kw))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert sorted(g) == sorted(w)
            for k in w:
                assert g[k].shape[0] == 4 // count, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=f"{index}/{count} {k}")


def test_process_shard_refuses_an_indivisible_batch(parquet):
    with pytest.raises(ValueError, match="divide the global batch"):
        make_dataloader(ParquetImageDataset(parquet), CLIPTokenizer.tiny(), batch_size=4,
                        resolution=32, process_shard=True, process_index=0, process_count=3)


def test_single_process_shard_is_the_whole_batch(parquet):
    kw = dict(batch_size=4, resolution=32, seed=3, num_epochs=1, num_workers=1)
    a = list(make_dataloader(ParquetImageDataset(parquet), CLIPTokenizer.tiny(), **kw))
    b = list(make_dataloader(ParquetImageDataset(parquet), CLIPTokenizer.tiny(),
                             process_shard=True, **kw))
    for x, y in zip(a, b):
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


# ---------------------------------------------------------------------------
# Stage 2 on two ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def s2(tmp_path_factory):
    """The tiny GM UNet from gmdx's init, a seeded CLIP, a cached-latent
    global batch of 8; the port's one-rank run (checkpointed after the
    first update), the two-rank runs, and gmdx's two updates of the global
    batch on the 8-device mesh from the ranks' draws."""
    work = tmp_path_factory.mktemp("dist_stage2")
    jmodel = JaxUNet(dataclasses.replace(JAX_TINY_UNET, in_channels=8))
    # A seeded torch init carried across (Flax's init of the UNet takes
    # half a minute on the CPU).
    torch.manual_seed(3)
    unet_sd = {k: v.numpy() for k, v in UNet2DConditionModel(
        dataclasses.replace(TINY_UNET_CONFIG, in_channels=8)).state_dict().items()}
    jparams = convert_unet_state_dict(unet_sd)
    torch.manual_seed(1)
    text_sd = {k: v.numpy() for k, v in CLIPTextModel(TINY_CLIP_CONFIG).state_dict().items()}
    rng = np.random.default_rng(7)
    shape = (GLOBAL_BATCH, 4, LATENT, LATENT)
    batch = {
        "sdr_latent_mean": rng.standard_normal(shape).astype(np.float32),
        "sdr_latent_std": rng.uniform(0.05, 0.3, shape).astype(np.float32),
        "gm_latent_mean": rng.standard_normal(shape).astype(np.float32),
        "gm_latent_std": rng.uniform(0.05, 0.3, shape).astype(np.float32),
        "input_ids": rng.integers(0, 1000, (GLOBAL_BATCH, 77)).astype(np.int64),
    }
    config = dict(learning_rate=3e-4, use_ema=True, max_grad_norm=1.0, noise_offset=0.1)
    setup = {"unet_sd": unet_sd, "text_sd": text_sd,
             "batch": batch, "stage2_config": config, "seeds": [101, 202],
             "workdir": str(work)}
    one = torch_dist_ranks.stage2_run(setup, "ddp", save=(str(work / "ckpt_n1"), 1))
    ranks = Ranks("stage2", 2, work, setup)

    # gmdx: two updates of the global batch from the one-rank run's inputs
    # (which the ranks' are, test_stage2_draws_are_the_global_batch_sliced),
    # while the ranks run.
    jcfg = JaxStage2Config(**config)
    acp = jnp.asarray(JaxDDPM().alphas_cumprod)
    opt = jax_make_optimizer(jcfg)
    mesh = make_mesh(8)

    def loss_fn(p, inputs):
        return jax_stage2_loss(lambda p_, *a: jmodel.apply({"params": p_}, *a), p, **inputs,
                               alphas_cumprod=acp, config=jcfg)

    @jax.jit
    def update(p, s, inputs):
        loss, grads = jax.value_and_grad(loss_fn)(p, inputs)
        upd, s = opt.update(grads, s, p)
        return optax.apply_updates(p, upd), s, loss, optax.global_norm(grads)

    params = replicate(mesh, jparams)
    opt_state = replicate(mesh, opt.init(jparams))
    jax_out = {"loss": [], "grad_norm": []}
    with jax.default_matmul_precision("highest"):
        for k in range(2):
            inputs = dict(one["draws"][k])
            inputs["timesteps"] = inputs["timesteps"].astype(np.int32)
            inputs.pop("perturbed_noise", None)
            params, opt_state, loss, gnorm = update(params, opt_state,
                                                    shard_batch(mesh, inputs))
            jax_out["loss"].append(float(loss))
            jax_out["grad_norm"].append(float(gnorm))
    jax_out["params"] = unet_state_dict_from_flax(jax.tree.map(np.asarray, params))
    adam = opt_state[-1][0]
    jax_out["mu"] = unet_state_dict_from_flax(jax.tree.map(np.asarray, adam.mu))
    ranks = ranks.results()
    # The port's one-rank run restoring the two-rank zero1 checkpoint.
    resumed = torch_dist_ranks.stage2_run(setup, "ddp", steps=(1,),
                                          restore=(str(work / "ckpt_n2"), 1))
    return {"one": one, "ranks": ranks, "resumed": resumed, "jax": jax_out}


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_stage2_draws_are_the_global_batch_sliced(s2, strategy):
    """Each rank's latents, text states, noise and timesteps are its rows
    of the one-rank step's on the global batch, bit for bit."""
    for k in range(2):
        want = s2["one"]["draws"][k]
        got = [r[strategy]["draws"][k] for r in s2["ranks"]]
        for n in want:
            np.testing.assert_array_equal(np.concatenate([g[n] for g in got]), want[n],
                                          err_msg=f"step {k} {n}")


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_stage2_update_matches_one_rank(s2, strategy):
    """Loss, gradient norms and every tensor of the state (parameters,
    moments, EMA) after two updates: the two-rank run is the one-rank run
    on the global batch, to the rounding of the sum over the ranks."""
    one = s2["one"]
    for r in s2["ranks"]:
        got = r[strategy]
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=ONE_RANK_TOL)
        np.testing.assert_allclose(got["grad_norm"], one["grad_norm"], rtol=ONE_RANK_TOL)
        for k in range(2):
            for n, v in one["module_grad_norms"][k].items():
                np.testing.assert_allclose(got["module_grad_norms"][k][n], v, rtol=1e-4,
                                           atol=1e-7, err_msg=n)
        assert got["scalars"] == one["scalars"]
        for group in ("params/", "ema/", "mu/", "nu/"):
            assert _group_rel_l2(got["tensors"], one["tensors"], group) <= ONE_RANK_TOL, group
    # Every rank reports the same digest of the whole state.
    assert len({r[strategy]["digest"] for r in s2["ranks"]}) == 1


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_stage2_update_matches_gmdx_global_batch(s2, strategy):
    """Two updates against gmdx's value_and_grad + clipped AdamW on the
    global batch: losses and gradient norms 1e-5, the parameters 1e-4
    relative L2, the first moment (a multiple of the clipped gradient)
    1e-4 relative L2."""
    want = s2["jax"]
    got = s2["ranks"][0][strategy]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], rtol=LOSS_RTOL)
    params = {k[len("params/"):]: v for k, v in got["tensors"].items() if k.startswith("params/")}
    mu = {k[len("mu/"):]: v for k, v in got["tensors"].items() if k.startswith("mu/")}
    assert sorted(params) == sorted(want["params"])
    assert _group_rel_l2(params, want["params"], "") <= PARAM_REL_L2
    assert _group_rel_l2(mu, want["mu"], "") <= PARAM_REL_L2


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_stage2_state_is_placed_as_the_strategy_says(s2, strategy):
    """Between steps a rank holds: ddp everything; zero1 half of each
    moment; fsdp half of the moments, the master parameters and the EMA,
    and no storage for the module's parameters."""
    total = s2["one"]["placement"]["params"]
    half = -(-total // 2)
    want = {"ddp": dict(params=total, master=total, mu=total, nu=total, ema=total),
            "zero1": dict(params=total, master=total, mu=half, nu=half, ema=total),
            "fsdp": dict(params=0, master=half, mu=half, nu=half, ema=half)}[strategy]
    assert s2["one"]["placement"] == dict(params=total, master=total, mu=total, nu=total,
                                          ema=total)
    held = [r[strategy]["placement"] for r in s2["ranks"]]
    for p in held:
        for k, v in want.items():
            # The last rank's shard ends where the tensors do.
            assert p[k] == v or (v == half and p[k] == total - half), (k, p)
    if strategy != "ddp":
        assert sum(p["mu"] for p in held) == total


def test_checkpoint_from_two_ranks_resumes_on_one(s2):
    """zero1 on two ranks saves after update 1 (the one-process format);
    one rank restores it bit-equal and takes update 2 as the two ranks did."""
    zero1 = s2["ranks"][0]["zero1"]
    assert zero1["saved"] and all(r["zero1"]["saved"] == zero1["saved"] for r in s2["ranks"])
    assert s2["resumed"]["restored"] == zero1["saved"]
    np.testing.assert_allclose(s2["resumed"]["loss"][0], zero1["loss"][1], rtol=LOSS_RTOL)


def test_checkpoint_from_one_rank_resumes_on_two(s2):
    """fsdp on two ranks restores the one-rank checkpoint of update 1:
    the same digest on both ranks, and update 2's loss is the
    uninterrupted one-rank run's."""
    for r in s2["ranks"]:
        assert r["fsdp_resumed"]["restored"] == s2["one"]["saved"]
        np.testing.assert_allclose(r["fsdp_resumed"]["loss"][0], s2["one"]["loss"][1],
                                   rtol=LOSS_RTOL)


# ---------------------------------------------------------------------------
# Stage 1 on two ranks
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def s1(tmp_path_factory):
    """The tiny Stage 1 from gmdx's inits on a global batch of 4: the
    two-rank runs (ddp, fsdp), the port's one-rank run, and gmdx's
    generator step on the global batch with the posterior draw the port
    makes (the first draw of the step's generator)."""
    work = tmp_path_factory.mktemp("dist_stage1")
    jvae = JaxVAE(JAX_TINY_VAE_CONFIG)
    jdisc = JaxDiscriminator(depth=4, hidden_channels=64)
    jvgg = JaxVGG()
    hw = S1_HW
    torch.manual_seed(0)
    vae_params = convert_vae_state_dict(
        {k: v.numpy() for k, v in AutoencoderKL(TINY_VAE_CONFIG).state_dict().items()})
    disc_vars = jax.jit(jdisc.init)(jax.random.key(2), jnp.zeros((1, 3, hw, hw)))
    vgg_params = jax.jit(jvgg.init)(jax.random.key(3),
                                    jnp.zeros((1, 3, VGG_RES, VGG_RES)))["params"]
    # No clip on the adaptive weight: at these inits it lies above the
    # default 1e4, where both packages would report the clip.
    cfg = jax_stage1.Stage1Config(lora=JaxLoRAConfig(rank=2, alpha=2.0), vgg_resolution=VGG_RES,
                                  adaptive_weight_max=AW_MAX)
    trainables = jax_stage1.init_trainables(jax.random.key(4), vae_params, cfg)
    rng = np.random.default_rng(5)
    for f in trainables["lora"].values():
        f["b"] = jnp.asarray(0.05 * rng.standard_normal(f["b"].shape).astype(np.float32))
    trainables = jax.tree.map(np.asarray, trainables)
    disc_params = jax.tree.map(np.asarray, disc_vars["params"])
    disc_stats = jax.tree.map(np.asarray, {k: v for k, v in disc_vars.items() if k != "params"})
    batch = {
        "pixel_values": rng.uniform(-1, 1, (S1_BATCH, 3, hw, hw)).astype(np.float32),
        "miss_pixel_values": rng.uniform(-1, 1, (S1_BATCH, 3, hw, hw)).astype(np.float32),
    }
    seed = 303
    setup = {"vae_sd": vae_state_dict_from_flax(jax.tree.map(np.asarray, vae_params)),
             "vgg_sd": vgg19_state_dict_from_flax(jax.tree.map(np.asarray, vgg_params)),
             "disc_sd": discriminator_state_dict_from_flax(disc_params, disc_stats),
             "trainables": trainables, "s1_batch": batch, "seeds": [seed],
             "vgg_resolution": VGG_RES, "adaptive_weight_max": AW_MAX, "workdir": str(work)}
    ranks = Ranks("stage1", 2, work, setup)
    one = torch_dist_ranks.stage1_run(setup, "ddp")

    eps = torch.randn((S1_BATCH, 4, hw // 2, hw // 2),
                      generator=torch.Generator().manual_seed(seed)).numpy()
    state = jax_stage1.Stage1State(
        trainables=trainables, disc_params=disc_params, disc_vars=disc_stats,
        opt_state=optax.identity().init(trainables), disc_opt_state=None, ema=None,
        step=jnp.zeros((), jnp.int32))
    with jax.default_matmul_precision("highest"):
        gen = jax_stage1.make_gen_step(cfg, vae=jvae, discriminator=jdisc, vgg=jvgg,
                                       tmo_fn=jax_tmo.fix_mulog_tmo, optimizer=optax.identity(),
                                       donate=False)
        _, metrics = gen(state, {"vae": vae_params, "vgg": vgg_params},
                         {**{k: jnp.asarray(v) for k, v in batch.items()},
                          "encode_eps": jnp.asarray(eps)}, jax.random.key(0))
    return {"one": one, "ranks": ranks.results(), "jax": jax.tree.map(np.asarray, metrics)}


@pytest.mark.parametrize("strategy", ["ddp", "fsdp"])
def test_stage1_adaptive_weight_matches_gmdx_global_batch(s1, strategy):
    """The adaptive weight and the generator's losses on two ranks (the
    probes averaged over the ranks) against gmdx's on the global batch.
    The perceptual term is held to the one-rank run instead
    (test_stage1_pair_matches_one_rank): at this batch the port's own
    one-process value lies 1.7e-5 from gmdx's (float32 sums over the VGG
    pyramid), whatever the ranks."""
    want = s1["jax"]
    for r in s1["ranks"]:
        got = r[strategy]["gen"]
        for k in ("adaptive_weight", "gen_loss", "recon", "adversarial", "grad_norm"):
            np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)


@pytest.mark.parametrize("strategy", ["ddp", "fsdp"])
def test_stage1_pair_matches_one_rank(s1, strategy):
    """A generator and a discriminator update with the EMA between: the
    metrics and the state (trainables, discriminator, moments, EMA) of two
    ranks against the one-rank pair on the global batch."""
    one = s1["one"]
    for r in s1["ranks"]:
        got = r[strategy]
        for part in ("gen", "disc"):
            for k, v in one[part].items():
                np.testing.assert_allclose(got[part][k], v, rtol=ONE_RANK_TOL, atol=1e-7,
                                           err_msg=f"{part} {k}")
        for group in ("gen_params/", "disc_params/", "gen_mu/", "disc_nu/", "ema/"):
            assert _group_rel_l2(got["tensors"], one["tensors"], group) <= ONE_RANK_TOL, group
        np.testing.assert_array_equal(
            np.concatenate([got["tensors"][k].ravel() for k in sorted(got["tensors"])
                            if k.startswith("disc_buffers/")]),
            np.concatenate([one["tensors"][k].ravel() for k in sorted(one["tensors"])
                            if k.startswith("disc_buffers/")]))


# ---------------------------------------------------------------------------
# a small model: every strategy, with and without accumulation
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def mlp(tmp_path_factory):
    setup = torch_dist_ranks.mlp_setup("cpu")
    ranks = Ranks("mlp", 2, tmp_path_factory.mktemp("dist_mlp"), setup)
    one = {k: torch_dist_ranks.mlp_run(setup, "ddp", k) for k in (1, 2)}
    return one, ranks.results()


@pytest.mark.parametrize("accumulation", [1, 2])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_small_model_updates_match_one_rank(mlp, strategy, accumulation):
    """Four micro-batches (two updates under accumulation, whose local
    gradients are reduced once, at the update), buckets smaller than a
    tensor: the losses and parameters of two ranks are one rank's on the
    global batches."""
    one, ranks = mlp
    want = one[accumulation]
    for r in ranks:
        got = r[(strategy, accumulation)]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=ONE_RANK_TOL)
        for g, w in zip(got["params"], want["params"]):
            assert _rel_l2(g, w) <= ONE_RANK_TOL


# ---------------------------------------------------------------------------
# sizes and strategies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_dev,ga,max_steps", [(1, 1, None), (2, 1, None), (4, 3, None),
                                                (8, 2, 7)])
def test_run_sizes_match_gmdx(n_dev, ga, max_steps):
    """The JAX trainers' arithmetic (scripts/stage2/train_gm_unet.py:375-393,
    scripts/stage1/train_vqgan_lora.py:317-342,
    scripts/controlnet/train_controlnet.py:219-227): the global batch is
    the per-rank batch times the ranks, the epoch drops the ragged tail,
    an epoch's updates are ceil(batches / ga)."""
    bs, n, epochs = 3, 100, 4
    got = run_sizes(n_samples=n, train_batch_size=bs, n_dev=n_dev,
                    gradient_accumulation_steps=ga, max_train_steps=max_steps,
                    num_train_epochs=epochs)
    batches = max(1, n // (bs * max(1, n_dev)))
    steps = max(1, -(-batches // ga))
    assert got == {"global_batch": bs * n_dev, "batches_per_epoch": batches,
                   "steps_per_epoch": steps, "max_train_steps": max_steps or epochs * steps}


def test_single_process_is_a_no_op():
    assert not dist.initialize()
    assert (dist.world_size(), dist.rank(), dist.batch_rows(4)) == (1, 0, None)
    batch = {"x": torch.arange(4)}
    assert dist.shard_batch(batch) is batch
    state = object()
    assert dist.apply_shard_strategy(state, "fsdp", param_fields=(), opt_fields=()) is state


@pytest.mark.parametrize("trainer,strategy", [
    pytest.param("train_vqgan_lora", "tp", id="tp"),
    pytest.param("train_vqgan_lora", "sp", id="sp"),
    pytest.param("train_controlnet", "tp", id="controlnet-tp"),
    pytest.param("train_controlnet", "sp", id="controlnet-sp"),
])
def test_tensor_and_spatial_parallelism_raise_naming_the_item(tmp_path, trainer, strategy):
    """The Stage-1 and ControlNet trainers take tp / sp, as Stage 2 does;
    what raises is gmdx's rule (``make_train_mesh``): a model group of at
    least 2 ranks that divides the world, checked by ``check_group_size``
    and by the CLI in one process before anything is read or written. The
    data-parallel check (``check_strategy``, which ``DataParallel`` makes)
    refuses tp / sp and an unknown strategy."""
    dist.check_group_size(strategy, 2, 4)
    for size, n in ((1, 1), (2, 1), (3, 4)):
        with pytest.raises(ValueError, match=rf"group size >= 2 dividing the device count "
                                             rf"\({n}\); got {size}"):
            dist.check_group_size(strategy, size, n)
    with pytest.raises(ValueError, match="data x model grid"):
        dist.check_strategy(strategy)
    with pytest.raises(ValueError):
        dist.check_strategy("zero3")
    spec = importlib.util.spec_from_file_location(
        f"refusing_{trainer}", os.path.join(REPO, "scripts", "torch", f"{trainer}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = tmp_path / "out"
    with pytest.raises(ValueError, match=rf"--shard_strategy {strategy} needs a group size >= 2 "
                                         rf"dividing the device count \(1\); got 2"):
        mod.main(["--pretrained_model_name_or_path", str(tmp_path / "pipe"), "--train_metadata",
                  str(tmp_path / "train.parquet"), "--output_dir", str(out), "--device", "cpu",
                  "--shard_strategy", strategy])
    assert not out.exists()


@pytest.mark.parametrize("world", [1, 2, 3, 5])
def test_shard_layout_covers_every_element_once(world):
    numels = [7, 1, 30, 0, 12, 5]
    seen = {i: np.zeros(n, int) for i, n in enumerate(numels)}
    for r in range(world):
        layout = dist.ShardLayout(numels, world, r, bucket=4)
        assert layout.chunk * world >= sum(numels)
        pos = []
        for lo, hi in layout.buckets():
            for i, a, b, s in layout.spans(r, lo, hi):
                seen[i][a:b] += 1
                pos.append((s, b - a))
        # Within a shard, the spans lie back to back from its start.
        ends = np.cumsum([0] + [n for _, n in pos])
        assert [s for s, _ in pos] == list(ends[:-1])
    assert all((v == 1).all() for v in seen.values())
