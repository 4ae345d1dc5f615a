"""Stage-2 training under tensor parallelism on the CPU: two gloo ranks
(``tests/torch_tp_ranks.py``) of one model group, the tiny GM UNet in fp32,
held against gmdx's single-process step and the port's one process.

* A step's loss within 1e-5 relative and every gradient within 1e-4
  relative L2 of gmdx's single-process value_and_grad (the bars of
  ``tests/test_torch_train.py:test_stage2_loss_and_grads_match_jax``), and
  of the port's one process; two updates (clipped AdamW, EMA) against the
  one process's; the draws of a model group the global batch's.
* Each rank holds its slices of the parameters, moments and EMA.
* A checkpoint of the ranks restored in one process, and the other way
  round, with the saved digests.
* The TP autograd collectives (``copy_to_model``, ``reduce_from_model``,
  ``gather_full``) against one process's gradients.
* ``scripts/torch/train_gm_unet.py --shard_strategy tp --tp_size 2`` for two
  updates (EMA, remat, gradient accumulation, cached latents) against one
  process, the saved pipeline's UNet whole.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_train_parallel as tpt  # noqa: E402

MODE = "tp"

_one_thread = pytest.fixture(autouse=True, scope="module")(tpt.one_thread)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return tpt.stage2_runs(MODE, tmp_path_factory.mktemp("tp_train"))


def test_step_matches_gmdx_single_process(runs):
    tpt.check_against_jax(runs)


def test_updates_match_one_process(runs):
    tpt.check_against_one_process(runs)


def test_model_group_draws_the_global_batch(runs):
    """Both ranks of the one model group draw the global batch's latents,
    text states, noise and timesteps, bit for bit the one process's."""
    for r in runs["ranks"]:
        for k, want in enumerate(runs["one"]["draws"]):
            for n, v in want.items():
                np.testing.assert_array_equal(r["draws"][k][n], v, err_msg=f"{k} {n}")


def test_each_rank_holds_its_slices(runs):
    """The two ranks hold as many parameters each, fewer than the whole: the
    sliced leaves' halves and the replicated ones."""
    held = [r["held"] for r in runs["ranks"]]
    assert held[0] == held[1] < runs["one"]["held"]


def test_checkpoints_restore_across_tp_and_one_process(runs):
    tpt.check_checkpoints(runs)


@pytest.mark.parametrize("name", ["copy_to_model", "reduce_from_model", "gather_full"])
def test_autograd_collectives_match_one_process(collectives, name):
    ranks, want = collectives
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res[name], want[name][r], rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    return tpt.collectives(MODE, tmp_path_factory.mktemp("tp_collectives"))


def test_train_gm_unet_cli_matches_one_process(tmp_path):
    runs = tpt.cli_runs(MODE, tmp_path, ["--use_ema", "--gradient_checkpointing",
                                         "--gradient_accumulation_steps", "2",
                                         "--cache_latents", "--center_crop"])
    tpt.check_cli(runs, MODE)
