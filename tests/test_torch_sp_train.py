"""Stage-2 training under spatial parallelism on the CPU: two gloo ranks
(``tests/torch_tp_ranks.py``) split each image's rows, the tiny GM UNet in
fp32 at 16^2 latents (the first level's 256 tokens take the flash route: a
rank's 128 queries against the gathered keys), held against gmdx's
single-process step and the port's one process.

* A step's loss within 1e-5 relative and every gradient within 1e-4
  relative L2 of gmdx's single-process value_and_grad (the bars of
  ``tests/test_torch_train.py:test_stage2_loss_and_grads_match_jax``), and
  of the port's one process; two updates (clipped AdamW, EMA, min-SNR
  weights per sample) against the one process's; each rank's draws its rows
  of the whole image's.
* A checkpoint of the ranks restored in one process, and the other way
  round, with the saved digests.
* The SP autograd collectives (``gather_rows``, ``halo_rows``,
  ``fill_halo``) against one process's gradients.
* The split GroupNorm backward's plain versions over 2 and 4 row slices
  against the whole image's.
* ``scripts/torch/train_gm_unet.py --shard_strategy sp --sp_size 2`` for two
  updates from pixels (the VAE on each rank's rows; EMA, remat, gradient
  accumulation) against one process, the saved pipeline's UNet whole.
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_train_parallel as tpt  # noqa: E402

from gmdx_torch.kernels.groupnorm import (  # noqa: E402
    group_norm_bwd_apply_plain, group_norm_bwd_sums_plain, group_norm_silu_bwd_plain,
    group_norm_silu_plain,
)

MODE = "sp"

_one_thread = pytest.fixture(autouse=True, scope="module")(tpt.one_thread)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return tpt.stage2_runs(MODE, tmp_path_factory.mktemp("sp_train"))


def test_step_matches_gmdx_single_process(runs):
    tpt.check_against_jax(runs)


def test_updates_match_one_process(runs):
    tpt.check_against_one_process(runs)


def test_each_rank_draws_its_rows_of_the_whole_image(runs):
    """Each rank's latents and noise are its rows (H) of the one process's
    draws on the global batch, bit for bit; the text states and timesteps
    are the whole batch's on both."""
    for k, want in enumerate(runs["one"]["draws"]):
        for n, v in want.items():
            got = [r["draws"][k][n] for r in runs["ranks"]]
            if v.ndim == 4:
                got = [np.concatenate(got, axis=2)]
            for g in got:
                np.testing.assert_array_equal(g, v, err_msg=f"{k} {n}")


def test_checkpoints_restore_across_sp_and_one_process(runs):
    tpt.check_checkpoints(runs)


@pytest.fixture(scope="module")
def collectives(tmp_path_factory):
    return tpt.collectives(MODE, tmp_path_factory.mktemp("sp_collectives"))


@pytest.mark.parametrize("name", ["gather_rows", "halo_rows", "halo_rows_top", "fill_halo"])
def test_autograd_collectives_match_one_process(collectives, name):
    """The gradient of each rank's rows: gather_rows' is every rank's
    cotangent of them, summed; a halo row's goes back to the rank whose
    edge row it is (halo_rows: a row above and below, or above alone, as a
    stride-2 conv reads; fill_halo: the padded slab's border rows)."""
    ranks, want = collectives
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res[name], want[name][r], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("slices", [2, 4])
def test_split_group_norm_backward_over_row_slices(slices):
    """Each slice's sums (its padded cotangent's interior), summed as the
    ranks' all-reduce does, then each slice's dx and dtemb: the whole
    image's backward (temb, SiLU, padded output), dx row for row, dtemb and
    the parameters' gradients summed over the slices."""
    g = torch.Generator().manual_seed(slices)
    x = torch.randn(2, 8, 6, 64, generator=g) * 2 + 0.5
    scale, bias = torch.randn(64, generator=g), torch.randn(64, generator=g)
    t = torch.randn(2, 64, generator=g)
    cot = torch.randn(2, 10, 8, 64, generator=g)
    _, stats = group_norm_silu_plain(x, scale, bias, t, return_stats=True)
    kw = dict(activate=True, pad_output=True)
    dx, dscale, dbias, dtemb = group_norm_silu_bwd_plain(x, scale, bias, t, stats, cot, **kw)
    rows = 8 // slices
    parts = [(x[:, r * rows:(r + 1) * rows], cot[:, r * rows:(r + 1) * rows + 2])
             for r in range(slices)]
    sums = [group_norm_bwd_sums_plain(xr, scale, bias, t, stats, gr, **kw) for xr, gr in parts]
    total = sum(s for s, _, _ in sums)
    outs = [group_norm_bwd_apply_plain(xr, scale, bias, t, stats, gr, total, 8 * 6, **kw)
            for xr, gr in parts]
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(torch.cat([o[0] for o in outs], 1).numpy(), dx.numpy(), **tol)
    np.testing.assert_allclose(sum(o[1] for o in outs).numpy(), dtemb.numpy(), **tol)
    np.testing.assert_allclose(sum(s[1] for s in sums).numpy(), dscale.numpy(), **tol)
    np.testing.assert_allclose(sum(s[2] for s in sums).numpy(), dbias.numpy(), **tol)


def test_train_gm_unet_cli_matches_one_process(tmp_path):
    runs = tpt.cli_runs(MODE, tmp_path, ["--use_ema", "--gradient_checkpointing",
                                         "--gradient_accumulation_steps", "2"])
    tpt.check_cli(runs, MODE)
