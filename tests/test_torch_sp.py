"""Spatial parallelism of the port on the CPU: each image's rows split over
2 and 4 gloo ranks (``tests/torch_tp_ranks.py``), against gmdx's unsharded
forwards (the JAX package's ``shard_batch_spatial`` layout computes those
numbers, ``tests/test_tp.py``) at its tolerance, rtol = atol = 3e-5: the
tiny UNet, the VAE's posterior and decode (its asymmetric-pad downsample
and its mid attention over gathered K/V) and the ControlNet's residuals
(its stride-2 pixel-space embedder). Then the halo rows at the image's
edges, the refusal of rows that do not split, the samplers' step noise (the
whole image's draws), and the GroupNorm merge of per-slice moments against
the whole image's GroupNorm."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from parallel_reference import (  # noqa: E402
    TOL, assert_forwards_close, jax_forwards, port_setup, tiny_setup,
)
from torch_dist_ranks import Ranks  # noqa: E402
from torch_tp_ranks import step_noise_run  # noqa: E402

from gmdx_torch.kernels.groupnorm import (  # noqa: E402
    group_norm_apply, group_norm_moments, group_norm_silu_plain, merge_moments,
)


@pytest.fixture(scope="module")
def tiny():
    s = tiny_setup(0)
    return s, jax_forwards(s)


@pytest.mark.parametrize("world", [2, 4])
def test_forwards_split_by_rows_match_gmdx(tmp_path, tiny, world):
    s, want = tiny
    for r in Ranks("tp_models", world, tmp_path, port_setup(s, mode="sp")).results():
        assert_forwards_close(r, want)


@pytest.fixture(scope="module")
def edges(tmp_path_factory, tiny):
    s, _ = tiny
    return {w: Ranks("sp_edges", w, tmp_path_factory.mktemp(f"sp{w}"), port_setup(s)).results()
            for w in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
def test_halo_rows_at_image_edges(edges, world):
    """Each rank's slab: its rows, the previous rank's last row above and the
    next rank's first below, zeros past the image's top and bottom."""
    full = np.arange(2 * 8 * 3 * 2, dtype=np.float32).reshape(2, 8, 3, 2)
    padded = np.pad(full, ((0, 0), (1, 1), (0, 0), (0, 0)))
    rows = 8 // world
    for r, res in enumerate(edges[world]):
        np.testing.assert_array_equal(res["halo"], padded[:, r * rows:(r + 1) * rows + 2])
        np.testing.assert_array_equal(res["halo_top"], padded[:, r * rows:(r + 1) * rows + 1])
        want = np.pad(padded[:, r * rows:(r + 1) * rows + 2], ((0, 0), (0, 0), (1, 1), (0, 0)))
        np.testing.assert_array_equal(res["filled"], want)
    assert not edges[world][0]["halo"][:, 0].any()
    assert not edges[world][-1]["halo"][:, -1].any()


@pytest.mark.parametrize("world", [2, 4])
def test_rows_that_do_not_split_raise(edges, world):
    """A level whose rows a rank holds cannot take a stride-2 conv (named by
    its rows), and an image whose rows do not divide by the ranks is refused
    before any layer runs."""
    for res in edges[world]:
        assert f"the {3 * world}-row level: 3 rows a rank" in res["unet_odd_level"]
        assert "do not split evenly" in res["uneven_split"]


def test_step_noise_is_the_whole_images(tmp_path):
    """DDPM, DDIM (eta 0.5 and 0) and LCM steps over rows split on two ranks:
    the latents one process samples, from as many draws of the generator."""
    want = step_noise_run(None)
    for r in Ranks("sp_step_noise", 2, tmp_path, {"mode": "sp"}).results():
        for k, v in want.items():
            np.testing.assert_allclose(r[k], v, rtol=TOL, atol=TOL, err_msg=k)


@pytest.mark.parametrize("ranks,temb,pad", [(2, False, False), (4, True, True), (3, True, False)])
def test_group_norm_merge_of_row_slices(ranks, temb, pad):
    """Per-slice moments, merged, applied to each slice: the whole image's
    plain GroupNorm (the padded slices' interiors, row for row)."""
    g = torch.Generator().manual_seed(ranks)
    x = torch.randn(2, 12, 8, 64, generator=g) * 3 + 1
    scale, bias = torch.randn(64, generator=g), torch.randn(64, generator=g)
    t = torch.randn(2, 64, generator=g) if temb else None
    parts = x.chunk(ranks, dim=1)
    moments = torch.stack([group_norm_moments(p, t) for p in parts])
    stats = merge_moments(moments, parts[0].shape[1] * 8 * 2, 1e-5)
    outs = [group_norm_apply(p, scale, bias, t, stats, pad_output=pad) for p in parts]
    got = torch.cat([o[:, 1:-1, 1:-1] if pad else o for o in outs], dim=1)
    want, want_stats = group_norm_silu_plain(x, scale, bias, t, return_stats=True)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(stats.numpy(), want_stats.numpy(), rtol=TOL, atol=TOL)
    if pad:
        assert all(not o[:, :, 0].any() and not o[:, :, -1].any() for o in outs)
