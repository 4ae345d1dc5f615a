"""The port's CLIs on the CPU at tiny size: ``scripts/torch/init_pipeline.py``
writes a directory, ``generate_hdr.py`` (with each sampler the directory can
name) and ``upconvert_hdrtv.py`` run 2 steps on PNGs of two sizes, and every
output file exists and reads back (the .hdr files finite, at the input's
size after --resolution); each refused flag raises. ``generate_hdr.py
--tp_size 2`` and ``--sp_size 2`` and ``upconvert_hdrtv.py --sp_size 2`` on
two gloo ranks (``tests/torch_tp_ranks.py``) compute what one process
writes (3e-5), and rank 0 writes it; a world the width does not fit, and
both widths at once, raise."""

import glob
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from gmdx_torch.io import read_hdr
from gmdx_torch.io.png import read_png, write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_ranks import Ranks  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models gain nothing from intra-op threads, and under a
    parallel test run they oversubscribe the cores; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _script(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_cli_{name}", os.path.join(REPO, "scripts", "torch", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("sdr")
    rng = np.random.default_rng(0)
    for name, (h, w) in (("a", (16, 16)), ("b", (12, 20))):
        write_png(str(d / f"{name}.png"), rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
    return str(d)


def _init(tmp_path, scheduler):
    out = str(tmp_path / f"pipe_{scheduler}")
    _script("init_pipeline").main(["--output_dir", out, "--size", "tiny", "--dual",
                                   "--scheduler", scheduler, "--device", "cpu"])
    return out


@pytest.mark.parametrize("scheduler", ["pndm", "ddim", "dpm++", "lcm"])
def test_generate_hdr(tmp_path, inputs, scheduler):
    pipe_dir = _init(tmp_path, scheduler)
    out = str(tmp_path / "out")
    _script("generate_hdr").main([
        "--pretrained_model_name_or_path", pipe_dir, "--unet_ckpt",
        os.path.join(pipe_dir, "gm_unet"), "--sdr_input_path", inputs, "--output_dir", out,
        "--resolution", "16", "--num_inference_steps", "2", "--device", "cpu"])
    for name in ("a", "b"):
        for kind in ("sdr", "gm"):
            assert read_png(os.path.join(out, f"{kind}_{name}.png")).shape == (16, 16, 3)
        for tag in ("decoded", "original"):
            hdr = read_hdr(os.path.join(out, f"hdr_{tag}_{name}.hdr"))
            assert hdr.shape == (16, 16, 3) and np.isfinite(hdr).all()
    assert len(os.listdir(out)) == 8


def test_upconvert_hdrtv(tmp_path, inputs):
    pipe_dir = _init(tmp_path, "ddim")
    out = str(tmp_path / "out")
    _script("upconvert_hdrtv").main([
        "--pretrained_model_name_or_path", pipe_dir, "--sdr_input_path", inputs,
        "--output_dir", out, "--resolution", "32", "--num_inference_steps", "2",
        "--device", "cpu"])
    for name in ("a", "b"):
        for kind in ("sdr", "gm"):
            assert read_png(os.path.join(out, f"{kind}_{name}.png")).ndim == 3
        hdr = read_hdr(os.path.join(out, f"hdrtv_{name}.hdr"))
        assert hdr.shape == (32, 32, 3) and np.isfinite(hdr).all()
    assert sorted(os.listdir(out)) == sorted(
        f"{k}_{n}.{e}" for n in ("a", "b") for k, e in (("sdr", "png"), ("gm", "png"),
                                                        ("hdrtv", "hdr")))


def test_refused_flags_raise(tmp_path, inputs):
    common = ["--pretrained_model_name_or_path", str(tmp_path), "--sdr_input_path", inputs,
              "--device", "cpu"]
    gen = _script("generate_hdr")
    with pytest.raises(NotImplementedError, match="export cache"):
        gen.main(common + ["--unet_ckpt", str(tmp_path), "--aot_cache"])
    pipe_dir = _init(tmp_path, "pndm")
    with pytest.raises(ValueError, match="8-channel"):
        gen.main(common[:1] + [pipe_dir] + common[2:] + [
            "--unet_ckpt", os.path.join(pipe_dir, "unet"), "--output_dir",
            str(tmp_path / "o")])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no card"):
            gen.main(common[:1] + [pipe_dir] + common[2:4] + ["--unet_ckpt", pipe_dir])
    assert not glob.glob(os.path.join(str(tmp_path), "o", "*.hdr"))


# --- split over ranks ---------------------------------------------------------


@pytest.fixture(scope="module")
def split_pipe(tmp_path_factory):
    return _init(tmp_path_factory.mktemp("split"), "ddim")


def _same_outputs(got: dict, want: dict) -> None:
    """Each file's array within 3e-5, relative and of its peak (the .hdr
    files reach (1 + qmax) times the gain map's exponent's rounding)."""
    assert sorted(got) == sorted(want)
    for name, arr in want.items():
        np.testing.assert_allclose(got[name], arr, rtol=3e-5,
                                   atol=3e-5 * max(1.0, float(np.abs(arr).max())), err_msg=name)


@pytest.mark.parametrize("flags", [["--tp_size", "2"], ["--sp_size", "2"]],
                         ids=["tp2", "sp2"])
def test_generate_hdr_over_two_ranks_writes_one_process_images(tmp_path, inputs, split_pipe,
                                                               flags):
    def argv(out):
        return ["--pretrained_model_name_or_path", split_pipe, "--unet_ckpt",
                os.path.join(split_pipe, "gm_unet"), "--sdr_input_path", inputs,
                "--output_dir", str(out), "--resolution", "16", "--num_inference_steps", "2",
                "--device", "cpu"]

    ranks = Ranks("tp_cli", 2, tmp_path, {"cli_runs": [
        ("gen", "generate_hdr", argv(tmp_path / "split") + flags)]})
    want = _script("generate_hdr").main(argv(tmp_path / "one"))
    for r in ranks.results():
        _same_outputs(r["gen"], want)
    assert sorted(os.listdir(tmp_path / "split")) == sorted(os.listdir(tmp_path / "one"))
    np.testing.assert_allclose(read_hdr(str(tmp_path / "split" / "hdr_original_a.hdr")),
                               read_hdr(str(tmp_path / "one" / "hdr_original_a.hdr")),
                               rtol=1e-2)


def test_upconvert_hdrtv_over_two_ranks_writes_one_process_frames(tmp_path, inputs, split_pipe):
    def argv(out):
        return ["--pretrained_model_name_or_path", split_pipe, "--sdr_input_path", inputs,
                "--output_dir", str(out), "--resolution", "32", "--num_inference_steps", "2",
                "--device", "cpu"]

    ranks = Ranks("tp_cli", 2, tmp_path, {"cli_runs": [
        ("up", "upconvert_hdrtv", argv(tmp_path / "split") + ["--sp_size", "2"])]})
    want = _script("upconvert_hdrtv").main(argv(tmp_path / "one"))
    for r in ranks.results():
        _same_outputs(r["up"], want)
    assert sorted(os.listdir(tmp_path / "split")) == sorted(os.listdir(tmp_path / "one"))


@pytest.mark.parametrize("script,flags,match", [
    ("generate_hdr", ["--tp_size", "2", "--sp_size", "2"], "mutually exclusive"),
    ("generate_hdr", ["--tp_size", "2"], "does not divide the world size \\(1\\)"),
    ("generate_hdr", ["--sp_size", "4"], "does not divide the world size \\(1\\)"),
    ("upconvert_hdrtv", ["--sp_size", "2"], "does not divide the world size \\(1\\)"),
])
def test_widths_the_world_does_not_fit_raise(tmp_path, inputs, script, flags, match):
    """One process (no process group): a width of 2 or more raises before
    anything loads, as the JAX scripts do where it does not divide the
    device count."""
    argv = ["--pretrained_model_name_or_path", str(tmp_path), "--sdr_input_path", inputs,
            "--device", "cpu"] + (["--unet_ckpt", str(tmp_path)] if script == "generate_hdr"
                                  else []) + flags
    with pytest.raises(ValueError, match=match):
        _script(script).main(argv)
