"""The port's diffusers converter against the JAX package's, on the CPU.

``scripts/torch/convert_torch_checkpoint.py`` (no JAX, no ``safetensors``)
against ``scripts/tools/convert_torch_checkpoint.py`` on a tiny
diffusers-layout directory written here from seeded numpy weights:
``unet``, ``gm_unet`` (8 channels), ``vae``, ``text_encoder``,
``safety_checker`` (``TINY_VISION_CONFIG``), a tokenizer and a scheduler
config, nothing downloaded. ``import`` must write the JAX tool's directory
(every ``config.json`` equal as JSON, every tensor bit-equal with its
dtype) over the quirks of real checkpoints; ``export`` must write the JAX
tool's diffusers files, read back here with ``safetensors``; export then
import is the identity.
"""

import dataclasses
import importlib.util
import json
import os
import shutil

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as st_load
from safetensors.numpy import save_file as st_save
from safetensors.torch import save_file as st_save_torch

from gmdx.io.torch_import import load_torch_checkpoint as jax_load_torch_checkpoint
from gmdx.schedulers.base import SchedulerConfig as JaxSchedulerConfig
from gmdx_torch.io import torch_import
from gmdx_torch.io.pipeline import save_component, save_scheduler, save_tokenizer
from gmdx_torch.models import (
    TINY_CLIP_CONFIG, TINY_CONTROLNET_CONFIG, TINY_UNET_CONFIG, TINY_VAE_CONFIG,
    TINY_VISION_CONFIG, AutoencoderKL, CLIPTextModel, CLIPTokenizer, ControlNetModel,
    StableDiffusionSafetyChecker, UNet2DConditionModel,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, *path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_TOOL = _script(("scripts", "tools", "convert_torch_checkpoint.py"), "jax_convert_tool")
PORT_TOOL = _script(("scripts", "torch", "convert_torch_checkpoint.py"), "port_convert_tool")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models gain nothing from intra-op threads, and under a
    parallel test run they oversubscribe the cores; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# a tiny diffusers-layout directory
# ---------------------------------------------------------------------------

DOWN = ["CrossAttnDownBlock2D", "DownBlock2D"]
UP = ["UpBlock2D", "CrossAttnUpBlock2D"]
UNET_CFG = {"_class_name": "UNet2DConditionModel", "_diffusers_version": "0.6.0",
            "act_fn": "silu", "attention_head_dim": 2, "block_out_channels": [32, 64],
            "center_input_sample": False, "cross_attention_dim": 32, "down_block_types": DOWN,
            "downsample_padding": 1, "flip_sin_to_cos": True, "freq_shift": 0, "in_channels": 4,
            "layers_per_block": 2, "mid_block_scale_factor": 1, "norm_eps": 1e-05,
            "norm_num_groups": 32, "out_channels": 4, "sample_size": 8, "up_block_types": UP}
VAE_CFG = {"_class_name": "AutoencoderKL", "_diffusers_version": "0.6.0", "act_fn": "silu",
           "block_out_channels": [32, 64], "down_block_types": ["DownEncoderBlock2D"] * 2,
           "in_channels": 3, "latent_channels": 4, "layers_per_block": 2,
           "norm_num_groups": 32, "out_channels": 3, "sample_size": 32,
           "up_block_types": ["UpDecoderBlock2D"] * 2}
CLIP_CFG = {"architectures": ["CLIPTextModel"], "hidden_act": "quick_gelu", "hidden_size": 32,
            "intermediate_size": 64, "layer_norm_eps": 1e-05, "max_position_embeddings": 77,
            "model_type": "clip_text_model", "num_attention_heads": 2, "num_hidden_layers": 2,
            "projection_dim": 768, "torch_dtype": "float32", "vocab_size": 1000}
CHECKER_CFG = {"architectures": ["StableDiffusionSafetyChecker"], "model_type": "clip",
               "projection_dim": 16, "text_config": {"hidden_size": 32},
               "vision_config": {"hidden_size": 32, "image_size": 32, "intermediate_size": 64,
                                 "num_attention_heads": 2, "num_hidden_layers": 2,
                                 "patch_size": 8, "layer_norm_eps": 1e-05}}
PNDM_CFG = {"_class_name": "PNDMScheduler", "_diffusers_version": "0.6.0", "beta_end": 0.012,
            "beta_schedule": "scaled_linear", "beta_start": 0.00085, "clip_sample": False,
            "num_train_timesteps": 1000, "set_alpha_to_one": False, "skip_prk_steps": True,
            "steps_offset": 1, "trained_betas": None}


def _state_dict(module, rng) -> dict:
    """Seeded numpy weights in ``module``'s key space (built on meta)."""
    out = {}
    for k, v in module.state_dict().items():
        shape = tuple(v.shape)
        x = rng.standard_normal(shape).astype(np.float32)
        if len(shape) >= 2:
            x *= np.float32(np.prod(shape[1:]) ** -0.5)
        out[k] = x if len(shape) >= 2 else (1.0 + 0.1 * x).astype(np.float32)
    return out


def _modules():
    with torch.device("meta"):
        return {
            "unet": UNet2DConditionModel(TINY_UNET_CONFIG),
            "gm_unet": UNet2DConditionModel(dataclasses.replace(TINY_UNET_CONFIG, in_channels=8)),
            "vae": AutoencoderKL(TINY_VAE_CONFIG),
            "text_encoder": CLIPTextModel(TINY_CLIP_CONFIG),
            "safety_checker": StableDiffusionSafetyChecker(TINY_VISION_CONFIG),
        }


_FILES = {"unet": "diffusion_pytorch_model", "gm_unet": "diffusion_pytorch_model",
          "vae": "diffusion_pytorch_model", "text_encoder": "model", "safety_checker": "model"}


def write_diffusers_dir(root: str, variant: str = "base", seed: int = 0) -> str:
    """A tiny SD-1.5-layout directory; ``variant`` adds one quirk of real
    checkpoints."""
    rng = np.random.default_rng(seed)
    sds = {name: _state_dict(m, rng) for name, m in _modules().items()}
    configs = {"unet": dict(UNET_CFG), "gm_unet": dict(UNET_CFG, in_channels=8),
               "vae": dict(VAE_CFG), "text_encoder": dict(CLIP_CFG),
               "safety_checker": json.loads(json.dumps(CHECKER_CFG))}
    if variant == "legacy_vae":
        legacy = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}
        vae = {}
        for k, v in sds["vae"].items():
            for new, old in legacy.items():
                if f".attentions.0.{new}." in k:
                    k = k.replace(new, old)
                    v = v[:, :, None, None] if v.ndim == 2 else v
            vae[k] = v
        sds["vae"] = vae
    if variant == "position_ids":
        sds["text_encoder"]["text_model.embeddings.position_ids"] = np.arange(77)[None]
        sds["safety_checker"]["vision_model.vision_model.embeddings.position_ids"] = \
            np.arange(17)[None]
    if variant == "num_heads":
        configs["unet"].update(num_attention_heads=4, attention_head_dim=8)
    if variant == "head_dim_list":
        configs["gm_unet"]["attention_head_dim"] = [5, 10]
    for name, sd in sds.items():
        sub = os.path.join(root, name)
        os.makedirs(sub)
        with open(os.path.join(sub, "config.json"), "w") as f:
            json.dump(configs[name], f)
        path = os.path.join(sub, _FILES[name])
        if variant == "bf16" and name in ("text_encoder", "safety_checker"):
            st_save_torch({k: torch.from_numpy(v).to(torch.bfloat16) for k, v in sd.items()},
                          path + ".safetensors")
        elif variant == "fp16_only" and name == "vae":
            st_save({k: v.astype(np.float16) for k, v in sd.items()}, path + ".fp16.safetensors")
        else:
            st_save(sd, path + ".safetensors")
        if variant == "variants" and name == "unet":
            st_save({k: v.astype(np.float16) for k, v in sd.items()}, path + ".fp16.safetensors")
            st_save({k: v + np.float32(1) for k, v in sd.items()}, path + ".non_ema.safetensors")
            st_save({k: v - np.float32(1) for k, v in sd.items()}, path + ".bf16.safetensors")
    save_tokenizer(os.path.join(root, "tokenizer"), CLIPTokenizer.tiny())
    with open(os.path.join(root, "tokenizer", "special_tokens_map.json"), "w") as f:
        json.dump({"bos_token": "<|startoftext|>"}, f)
    os.makedirs(os.path.join(root, "scheduler"))
    with open(os.path.join(root, "scheduler", "scheduler_config.json"), "w") as f:
        json.dump(PNDM_CFG, f)
    index = {"_class_name": "StableDiffusionPipeline", "_diffusers_version": "0.6.0",
             **{n: ["diffusers", "x"] for n in sds}, "tokenizer": ["transformers", "CLIPTokenizer"],
             "scheduler": ["diffusers", "PNDMScheduler"]}
    with open(os.path.join(root, "model_index.json"), "w") as f:
        json.dump(index, f)
    return root


# ---------------------------------------------------------------------------
# comparison
# ---------------------------------------------------------------------------


def _json(path):
    with open(path) as f:
        return json.load(f)


def _assert_same_tensors(got: dict, want: dict, what: str):
    assert sorted(got) == sorted(want), what
    for k in want:
        g, w = got[k], want[k]
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), (what, k)


def _run(capsys, fn, src, dst):
    """``fn(src, dst)``'s printed lines, ``dst`` written as DST."""
    capsys.readouterr()
    fn(src, dst)
    return capsys.readouterr().out.replace(dst, "DST").splitlines()


def _assert_same_pipeline_dirs(got: str, want: str, checker_counts=None):
    """Two pipeline directories hold the same files. ``checker_counts``:
    the safety checker's (num_concepts, num_special_concepts) in ``got``,
    where ``want`` (the JAX tool's) holds SD-1.5's 17 and 3."""
    index = _json(os.path.join(want, "model_index.json"))
    assert _json(os.path.join(got, "model_index.json")) == index
    for name in index["components"]:
        if name == "tokenizer":
            for fn in ("vocab.json", "merges.txt"):
                with open(os.path.join(got, name, fn)) as g, open(os.path.join(want, name, fn)) as w:
                    assert g.read() == w.read(), fn
            continue
        g, w = (_json(os.path.join(d, name, "config.json")) for d in (got, want))
        if name == "safety_checker" and checker_counts is not None:
            # The JAX tool's _vision_config leaves the concept counts at
            # diffusers' 17 and 3 whatever the tensors hold
            # (scripts/tools/convert_torch_checkpoint.py:122-138); the port
            # reads them from the tensors.
            assert (w.pop("num_concepts"), w.pop("num_special_concepts")) == (17, 3)
            assert (g.pop("num_concepts"), g.pop("num_special_concepts")) == checker_counts
        assert g == w, name
        if name != "scheduler":
            _assert_same_tensors(st_load(os.path.join(got, name, "params.safetensors")),
                                 st_load(os.path.join(want, name, "params.safetensors")), name)


TINY_COUNTS = (TINY_VISION_CONFIG.num_concepts, TINY_VISION_CONFIG.num_special_concepts)
VARIANTS = ["base", "legacy_vae", "position_ids", "bf16", "fp16_only", "variants", "num_heads",
            "head_dim_list"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_import_matches_jax_tool(tmp_path, capsys, variant):
    """The port's ``import`` writes the JAX tool's directory and prints its
    lines, over each quirk: legacy VAE attention names with 4-D weights,
    ``position_ids`` buffers, a BF16 file, only a ``.fp16.`` file, a plain
    file beside ``.fp16.``, ``.bf16.`` and ``.non_ema.`` ones,
    ``num_attention_heads`` beside an int ``attention_head_dim``, and a
    list ``attention_head_dim``."""
    src = write_diffusers_dir(str(tmp_path / "src"), variant)
    want_lines = _run(capsys, JAX_TOOL.do_import, src, str(tmp_path / "jax"))
    got_lines = _run(capsys, PORT_TOOL.do_import, src, str(tmp_path / "port"))
    assert got_lines == want_lines
    _assert_same_pipeline_dirs(str(tmp_path / "port"), str(tmp_path / "jax"), TINY_COUNTS)
    port = str(tmp_path / "port")
    unet_cfg = _json(os.path.join(port, "unet", "config.json"))
    dtypes = {n: {v.dtype for v in st_load(os.path.join(port, n, "params.safetensors")).values()}
              for n in ("vae", "text_encoder", "unet")}
    assert dtypes["vae"] == {np.dtype(np.float16 if variant == "fp16_only" else np.float32)}
    assert dtypes["text_encoder"] == {np.dtype(np.float32)}
    assert unet_cfg["num_attention_heads"] == (4 if variant == "num_heads" else 2)
    if variant == "head_dim_list":
        assert _json(os.path.join(port, "gm_unet", "config.json"))["num_attention_heads"] == 8
    if variant == "variants":
        plain = st_load(os.path.join(src, "unet", "diffusion_pytorch_model.safetensors"))
        got = st_load(os.path.join(port, "unet", "params.safetensors"))
        assert np.array_equal(got["conv_in/bias"], plain["conv_in.bias"])


def _scheduler_case(root: str, case: str) -> str:
    extras = {
        "DDIMScheduler": dict(clip_sample=False, set_alpha_to_one=False, prediction_type="v_prediction"),
        "DDPMScheduler": dict(variance_type="fixed_small", clip_sample=True),
        "DPMSolverMultistepScheduler": dict(algorithm_type="dpmsolver++", solver_order=2,
                                            solver_type="midpoint", lower_order_final=True,
                                            use_karras_sigmas=True, timestep_spacing="trailing",
                                            thresholding=False),
        "LCMScheduler": dict(original_inference_steps=50, timestep_scaling=10.0,
                             timestep_spacing="leading"),
        "PNDMScheduler": {}, "EulerDiscreteScheduler": dict(interpolation_type="linear"),
    }
    os.makedirs(os.path.join(root, "scheduler"), exist_ok=True)
    if case != "missing":
        cls = "PNDMScheduler" if case == "config.json" else case
        cfg = dict(PNDM_CFG, _class_name=cls, **extras[cls])
        fn = "config.json" if case == "config.json" else "scheduler_config.json"
        with open(os.path.join(root, "scheduler", fn), "w") as f:
            json.dump(cfg, f)
    return root


@pytest.mark.parametrize("case", ["PNDMScheduler", "DDIMScheduler", "DDPMScheduler",
                                  "DPMSolverMultistepScheduler", "LCMScheduler",
                                  "EulerDiscreteScheduler", "config.json", "missing"])
def test_scheduler_import_matches_jax_tool(tmp_path, capsys, case):
    """Each of the five scheduler classes, an unknown one (PNDM on the base
    fields), a ``config.json`` in place of ``scheduler_config.json`` and no
    config at all: the same scheduler config and printed lines."""
    import gmdx.io.pipeline as jax_pipeline

    src = _scheduler_case(str(tmp_path / "src"), case)
    capsys.readouterr()
    jax_pipeline.save_scheduler(str(tmp_path / "jax"), JAX_TOOL._import_scheduler(src))
    want_lines = capsys.readouterr().out
    save_scheduler(str(tmp_path / "port"), PORT_TOOL._import_scheduler(src))
    assert capsys.readouterr().out == want_lines
    got, want = (_json(str(tmp_path / d / "config.json")) for d in ("port", "jax"))
    assert got == want
    assert {f.name for f in dataclasses.fields(JaxSchedulerConfig)} <= set(got)


# ---------------------------------------------------------------------------
# export, round trip, keys, dtypes
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_imported(tmp_path_factory):
    """The JAX tool's import of the base directory, with a tiny ControlNet
    component added (no exporter in either tool)."""
    root = tmp_path_factory.mktemp("exp")
    src = write_diffusers_dir(str(root / "src"), "base")
    JAX_TOOL.do_import(src, str(root / "pipe"))
    torch.manual_seed(0)
    save_component(str(root / "pipe" / "controlnet"), ControlNetModel(TINY_CONTROLNET_CONFIG))
    index = _json(str(root / "pipe" / "model_index.json"))
    index["components"] = sorted(index["components"] + ["controlnet"])
    with open(root / "pipe" / "model_index.json", "w") as f:
        json.dump(index, f)
    return str(root / "pipe")


def test_export_matches_jax_tool(jax_imported, tmp_path, capsys, monkeypatch):
    """The port's ``export`` writes the JAX tool's diffusers files (read
    back with ``safetensors``) and prints its lines; it never loads a
    component onto a device (the card would hold float32 trees in
    bfloat16)."""
    import gmdx_torch.io.pipeline as port_pipeline

    want_lines = _run(capsys, JAX_TOOL.do_export, jax_imported, str(tmp_path / "jax"))

    def refuse(*a, **kw):
        raise AssertionError("export must read the stored trees, not load components")

    monkeypatch.setattr(port_pipeline, "load_component", refuse)
    monkeypatch.setattr(port_pipeline, "load_pipeline", refuse)
    got_lines = _run(capsys, PORT_TOOL.do_export, jax_imported, str(tmp_path / "port"))
    assert got_lines == want_lines
    assert "controlnet: no exporter, skipped" in got_lines
    got, want = str(tmp_path / "port"), str(tmp_path / "jax")
    assert _json(os.path.join(got, "model_index.json")) == _json(os.path.join(want, "model_index.json"))
    files = sorted(os.path.relpath(os.path.join(r, f), want) for r, _, fs in os.walk(want) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(r, f), got)
                           for r, _, fs in os.walk(got) for f in fs)
    for rel in files:
        a, b = os.path.join(got, rel), os.path.join(want, rel)
        if rel.endswith(".safetensors"):
            _assert_same_tensors(st_load(a), st_load(b), rel)
        elif rel.endswith(".json"):
            assert _json(a) == _json(b), rel
        else:
            with open(a) as f, open(b) as g:
                assert f.read() == g.read(), rel
    unet = st_load(os.path.join(got, "unet", "diffusion_pytorch_model.safetensors"))
    assert {v.dtype for v in unet.values()} == {np.dtype(np.float32)}


def test_export_then_import_is_identity(tmp_path, capsys):
    """The port's own import, exported and imported again, comes back bit
    for bit, configs (the checker's concept counts included) and all."""
    src = write_diffusers_dir(str(tmp_path / "src"), "position_ids")
    first, diff, back = (str(tmp_path / d) for d in ("first", "diff", "back"))
    PORT_TOOL.do_import(src, first)
    PORT_TOOL.do_export(first, diff)
    PORT_TOOL.do_import(diff, back)
    _assert_same_pipeline_dirs(back, first)
    cfg = _json(os.path.join(back, "safety_checker", "config.json"))
    assert (cfg["num_concepts"], cfg["num_special_concepts"]) == TINY_COUNTS


@pytest.mark.parametrize("name", ["unet", "vae", "text_encoder", "safety_checker"])
def test_unknown_key_raises_naming_it(tmp_path, name):
    """An unknown key raises ``KeyError`` naming it, in the converter and
    through the tool; so does a missing one."""
    convert, config = {
        "unet": (torch_import.convert_unet_state_dict, TINY_UNET_CONFIG),
        "vae": (torch_import.convert_vae_state_dict, TINY_VAE_CONFIG),
        "text_encoder": (torch_import.convert_clip_text_state_dict, TINY_CLIP_CONFIG),
        "safety_checker": (torch_import.convert_safety_checker_state_dict, TINY_VISION_CONFIG),
    }[name]
    sd = _state_dict(_modules()[name], np.random.default_rng(1))
    convert(sd, config)
    with pytest.raises(KeyError, match="lora_extra.weight"):
        convert(dict(sd, **{"lora_extra.weight": np.zeros(2, np.float32)}), config)
    with pytest.raises(KeyError, match="lacks 1 keys"):
        convert({k: v for k, v in sd.items() if k != sorted(sd)[0]}, config)
    src = write_diffusers_dir(str(tmp_path / "src"))
    path = os.path.join(src, name, _FILES[name] + ".safetensors")
    st_save(dict(st_load(path), **{"lora_extra.weight": np.zeros(2, np.float32)}), path)
    with pytest.raises(KeyError, match="lora_extra.weight"):
        PORT_TOOL.do_import(src, str(tmp_path / "out"))


@pytest.mark.parametrize("ext", [".pth", ".bin", ".safetensors"])
def test_load_torch_checkpoint_matches_jax(tmp_path, ext):
    """``.pth`` / ``.bin`` (a nested ``state_dict``, float32 out) and
    ``.safetensors`` (BF16 upcast, F16 kept) read as gmdx reads them."""
    gen = torch.Generator().manual_seed(0)
    sd = {"a.weight": torch.randn(3, 4, generator=gen).half(),
          "b.bias": torch.randn(5, generator=gen).to(torch.bfloat16),
          "c": torch.randn(2, 2, generator=gen)}
    path = str(tmp_path / f"ckpt{ext}")
    if ext == ".safetensors":
        st_save_torch(sd, path)
    else:
        torch.save({"state_dict": sd}, path)
    got, want = torch_import.load_torch_checkpoint(path), jax_load_torch_checkpoint(path)
    _assert_same_tensors(got, {k: np.asarray(v) for k, v in want.items()}, ext)
    if ext == ".safetensors":
        assert got["a.weight"].dtype == np.float16 and got["b.bias"].dtype == np.float32


def test_card_machine_tool_reads_no_safetensors_package(tmp_path, monkeypatch):
    """The tool runs where ``safetensors`` and ``ml_dtypes`` are absent."""
    import sys

    src = write_diffusers_dir(str(tmp_path / "src"), "bf16")
    for mod in ("safetensors", "safetensors.numpy", "safetensors.torch", "ml_dtypes"):
        monkeypatch.setitem(sys.modules, mod, None)
    PORT_TOOL.do_import(src, str(tmp_path / "pipe"))
    PORT_TOOL.do_export(str(tmp_path / "pipe"), str(tmp_path / "diff"))
    shutil.rmtree(tmp_path / "src")
