"""The port's I/O against the JAX package, PIL and ``safetensors`` on the CPU:
safetensors files, pipeline directories, the PNG codec, the BICUBIC resize
and ``to_model_input``.

Weights must cross between the packages bit for bit both ways; a
``scripts/tools/init_pipeline.py --size tiny --dual`` directory, with each
scheduler, loads into the port, whose UNet, VAE and CLIP text encoder then
match gmdx's at >= 100 dB; PNG decode and the resize must equal PIL's exactly.
"""

import dataclasses
import io
import json
import os
import struct
import zlib

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from PIL import Image
from safetensors.numpy import load_file as st_load_file
from safetensors.numpy import save_file as st_save_file

import gmdx.io.pipeline as jax_pipeline
from gmdx.data.transforms import to_model_range as jax_to_model_range
from gmdx.io import from_model_output as jax_from_model_output
from gmdx.io import to_model_input as jax_to_model_input
from gmdx.io.params import save_params as jax_save_params
from gmdx.schedulers import SCHEDULERS as JAX_SCHEDULERS
from gmdx_torch.io import image as port_image
from gmdx_torch.io import pipeline as port_pipeline
from gmdx_torch.io.params import flatten_tree, load_file, load_params, save_file, save_params
from gmdx_torch.io.png import decode_png, encode_png, read_png, resize_bicubic, write_png
from gmdx_torch.schedulers import SCHEDULERS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PSNR_MIN_DB = 100.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny models gain nothing from intra-op threads, and under a
    parallel test run they oversubscribe the cores; restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def psnr(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    peak = max(np.abs(a).max(), np.abs(b).max(), 1e-9)
    mse = float(np.mean((a - b) ** 2))
    return float("inf") if mse == 0.0 else 10.0 * np.log10(peak**2 / mse)


# ---------------------------------------------------------------------------
# safetensors
# ---------------------------------------------------------------------------


def _tree(rng):
    return {"a": {"kernel": rng.standard_normal((3, 4, 5)).astype(np.float32),
                  "bias": rng.standard_normal(5).astype(np.float16)},
            "b": {"c": {"idx": np.arange(7, dtype=np.int64)}},
            "count": np.array(3, np.int32)}


def _assert_same_flat(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w), k


def test_safetensors_cross_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    tree = _tree(rng)
    jax_save_params(str(tmp_path / "j.safetensors"), tree)
    _assert_same_flat(flatten_tree(load_params(str(tmp_path / "j.safetensors"))),
                      flatten_tree(tree))
    save_params(str(tmp_path / "p.safetensors"), tree)
    _assert_same_flat(st_load_file(str(tmp_path / "p.safetensors")), flatten_tree(tree))
    save_file({"w": torch.ones(2, 2)}, str(tmp_path / "t.safetensors"))
    _assert_same_flat(st_load_file(str(tmp_path / "t.safetensors")),
                      {"w": np.ones((2, 2), np.float32)})
    st_save_file(flatten_tree(tree), str(tmp_path / "m.safetensors"), metadata={"k": "v"})
    _assert_same_flat(load_file(str(tmp_path / "m.safetensors")), flatten_tree(tree))


def test_safetensors_reader_dtypes(tmp_path):
    """F16, I32, I64 and BF16 (read into torch.bfloat16) from files the
    safetensors package writes; any other dtype (F64, F8) raises naming the
    key."""
    path = str(tmp_path / "d.safetensors")
    want = {"f16": np.linspace(0, 1, 6, dtype=np.float16).reshape(2, 3),
            "i32": np.arange(5, dtype=np.int32), "i64": np.arange(-3, 3, dtype=np.int64)}
    st_save_file(want, path)
    _assert_same_flat(load_file(path), want)
    st_save_file({"f64": np.linspace(0, 1, 6)}, path)
    with pytest.raises(ValueError, match="'f64'"):
        load_file(path)
    from safetensors.torch import save_file as st_torch_save

    bf = torch.randn(3, 4).to(torch.bfloat16)
    st_torch_save({"bf": bf}, path)
    got = load_file(path)["bf"]
    assert got.dtype == torch.bfloat16 and torch.equal(got, bf)
    header = json.dumps({"odd": {"dtype": "F8_E4M3", "shape": [2], "data_offsets": [0, 2]}})
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(header)) + header.encode() + b"\0\0")
    with pytest.raises(ValueError, match="'odd'"):
        load_file(path)
    with pytest.raises(ValueError, match="not writable"):
        save_file({"x": np.zeros(2, np.uint16)}, path)


# ---------------------------------------------------------------------------
# pipeline directories
# ---------------------------------------------------------------------------


def _random_params(shapes, rng):
    def leaf(path, sd):
        name = path[-1].key
        x = rng.standard_normal(sd.shape).astype(np.float32)
        if name in ("kernel", "embedding"):
            return x * np.float32(np.prod(sd.shape[:-1]) ** -0.5)
        return 1.0 + 0.1 * x if name == "scale" else 0.05 * x
    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    """A ``--size tiny --dual`` directory as ``scripts/tools/init_pipeline.py``
    writes it (its modules, configs, tiny tokenizer, PNDM, through
    ``gmdx.io.pipeline.save_pipeline``), with seeded numpy weights in place
    of its jitted inits, which alone take ~45 s on the CPU."""
    from gmdx.models import (
        TINY_CLIP_CONFIG, TINY_UNET_CONFIG, TINY_VAE_CONFIG, AutoencoderKL, CLIPTextModel,
        CLIPTokenizer, UNet2DConditionModel,
    )

    out = str(tmp_path_factory.mktemp("pipe") / "tiny")
    rng = np.random.default_rng(7)
    key, ctx = jax.random.key(0), jnp.zeros((1, 77, 32))
    unet = UNet2DConditionModel(TINY_UNET_CONFIG)
    gm_unet = UNet2DConditionModel(dataclasses.replace(TINY_UNET_CONFIG, in_channels=8))
    vae, text = AutoencoderKL(TINY_VAE_CONFIG), CLIPTextModel(TINY_CLIP_CONFIG)
    shapes = {
        "unet": (unet, jax.eval_shape(unet.init, key, jnp.zeros((1, 4, 8, 8)), jnp.array(1.0),
                                      ctx)),
        "gm_unet": (gm_unet, jax.eval_shape(gm_unet.init, key, jnp.zeros((1, 8, 8, 8)),
                                            jnp.array(1.0), ctx)),
        "vae": (vae, jax.eval_shape(vae.init, key, jnp.zeros((1, 3, 32, 32)),
                                    jax.random.key(1))),
        "text_encoder": (text, jax.eval_shape(text.init, key, jnp.zeros((1, 77), jnp.int32))),
    }
    components = {k: (m, _random_params(v["params"], rng)) for k, (m, v) in shapes.items()}
    jax_pipeline.save_pipeline(out, components=components, tokenizer=CLIPTokenizer.tiny(),
                               scheduler=JAX_SCHEDULERS["pndm"]())
    return out, jax_pipeline.load_pipeline(out)


_SCHEDULER_CASES = {
    "pndm": {}, "ddpm": {}, "ddim": dict(set_alpha_to_one=True, clip_sample=True),
    "dpm++": dict(use_karras_sigmas=True, solver_order=1), "lcm": dict(original_inference_steps=40),
}


@pytest.mark.parametrize("name", sorted(_SCHEDULER_CASES))
def test_jax_scheduler_configs_load(tmp_path, name):
    """Each scheduler's config.json as the JAX package writes it loads into
    the port's scheduler of that class with the same settings and tables;
    the port writes the same file back."""
    sched = JAX_SCHEDULERS[name](**_SCHEDULER_CASES[name])
    jax_pipeline.save_scheduler(str(tmp_path / "j"), sched)
    ours = port_pipeline.load_scheduler(str(tmp_path / "j"))
    assert type(ours) is SCHEDULERS[name]
    assert dataclasses.asdict(ours.config) == dataclasses.asdict(sched.config)
    np.testing.assert_allclose(ours.alphas_cumprod, np.asarray(sched.alphas_cumprod), rtol=1e-5)
    port_pipeline.save_scheduler(str(tmp_path / "p"), ours)
    with open(tmp_path / "j" / "config.json") as f, open(tmp_path / "p" / "config.json") as g:
        assert json.load(f) == json.load(g)
    back = jax_pipeline.load_scheduler(str(tmp_path / "p"))
    assert type(back) is type(sched) and back.config == sched.config


def test_jax_directory_loads_and_matches(jax_dir):
    """UNet, GM UNet, VAE and CLIP of the JAX directory in the port: the
    same outputs as gmdx on the same inputs (fp32)."""
    path, bundle = jax_dir
    ours = port_pipeline.load_pipeline(path, device="cpu")
    assert sorted(ours["modules"]) == sorted(bundle["modules"])
    assert type(ours["scheduler"]).__name__ == type(bundle["scheduler"]).__name__
    assert np.array_equal(ours["tokenizer"]("a photo")["input_ids"],
                          bundle["tokenizer"]("a photo")["input_ids"])
    mods, params = bundle["modules"], bundle["params"]
    rng = np.random.default_rng(1)
    ctx = rng.standard_normal((1, 77, 32)).astype(np.float32)
    t = torch.from_numpy
    vae = mods["vae"]
    with jax.default_matmul_precision("highest"), torch.no_grad():
        x = rng.standard_normal((1, 8, 8, 8)).astype(np.float32)
        want = jax.jit(mods["gm_unet"].apply)({"params": params["gm_unet"]}, jnp.asarray(x),
                                              jnp.array(501), jnp.asarray(ctx))
        got = ours["modules"]["gm_unet"](t(x), 501, t(ctx))
        assert psnr(got.numpy(), np.asarray(want)) >= PSNR_MIN_DB
        z = rng.standard_normal((1, 4, 8, 8)).astype(np.float32)
        want = jax.jit(lambda p, z: vae.apply({"params": p}, z, method=vae.decode))(
            params["vae"], jnp.asarray(z))
        assert psnr(ours["modules"]["vae"].decode(t(z)).numpy(), np.asarray(want)) >= PSNR_MIN_DB
        ids = np.asarray(bundle["tokenizer"](["a bright hdr photo"])["input_ids"])
        want = jax.jit(mods["text_encoder"].apply)({"params": params["text_encoder"]},
                                                   jnp.asarray(ids))
        got = ours["modules"]["text_encoder"](torch.as_tensor(ids, dtype=torch.long))
        assert psnr(got.numpy(), np.asarray(want)) >= PSNR_MIN_DB


def test_port_directory_loads_in_jax(jax_dir, tmp_path):
    """The port writes back what it read: gmdx loads identical trees, the
    same configs, tokenizer and scheduler."""
    path, bundle = jax_dir
    ours = port_pipeline.load_pipeline(path, device="cpu")
    out = str(tmp_path / "port")
    port_pipeline.save_pipeline(out, components=ours["modules"], tokenizer=ours["tokenizer"],
                                scheduler=ours["scheduler"])
    back = jax_pipeline.load_pipeline(out)
    assert sorted(back["params"]) == sorted(bundle["params"])
    for name in bundle["params"]:
        _assert_same_flat(flatten_tree(back["params"][name]), flatten_tree(bundle["params"][name]))
        assert back["modules"][name].config == bundle["modules"][name].config
    assert back["tokenizer"].encoder == bundle["tokenizer"].encoder
    assert back["scheduler"].config == bundle["scheduler"].config


def test_controlnet_component_round_trip(tmp_path):
    from gmdx_torch.models import TINY_CONTROLNET_CONFIG, ControlNetModel

    torch.manual_seed(0)
    cnet = ControlNetModel(TINY_CONTROLNET_CONFIG).eval()
    with torch.no_grad():
        for p in cnet.parameters():
            p.normal_()
    port_pipeline.save_component(str(tmp_path / "controlnet"), cnet)
    module, params = jax_pipeline.load_component(str(tmp_path / "controlnet"))
    assert module.config.unet == dataclasses.replace(module.config.unet)
    back = port_pipeline.load_component(str(tmp_path / "controlnet"), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(cnet.state_dict().values(),
                                                 back.state_dict().values()))
    assert "cond_embedding" in params and "controlnet_mid" in params


def test_unknown_and_unported_components_raise(tmp_path):
    d = tmp_path / "sc"
    d.mkdir()
    (d / "config.json").write_text(json.dumps({"_class_name": "StableDiffusionSafetyChecker"}))
    with pytest.raises(NotImplementedError, match="Queue 1 item 10"):
        port_pipeline.load_component(str(d), device="cpu")
    (d / "config.json").write_text(json.dumps({"_class_name": "Nope"}))
    with pytest.raises(ValueError, match="unknown component"):
        port_pipeline.load_component(str(d), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no card"):
            port_pipeline.load_component(str(d))


# ---------------------------------------------------------------------------
# PNG and resize
# ---------------------------------------------------------------------------


def _smooth(rng, h, w, c):
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(x / 7 + k) * 60 + np.cos(y / 11) * 50 + 128 for k in range(c)], -1)
    return np.clip(base + rng.integers(-20, 20, (h, w, c)), 0, 255).astype(np.uint8)


def _filters(data: bytes) -> set:
    """The scanline filter types a PNG's rows use."""
    pos, idat, hdr = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        hdr = struct.unpack(">IIBBBBB", body) if kind == b"IHDR" else hdr
        idat += body if kind == b"IDAT" else b""
        pos += 12 + n
    w, h, depth, color = hdr[:4]
    stride = 1 + w * {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color] * depth // 8
    raw = zlib.decompress(idat)
    return {raw[i * stride] for i in range(h)}


def _pil_png(arr, mode):
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, "PNG")
    return buf.getvalue()


def _filtered_rows(px: np.ndarray, depth: int, row_filters) -> np.ndarray:
    """The scanlines of ``px`` (H, W, C; uint8, or uint16 at depth 16), row y
    filtered by ``row_filters[y]`` (0-4) and led by its filter byte."""
    h, w = px.shape[:2]
    rows = np.ascontiguousarray(px.astype(">u2") if depth == 16 else px).view(np.uint8)
    rows = rows.reshape(h, -1).astype(np.int64)
    bpp = rows.shape[1] // w
    left = np.pad(rows, ((0, 0), (bpp, 0)))[:, :-bpp]
    up = np.pad(rows, ((1, 0), (0, 0)))[:-1]
    ul = np.pad(left, ((1, 0), (0, 0)))[:-1]
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, ul))
    preds = [np.zeros_like(rows), left, up, (left + up) >> 1, paeth]
    f = np.asarray(row_filters)[:, None]
    body = (rows - np.choose(np.broadcast_to(f, rows.shape), preds)) & 0xFF
    return np.concatenate([f, body], axis=1).astype(np.uint8)


_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _png_with_filters(px: np.ndarray, color: int, depth: int, row_filters,
                      interlace: bool = False) -> bytes:
    """A PNG of ``px`` encoded from the known pixels, row y of each pass
    filtered by ``row_filters[y]``; with ``interlace`` as Adam7's seven
    passes."""
    h, w = px.shape[:2]
    if interlace:
        raw = b"".join(_filtered_rows(px[y0::dy, x0::dx], depth, row_filters[:len(
            range(y0, h, dy))]).tobytes() for x0, y0, dx, dy in _ADAM7 if x0 < w and y0 < h)
    else:
        raw = _filtered_rows(px, depth, row_filters).tobytes()

    def chunk(kind, data):
        return struct.pack(">I", len(data)) + kind + data + struct.pack(
            ">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_png_decode_matches_pil():
    """Files PIL writes (grey, grey + alpha, RGB, RGBA, palette with
    transparency; its adaptive filters choose None, Sub, Up and Paeth),
    and files whose rows cycle through all five filters (PIL never picks
    Average): the decode equals PIL's ``convert("RGB")``."""
    rng = np.random.default_rng(2)
    files = []
    for mode, c in (("L", 1), ("LA", 2), ("RGB", 3), ("RGBA", 4)):
        a = _smooth(rng, 37, 53, c)
        files.append(_pil_png(a[..., 0] if c == 1 else a, mode))
    files.append(_pil_png(_smooth(rng, 64, 48, 3), "RGB"))
    pal = Image.fromarray(_smooth(rng, 40, 30, 3)).convert("P", palette=Image.ADAPTIVE)
    buf = io.BytesIO()
    pal.save(buf, "PNG", transparency=3)
    files.append(buf.getvalue())
    pil_filters = set().union(*(_filters(d) for d in files))
    assert {0, 1, 2, 4} <= pil_filters
    for color, c in ((0, 1), (2, 3), (4, 2), (6, 4)):
        files.append(_png_with_filters(_smooth(rng, 25, 19, c), color, 8, np.arange(25) % 5))
    assert set().union(*(_filters(d) for d in files)) == {0, 1, 2, 3, 4}
    for data in files:
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(decode_png(data), want)


def test_png_16bit_keeps_high_byte():
    """16-bit RGB and RGBA, every filter, read as PIL reads them: the high
    byte of each sample."""
    rng = np.random.default_rng(3)
    for color, ch in ((2, 3), (6, 4)):
        px = rng.integers(0, 65536, (11, 9, ch)).astype(np.uint16)
        data = _png_with_filters(px, color, 16, np.arange(11) % 5)
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(decode_png(data), want)
        np.testing.assert_array_equal(decode_png(data), (px[..., :3] >> 8).astype(np.uint8))


@pytest.mark.parametrize("h,w", [(21, 34), (5, 3), (1, 9)])
def test_png_adam7_matches_pil(h, w):
    """Adam7-interlaced files (every colour type, 16-bit RGB, every filter;
    images small enough that some passes are empty) decode as PIL's."""
    rng = np.random.default_rng(7)
    for color, c, depth in ((0, 1, 8), (2, 3, 8), (4, 2, 8), (6, 4, 8), (2, 3, 16)):
        px = (rng.integers(0, 65536, (h, w, c)).astype(np.uint16) if depth == 16
              else _smooth(rng, h, w, c))
        data = _png_with_filters(px, color, depth, np.arange(h) % 5, interlace=True)
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
        np.testing.assert_array_equal(decode_png(data), want)


def test_png_writer_read_by_pil(tmp_path):
    rng = np.random.default_rng(4)
    a = _smooth(rng, 21, 34, 3)
    path = str(tmp_path / "x.png")
    write_png(path, a)
    np.testing.assert_array_equal(np.asarray(Image.open(path)), a)
    np.testing.assert_array_equal(read_png(path), a)
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a" + bytes(20))
    data = bytearray(encode_png(a))
    data[8 + 8 + 12] = 2  # IHDR's interlace byte: no such method
    with pytest.raises(ValueError, match="interlace"):
        decode_png(bytes(data))


@pytest.mark.parametrize("src,dst", [((480, 640), (512, 512)), ((200, 300), (512, 512)),
                                     ((1024, 1024), (512, 512)), ((97, 333), (64, 201))],
                         ids=lambda s: "x".join(map(str, s)))
def test_bicubic_resize_matches_pil(src, dst):
    rng = np.random.default_rng(5)
    a = _smooth(rng, src[0], src[1], 3)
    want = np.asarray(Image.fromarray(a).resize((dst[1], dst[0]), Image.BICUBIC))
    np.testing.assert_array_equal(resize_bicubic(a, *dst), want)


def test_image_helpers_match_jax(tmp_path):
    from gmdx.io import load_image as jax_load_image

    rng = np.random.default_rng(6)
    path = str(tmp_path / "in.png")
    Image.fromarray(_smooth(rng, 48, 64, 3)).save(path)
    np.testing.assert_array_equal(port_image.load_image(path, size=(32, 40)),
                                  jax_load_image(path, size=(32, 40)))
    np.testing.assert_array_equal(port_image.load_image(path), jax_load_image(path))
    for x in (_smooth(rng, 5, 6, 3), rng.uniform(0, 1, (5, 6, 3)).astype(np.float32),
              np.full((5, 6, 3), 1, np.uint8), rng.uniform(0, 1, (2, 5, 6, 3))):
        np.testing.assert_array_equal(port_image.to_model_input(x), jax_to_model_input(x))
        if x.ndim == 3:
            np.testing.assert_array_equal(port_image.to_model_range(x), jax_to_model_range(x))
    y = rng.uniform(-1.5, 1.5, (2, 3, 4, 5)).astype(np.float32)
    np.testing.assert_array_equal(port_image.from_model_output(y), jax_from_model_output(y))
    out = rng.uniform(0, 1, (7, 9, 3)).astype(np.float32)
    port_image.save_image(str(tmp_path / "o.png"), out)
    from gmdx.io import save_image as jax_save_image

    jax_save_image(str(tmp_path / "j.png"), out)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "o.png")),
                                  np.asarray(Image.open(tmp_path / "j.png")))
