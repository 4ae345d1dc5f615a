"""The port's data pipeline against PIL, pyarrow and the JAX package on the
CPU: PIL's BILINEAR resize to the bit, the paired transforms draw for draw,
the parquet reader against pyarrow over its writer's codecs, encodings,
page versions and row groups, the port's writer read by pyarrow and by
``gmdx.data``, the batch loader against gmdx's PIL path batch for batch,
and the device prefetcher's order, errors and early exit."""

import io
import itertools
import os
import struct
import subprocess
import sys
import time
import zlib

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch
from PIL import Image

from gmdx.data import ParquetImageDataset as JaxDataset
from gmdx.data import make_dataloader as jax_make_dataloader
from gmdx.data.transforms import preprocess_pair as jax_preprocess_pair
from gmdx.models.tokenizer import CLIPTokenizer as JaxTokenizer
from gmdx_torch.data import (
    ParquetImageDataset,
    device_prefetch,
    make_dataloader,
    preprocess_pair,
    read_parquet,
    write_parquet,
    write_parquet_dataset,
)
from gmdx_torch.data.parquet_format import _DATA_PAGE, _DATA_PAGE_V2, _Thrift, _footer
from gmdx_torch.io.png import decode_png, resize_bilinear
from gmdx_torch.models import CLIPTokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Intra-op threads oversubscribe the cores of a parallel test run;
    restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _png(arr: np.ndarray, mode: str | None = None) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, format="PNG")
    return buf.getvalue()


# ---------------------------------------------------------------------------
# PIL's BILINEAR and the paired transforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("src,dst", [((600, 800), (512, 683)), ((37, 23), (80, 51)),
                                     ((512, 700), (512, 700)), ((512, 683), (512, 512)),
                                     ((33, 31), (7, 5)), ((64, 64), (65, 63))])
@pytest.mark.parametrize("channels", [1, 3])
def test_bilinear_resize_matches_pil(src, dst, channels):
    """Down, up and unchanged sizes, odd sizes, grey and RGB."""
    rng = np.random.default_rng(sum(src) + channels)
    a = rng.integers(0, 256, src + (channels,)).astype(np.uint8)
    im = Image.fromarray(a[:, :, 0] if channels == 1 else a)
    want = np.asarray(im.resize(dst[::-1], Image.BILINEAR))
    got = resize_bilinear(a, *dst)
    np.testing.assert_array_equal(got[:, :, 0] if channels == 1 else got, want)


@pytest.mark.parametrize("kind", ["grey", "rgba", "rgb16", "palette"])
def test_bilinear_resize_of_decoded_sources_matches_pil(kind):
    """Grey, RGBA, 16-bit and palette PNGs through the port's decoder and
    resize against PIL's ``convert("RGB")`` then ``resize(BILINEAR)``."""
    rng = np.random.default_rng(5)
    h, w = 45, 67
    if kind == "grey":
        data = _png(rng.integers(0, 256, (h, w)).astype(np.uint8), "L")
    elif kind == "rgba":
        data = _png(rng.integers(0, 256, (h, w, 4)).astype(np.uint8), "RGBA")
    elif kind == "palette":
        im = Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8)).quantize(200)
        buf = io.BytesIO()
        im.save(buf, format="PNG")
        data = buf.getvalue()
    else:
        px = rng.integers(0, 65536, (h, w, 3)).astype(">u2")
        rows = b"".join(b"\0" + px[y].tobytes() for y in range(h))

        def chunk(k, body):
            return struct.pack(">I", len(body)) + k + body + struct.pack(
                ">I", zlib.crc32(k + body) & 0xFFFFFFFF)

        header = struct.pack(">IIBBBBB", w, h, 16, 2, 0, 0, 0)
        data = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB").resize((40, 27),
                                                                         Image.BILINEAR))
    np.testing.assert_array_equal(resize_bilinear(decode_png(data), 27, 40), want)


@pytest.mark.parametrize("center_crop,random_flip", [(True, False), (False, False),
                                                     (False, True), (True, True)])
def test_preprocess_pair_matches_jax(center_crop, random_flip):
    """Center and random crops, with and without the flip: the same arrays
    as gmdx's, and the rng left in the same state (the same draws)."""
    rng = np.random.default_rng(11)
    for shape in ((70, 90), (90, 64), (64, 64)):
        sdr = rng.integers(0, 256, shape + (3,)).astype(np.uint8)
        gm = rng.integers(0, 256, shape + (3,)).astype(np.uint8)
        for seed in range(4):
            r_port, r_jax = np.random.default_rng(seed), np.random.default_rng(seed)
            got = preprocess_pair(sdr, gm, 64, center_crop=center_crop,
                                  random_flip=random_flip, rng=r_port)
            want = jax_preprocess_pair(Image.fromarray(sdr), Image.fromarray(gm), 64,
                                       center_crop=center_crop, random_flip=random_flip,
                                       rng=r_jax)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype == np.float32
                np.testing.assert_array_equal(g, w)
            assert r_port.random() == r_jax.random()


# ---------------------------------------------------------------------------
# parquet
# ---------------------------------------------------------------------------


def _table(n=23, seed=0, nulls=True):
    rng = np.random.default_rng(seed)
    texts = [f"caption {i} " + "x" * int(rng.integers(0, 50)) for i in range(n)]
    if nulls:
        texts[3] = None
    blobs = [rng.integers(0, 256, int(rng.integers(0, 2000))).astype(np.uint8).tobytes()
             for _ in range(n)]
    blobs[5] = b""
    return pa.table({"sdr": [f"/data/img_{i % 7}.png" for i in range(n)], "gainmap": blobs,
                     "text": texts, "n": list(range(n))})


@pytest.mark.parametrize("codec,dictionary,version,groups", list(itertools.product(
    ["NONE", "SNAPPY", "GZIP"], [True, False], ["1.0", "2.0"], [1, 3])))
def test_reader_matches_pyarrow(tmp_path, codec, dictionary, version, groups):
    table = _table()
    path = str(tmp_path / "t.parquet")
    pq.write_table(table, path, compression=codec, use_dictionary=dictionary,
                   data_page_version=version, row_group_size=-(-table.num_rows // groups))
    assert pq.ParquetFile(path).metadata.num_row_groups == groups
    want = pq.read_table(path, columns=["sdr", "gainmap", "text"]).to_pydict()
    assert read_parquet(path, ["sdr", "gainmap", "text"]) == want


def _page_encodings(path, column):
    """The (page type, value encoding) of every data page of ``column``."""
    with open(path, "rb") as f:
        data = memoryview(f.read())
    meta = _footer(data, path)
    names = [el[4].decode() for el in meta[2][1:]]
    out = []
    for rg in meta[4]:
        cm = rg[1][names.index(column)][3]
        pos, seen = min(cm[9], cm.get(11) or cm[9]), 0
        while seen < cm[5]:
            r = _Thrift(data, pos)
            h = r.struct()
            pos = r.pos + h[3]
            if h[1] == _DATA_PAGE:
                out.append(("v1", h[5][2]))
                seen += h[5][1]
            elif h[1] == _DATA_PAGE_V2:
                out.append(("v2", h[8][4]))
                seen += h[8][1]
    return out


@pytest.mark.parametrize("version", ["1.0", "2.0"])
def test_reader_takes_the_dictionary_to_plain_fallback(tmp_path, version):
    """Large gain-map blobs overflow the dictionary page: the chunk starts
    with dictionary-indexed pages and goes on in PLAIN ones (pyarrow checks
    the dictionary's size after each write batch)."""
    rng = np.random.default_rng(1)
    blobs = [rng.integers(0, 256, 300_000).astype(np.uint8).tobytes() for _ in range(10)]
    blobs += blobs[:4]
    n = len(blobs)
    path = str(tmp_path / "f.parquet")
    pq.write_table(pa.table({"sdr": [f"p{i}" for i in range(n)], "gainmap": blobs,
                             "text": ["t"] * n}), path, compression="SNAPPY",
                   dictionary_pagesize_limit=1 << 20, data_page_version=version,
                   write_batch_size=2, data_page_size=1 << 16)
    encodings = {e for _, e in _page_encodings(path, "gainmap")}
    assert encodings == {0, 8}, encodings  # PLAIN and RLE_DICTIONARY pages
    assert read_parquet(path)["gainmap"] == blobs


def test_writer_read_by_pyarrow_and_jax(tmp_path):
    rng = np.random.default_rng(2)
    paths, gms, texts = [], [], []
    for i in range(5):
        p = str(tmp_path / f"s{i}.png")
        Image.fromarray(rng.integers(0, 256, (40, 48, 3)).astype(np.uint8)).save(p)
        paths.append(p)
        gms.append(_png(rng.integers(0, 256, (40, 48, 3)).astype(np.uint8)))
        texts.append(f"caption {i} é")
    meta = str(tmp_path / "m.parquet")
    write_parquet_dataset(meta, paths, gms, texts)
    table = pq.read_table(meta)
    assert table.to_pydict() == {"sdr": paths, "gainmap": gms, "text": texts}
    assert str(table.schema.field("text").type) == "string"
    ds = JaxDataset(meta)
    assert len(ds) == 5 and ds[2] == {"sdr": paths[2], "gainmap": gms[2], "text": texts[2]}
    big = str(tmp_path / "big.parquet")  # several pages
    blobs = [rng.integers(0, 256, 400_000).astype(np.uint8).tobytes() for _ in range(6)]
    write_parquet(big, {"b": blobs})
    assert pq.read_table(big).column("b").to_pylist() == blobs
    assert len(_page_encodings(big, "b")) > 1


def test_reader_refusals_name_the_file(tmp_path):
    path = str(tmp_path / "z.parquet")
    pq.write_table(_table(nulls=False), path, compression="ZSTD")
    with pytest.raises(NotImplementedError, match=r"z\.parquet.*ZSTD"):
        read_parquet(path)
    nul = str(tmp_path / "nulls.parquet")
    pq.write_table(_table(), nul)
    with pytest.raises(ValueError, match=r"nulls\.parquet.*'text' has nulls"):
        ParquetImageDataset(nul)
    miss = str(tmp_path / "miss.parquet")
    pq.write_table(pa.table({"sdr": ["a"], "text": ["b"]}), miss)
    with pytest.raises(ValueError, match=r"miss\.parquet: parquet missing columns \['gainmap'\]; "
                                         r"has \['sdr', 'text'\]"):
        ParquetImageDataset(miss)


def test_jpeg_row_raises_naming_file_and_row(tmp_path):
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (32, 32, 3)).astype(np.uint8)
    jpg = str(tmp_path / "a.jpg")
    Image.fromarray(img).save(jpg, format="JPEG")
    meta = str(tmp_path / "j.parquet")
    write_parquet_dataset(meta, [jpg], [_png(img)], ["c"])
    with pytest.raises(NotImplementedError, match=r"a\.jpg is not a PNG"):
        ParquetImageDataset(meta).load_pair(0)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG")
    png = str(tmp_path / "a.png")
    Image.fromarray(img).save(png)
    write_parquet_dataset(meta, [png], [buf.getvalue()], ["c"])
    with pytest.raises(NotImplementedError, match=r"j\.parquet, row 0: the gain map"):
        ParquetImageDataset(meta).load_pair(0)


# ---------------------------------------------------------------------------
# the loader and the prefetcher
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(4)
    paths, gms, texts = [], [], []
    for i in range(7):
        h, w = (70, 90) if i % 2 else (90, 68)
        p = str(d / f"sdr_{i}.png")
        Image.fromarray(rng.integers(0, 255, (h, w, 3)).astype(np.uint8)).save(p)
        paths.append(p)
        gms.append(_png(rng.integers(0, 255, (h, w, 3)).astype(np.uint8)))
        texts.append(f"a photo number {i}")
    meta = str(d / "train.parquet")
    write_parquet_dataset(meta, paths, gms, texts)
    return meta


def test_dataloader_matches_jax_pil_path(dataset):
    """Two epochs of shuffled batches with random crops and flips, a
    resume skip and max_samples: the batches equal gmdx's PIL path's."""
    kw = dict(batch_size=2, resolution=64, random_flip=True, seed=3, num_epochs=2,
              num_workers=2, max_samples=6, skip_batches=1)
    got = list(make_dataloader(ParquetImageDataset(dataset), CLIPTokenizer.tiny(), **kw))
    want = list(jax_make_dataloader(JaxDataset(dataset), JaxTokenizer.tiny(), use_native=False,
                                    **kw))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_dataloader_forwards_producer_errors(dataset, tmp_path):
    ds = ParquetImageDataset(dataset)
    ds.rows["sdr"][2] = str(tmp_path / "missing.png")
    loader = make_dataloader(ds, CLIPTokenizer.tiny(), batch_size=7, resolution=64,
                             shuffle=False, num_epochs=1)
    with pytest.raises(FileNotFoundError, match="missing.png"):
        next(loader)


def test_device_prefetch_on_cpu():
    """Order kept, arrays become tensors, a loader error raised in the
    consumer, and the producer stops when the consumer leaves early."""
    batches = [{"x": np.full((2, 3), i, np.float32)} for i in range(5)]
    got = [b["x"] for b in device_prefetch(iter(batches), device="cpu", depth=2)]
    assert all(isinstance(t, torch.Tensor) and float(t[0, 0]) == i for i, t in enumerate(got))

    def failing():
        yield batches[0]
        raise OSError("disk gone")

    it = device_prefetch(failing(), device="cpu")
    assert float(next(it)["x"][0, 0]) == 0
    with pytest.raises(OSError, match="disk gone"):
        next(it)

    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield {"x": np.zeros(1, np.float32)}
            i += 1

    it = device_prefetch(endless(), device="cpu", depth=1)
    next(it)
    it.close()
    time.sleep(0.5)
    n = len(produced)
    time.sleep(0.3)
    assert len(produced) == n and n <= 4
    with pytest.raises(ValueError, match="depth"):
        device_prefetch(iter(batches), device="cpu", depth=0)


def test_data_and_train_import_without_pyarrow_or_pil():
    """As on the card's machine: ``gmdx_torch.data`` and ``gmdx_torch.train``
    import and read parquet with pyarrow and PIL unavailable."""
    code = ("import sys; sys.modules['pyarrow'] = sys.modules['PIL'] = None; "
            "import gmdx_torch.data, gmdx_torch.train; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'gmdx', 'PIL', "
            "'pyarrow', 'orbax') and sys.modules[m] is not None]; "
            "assert not bad, bad; print('ok')")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                       timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]
