"""Parquet dataset and threaded batch loader of Stage-2 training.

Counterpart of ``gmdx/data/parquet.py`` without pyarrow or PIL: columns
``sdr`` (image path on disk), ``gainmap`` (encoded image bytes) and ``text``
(caption), read by ``gmdx_torch.data.parquet_format``; images decoded by
``gmdx_torch.io.png`` (PNG only: any other format raises, naming the file
and the row) and transformed by ``gmdx_torch.data.transforms``. The batches
equal the JAX loader's on its PIL path (``use_native=False``), which its C++
path matches only up to resize rounding; the port has one decode path.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Sequence

import numpy as np

from gmdx_torch.data.parquet_format import read_parquet, write_parquet
from gmdx_torch.data.transforms import crop_pair, resize_shorter_side
from gmdx_torch.io.png import decode_png

_COLUMNS = ("sdr", "gainmap", "text")
_PNG = b"\x89PNG\r\n\x1a\n"


class ParquetImageDataset:
    """Random-access rows of one or more parquet files."""

    def __init__(self, data_files: str | Sequence[str]):
        if isinstance(data_files, str):
            data_files = [data_files]
        self.rows: dict[str, list] = {c: [] for c in _COLUMNS}
        self._source: list[tuple[str, int]] = []  # (file, row in it) of each row
        for f in data_files:
            table = read_parquet(f, _COLUMNS)
            for c in _COLUMNS:
                nulls = [i for i, v in enumerate(table[c]) if v is None]
                if nulls:
                    raise ValueError(f"{f}: column {c!r} has nulls (rows {nulls[:5]}); every "
                                     f"row needs an sdr path, gain-map bytes and a caption")
                self.rows[c].extend(table[c])
            self._source.extend((f, i) for i in range(len(table["sdr"])))

    def __len__(self) -> int:
        return len(self._source)

    def __getitem__(self, idx: int) -> dict:
        return {c: self.rows[c][idx] for c in _COLUMNS}

    def _decode(self, data: bytes, what: str, idx: int) -> np.ndarray:
        if data[:8] != _PNG:
            f, row = self._source[idx]
            raise NotImplementedError(
                f"{f}, row {row}: {what} is not a PNG; the port's loader decodes PNG only "
                f"(JPEG and other formats: ROADMAP Queue 1 item 5)")
        return decode_png(data, what)

    def load_pair(self, idx: int) -> tuple[np.ndarray, np.ndarray, str]:
        """(SDR, gain map) as uint8 RGB (H, W, 3), and the caption."""
        row = self[idx]
        with open(row["sdr"], "rb") as fh:
            sdr = self._decode(fh.read(), row["sdr"], idx)
        gm = self._decode(row["gainmap"], f"the gain map of {self._source[idx][0]} row "
                          f"{self._source[idx][1]}", idx)
        return sdr, gm, row["text"]


def make_dataloader(
    dataset: ParquetImageDataset,
    tokenizer,
    *,
    batch_size: int,
    resolution: int = 512,
    center_crop: bool = False,
    random_flip: bool = False,
    shuffle: bool = True,
    seed: int = 0,
    num_epochs: int | None = None,
    num_workers: int = 4,
    max_samples: int | None = None,
    skip_batches: int = 0,
    process_shard: bool = False,
    process_index: int | None = None,
    process_count: int | None = None,
) -> Iterator[dict[str, np.ndarray]]:
    """Batches ``pixel_values`` / ``gainmap_values`` (B, 3, R, R) float32 in
    [-1, 1] and ``input_ids`` / ``attention_mask`` (B, 77) int32, made on a
    producer thread ``max(2, num_workers)`` batches ahead, a batch's pairs
    decoded and resized by ``num_workers`` threads; the ragged last
    batch of an epoch is dropped. Epoch e's order is
    ``default_rng(seed + e)``'s shuffle; a batch's crop and flip draws come
    from ``default_rng((seed, epoch, start))``, so ``skip_batches`` (resume)
    skips batches without decoding them and the rest equal an uninterrupted
    run's. A producer error is raised in the consumer; the producer stops
    when the consumer closes the iterator or drops it.

    ``process_shard``: ``batch_size`` stays the global batch and process
    ``pi`` of ``pc`` (``process_index`` / ``process_count``, by default the
    rank and world size of ``gmdx_torch.dist``) decodes and yields only its
    rows ``[pi * local, (pi + 1) * local)`` of it; with ``pc > 1`` a batch's
    crop and flip draws come from ``default_rng((seed, epoch, start, pi))``
    (the JAX package's keys), and ``skip_batches`` counts global batches."""
    n = len(dataset) if max_samples is None else min(max_samples, len(dataset))
    if n < batch_size:
        raise ValueError(f"dataset ({n}) smaller than batch size ({batch_size})")
    pi, pc = 0, 1
    if process_shard:
        from gmdx_torch.dist.multihost import rank, world_size

        pi = rank() if process_index is None else process_index
        pc = world_size() if process_count is None else process_count
        if batch_size % pc:
            raise ValueError(
                f"process_shard needs process_count ({pc}) to divide the "
                f"global batch size ({batch_size})")
    local = batch_size // pc

    def decoded(idx: int):
        """Decode and resize one pair: no random draw, so it runs on the
        pool's threads (zlib and numpy release the interpreter lock)."""
        sdr, gm, text = dataset.load_pair(idx)
        return resize_shorter_side(sdr, resolution), resize_shorter_side(gm, resolution), text

    def sample(pair, rng: np.random.Generator) -> dict[str, np.ndarray]:
        sdr, gm, text = pair
        pv, gv = crop_pair(sdr, gm, resolution, center_crop=center_crop,
                           random_flip=random_flip, rng=rng)
        tok = tokenizer(text)
        return {"pixel_values": pv, "gainmap_values": gv,
                "input_ids": np.asarray(tok["input_ids"][0]),
                "attention_mask": np.asarray(tok["attention_mask"][0])}

    q: queue.Queue = queue.Queue(maxsize=max(2, num_workers))
    stop = threading.Event()

    def put(item) -> bool:
        """A put that gives up once the consumer has gone (the trainers
        break out of a loader that cycles for ever)."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer() -> None:
        pool = ThreadPoolExecutor(max(1, num_workers))
        try:
            remaining_skip = skip_batches
            epoch = 0
            while num_epochs is None or epoch < num_epochs:
                order = np.arange(n)
                if shuffle:
                    np.random.default_rng(seed + epoch).shuffle(order)
                for start in range(0, n - batch_size + 1, batch_size):
                    if remaining_skip > 0:
                        remaining_skip -= 1
                        continue
                    idxs = order[start:start + batch_size][pi * local:(pi + 1) * local]
                    pairs = pool.map(decoded, (int(i) for i in idxs))
                    # The draws, in sample order, as the JAX loader makes them.
                    rng = np.random.default_rng((seed, epoch, start, pi) if pc > 1
                                                else (seed, epoch, start))
                    items = [sample(pair, rng) for pair in pairs]
                    if not put({k: np.stack([it[k] for it in items]) for k in items[0]}):
                        return
                epoch += 1
        except BaseException as e:  # noqa: BLE001 -- raised in the consumer
            put(e)
        else:
            put(None)
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    threading.Thread(target=producer, daemon=True).start()

    def gen():
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()

    return gen()


def write_parquet_dataset(path: str, sdr_paths: list[str], gainmap_bytes: list[bytes],
                          texts: list[str]) -> None:
    """A Stage-2 metadata file (columns sdr, gainmap, text)."""
    write_parquet(path, {"sdr": list(sdr_paths), "gainmap": [bytes(b) for b in gainmap_bytes],
                         "text": list(texts)})


__all__ = ["ParquetImageDataset", "make_dataloader", "write_parquet_dataset"]
