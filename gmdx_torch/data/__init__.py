"""Host data pipeline of the port (counterpart of ``gmdx.data``): a parquet
reader and writer of its own (no pyarrow), PNG decode and PIL's BILINEAR
resize in numpy (no PIL), the paired transforms, a threaded batch loader
and a side-stream device prefetcher."""

from gmdx_torch.data.parquet import ParquetImageDataset, make_dataloader, write_parquet_dataset
from gmdx_torch.data.parquet_format import read_parquet, write_parquet
from gmdx_torch.data.prefetch import device_prefetch
from gmdx_torch.data.transforms import (
    crop_pair,
    paired_crop,
    preprocess_pair,
    resize_shorter_side,
    resized_dims,
    to_model_range,
)

__all__ = [
    "ParquetImageDataset",
    "make_dataloader",
    "write_parquet_dataset",
    "read_parquet",
    "write_parquet",
    "device_prefetch",
    "resized_dims",
    "resize_shorter_side",
    "paired_crop",
    "crop_pair",
    "to_model_range",
    "preprocess_pair",
]
