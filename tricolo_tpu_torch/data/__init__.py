"""Host data pipeline and device-side batch preparation."""

from .datasets import GeneralDataset, SyntheticDataset, build_dataset
from .device_prep import normalize_images, unpack_windowed_rows
from .loader import BatchIterator, DataModule, collate

__all__ = [
    "GeneralDataset",
    "SyntheticDataset",
    "build_dataset",
    "BatchIterator",
    "DataModule",
    "collate",
    "normalize_images",
    "unpack_windowed_rows",
]
