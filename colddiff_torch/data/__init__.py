"""Datasets and the threaded input pipeline (numpy/PIL copies of
``colddiff.data``; the MNIST/CIFAR parsers and ``get_dataset`` are not
ported yet)."""

from .datasets import (  # noqa: F401
    ArrayDataset,
    DataLoader,
    ImageFolderDataset,
    SyntheticDataset,
)

__all__ = ["ArrayDataset", "DataLoader", "ImageFolderDataset", "SyntheticDataset"]
