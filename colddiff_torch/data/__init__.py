"""Datasets, the named-dataset loaders and the threaded input pipeline
(numpy/PIL copies of ``colddiff.data``)."""

from .datasets import (  # noqa: F401
    ArrayDataset,
    DataLoader,
    ImageFolderDataset,
    SyntheticDataset,
    load_cifar10_batches,
    load_mnist_idx,
)
from .get_dataset import (  # noqa: F401
    CelebADataset,
    Flowers102Dataset,
    LSUNChurchDataset,
    get_dataset,
)

__all__ = ["ArrayDataset", "CelebADataset", "DataLoader", "Flowers102Dataset",
           "ImageFolderDataset", "LSUNChurchDataset", "SyntheticDataset", "get_dataset",
           "load_cifar10_batches", "load_mnist_idx"]
