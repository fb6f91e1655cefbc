"""Datasets and input pipeline (PIL + numpy + threads).

Copies of ``colddiff/data/datasets.py``, so the same seed gives the same
batches in the same order in both packages.  Transform parity with the
reference datasets:
  - ``aug1``:   Resize(1.12*S) -> RandomCrop(S) -> RandomHFlip
                (Dataset_Aug1, deblurring_diffusion_pytorch.py:983-1004)
  - ``center``: Resize(1.12*S) -> CenterCrop(S)
                (Dataset, deblurring_diffusion_pytorch.py:1006-1026)
  - ``center_pad``: CenterCrop(S) only (snowification diffusion.py:493-520)
  - ``random_aug``: RandomResizedCrop(S) + RandomHFlip + ColorJitter
                (snowification diffusion.py:505-516)
  - ``cifar``:  pad 4 + RandomCrop(S) + RandomHFlip
                (Dataset_Cifar10, snowification diffusion.py:539-552)
Images are NHWC float32 in [-1, 1].  Every random draw comes from the
dataset's own ``np.random.default_rng(seed)``, in the JAX order.

The ``aug1``/``center`` crops and the uint8 ``cifar`` arrays' pad-4 crops go
through :mod:`.native`, as the JAX loaders do: its C++ helper scales by
``v * (2/255) - 1``, and under ``COLDDIFF_NO_NATIVE`` its numpy path by
``v / 255 * 2 - 1``, like the rest of this module, so each path gives the
JAX loader's bits.  Raw MNIST (idx) and CIFAR-10 (pickle batches) parsers
read the standard downloads.
"""

from __future__ import annotations

import gzip
import pickle
from pathlib import Path
from typing import Optional

import numpy as np

from ..tracing import span
from . import native

__all__ = [
    "ImageFolderDataset",
    "ArrayDataset",
    "SyntheticDataset",
    "load_mnist_idx",
    "load_cifar10_batches",
    "DataLoader",
]

_EXTS = ("jpg", "jpeg", "png", "JPG", "JPEG", "PNG")


def _to_tensor_range(img: np.ndarray) -> np.ndarray:
    return img.astype(np.float32) / 255.0 * 2.0 - 1.0


class ImageFolderDataset:
    """Recursive image-folder dataset with reference-parity augmentation."""

    def __init__(self, folder: str, image_size: int, aug: str = "aug1", seed: int = 0):
        self.paths = sorted(
            p for ext in _EXTS for p in Path(folder).glob(f"**/*.{ext}")
        )
        if not self.paths:
            raise FileNotFoundError(f"no images under {folder}")
        self.image_size = image_size
        self.aug = aug
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, index: int) -> np.ndarray:
        from PIL import Image

        img = Image.open(self.paths[index])
        if img.mode not in ("RGB", "L"):
            img = img.convert("RGB")
        return self._transform(img)

    def _transform(self, img) -> np.ndarray:
        from PIL import Image

        s = self.image_size
        rng = self._rng
        if self.aug in ("aug1", "center"):
            big = int(s * 1.12)
            img = img.resize((big, big), Image.BILINEAR)
            if self.aug == "aug1":
                x0 = int(rng.integers(0, big - s + 1))
                y0 = int(rng.integers(0, big - s + 1))
                flip = rng.random() < 0.5
            else:
                x0 = y0 = (big - s) // 2
                flip = False
            arr = np.asarray(img)
            if arr.ndim == 2:
                arr = arr[..., None]
            return native.crop_flip_normalize(arr, y0, x0, s, flip)
        elif self.aug == "center_pad":
            w, h = img.size
            x0, y0 = (w - s) // 2, (h - s) // 2
            img = img.crop((x0, y0, x0 + s, y0 + s))
        elif self.aug == "random_aug":
            # SimCLR-style RandomResizedCrop + ColorJitter
            # (snowification diffusion.py:505-516)
            w, h = img.size
            for _ in range(10):
                area = rng.uniform(0.08, 1.0) * w * h
                ratio = np.exp(rng.uniform(np.log(3 / 4), np.log(4 / 3)))
                cw = int(round(np.sqrt(area * ratio)))
                ch = int(round(np.sqrt(area / ratio)))
                if cw <= w and ch <= h:
                    x0 = int(rng.integers(0, w - cw + 1))
                    y0 = int(rng.integers(0, h - ch + 1))
                    img = img.crop((x0, y0, x0 + cw, y0 + ch))
                    break
            img = img.resize((s, s), Image.BICUBIC)
            if rng.random() < 0.5:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
            if rng.random() < 0.8:
                from PIL import ImageEnhance

                for enh in (ImageEnhance.Brightness, ImageEnhance.Contrast,
                            ImageEnhance.Color):
                    img = enh(img).enhance(1.0 + rng.uniform(-0.4, 0.4))
        elif self.aug == "cifar":
            arr = np.asarray(img)
            arr = np.pad(arr, ((4, 4), (4, 4)) + ((0, 0),) * (arr.ndim - 2), mode="constant")
            x0 = int(rng.integers(0, 9))
            y0 = int(rng.integers(0, 9))
            arr = arr[y0 : y0 + s, x0 : x0 + s]
            if rng.random() < 0.5:
                arr = arr[:, ::-1]
            img = Image.fromarray(arr)
        else:
            raise ValueError(f"unknown aug: {self.aug}")
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[..., None]
        return _to_tensor_range(arr)


class ArrayDataset:
    """In-memory NHWC uint8/float array dataset with optional augmentation."""

    def __init__(self, images: np.ndarray, aug: Optional[str] = None, seed: int = 0):
        self.images = images
        self.aug = aug
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, index: int) -> np.ndarray:
        arr = self.images[index]
        if self.aug == "cifar":
            x0 = int(self._rng.integers(0, 9))
            y0 = int(self._rng.integers(0, 9))
            flip = self._rng.random() < 0.5
            if arr.dtype == np.uint8:
                return native.pad4_crop_flip_normalize(arr, y0, x0, flip)
            s = arr.shape[0]
            p = np.pad(arr, ((4, 4), (4, 4), (0, 0)), mode="constant")
            arr = p[y0 : y0 + s, x0 : x0 + s]
            if flip:
                arr = arr[:, ::-1].copy()
        elif arr.dtype == np.uint8:
            arr = _to_tensor_range(arr)
        return arr.astype(np.float32)


class SyntheticDataset:
    """Deterministic structured images (gaussian bumps + gradients) for tests
    and benchmarks -- no download needed."""

    def __init__(self, image_size: int, channels: int = 3, length: int = 256, seed: int = 0):
        self.image_size = image_size
        self.channels = channels
        self.length = length
        self.seed = seed

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, index: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 100003 + index)
        s, c = self.image_size, self.channels
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32) / s
        img = np.zeros((s, s, c), dtype=np.float32)
        for _ in range(3):
            cx, cy = rng.random(2)
            sig = 0.05 + 0.2 * rng.random()
            bump = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sig**2))
            col = rng.random(c).astype(np.float32)
            img += bump[..., None] * col
        img += 0.3 * (xx + yy)[..., None] * rng.random(c).astype(np.float32)
        img = img / max(img.max(), 1e-6)
        return img * 2.0 - 1.0


def load_mnist_idx(root: str, train: bool = True) -> np.ndarray:
    """Parse raw MNIST idx(.gz) files -> [N, 28, 28, 1] uint8."""
    name = "train-images-idx3-ubyte" if train else "t10k-images-idx3-ubyte"
    root_p = Path(root)
    for cand in (root_p / name, root_p / (name + ".gz"),
                 root_p / "MNIST" / "raw" / name, root_p / "MNIST" / "raw" / (name + ".gz")):
        if cand.exists():
            opener = gzip.open if cand.suffix == ".gz" else open
            with opener(cand, "rb") as f:
                data = f.read()
            n = int.from_bytes(data[4:8], "big")
            return np.frombuffer(data, dtype=np.uint8, offset=16).reshape(n, 28, 28, 1)
    raise FileNotFoundError(f"MNIST idx files not found under {root}")


def load_cifar10_batches(root: str, train: bool = True) -> np.ndarray:
    """Parse CIFAR-10 python pickle batches -> [N, 32, 32, 3] uint8."""
    base = Path(root)
    for sub in ("cifar-10-batches-py", "."):
        d = base / sub
        names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
        if all((d / n).exists() for n in names):
            parts = []
            for n in names:
                with open(d / n, "rb") as f:
                    batch = pickle.load(f, encoding="bytes")
                parts.append(batch[b"data"])
            data = np.concatenate(parts).reshape(-1, 3, 32, 32)
            return np.transpose(data, (0, 2, 3, 1)).copy()
    raise FileNotFoundError(f"CIFAR-10 batches not found under {root}")


class DataLoader:
    """Background-thread prefetching loader yielding NHWC float32 batches.

    Replaces torch DataLoader(shuffle=True, pin_memory=True, num_workers=16)
    (deblurring_diffusion_pytorch.py:1115): worker threads decode/augment with
    PIL (which releases the GIL) while the GPU runs the previous step.  The
    batches are numpy arrays; the Trainer pins and copies them.

    ``skip`` passes over that many batches of the stream, without loading
    them, before the first one it yields: a loader with the seed of a run
    and ``skip = n`` continues that run's stream after its n-th batch.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        num_workers: int = 4,
        seed: int = 0,
        drop_last: bool = True,
        prefetch: int = 4,
        process_index: int = 0,
        process_count: int = 1,
        skip: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch
        # multi-process input sharding: each process reads a disjoint stripe
        self.process_index = process_index
        self.process_count = process_count
        self._epoch_rng = np.random.default_rng(seed)
        self._skip = skip

    def __len__(self) -> int:
        n = len(self.dataset) // self.process_count
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self) -> list[np.ndarray]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            self._epoch_rng.shuffle(idx)
        if self.process_count > 1:
            idx = idx[self.process_index :: self.process_count]
        stop = (len(idx) // self.batch_size) * self.batch_size if self.drop_last else len(idx)
        return [idx[i : i + self.batch_size] for i in range(0, stop, self.batch_size)]

    def __iter__(self):
        from concurrent.futures import ThreadPoolExecutor

        batches = self._batches()
        while self._skip and batches:
            n = min(self._skip, len(batches))
            self._skip -= n
            batches = batches[n:] or self._batches()
        if not batches:
            return
        with ThreadPoolExecutor(max_workers=self.num_workers) as pool:

            def load(batch_idx):
                return np.stack([self.dataset[int(i)] for i in batch_idx])

            futures = []
            it = iter(batches)
            for _ in range(min(self.prefetch, len(batches))):
                futures.append(pool.submit(load, next(it)))
            for b in it:
                with span("loader.queue"):  # the wait on the oldest prefetched batch
                    out = futures.pop(0).result()
                futures.append(pool.submit(load, b))
                yield out
            for f in futures:
                with span("loader.queue"):
                    out = f.result()
                yield out
