"""Datasets and input pipeline (PIL + numpy + threads).

Copies of ``colddiff/data/datasets.py``, so the same seed gives the same
batches in the same order in both packages.  Transform parity with the
reference datasets:
  - ``aug1``:   Resize(1.12*S) -> RandomCrop(S) -> RandomHFlip
                (Dataset_Aug1, deblurring_diffusion_pytorch.py:983-1004)
  - ``center``: Resize(1.12*S) -> CenterCrop(S)
                (Dataset, deblurring_diffusion_pytorch.py:1006-1026)
  - ``cifar`` (``ArrayDataset``): pad 4 + RandomCrop(S) + RandomHFlip
                (Dataset_Cifar10, snowification diffusion.py:539-552)
Images are NHWC float32 in [-1, 1].

The crops and the uint8 -> [-1, 1] scaling are the JAX package's numpy
path, ``v / 255 * 2 - 1``.  (Its optional native helper computes
``v * (2 / 255) - 1``, which can differ in the last bit.)  The
``center_pad`` and ``random_aug`` transforms and the MNIST/CIFAR parsers
are not ported yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

__all__ = [
    "ImageFolderDataset",
    "ArrayDataset",
    "SyntheticDataset",
    "DataLoader",
]

_EXTS = ("jpg", "jpeg", "png", "JPG", "JPEG", "PNG")


def _to_tensor_range(img: np.ndarray) -> np.ndarray:
    return img.astype(np.float32) / 255.0 * 2.0 - 1.0


def _crop_flip_normalize(img: np.ndarray, y0: int, x0: int, size: int,
                         flip: bool) -> np.ndarray:
    crop = img[y0 : y0 + size, x0 : x0 + size]
    if flip:
        crop = crop[:, ::-1]
    return _to_tensor_range(crop)


class ImageFolderDataset:
    """Recursive image-folder dataset with reference-parity augmentation."""

    def __init__(self, folder: str, image_size: int, aug: str = "aug1", seed: int = 0):
        if aug not in ("aug1", "center"):
            raise NotImplementedError(
                f"aug '{aug}' is not ported to colddiff_torch yet (aug1, center are); "
                "see ROADMAP.md section 1, item 6")
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
        return _crop_flip_normalize(arr, y0, x0, s, flip)


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
            s = arr.shape[0]
            p = np.pad(arr, ((4, 4), (4, 4), (0, 0)), mode="constant")
            if arr.dtype == np.uint8:
                return _crop_flip_normalize(p, y0, x0, s, flip)
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


class DataLoader:
    """Background-thread prefetching loader yielding NHWC float32 batches.

    Replaces torch DataLoader(shuffle=True, pin_memory=True, num_workers=16)
    (deblurring_diffusion_pytorch.py:1115): worker threads decode/augment with
    PIL (which releases the GIL) while the GPU runs the previous step.  The
    batches are numpy arrays; the Trainer pins and copies them.
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
                out = futures.pop(0).result()
                futures.append(pool.submit(load, b))
                yield out
            for f in futures:
                yield f.result()
