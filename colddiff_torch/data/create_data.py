"""One-off dataset preparation tool (torchvision-free), a copy of
``colddiff/data/create_data.py``.

Mirrors the reference root-level create_data.py:26-110: dump MNIST / CIFAR-10
into per-class (train) and per-split PNG folder trees, and 90/10-split a
CelebA-HQ image folder -- producing the directory layouts the entry scripts'
--data_path flags expect.

Usage:
  python -m colddiff_torch.data.create_data mnist  --raw ./raw --out ./root_mnist
  python -m colddiff_torch.data.create_data cifar10 --raw ./raw --out ./root_cifar10
  python -m colddiff_torch.data.create_data celeba --raw ./celeba_hq_128 --out ./root_celebA
"""

from __future__ import annotations

import argparse
import gzip
import pickle
from pathlib import Path

import numpy as np


def _save_png(arr: np.ndarray, path: Path) -> None:
    from PIL import Image

    path.parent.mkdir(parents=True, exist_ok=True)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    Image.fromarray(arr).save(path)


def _mnist_labels(root: Path, train: bool) -> np.ndarray:
    name = "train-labels-idx1-ubyte" if train else "t10k-labels-idx1-ubyte"
    for cand in (root / name, root / (name + ".gz"),
                 root / "MNIST" / "raw" / name, root / "MNIST" / "raw" / (name + ".gz")):
        if cand.exists():
            opener = gzip.open if cand.suffix == ".gz" else open
            with opener(cand, "rb") as f:
                data = f.read()
            return np.frombuffer(data, dtype=np.uint8, offset=8)
    raise FileNotFoundError(f"MNIST label files not found under {root}")


def dump_mnist(raw: str, out: str) -> None:
    from .datasets import load_mnist_idx

    outp = Path(out)
    for split, train in [("train", True), ("test", False)]:
        imgs = load_mnist_idx(raw, train=train)
        labels = _mnist_labels(Path(raw), train)
        for i, (img, y) in enumerate(zip(imgs, labels)):
            if split == "train":
                _save_png(img, outp / split / str(int(y)) / f"{i}.png")
            else:
                _save_png(img, outp / split / f"{i}.png")


def _cifar_labels(raw: Path, train: bool) -> np.ndarray:
    base = raw / "cifar-10-batches-py" if (raw / "cifar-10-batches-py").exists() else raw
    names = [f"data_batch_{i}" for i in range(1, 6)] if train else ["test_batch"]
    labels = []
    for n in names:
        with open(base / n, "rb") as f:
            batch = pickle.load(f, encoding="bytes")
        labels.extend(batch[b"labels"])
    return np.asarray(labels)


def dump_cifar10(raw: str, out: str) -> None:
    from .datasets import load_cifar10_batches

    outp = Path(out)
    for split, train in [("train", True), ("test", False)]:
        imgs = load_cifar10_batches(raw, train=train)
        labels = _cifar_labels(Path(raw), train)
        for i, (img, y) in enumerate(zip(imgs, labels)):
            if split == "train":
                _save_png(img, outp / split / str(int(y)) / f"{i}.png")
            else:
                _save_png(img, outp / split / f"{i}.png")


def split_celeba(raw: str, out: str, train_frac: float = 0.9) -> None:
    import shutil

    paths = sorted(
        p for ext in ("jpg", "jpeg", "png") for p in Path(raw).glob(f"**/*.{ext}")
    )
    n_train = int(len(paths) * train_frac)
    outp = Path(out)
    for i, p in enumerate(paths):
        split = "train" if i < n_train else "test"
        dst = outp / split / p.name
        dst.parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(p, dst)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("dataset", choices=["mnist", "cifar10", "celeba"])
    ap.add_argument("--raw", required=True, help="raw download dir / image folder")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    if args.dataset == "mnist":
        dump_mnist(args.raw, args.out)
    elif args.dataset == "cifar10":
        dump_cifar10(args.raw, args.out)
    else:
        split_celeba(args.raw, args.out)


if __name__ == "__main__":
    main()
