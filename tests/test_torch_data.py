"""The port's data modules == colddiff's, on files the tests write.

``ImageFolderDataset`` (all five transforms), the MNIST and CIFAR-10
parsers, ``get_dataset`` over the CelebA, Flowers, LSUN, MNIST and CIFAR
layouts, the CLI's ``make_dataset``, and ``create_data``'s PNG trees.
Each dataset draws from its own ``np.random.default_rng(seed)`` in the JAX
order, so the arrays are equal.  Where the JAX path goes through its native
crop helper (``aug1``, ``center``, uint8 ``cifar`` arrays), so does the
port's; these cases are held at 1e-6 here and bitwise in
``tests/test_torch_native.py``.  Also ``rgb2hsv``/``hsv2rgb`` against the
JAX copies at 1e-6.
"""

import argparse
import gzip
import importlib
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from colddiff.data import create_data as jcreate
from colddiff.data import datasets as jdatasets
from colddiff.ops import image as jimage
from colddiff_torch.cli import main as pcli
from colddiff_torch.data import create_data as pcreate
from colddiff_torch.data import datasets
from colddiff_torch.ops import image

# the packages export functions of these modules' names
jcli = importlib.import_module("colddiff.cli.main")
jget = importlib.import_module("colddiff.data.get_dataset")
pget = importlib.import_module("colddiff_torch.data.get_dataset")

NATIVE_ATOL = 1e-6


def _assert_same(got, want, atol=0.0):
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    if atol:
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    else:
        np.testing.assert_array_equal(got, want)


def _rand_png(path, h, w, mode="RGB", seed=0):
    rng = np.random.default_rng(seed)
    c = {"RGB": 3, "L": 1, "RGBA": 4}[mode]
    arr = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr[..., 0] if c == 1 else arr, mode).save(path)


@pytest.fixture
def folder(tmp_path):
    f = tmp_path / "imgs"
    for i, (h, w, mode) in enumerate([(40, 52, "RGB"), (33, 33, "L"), (64, 48, "RGB"),
                                      (20, 30, "RGBA"), (50, 50, "RGB")]):
        _rand_png(f / ("sub" if i % 2 else "") / f"im{i}.png", h, w, mode, seed=i)
    return f


@pytest.mark.parametrize("aug,atol", [("aug1", NATIVE_ATOL), ("center", NATIVE_ATOL),
                                      ("center_pad", 0.0), ("random_aug", 0.0),
                                      ("cifar", 0.0)])
def test_image_folder_transforms_equal_jax(folder, aug, atol):
    size = 16 if aug != "center_pad" else 20
    want = jdatasets.ImageFolderDataset(str(folder), size, aug=aug, seed=3)
    got = datasets.ImageFolderDataset(str(folder), size, aug=aug, seed=3)
    assert len(got) == len(want) == 5
    for _ in range(3):  # later passes take later draws of the one rng
        for i in range(len(want)):
            _assert_same(got[i], want[i], atol)


def test_unknown_transform_raises(folder):
    ds = datasets.ImageFolderDataset(str(folder), 16, aug="nope")
    with pytest.raises(ValueError, match="unknown aug"):
        ds[0]


def _write_idx(path, imgs=None, labels=None):
    if imgs is not None:
        n = imgs.shape[0]
        data = ((2051).to_bytes(4, "big") + n.to_bytes(4, "big") + (28).to_bytes(4, "big")
                + (28).to_bytes(4, "big") + imgs.tobytes())
    else:
        data = ((2049).to_bytes(4, "big") + len(labels).to_bytes(4, "big")
                + bytes(int(v) for v in labels))
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.suffix == ".gz":
        with gzip.open(path, "wb") as f:
            f.write(data)
    else:
        path.write_bytes(data)


def _mnist_raw(root, layout="flat", gz=False):
    """MNIST idx files: 6 train, 3 test images with labels."""
    rng = np.random.default_rng(0)
    base = root / "MNIST" / "raw" if layout == "torchvision" else root
    ext = ".gz" if gz else ""
    _write_idx(base / f"train-images-idx3-ubyte{ext}",
               rng.integers(0, 256, (6, 28, 28), dtype=np.uint8))
    _write_idx(base / f"train-labels-idx1-ubyte{ext}", labels=[0, 1, 2, 0, 1, 2])
    _write_idx(base / f"t10k-images-idx3-ubyte{ext}",
               rng.integers(0, 256, (3, 28, 28), dtype=np.uint8))
    _write_idx(base / f"t10k-labels-idx1-ubyte{ext}", labels=[5, 6, 7])
    return root


def _cifar_raw(root, sub=True):
    rng = np.random.default_rng(1)
    base = root / "cifar-10-batches-py" if sub else root
    base.mkdir(parents=True, exist_ok=True)
    for i in range(1, 6):
        batch = {b"data": rng.integers(0, 256, (2, 3072), dtype=np.uint8),
                 b"labels": [i % 10, (i + 1) % 10]}
        (base / f"data_batch_{i}").write_bytes(pickle.dumps(batch))
    (base / "test_batch").write_bytes(pickle.dumps(
        {b"data": rng.integers(0, 256, (4, 3072), dtype=np.uint8), b"labels": [0, 1, 2, 3]}))
    return root


@pytest.mark.parametrize("layout,gz", [("flat", False), ("flat", True),
                                       ("torchvision", True)])
def test_load_mnist_idx_equals_jax(tmp_path, layout, gz):
    root = str(_mnist_raw(tmp_path, layout, gz))
    for train in (True, False):
        got = datasets.load_mnist_idx(root, train=train)
        want = jdatasets.load_mnist_idx(root, train=train)
        assert got.dtype == np.uint8 and got.shape == (6 if train else 3, 28, 28, 1)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(FileNotFoundError):
        datasets.load_mnist_idx(str(tmp_path / "none"))


@pytest.mark.parametrize("sub", [True, False])
def test_load_cifar10_batches_equals_jax(tmp_path, sub):
    root = str(_cifar_raw(tmp_path, sub))
    for train in (True, False):
        got = datasets.load_cifar10_batches(root, train=train)
        want = jdatasets.load_cifar10_batches(root, train=train)
        assert got.dtype == np.uint8 and got.shape == (10 if train else 4, 32, 32, 3)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(FileNotFoundError):
        datasets.load_cifar10_batches(str(tmp_path / "none"))


def _celeba(root):
    base = root / "celeba"
    names = [f"{i:06d}.jpg" for i in range(1, 7)]
    for i, n in enumerate(names):
        _rand_png(base / "img_align_celeba" / n, 60 + 20 * i, 50 + 25 * i, seed=10 + i)
    (base / "list_eval_partition.txt").write_text(
        "".join(f"{n} {p}\n" for n, p in zip(names, [0, 0, 0, 1, 2, 2])))
    return root


def _flowers(root):
    from scipy.io import savemat

    base = root / "flowers-102"
    for i in range(1, 9):
        _rand_png(base / "jpg" / f"image_{i:05d}.jpg", 80 + 3 * i, 100, seed=20 + i)
    savemat(str(base / "setid.mat"), {"trnid": np.array([[1, 2, 3]]),
                                      "valid": np.array([[4, 5]]),
                                      "tstid": np.array([[6, 7, 8]])})
    return root


def _lsun(root):
    for split in ("train", "val"):
        for i in range(3):
            _rand_png(root / f"church_outdoor_{split}" / f"{i}.png", 70, 90 + i, seed=30 + i)
    return root


LAYOUTS = {"celeba": _celeba, "flower": _flowers, "lsun_church": _lsun,
           "mnist": _mnist_raw, "cifar10": _cifar_raw}
# (name, image_size, random_aug, atol): 64 px takes CelebA's crop-128 path,
# 150 px its zero-padding centre crop; uint8 CIFAR crops go through the
# JAX native helper
NAMED = [("CelebA_train", 32, False, 0.0), ("CelebA_test", 64, False, 0.0),
         ("CelebA_train", 150, False, 0.0), ("CelebA_train", 24, True, 0.0),
         ("flower_train", 32, False, 0.0), ("flower_test", 40, True, 0.0),
         ("lsun_church_train", 48, False, 0.0), ("lsun_church_val", 32, True, 0.0),
         ("mnist_train", 28, False, 0.0), ("mnist_test", 28, False, 0.0),
         ("cifar10_train", 32, False, NATIVE_ATOL), ("cifar10_test", 32, False, 0.0)]


@pytest.mark.parametrize("name,size,random_aug,atol", NAMED)
def test_get_dataset_equals_jax(tmp_path, name, size, random_aug, atol):
    layout = next(v for k, v in LAYOUTS.items() if name.lower().startswith(k.lower()))
    root = str(layout(tmp_path))
    want = jget.get_dataset(name, root, size, random_aug=random_aug, seed=4)
    got = pget.get_dataset(name, root, size, random_aug=random_aug, seed=4)
    assert type(got).__name__ == type(want).__name__ and len(got) == len(want) > 0
    for _ in range(2):
        for i in range(len(want)):
            _assert_same(got[i], want[i], atol)


def test_named_dataset_errors_equal_jax(tmp_path):
    for mod in (jget, pget):
        with pytest.raises(ValueError, match="unknown dataset name"):
            mod.get_dataset("imagenet_train", str(tmp_path), 32)
        for cls in (mod.CelebADataset, mod.Flowers102Dataset, mod.LSUNChurchDataset):
            with pytest.raises(FileNotFoundError):
                cls(str(tmp_path / "missing"), split="train")


@pytest.mark.parametrize("dataset,train", [
    ("synthetic", True), ("folder", True), ("folder", False), ("mnist", True),
    ("cifar10", True), ("cifar10", False), ("celeba", True), ("celeba", False),
    ("flowers", True), ("lsun_church", False)])
def test_make_dataset_equals_jax(tmp_path, folder, dataset, train):
    """The CLI's dataset builder, as ``main`` calls it (random_aug off)."""
    root = {"folder": lambda p: folder, "synthetic": lambda p: p,
            "celeba": _celeba, "flowers": _flowers, "lsun_church": _lsun,
            "mnist": _mnist_raw, "cifar10": _cifar_raw}[dataset](tmp_path)
    args = argparse.Namespace(dataset=dataset, data_path=str(root), seed=2, random_aug=False)
    size = {"mnist": 28, "cifar10": 32}.get(dataset, 16)
    want = jcli.make_dataset(args, size, train=train)
    got = pcli.make_dataset(args, size, train=train)
    assert len(got) == len(want) > 0
    native = dataset == "folder" or (dataset == "cifar10" and train)
    for i in range(min(len(want), 6)):
        _assert_same(got[i], want[i], NATIVE_ATOL if native else 0.0)


def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("kind", ["mnist", "cifar10", "celeba"])
def test_create_data_trees_equal_jax(tmp_path, kind):
    if kind == "mnist":
        raw = _mnist_raw(tmp_path / "raw", gz=True)
    elif kind == "cifar10":
        raw = _cifar_raw(tmp_path / "raw")
    else:
        raw = tmp_path / "raw"
        for i in range(10):
            _rand_png(raw / ("a" if i % 3 else "") / f"{i:03d}.png", 8, 8, seed=i)
    jcreate.main([kind, "--raw", str(raw), "--out", str(tmp_path / "jax")])
    pcreate.main([kind, "--raw", str(raw), "--out", str(tmp_path / "port")])
    want, got = _tree(tmp_path / "jax"), _tree(tmp_path / "port")
    assert got.keys() == want.keys() and len(got) > 0
    assert all(got[k] == want[k] for k in want)


def test_rgb2hsv_and_back_equal_jax():
    import torch

    rng = np.random.default_rng(0)
    x = rng.random((2, 9, 7, 3)).astype(np.float32)
    # gray pixels (delta 0) and each channel as the max, ties included
    x[0, 0, :3] = 0.5
    x[0, 1, 0] = [0.9, 0.2, 0.2]
    x[0, 1, 1] = [0.2, 0.9, 0.2]
    x[0, 1, 2] = [0.2, 0.2, 0.9]
    x[0, 1, 3] = [0.9, 0.9, 0.1]
    x[0, 1, 4] = [0.0, 0.0, 0.0]
    hsv = image.rgb2hsv(torch.from_numpy(x))
    jhsv = np.asarray(jimage.rgb2hsv(jnp.asarray(x)))
    np.testing.assert_allclose(hsv.numpy(), jhsv, rtol=0, atol=1e-6)
    back = image.hsv2rgb(hsv)
    np.testing.assert_allclose(back.numpy(), np.asarray(jimage.hsv2rgb(jnp.asarray(jhsv))),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=1e-5)
    # differentiable, as the JAX copy
    xt = torch.from_numpy(x[1:]).requires_grad_()
    image.hsv2rgb(image.rgb2hsv(xt)).sum().backward()
    assert torch.isfinite(xt.grad).all()
