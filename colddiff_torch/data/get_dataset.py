"""Named-dataset convenience loaders (torchvision-free equivalents).

Parity target: ``snowification/diffusion/get_dataset.py:4-56`` -- the
reference wires ``cifar10_train/test``, ``CelebA_train/test`` and
``flower_train/test`` through torchvision with the transform stack

    image_size 64:  CenterCrop(128) -> Resize(64)
    default:        [Resize(S) if resize] -> CenterCrop(S)
    random_aug:     RandomResizedCrop(S) -> HFlip -> ColorJitter(p=0.8)

and ``deblurring_diffusion_pytorch.py:1098-1108`` adds LSUN church_outdoor.
A copy of ``colddiff/data/get_dataset.py``: these loaders need no
torchvision; they parse the standard on-disk layouts directly (PIL + numpy +
scipy.io for setid.mat) and never download, and they raise
FileNotFoundError with the expected layout when the files are absent.  The
random_aug draws come from the dataset's own ``np.random.default_rng(seed)``
in the JAX order, so both packages give the same arrays.

All datasets yield NHWC float32 in [-1, 1].
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .datasets import ArrayDataset, _to_tensor_range, _EXTS

__all__ = [
    "CelebADataset",
    "Flowers102Dataset",
    "LSUNChurchDataset",
    "get_dataset",
]


def _center_crop(img, size):
    from PIL import Image

    w, h = img.size
    tw = th = size
    if w < tw or h < th:  # torchvision CenterCrop zero-pads small images
        arr = np.asarray(img)
        if arr.ndim == 2:
            arr = arr[..., None]
        py, px = max(th - h, 0), max(tw - w, 0)
        arr = np.pad(arr, ((py // 2, py - py // 2), (px // 2, px - px // 2),
                           (0, 0)))
        img = Image.fromarray(arr.squeeze(-1) if arr.shape[-1] == 1 else arr)
        w, h = img.size
    x0, y0 = (w - tw) // 2, (h - th) // 2
    return img.crop((x0, y0, x0 + tw, y0 + th))


class _RefTransformImages:
    """File-list dataset applying the reference get_transform stack."""

    def __init__(self, paths, image_size: int, random_aug: bool = False,
                 resize: bool = False, seed: int = 0):
        if not paths:
            raise FileNotFoundError("empty image list")
        self.paths = list(paths)
        self.image_size = image_size
        self.random_aug = random_aug
        self.resize = resize
        self._rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index: int) -> np.ndarray:
        from PIL import Image

        img = Image.open(self.paths[index])
        if img.mode != "RGB":
            img = img.convert("RGB")
        s = self.image_size
        rng = self._rng
        if s == 64:
            # get_dataset.py:7-12 -- CenterCrop(128) then Resize(64)
            img = _center_crop(img, 128).resize((64, 64), Image.BILINEAR)
        elif self.random_aug:
            # SimCLR-style stack, get_dataset.py:22-32
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
            img = img.resize((s, s), Image.BILINEAR)
            if rng.random() < 0.5:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
            if rng.random() < 0.8:
                from PIL import ImageEnhance

                for enh in (ImageEnhance.Brightness, ImageEnhance.Contrast,
                            ImageEnhance.Color):
                    img = enh(img).enhance(1.0 + rng.uniform(-0.4, 0.4))
        else:
            if self.resize:
                img = img.resize((s, s), Image.BILINEAR)
            img = _center_crop(img, s)
        return _to_tensor_range(np.asarray(img))


class CelebADataset(_RefTransformImages):
    """CelebA aligned faces from the standard on-disk layout.

    Expects ``<root>/[celeba/]img_align_celeba/*.jpg`` plus (optionally)
    ``list_eval_partition.txt`` for the train(0)/valid(1)/test(2) split --
    the files torchvision.datasets.CelebA manages (get_dataset.py:49-52).
    Without the partition file all images are used for any split.
    """

    _SPLITS = {"train": 0, "valid": 1, "test": 2, "all": None}

    def __init__(self, root: str, split: str = "train", image_size: int = 128,
                 random_aug: bool = False, seed: int = 0):
        base = None
        for cand in (Path(root) / "celeba", Path(root)):
            if (cand / "img_align_celeba").is_dir():
                base = cand
                break
        if base is None:
            raise FileNotFoundError(
                f"expected <root>/[celeba/]img_align_celeba under {root}")
        img_dir = base / "img_align_celeba"
        part_file = base / "list_eval_partition.txt"
        want = self._SPLITS[split]
        if want is not None and part_file.exists():
            paths = [
                img_dir / name
                for name, p in (ln.split() for ln in
                                part_file.read_text().splitlines() if ln)
                if int(p) == want
            ]
        else:
            paths = sorted(
                p for ext in _EXTS for p in img_dir.glob(f"*.{ext}"))
        super().__init__(paths, image_size, random_aug=random_aug, seed=seed)


class Flowers102Dataset(_RefTransformImages):
    """Oxford Flowers-102 from the standard layout: ``<root>/[flowers-102/]
    jpg/image_*.jpg`` + ``setid.mat`` (trnid/valid/tstid MATLAB 1-based ids),
    the files torchvision.datasets.Flowers102 manages (get_dataset.py:53-56).
    The reference passes resize=True for flowers."""

    _SPLIT_KEY = {"train": "trnid", "valid": "valid", "test": "tstid"}

    def __init__(self, root: str, split: str = "train", image_size: int = 128,
                 random_aug: bool = False, seed: int = 0):
        base = None
        for cand in (Path(root) / "flowers-102", Path(root)):
            if (cand / "jpg").is_dir():
                base = cand
                break
        if base is None:
            raise FileNotFoundError(
                f"expected <root>/[flowers-102/]jpg under {root}")
        setid = base / "setid.mat"
        if setid.exists():
            from scipy.io import loadmat

            ids = loadmat(str(setid))[self._SPLIT_KEY[split]].ravel()
            paths = [base / "jpg" / f"image_{i:05d}.jpg" for i in ids]
        else:
            paths = sorted((base / "jpg").glob("image_*.jpg"))
        super().__init__(paths, image_size, random_aug=random_aug,
                         resize=True, seed=seed)


class LSUNChurchDataset(_RefTransformImages):
    """LSUN church_outdoor as an exported image folder.

    The reference loads the lmdb archives through torchvision
    (deblurring_diffusion_pytorch.py:1098-1108 uses datasets.LSUN with
    classes=['church_outdoor_train']); this loader needs no lmdb and reads
    the common exported-PNG layout
    ``<root>/church_outdoor_<split>[_images]/**.{jpg,png,webp}`` instead
    (produced by the LSUN repo's data.py export tool).
    """

    def __init__(self, root: str, split: str = "train", image_size: int = 128,
                 random_aug: bool = False, seed: int = 0):
        exts = _EXTS + ("webp", "WEBP")
        paths = []
        cands = [Path(root) / f"church_outdoor_{split}",
                 Path(root) / f"church_outdoor_{split}_images"]
        if not any(Path(root).glob("church_outdoor_*")):
            cands.append(Path(root))  # root itself is the exported folder
        for cand in cands:
            if cand.is_dir():
                paths = sorted(
                    p for ext in exts for p in cand.glob(f"**/*.{ext}"))
                if paths:
                    break
        if not paths:
            raise FileNotFoundError(
                f"no exported LSUN church_outdoor_{split} images under "
                f"{root}; export the lmdb archive to PNGs first")
        super().__init__(paths, image_size, random_aug=random_aug, seed=seed)


def get_dataset(name: str, folder: str, image_size: int,
                random_aug: bool = False, seed: int = 0):
    """Reference-name dataset factory (get_dataset.py:43-56 + LSUN/MNIST).

    Names: ``cifar10_train/test``, ``CelebA_train/test``,
    ``flower_train/test``, ``lsun_church_train/val``, ``mnist_train/test``.
    """
    from .datasets import load_cifar10_batches, load_mnist_idx

    lname = name.lower()
    train = lname.endswith("train")
    split = "train" if train else ("val" if lname.endswith("val") else "test")
    if lname.startswith("cifar10"):
        return ArrayDataset(load_cifar10_batches(folder, train=train),
                            aug="cifar" if train else None, seed=seed)
    if lname.startswith("mnist"):
        return ArrayDataset(load_mnist_idx(folder, train=train), seed=seed)
    if lname.startswith("celeba"):
        return CelebADataset(folder, split=split, image_size=image_size,
                             random_aug=random_aug, seed=seed)
    if lname.startswith("flower"):
        return Flowers102Dataset(folder, split=split, image_size=image_size,
                                 random_aug=random_aug, seed=seed)
    if lname.startswith("lsun"):
        return LSUNChurchDataset(folder, split=split, image_size=image_size,
                                 random_aug=random_aug, seed=seed)
    raise ValueError(f"unknown dataset name: {name}")
