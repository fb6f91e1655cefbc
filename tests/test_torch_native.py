"""The port's native loader helpers == colddiff's, bit for bit.

``colddiff_torch.data.native`` against ``colddiff.data.native``: the C++
path against the C++ path and the numpy path against the numpy path
(``COLDDIFF_NO_NATIVE`` on both sides), with ``rtol=0, atol=0``; the two
paths of the port differ by at most float32's eps, one ulp of 1.0
(``v * (2/255) - 1`` against ``v / 255 * 2 - 1``).  The port's loaders on top of them equal the JAX
loaders bitwise on either path.  A failed build raises, and two processes
that build at once load one library.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from colddiff.data import datasets as jdatasets
from colddiff.data import native as jnative
from colddiff_torch.data import datasets
from colddiff_torch.data import native

ROOT = Path(__file__).resolve().parents[1]
EPS = np.finfo(np.float32).eps  # one ulp of 1.0: the two paths' largest difference


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def path(request, monkeypatch):
    """Both packages on one path: ``native`` or ``numpy``
    (``COLDDIFF_NO_NATIVE``), each made to read the switch anew."""
    if request.param == "numpy":
        monkeypatch.setenv("COLDDIFF_NO_NATIVE", "1")
    else:
        monkeypatch.delenv("COLDDIFF_NO_NATIVE", raising=False)
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", False)
    native.reset()
    on = request.param == "native"
    assert (native.get_lib() is not None) == on
    assert (jnative.get_lib() is not None) == on, "the JAX package's g++ build failed"
    yield request.param
    native.reset()


@pytest.fixture
def fresh_build(monkeypatch, tmp_path):
    """The port's library state and build directory, restored afterwards."""
    monkeypatch.delenv("COLDDIFF_NO_NATIVE", raising=False)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.reset()
    yield tmp_path
    native.reset()


def _same(got, want):
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _image(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def test_library_builds_outside_the_source_tree():
    native.reset()
    lib = native.get_lib()
    assert lib is not None
    so = native.library_path()
    assert so.is_file() and so.parent == ROOT / "build" / "colddiff_torch"
    assert not list(native.SRC.parent.glob("*.so"))
    native.reset()
    assert native.get_lib()._name == str(so)  # the built library loads at once


def test_source_arithmetic_is_the_jax_source():
    def body(p):
        return p.read_text().split("#include <cstdint>", 1)[1]

    assert body(native.SRC) == body(Path(jnative._SRC))


# (image shape, y0, x0, size): the JAX test's crop, MNIST, and an aug1 crop
# of a 160 px image resized to int(128 * 1.12) = 143 px
CROPS = [((40, 44, 3), 5, 7, 32), ((28, 28, 1), 0, 0, 28), ((143, 143, 3), 9, 4, 128)]


@pytest.mark.parametrize("path", ["native", "numpy"], indirect=True)
@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("shape,y0,x0,size", CROPS, ids=["40x44", "28x28x1", "143to128"])
def test_crop_flip_normalize_equals_jax(path, flip, shape, y0, x0, size):
    img = _image(shape, seed=size)
    got = native.crop_flip_normalize(img, y0, x0, size, flip)
    _same(got, jnative.crop_flip_normalize(img, y0, x0, size, flip))
    crop = img[y0 : y0 + size, x0 : x0 + size][:, ::-1 if flip else 1]
    plain = crop.astype(np.float32) / 255.0 * 2.0 - 1.0
    assert np.abs(got - plain).max() <= EPS


@pytest.mark.parametrize("path", ["native", "numpy"], indirect=True)
@pytest.mark.parametrize("flip", [False, True])
@pytest.mark.parametrize("y0,x0", [(y, x) for y in (0, 4, 8) for x in (0, 4, 8)] + [(3, 6)])
def test_pad4_crop_flip_normalize_equals_jax(path, flip, y0, x0):
    img = _image((32, 32, 3), seed=10 * y0 + x0)
    got = native.pad4_crop_flip_normalize(img, y0, x0, flip)
    _same(got, jnative.pad4_crop_flip_normalize(img, y0, x0, flip))
    p = np.pad(img, ((4, 4), (4, 4), (0, 0)))[y0 : y0 + 32, x0 : x0 + 32]
    plain = p[:, ::-1 if flip else 1].astype(np.float32) / 255.0 * 2.0 - 1.0
    assert np.abs(got - plain).max() <= EPS


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    f = tmp_path_factory.mktemp("imgs")
    for i, (h, w, mode) in enumerate([(160, 160, "RGB"), (33, 33, "L"), (64, 48, "RGB"),
                                      (20, 30, "RGBA")]):
        arr = _image((h, w, {"RGB": 3, "L": 1, "RGBA": 4}[mode]), seed=i)
        Image.fromarray(arr[..., 0] if mode == "L" else arr, mode).save(f / f"im{i}.png")
    return f


@pytest.mark.parametrize("path", ["native", "numpy"], indirect=True)
@pytest.mark.parametrize("aug", ["aug1", "center"])
def test_image_folder_dataset_equals_jax(path, folder, aug):
    want = jdatasets.ImageFolderDataset(str(folder), 16, aug=aug, seed=3)
    got = datasets.ImageFolderDataset(str(folder), 16, aug=aug, seed=3)
    before = native.calls["crop_flip_normalize"]
    for _ in range(3):  # later passes take later draws of the one rng
        for i in range(len(want)):
            _same(got[i], want[i])
    ran = native.calls["crop_flip_normalize"] - before
    assert ran == (3 * len(want) if path == "native" else 0)


@pytest.mark.parametrize("path", ["native", "numpy"], indirect=True)
def test_array_dataset_cifar_equals_jax(path):
    images = _image((6, 32, 32, 3), seed=7)
    want = jdatasets.ArrayDataset(images, aug="cifar", seed=5)
    got = datasets.ArrayDataset(images, aug="cifar", seed=5)
    before = native.calls["pad4_crop_flip_normalize"]
    for _ in range(4):
        for i in range(len(want)):
            _same(got[i], want[i])
    ran = native.calls["pad4_crop_flip_normalize"] - before
    assert ran == (4 * len(want) if path == "native" else 0)


def test_missing_compiler_raises(fresh_build, monkeypatch):
    monkeypatch.setattr(native, "CXX", str(fresh_build / "no-such-g++"))
    with pytest.raises(RuntimeError, match="no-such-g\\+\\+"):
        native.get_lib()
    with pytest.raises(RuntimeError):  # no quiet numpy path afterwards
        native.crop_flip_normalize(_image((8, 8, 3), 0), 0, 0, 4, False)
    assert not list((fresh_build / "build").glob("*"))


def test_broken_source_raises_with_the_compiler_output(fresh_build, monkeypatch):
    src = fresh_build / "transform.cpp"
    src.write_text(native.SRC.read_text().replace("const float scale", "const floot scale"))
    monkeypatch.setattr(native, "SRC", src)
    with pytest.raises(RuntimeError, match="floot"):
        native.get_lib()
    assert not list((fresh_build / "build").glob("*"))  # no library, no temporary


def test_switch_is_read_again_after_reset(fresh_build, monkeypatch):
    monkeypatch.setenv("COLDDIFF_NO_NATIVE", "1")
    assert native.get_lib() is None
    monkeypatch.delenv("COLDDIFF_NO_NATIVE")
    assert native.get_lib() is None  # cached, as the JAX package caches it
    native.reset()
    assert native.get_lib() is not None
    assert len(list((fresh_build / "build").glob("*.so"))) == 1


_RACER = textwrap.dedent("""
    import os, sys, time, types
    from pathlib import Path
    import numpy as np
    # the port's package without its torch-importing __init__
    pkg = types.ModuleType("colddiff_torch")
    pkg.__path__ = [sys.argv[1] + "/colddiff_torch"]
    sys.modules["colddiff_torch"] = pkg
    from colddiff_torch.data import native
    native.BUILD_DIR = Path(sys.argv[2])
    ready = Path(sys.argv[3])
    (ready / str(os.getpid())).touch()
    deadline = time.time() + 60
    while len(list(ready.iterdir())) < 2 and time.time() < deadline:
        time.sleep(0.002)
    img = np.arange(12 * 12 * 3, dtype=np.uint8).reshape(12, 12, 3)
    out = native.crop_flip_normalize(img, 1, 2, 8, True)
    print(native.get_lib()._name, out.tobytes().hex())
""")


def test_two_processes_building_at_once_load_one_library(tmp_path):
    build, ready = tmp_path / "build", tmp_path / "ready"
    ready.mkdir()
    env = {k: v for k, v in os.environ.items() if k != "COLDDIFF_NO_NATIVE"}
    procs = [subprocess.Popen([sys.executable, "-c", _RACER, str(ROOT), str(build),
                               str(ready)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    lines = {o.strip() for o, _ in outs}
    assert len(lines) == 1  # one library path, the same bits
    so_name, data = lines.pop().split()
    assert sorted(p.name for p in build.iterdir()) == [Path(so_name).name]
    img = np.arange(12 * 12 * 3, dtype=np.uint8).reshape(12, 12, 3)
    native.reset()
    assert native.get_lib() is not None
    want = native.crop_flip_normalize(img, 1, 2, 8, True)
    assert bytes.fromhex(data) == want.tobytes()
