"""ctypes bindings for the loaders' host helpers (``_native/transform.cpp``).

Port of ``colddiff/data/native.py``: the same three C functions, the same
``argtypes`` and the same numpy bodies, so the port's loaders give the JAX
loaders' bits on either path.  The native path scales uint8 as
``v * (2/255) - 1``, the numpy path as ``v / 255 * 2 - 1``; they differ by
at most float32's eps (one ulp of 1.0).

The library is built with ``g++ -O3 -march=native -shared -fPIC`` the first
time a helper runs, never at import, into ``build/colddiff_torch/`` at the
repository root (the CUDA kernels' ``ops/_build.BUILD_DIR``).  Its name is a
hash of the source, the compiler and flags, and the host's machine and CPU
features (``-march=native`` code runs only where it was built), so an edited
source or another host builds anew.  The build runs under a lock, into a
temporary name that ``os.replace`` moves into place, so threads and
processes that reach it at once all load one complete library.

``COLDDIFF_NO_NATIVE`` (any non-empty value) selects the numpy path, as in
the JAX package; :func:`reset` makes the next call read it again.  Without
it a failed build raises ``RuntimeError`` with the compiler's output: the
port never falls back to numpy quietly, where the JAX package does.
``calls`` counts the native calls of each helper.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from collections import Counter
from pathlib import Path
from typing import Optional

import numpy as np

from ..ops._build import BUILD_DIR

__all__ = ["SRC", "CXX", "CXX_FLAGS", "BUILD_DIR", "calls", "library_path", "build",
           "get_lib", "reset", "crop_flip_normalize", "pad4_crop_flip_normalize"]

SRC = Path(__file__).resolve().parent / "_native" / "transform.cpp"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

calls: Counter = Counter()
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_READ = False  # whether get_lib has settled _LIB (or the numpy path)


def _cpu_id() -> bytes:
    """The host's CPU model and feature flags, what ``-march=native`` reads."""
    try:
        text = Path("/proc/cpuinfo").read_text()
    except OSError:
        return platform.processor().encode()
    keep = [ln for ln in text.splitlines() if ln.startswith(("model name", "flags"))]
    return "\n".join(keep[:2]).encode()


def library_path() -> Path:
    """Where the library of :data:`SRC` lives on this host."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join((CXX, *CXX_FLAGS, platform.machine())).encode())
    h.update(_cpu_id())
    return BUILD_DIR / f"libcolddiff_native_{h.hexdigest()[:16]}.so"


def build(path: Path) -> None:
    """Compile :data:`SRC` into ``path``: into a temporary name first, then
    ``os.replace``, so a reader never sees half a library.  Raises
    ``RuntimeError`` with the compiler's output if it fails."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"building the native loader helpers failed: {' '.join(cmd)}: "
                           f"{e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native loader helpers failed: {' '.join(cmd)} "
                           f"(exit {proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, path)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; ``None`` when
    ``COLDDIFF_NO_NATIVE`` is set.  Raises ``RuntimeError`` if it cannot be
    built."""
    global _LIB, _READ
    if _READ:
        return _LIB
    with _LOCK:
        if _READ:
            return _LIB
        if not os.environ.get("COLDDIFF_NO_NATIVE"):
            so = library_path()
            if not so.exists():
                build(so)
            lib = ctypes.CDLL(str(so))
            u8p = ctypes.POINTER(ctypes.c_uint8)
            f32p = ctypes.POINTER(ctypes.c_float)
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.crop_flip_normalize.argtypes = [
                u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p,
            ]
            lib.batch_crop_flip_normalize.argtypes = [
                ctypes.POINTER(u8p), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, i32p, ctypes.c_int, f32p,
            ]
            lib.pad4_crop_flip_normalize.argtypes = [
                u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, f32p,
            ]
            _LIB = lib
        _READ = True
    return _LIB


def reset() -> None:
    """Forget the loaded library and the switch: the next call reads
    ``COLDDIFF_NO_NATIVE`` again (and loads or builds the library)."""
    global _LIB, _READ
    with _LOCK:
        _LIB, _READ = None, False


def crop_flip_normalize(img: np.ndarray, y0: int, x0: int, size: int,
                        flip: bool) -> np.ndarray:
    """Fused crop + flip + uint8 -> [-1, 1] float32 (native unless switched off)."""
    assert img.dtype == np.uint8 and img.ndim == 3
    lib = get_lib()
    h, w, c = img.shape
    if lib is not None:
        img = np.ascontiguousarray(img)
        out = np.empty((size, size, c), dtype=np.float32)
        lib.crop_flip_normalize(
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, c,
            y0, x0, size, int(flip),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        calls["crop_flip_normalize"] += 1
        return out
    crop = img[y0 : y0 + size, x0 : x0 + size]
    if flip:
        crop = crop[:, ::-1]
    return crop.astype(np.float32) / 255.0 * 2.0 - 1.0


def pad4_crop_flip_normalize(img: np.ndarray, y0: int, x0: int,
                             flip: bool) -> np.ndarray:
    """Fused CIFAR aug: zero-pad 4, crop at (y0, x0), flip, normalize."""
    assert img.dtype == np.uint8 and img.ndim == 3
    lib = get_lib()
    h, w, c = img.shape
    if lib is not None:
        img = np.ascontiguousarray(img)
        out = np.empty((h, w, c), dtype=np.float32)
        lib.pad4_crop_flip_normalize(
            img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, c,
            y0, x0, int(flip),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        calls["pad4_crop_flip_normalize"] += 1
        return out
    p = np.pad(img, ((4, 4), (4, 4), (0, 0)), mode="constant")
    crop = p[y0 : y0 + h, x0 : x0 + w]
    if flip:
        crop = crop[:, ::-1]
    return crop.astype(np.float32) / 255.0 * 2.0 - 1.0
