"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``colddiff_torch/csrc/*.cu`` compiles into one shared library with a
plain C interface, for Hopper (``sm_90a``): one nvcc per source, all
started together, then one link.  The library lands in
``build/colddiff_torch/`` at the repository root, named after a hash of the
sources and flags, so an edited source builds anew and an unchanged one
loads at once.  Nothing here runs at import: the first CUDA tensor that
reaches a kernel triggers :func:`load_library`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "library_path", "build", "load_library"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC.parents[1] / "build" / "colddiff_torch"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the CUDA kernels of "
        "colddiff_torch are built from source at first use")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libcolddiff_torch_{h.hexdigest()[:16]}.so"


def build(path: Path) -> None:
    """Compile every ``csrc/*.cu`` into ``path``, one nvcc process per
    source in parallel, then link; the compilers' output (including ptxas
    register and spill counts) goes to ``path``.log."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{path.stem}.{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = path.with_name(f"{tag}.{src.stem}.o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out = proc.communicate()[0]
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} (exit {proc.returncode}):\n{out[-4000:]}")
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    if not failed:
        cmd = [nvcc, *_ARCH, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout)
        if proc.returncode != 0:
            failed.append(f"link (exit {proc.returncode}):\n{proc.stdout[-4000:]}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    path.with_suffix(".log").write_text("".join(log))
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, once per process."""
    path = library_path()
    if not path.exists():
        build(path)
    return ctypes.CDLL(str(path))
