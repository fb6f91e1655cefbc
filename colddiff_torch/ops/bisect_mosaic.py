"""The four probes of ``scripts/bisect_mosaic.py``: kernels and plain versions.

Each probe was one ``pl.pallas_call`` that bisected a Mosaic compiler crash
in the TPU front kernel's lane-packed layout.  On a CUDA tensor each wrapper
here launches its hand-written Hopper kernel from
``colddiff_torch/csrc/bisect_mosaic.cu``; on a CPU tensor it runs the plain
PyTorch version beside it.  A CUDA tensor never falls back to the plain
version: the kernel launches or the call raises.

  probe_roll         k_roll (:37-39)        ``torch.roll`` along the last axis
  probe_roll_slice   k_roll_slice (:42-46)  the roll for columns < split,
                                            the input after
  probe_masked_norm  k_masked_norm (:49-61) each element minus the mean of
                                            its 64-element group
  probe_dyn_sublane  k_dyn_sublane (:64-70) the sum of 7 consecutive rows

All take and return fp32 tensors ``[..., rows, width]``.  Each wrapper
counts its kernel's launches in ``<wrapper>.launches``.  The roll and
dyn_sublane kernels move 16-byte quads where :func:`quad_path` allows it,
single floats otherwise.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = [
    "GROUP", "WINDOW", "quad_path",
    "probe_roll", "probe_roll_slice", "probe_masked_norm", "probe_dyn_sublane",
    "roll_plain", "roll_slice_plain", "masked_norm_plain", "dyn_sublane_plain",
]

GROUP = 64  # masked_norm: the channel count c = 64 of the TPU probe
WINDOW = 7  # dyn_sublane: rows per sum

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _kernel(name: str, nint: int):
    fn = getattr(_build.load_library(), f"colddiff_probe_{name}")
    fn.argtypes = [_P, _P] + [_I] * nint + [_P]
    fn.restype = ctypes.c_int
    return fn


def quad_path(x_ptr: int, out_ptr: int, width: int, shift: int = 0, split: int = 0) -> bool:
    """Whether a roll or dyn_sublane kernel may move float4 quads: both
    pointers 16-byte aligned, and width, shift and split whole quads, so that
    an aligned output quad has one aligned input quad as its source."""
    return (x_ptr % 16 == 0 and out_ptr % 16 == 0
            and width % 4 == 0 and shift % 4 == 0 and split % 4 == 0)


def roll_plain(x: torch.Tensor, shift: int) -> torch.Tensor:
    return torch.roll(x, shifts=shift, dims=-1)


def roll_slice_plain(x: torch.Tensor, shift: int, split: int) -> torch.Tensor:
    return torch.cat([roll_plain(x, shift)[..., :split], x[..., split:]], dim=-1)


def masked_norm_plain(x: torch.Tensor) -> torch.Tensor:
    h = x.reshape(*x.shape[:-1], x.shape[-1] // GROUP, GROUP)
    return (h - h.mean(dim=-1, keepdim=True)).reshape(x.shape)


def dyn_sublane_plain(x: torch.Tensor) -> torch.Tensor:
    rows = x.shape[-2] - (WINDOW - 1)
    acc = x[..., 0:rows, :]
    for dy in range(1, WINDOW):
        acc = acc + x[..., dy:dy + rows, :]
    return acc


def _cuda_input(name: str, x: torch.Tensor) -> None:
    """Raise unless ``x`` is what the kernel takes."""
    if x.dtype != torch.float32:
        raise TypeError(f"probe_{name} kernel takes float32, got {x.dtype}")
    if x.dim() < 2 or not x.is_contiguous():
        raise ValueError(f"probe_{name} kernel takes a contiguous [..., rows, width] "
                         f"tensor, got shape {tuple(x.shape)}")


def _run(wrapper, name: str, x: torch.Tensor, out: torch.Tensor, *ints: int) -> torch.Tensor:
    with torch.cuda.device(x.device):
        err = _kernel(name, len(ints))(x.data_ptr(), out.data_ptr(), *ints,
                                       torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe_{name} kernel launch failed: cudaError {err}")
    wrapper.launches += 1
    return out


def _roll(wrapper, name: str, x: torch.Tensor, shift: int, split: int) -> torch.Tensor:
    _cuda_input(name, x)
    width = x.shape[-1]
    if not (0 <= shift < width and 0 <= split <= width):
        raise ValueError(f"probe_{name}: need 0 <= shift < {width} and "
                         f"0 <= split <= {width}, got {shift}, {split}")
    out = torch.empty_like(x)
    return _run(wrapper, "roll", x, out, x.numel() // width, width, shift, split,
                quad_path(x.data_ptr(), out.data_ptr(), width, shift, split))


def _check_device(x: torch.Tensor) -> bool:
    """True for a CUDA tensor; raise on anything but CUDA or CPU."""
    if x.is_cuda:
        return True
    if x.device.type != "cpu":
        raise ValueError(f"probes run on CUDA or CPU tensors, got {x.device}")
    return False


def probe_roll(x: torch.Tensor, shift: int) -> torch.Tensor:
    """``jnp.roll(x, shift, axis=-1)``: ``out[..., j] = x[..., (j - shift) % W]``
    (``pltpu.roll(row, W - 64, 1)`` in the TPU probe)."""
    if not _check_device(x):
        return roll_plain(x, shift)
    return _roll(probe_roll, "roll", x, shift, x.shape[-1])


def probe_roll_slice(x: torch.Tensor, shift: int, split: int) -> torch.Tensor:
    """The roll for columns ``< split``, the input's columns after them."""
    if not _check_device(x):
        return roll_slice_plain(x, shift, split)
    return _roll(probe_roll_slice, "roll_slice", x, shift, split)


def probe_masked_norm(x: torch.Tensor) -> torch.Tensor:
    """Each element minus the mean of its 64-element group (a 64-lane half of
    a 128-lane group on the TPU); the width must be a multiple of 64."""
    if x.shape[-1] % GROUP:
        raise ValueError(f"probe_masked_norm: width {x.shape[-1]} is not a multiple of {GROUP}")
    if not _check_device(x):
        return masked_norm_plain(x)
    _cuda_input("masked_norm", x)
    width = x.shape[-1]
    return _run(probe_masked_norm, "masked_norm", x, torch.empty_like(x),
                x.numel() // width, width)


def probe_dyn_sublane(x: torch.Tensor) -> torch.Tensor:
    """``out[..., r, :] = sum_{dy < 7} x[..., r + dy, :]``: [..., R, W] -> [..., R - 6, W]."""
    if x.shape[-2] < WINDOW:
        raise ValueError(f"probe_dyn_sublane: needs >= {WINDOW} rows, got {x.shape[-2]}")
    if not _check_device(x):
        return dyn_sublane_plain(x)
    _cuda_input("dyn_sublane", x)
    rows_in, width = x.shape[-2], x.shape[-1]
    out = torch.empty(*x.shape[:-2], rows_in - (WINDOW - 1), width,
                      dtype=x.dtype, device=x.device)
    return _run(probe_dyn_sublane, "dyn_sublane", x, out,
                x.numel() // (rows_in * width), rows_in, width,
                quad_path(x.data_ptr(), out.data_ptr(), width))


for _w in (probe_roll, probe_roll_slice, probe_masked_norm, probe_dyn_sublane):
    _w.launches = 0
del _w
