"""Separable linear-operator machinery for the degradations.

Port of ``colddiff/ops/linop.py``.  A per-step blur along one axis is an
``n x n`` matrix ``A``; the separable 2-D step is ``A (x) A`` and composing
steps multiplies the matrices.  The cumulative products ``P[n] = A_{n-1} ...
A_0`` are built once on the host (numpy, float64 inside, float32 out), and
degrading a batch to per-sample level ``t`` is a gather plus two batched fp32
matmuls:

    y[b] = P[t_b] @ x[b] @ P[t_b]^T        (per channel)

The matrix builders are copies of the JAX package's numpy code (pinned to it
by ``tests/test_torch_blur.py`` and ``tests/test_torch_operators.py``).  The two products are plain batched
matmuls, which go to ``torch.einsum`` / cuBLAS as the JAX package leaves them
to XLA.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import spatial

__all__ = [
    "conv1d_matrix",
    "resize1d_matrix",
    "resize_step_matrix",
    "cumulative_matrices",
    "apply_separable",
    "apply_rowcol",
]


def _pad_index(idx: int, n: int, mode: str) -> int:
    """Map an out-of-range 1-D index to an in-range one per torch padding mode."""
    if 0 <= idx < n:
        return idx
    if mode == "circular":
        return idx % n
    if mode == "reflect":
        # mirror without repeating the edge (torch 'reflect'); single bounce is
        # enough for all reference configs (pad <= n-1), loop for safety.
        while idx < 0 or idx >= n:
            if idx < 0:
                idx = -idx
            if idx >= n:
                idx = 2 * n - 2 - idx
        return idx
    if mode == "replicate":
        return min(max(idx, 0), n - 1)
    if mode == "zeros":
        return -1  # caller drops the tap
    raise ValueError(f"unknown padding mode: {mode}")


def conv1d_matrix(kernel: np.ndarray, n: int, mode: str = "circular") -> np.ndarray:
    """HxH matrix of a 1-D cross-correlation with ``pad = len(kernel)//2``.

    Matches torch ``nn.Conv2d(..., padding=k//2, padding_mode=mode)`` along one
    axis:  out[i] = sum_k w[k] * x[pad_map(i + k - p)].
    """
    k = np.asarray(kernel, dtype=np.float64)
    ks = k.shape[0]
    p = (ks - 1) // 2
    m = np.zeros((n, n), dtype=np.float64)
    for i in range(n):
        for j in range(ks):
            src = _pad_index(i + j - p, n, mode)
            if src >= 0:
                m[i, src] += k[j]
    return m


def _cubic_weight(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel (torch bicubic, a = -0.75)."""
    ax = np.abs(x)
    w = np.where(
        ax <= 1.0,
        (a + 2.0) * ax**3 - (a + 3.0) * ax**2 + 1.0,
        np.where(ax < 2.0, a * (ax**3 - 5.0 * ax**2 + 8.0 * ax - 4.0), 0.0),
    )
    return w


def resize1d_matrix(n_in: int, n_out: int, mode: str) -> np.ndarray:
    """[n_out, n_in] matrix of torch ``F.interpolate`` along one axis.

    Implements align_corners=False, antialias=False semantics for
    'bilinear' / 'bicubic' / 'nearest' / 'nearest-exact', and
    adaptive-average semantics for 'area' (exactly what torch 'area' mode is).
    Held against torch's ``F.interpolate`` in tests/test_torch_operators.py.
    """
    m = np.zeros((n_out, n_in), dtype=np.float64)
    if n_in == n_out and mode != "area":
        return np.eye(n_in, dtype=np.float64)
    scale = n_in / n_out
    if mode == "bilinear" or mode == "linear":
        for i in range(n_out):
            src = (i + 0.5) * scale - 0.5
            src = max(src, 0.0)
            i0 = int(np.floor(src))
            i1 = min(i0 + 1, n_in - 1)
            frac = src - i0
            i0 = min(i0, n_in - 1)
            m[i, i0] += 1.0 - frac
            m[i, i1] += frac
    elif mode == "bicubic" or mode == "cubic":
        for i in range(n_out):
            src = (i + 0.5) * scale - 0.5
            i0 = int(np.floor(src))
            frac = src - i0
            xs = np.array([frac + 1.0, frac, 1.0 - frac, 2.0 - frac])
            ws = _cubic_weight(xs)
            for tap, w in zip((i0 - 1, i0, i0 + 1, i0 + 2), ws):
                m[i, min(max(tap, 0), n_in - 1)] += w
    elif mode == "nearest":
        for i in range(n_out):
            src = min(int(np.floor(i * scale)), n_in - 1)
            m[i, src] = 1.0
    elif mode == "nearest-exact":
        for i in range(n_out):
            src = min(int(np.floor((i + 0.5) * scale)), n_in - 1)
            m[i, src] = 1.0
    elif mode == "area":
        for i in range(n_out):
            lo = i * n_in / n_out
            hi = (i + 1) * n_in / n_out
            i0 = int(np.floor(lo))
            i1 = int(np.ceil(hi))
            # torch adaptive_avg_pool: uniform average over [floor(lo), ceil(hi))
            taps = range(i0, min(i1, n_in))
            w = 1.0 / len(list(taps))
            for tap in range(i0, min(i1, n_in)):
                m[i, tap] += w
    else:
        raise ValueError(f"unknown resize mode: {mode}")
    return m


def resize_step_matrix(size: int, target: int, mode: str) -> np.ndarray:
    """One resolution-pyramid step as a [size, size] matrix.

    Matches resolution_diffusion_pytorch.py:370-371: downsample to ``target``
    with ``mode`` then upsample back to ``size`` with 'nearest-exact'.
    """
    down = resize1d_matrix(size, target, mode)
    up = resize1d_matrix(target, size, "nearest-exact")
    return up @ down


def cumulative_matrices(step_matrices: list[np.ndarray]) -> np.ndarray:
    """[T+1, n, n] cumulative products: P[0] = I, P[t] = A_{t-1} @ P[t-1].

    ``P[t] @ x`` applies degradation steps 0..t-1 (t applications), matching
    the reference's ``for i in range(t): x = kernels[i](x)`` loops.
    """
    n = step_matrices[0].shape[0]
    out = np.empty((len(step_matrices) + 1, n, n), dtype=np.float64)
    out[0] = np.eye(n)
    for t, a in enumerate(step_matrices):
        out[t + 1] = a @ out[t]
    return out.astype(np.float32)


def require_ieee_fp32(x: torch.Tensor) -> None:
    """Raise unless fp32 matmuls on ``x``'s device run in full fp32.

    Degrade math must be true fp32: TF32 keeps about three decimal digits,
    which perturbs even the identity level ``P[0] = I``.  The flag is global,
    so the caller sets ``torch.backends.cuda.matmul.allow_tf32 = False``.
    """
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "degrade math needs full fp32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False")


def apply_rowcol(x: torch.Tensor, row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """Apply per-sample row/col matrices to an NHWC batch, in fp32.

    x: [B, H, W, C]; row: [B, H, H]; col: [B, W, W].
    Returns y[b] = row[b] @ x[b] @ col[b]^T per channel -- two batched matmuls.

    Inside a row-sharded ``parallel.image_rows`` x is this process's block
    of h rows: the group's rows are gathered in fp32 and multiplied by this
    process's h rows of ``row``; the column product stays local.
    """
    require_ieee_fp32(x)
    x = x.to(torch.float32)
    if spatial.current() is not None:
        row = spatial.local(row, 1)
        x = spatial.gather(x, 1)
    y = torch.einsum("bij,bjwc->biwc", row, x)
    return torch.einsum("bij,bhjc->bhic", col, y)


def apply_separable(x: torch.Tensor, cum: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Degrade NHWC batch ``x`` to per-sample level ``t`` (number of steps).

    cum: [T+1, n, n] cumulative matrices (square images: row == col matrix).
    t: integer [B] in [0, T], on ``cum``'s device.
    """
    m = cum[t]  # [B, n, n] gather
    return apply_rowcol(x, m, m)
