"""Degradation schedules: per-step kernel and factor tables.

Copies of ``colddiff.schedules.gaussian_kernel_1d``, ``gaussian_kernel_2d``,
``blur_routine_params``, ``decolor_routine_thetas``, ``fade_routine_sigmas``
and ``resolution_routine_sizes`` (the JAX package imports JAX at package
import, so the port carries its own numpy table code;
``tests/test_torch_blur.py`` and ``tests/test_torch_operators.py`` pin each
copy to the original).  Host-side setup: numpy, float64
internally, float32 out.
"""

from __future__ import annotations

import numpy as np

__all__ = ["gaussian_kernel_1d", "gaussian_kernel_2d", "blur_routine_params",
           "decolor_routine_thetas", "fade_routine_sigmas", "resolution_routine_sizes"]


def gaussian_kernel_1d(size: int, sigma: float) -> np.ndarray:
    """1-D Gaussian window, torchgeometry semantics.

    ``g[x] = exp(-(x - size//2)^2 / (2 sigma^2))`` for x in [0, size), normalized
    to sum 1.  Note the ``size // 2`` center: for even sizes the peak is offset,
    exactly as in torchgeometry (all reference routines use odd sizes).
    """
    x = np.arange(size, dtype=np.float64)
    g = np.exp(-((x - size // 2) ** 2) / (2.0 * float(sigma) ** 2))
    return (g / g.sum()).astype(np.float32)


def gaussian_kernel_2d(size: tuple[int, int], sigma: tuple[float, float]) -> np.ndarray:
    """2-D Gaussian = outer product of 1-D windows (tgm.get_gaussian_kernel2d).

    ``K[i, j] = gx[i] * gy[j]`` with i indexing rows (height).
    """
    gx = gaussian_kernel_1d(size[0], sigma[0]).astype(np.float64)
    gy = gaussian_kernel_1d(size[1], sigma[1]).astype(np.float64)
    return np.outer(gx, gy).astype(np.float32)


def blur_routine_params(
    routine: str,
    timesteps: int,
    kernel_size: int,
    kernel_std: float,
    start_kernel_std: float = 0.01,
    target_kernel_std: float = 1.0,
) -> list[tuple[int, float, str]]:
    """Per-step (kernel_size, sigma, padding_mode) for every blur routine.

    Routines from deblurring_diffusion_pytorch.py:363-389 plus the
    Linear_Accum_Std / Linear_Dec_Std routines of
    snowification/diffusion/forward_process_impl.py:96-113 (circular padding).
    """
    out: list[tuple[int, float, str]] = []
    if routine == "Incremental":
        for i in range(timesteps):
            out.append((kernel_size, kernel_std * (i + 1), "circular"))
    elif routine == "Constant":
        for _ in range(timesteps):
            out.append((kernel_size, kernel_std, "circular"))
    elif routine == "Constant_reflect":
        for _ in range(timesteps):
            out.append((kernel_size, kernel_std, "reflect"))
    elif routine == "Exponential":
        for i in range(timesteps):
            out.append((kernel_size, float(np.exp(kernel_std * i)), "circular"))
    elif routine == "Exponential_reflect":
        for i in range(timesteps):
            out.append((kernel_size, float(np.exp(kernel_std * i)), "reflect"))
    elif routine == "Individual_Incremental":
        # NOTE: not cumulative -- single kernel per level (ks = 2i+1, sigma = 2 ks).
        for i in range(timesteps):
            ks = 2 * i + 1
            out.append((ks, 2.0 * ks, "circular"))
    elif routine == "Special_6_routine":
        for i in range(timesteps):
            out.append((11, i / 100.0 + 0.35, "reflect"))
    elif routine in ("Linear_Accum_Std", "Linear_Dec_Std"):
        if routine == "Linear_Accum_Std":
            accum = np.linspace(start_kernel_std, target_kernel_std, timesteps)
            stds = [float(accum[0])]
            for i in range(1, timesteps):
                stds.append(float(np.sqrt(accum[i] ** 2 - accum[i - 1] ** 2)))
        else:
            scale = np.linspace(1.0, start_kernel_std, timesteps)
            ratio = np.sqrt(target_kernel_std**2 / np.square(scale).sum())
            stds = [float(s) for s in scale * ratio]
        for s in stds:
            size = 2 * int(2 * s) + 3  # support out to two sigma
            out.append((size, s, "circular"))
    else:
        raise ValueError(f"unknown blur routine: {routine}")
    return out


def decolor_routine_thetas(
    routine: str,
    timesteps: int,
    ema_factor: float = 0.9,
    total_remove: bool = False,
) -> list[float]:
    """Per-step channel-mix factor theta (kernel = theta*I + (1-theta)*mean).

    Matches snowification/diffusion/forward_process_impl.py:168-189: ``Constant``
    repeats ema_factor; ``Linear`` picks per-step thetas so the cumulative
    saturation decays linearly; total_remove forces the final step to theta=0.
    """
    thetas: list[float] = []
    if routine == "Constant":
        for i in range(timesteps):
            last = i == timesteps - 1
            thetas.append(0.0 if (last and total_remove) else ema_factor)
    elif routine == "Linear":
        diff = 1.0 / timesteps
        start = 1.0
        for i in range(timesteps):
            if i == timesteps - 1 and total_remove:
                thetas.append(0.0)
            else:
                f = 1.0 - diff / start
                start = start * f
                thetas.append(f)
    else:
        raise ValueError(f"unknown decolor routine: {routine}")
    return thetas


def fade_routine_sigmas(
    routine: str, timesteps: int, kernel_std: float, initial_mask: int
) -> list[float]:
    """Per-step Gaussian-bump sigma for the conditional fade operator.

    defading_diffusion_gaussian.py:337-352: sigma = kernel_std * (i + initial_mask)
    for Incremental / Random_Incremental; constant kernel_std for Constant.
    """
    if routine in ("Incremental", "Random_Incremental"):
        return [kernel_std * (i + initial_mask) for i in range(timesteps)]
    if routine == "Constant":
        return [kernel_std for _ in range(timesteps)]
    raise ValueError(f"unknown fade routine: {routine}")


def resolution_routine_sizes(routine: str, timesteps: int, image_size: int):
    """Per-step (target_size, mode, do_blur) for the resolution pyramid.

    resolution_diffusion_pytorch.py:390-414: ``Incremental*`` shrink by i pixels;
    ``*_factor_2`` shrink to image_size // 2^(i+1).
    """
    base = routine
    do_blur = base.endswith("_with_blur")
    if do_blur:
        base = base[: -len("_with_blur")]
    factor2 = base.endswith("_factor_2")
    if factor2:
        base = base[: -len("_factor_2")]
    mode = {
        "Incremental": "bicubic",
        "Incremental_bilinear": "bilinear",
        "Incremental_area": "area",
        "Incremental_bicubic": "bicubic",
    }.get(base)
    if mode is None:
        raise ValueError(f"unknown resolution routine: {routine}")
    out = []
    for i in range(timesteps):
        if factor2:
            dec = image_size - image_size // 2 ** (i + 1)
        else:
            dec = i
        out.append((image_size - dec, mode, do_blur))
    return out
