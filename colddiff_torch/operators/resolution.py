"""Resolution-pyramid degradation (super-resolution task).

Port of ``colddiff/operators/resolution.py``.  Each reference step
interpolates down to ``size - dec(i)`` (bicubic, bilinear or area, no
antialias) and back up with 'nearest-exact', optionally between two 3x3
sigma=0.5 reflect blurs (resolution_diffusion_pytorch.py:354-414).
``F.interpolate`` is separable and linear, so a step is a pair of [S, S]
matrices (the copied ``linop.resize_step_matrix``) and ``degrade`` is a
gather of the cumulative products plus two batched fp32 matmuls.

Inside a row-sharded ``parallel.image_rows`` the degrade runs on this
process's rows (``linop.apply_rowcol`` gathers the rows for the row
product).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import linop
from ..schedules import gaussian_kernel_1d, resolution_routine_sizes
from .base import Degradation, table_device

__all__ = ["Resolution"]


class Resolution(Degradation):
    """``cum[n]`` ([T+1, S, S], fp32) applies n steps along each axis."""

    def __init__(self, *, timesteps: int, cum: torch.Tensor):
        super().__init__(timesteps)
        self.cum = cum

    @classmethod
    def create(
        cls,
        *,
        image_size: int,
        timesteps: int,
        resolution_routine: str = "Incremental",
        device: torch.device | str = "cuda",
    ) -> "Resolution":
        """Build the tables on ``device``: the card unless ``device="cpu"``."""
        device = table_device(device, "Resolution")
        steps = resolution_routine_sizes(resolution_routine, timesteps, image_size)
        blur_m = linop.conv1d_matrix(
            gaussian_kernel_1d(3, 0.5).astype(np.float64), image_size, "reflect"
        )
        mats = []
        for target, mode, do_blur in steps:
            m = linop.resize_step_matrix(image_size, target, mode)
            if do_blur:
                m = blur_m @ m @ blur_m
            mats.append(m)
        return cls(timesteps=timesteps,
                   cum=torch.as_tensor(linop.cumulative_matrices(mats), device=device))

    def degrade(self, x, n, *, x_end=None, og=None, rng=None):
        return linop.apply_separable(x, self.cum, self._levels(n, self.cum.device))
