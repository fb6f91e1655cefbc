"""Desaturation degradation (colorization task).

Port of ``colddiff/operators/decolor.py``.  The reference applies a 1x1
non-grouped conv per step whose kernel is ``theta*I + (1-theta) * (1 1^T / C)``,
optionally round-tripping through Lab space, and ``total_forward`` is the
pure channel mean (snowification/diffusion/forward_process_impl.py:131-218).
Each step is a CxC channel matrix, so the cumulative products ``[T+1, C, C]``
are built once on the host and ``degrade`` is one batched fp32 product
(exact: consecutive lab2rgb/rgb2lab round trips of the per-step chain
cancel).

The mix, the Lab round trip and ``total`` are per pixel, so inside a
row-sharded ``parallel.image_rows`` they run on this process's rows as
they are.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.image import lab2rgb, rgb2lab
from ..ops.linop import cumulative_matrices, require_ieee_fp32
from ..schedules import decolor_routine_thetas
from .base import Degradation, bcast, table_device

__all__ = ["Decolorization"]


class Decolorization(Degradation):
    """``cum[n]`` ([T+1, C, C], fp32) mixes the channels of n steps."""

    def __init__(self, *, timesteps: int, cum: torch.Tensor, to_lab: bool = False):
        super().__init__(timesteps)
        self.cum = cum
        self.to_lab = to_lab

    @classmethod
    def create(
        cls,
        *,
        timesteps: int,
        channels: int = 3,
        decolor_routine: str = "Constant",
        decolor_ema_factor: float = 0.9,
        decolor_total_remove: bool = False,
        to_lab: bool = False,
        device: torch.device | str = "cuda",
    ) -> "Decolorization":
        """Build the tables on ``device``: the card unless ``device="cpu"``."""
        device = table_device(device, "Decolorization")
        thetas = decolor_routine_thetas(
            decolor_routine, timesteps, decolor_ema_factor, decolor_total_remove
        )
        eye = np.eye(channels, dtype=np.float64)
        mean = np.ones((channels, channels), dtype=np.float64) / channels
        mats = [th * eye + (1.0 - th) * mean for th in thetas]
        return cls(timesteps=timesteps,
                   cum=torch.as_tensor(cumulative_matrices(mats), device=device),
                   to_lab=to_lab)

    @staticmethod
    def _mix(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        require_ieee_fp32(x)
        return torch.einsum("bij,bhwj->bhwi", m, x.to(torch.float32))

    def degrade(self, x, n, *, x_end=None, og=None, rng=None):
        n = self._levels(n, self.cum.device)
        m = self.cum[n]  # [B, C, C]
        if self.to_lab:
            y = rgb2lab(self._mix(lab2rgb(x), m))
        else:
            y = self._mix(x, m)
        return torch.where(bcast(n, x.dim()) == 0, x.to(y.dtype), y)

    def total(self, x, *, x_end=None, og=None, rng=None):
        """Pure channel mean (forward_process_impl.py:200-218)."""
        if self.to_lab:
            rgb = lab2rgb(x)
            return rgb2lab(rgb.mean(dim=-1, keepdim=True).expand_as(rgb))
        return x.mean(dim=-1, keepdim=True).expand_as(x)
