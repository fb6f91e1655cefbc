"""Interpolation degradations (Family B): hot noise and animorphosis mixing.

Port of ``colddiff/operators/noise.py``.  Both share the closed-form
cosine-schedule interpolation
``x_n = sqrt(acum[n-1]) * x0 + sqrt(1 - acum[n-1]) * x_end``
(denoising_diffusion_pytorch.py:331-337, 517-522); they differ only in where
``x_end`` comes from -- N(0, I) noise for the hot baseline, an image from a
second dataset for demixing/animorphosis (demixing_diffusion_pytorch.py:
331-337, 497-502).  The Trainer supplies ``x_end``; the operator is
elementwise math on two [T] tables.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import draw_rows
from ..schedules import cosine_alphas_cumprod
from .base import Degradation, bcast, table_device

__all__ = ["Interpolation", "GaussianNoise", "Animorphosis"]


class Interpolation(Degradation):
    """``sqrt_ac`` / ``sqrt_1mac`` ([T], fp32): sqrt(acum) and sqrt(1 - acum)."""

    requires_x_end = True

    def __init__(self, *, timesteps: int, sqrt_ac: torch.Tensor, sqrt_1mac: torch.Tensor):
        super().__init__(timesteps)
        self.sqrt_ac = sqrt_ac
        self.sqrt_1mac = sqrt_1mac

    @classmethod
    def create(cls, *, timesteps: int, s: float = 0.008,
               device: torch.device | str = "cuda") -> "Interpolation":
        """Build the tables on ``device``: the card unless ``device="cpu"``."""
        device = table_device(device, cls.__name__)
        ac = cosine_alphas_cumprod(timesteps, s)
        return cls(timesteps=timesteps,
                   sqrt_ac=torch.as_tensor(ac**0.5, dtype=torch.float32, device=device),
                   sqrt_1mac=torch.as_tensor((1.0 - ac) ** 0.5, dtype=torch.float32,
                                             device=device))

    def _coefs(self, n, ndim: int):
        n = self._levels(n, self.sqrt_ac.device)
        idx = torch.clamp(n - 1, 0, self.timesteps - 1)
        return n, bcast(self.sqrt_ac[idx], ndim), bcast(self.sqrt_1mac[idx], ndim)

    def degrade(self, x, n, *, x_end=None, og=None, rng=None):
        if x_end is None:
            raise ValueError(f"{type(self).__name__}.degrade needs x_end, the endpoint image")
        n, a, b = self._coefs(n, x.dim())
        y = a * x + b * x_end
        return torch.where(bcast(n, x.dim()) == 0, x.to(y.dtype), y)

    def degrade_range(self, x, n0, n1, *, x_end=None):
        """Advance x at level ``n0`` to ``n1`` without knowing x0 (host ints):

            r      = sqrt_ac[n1-1] / sqrt_ac[n0-1]
            x_{n1} = r * x + (sqrt_1mac[n1-1] - r * sqrt_1mac[n0-1]) * x_end
        """
        n0, n1 = int(n0), int(n1)
        if not 0 <= n0 <= n1 <= self.timesteps:
            raise ValueError(f"invalid range [{n0}, {n1}] for T={self.timesteps}")
        if n0 == 0:
            nvec = torch.full((x.shape[0],), n1, dtype=torch.long, device=self.sqrt_ac.device)
            return self.degrade(x, nvec, x_end=x_end)
        if n1 == n0:
            return x
        if x_end is None:
            raise ValueError(f"{type(self).__name__}.degrade_range needs x_end")
        r = self.sqrt_ac[n1 - 1] / self.sqrt_ac[n0 - 1]
        w_end = self.sqrt_1mac[n1 - 1] - r * self.sqrt_1mac[n0 - 1]
        return r * x + w_end * x_end

    def x_end_from_xt(self, x0_bar, xt, n):
        """(x_t - a x0) / b (get_x2_bar_from_xt, denoising_diffusion_pytorch.py:
        377-381); ``n`` is the number of applied steps."""
        _, a, b = self._coefs(n, xt.dim())
        return (xt - a * x0_bar) / b


class GaussianNoise(Interpolation):
    """Hot baseline: x_end ~ N(0, I) (denoising_diffusion_pytorch.py:738-742)."""

    def sample_x_end(self, generator, x):
        return draw_rows(lambda n: torch.randn((n, *x.shape[1:]), generator=generator,
                                               dtype=x.dtype, device=x.device), x.shape[0])


class Animorphosis(Interpolation):
    """Demixing: x_end is an image from a second dataset, so
    ``sample_x_end`` gives None and the Trainer's ``second_dataset`` feeds it."""
