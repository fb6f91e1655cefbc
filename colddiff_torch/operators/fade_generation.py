"""Fade degradation for unconditional generation (per-pixel alpha schedule).

Port of ``colddiff/operators/fade_generation.py``, the first Family-B
operator of the port.  The reference builds cumulative fade-kernel products
as per-pixel ``alphas`` [T, S, S] (defading_diffusion_pytorch.py:313-328),
and ``q_sample`` interpolates ``alpha_t * x0 + (1 - alpha_t) * x_end``
(:543-548) toward a random constant-color image (:769-774); ``reverse``
flips the schedule, and its alphas are the complement of the reversed
pre-products (:371-380), so level T is pure x_end.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel.mesh import draw_rows
from .base import Degradation, bcast, table_device
from .fade import fade_mask

__all__ = ["FadeGeneration"]


class FadeGeneration(Degradation):
    """``alphas[i]`` ([T, S, S], fp32) weighs x0 at level i + 1."""

    requires_x_end = True

    def __init__(self, *, timesteps: int, alphas: torch.Tensor):
        super().__init__(timesteps)
        self.alphas = alphas

    @classmethod
    def create(
        cls,
        *,
        image_size: int,
        timesteps: int,
        kernel_std: float = 0.15,
        initial_mask: int = 11,
        reverse: bool = False,
        device: torch.device | str = "cuda",
    ) -> "FadeGeneration":
        """Build the tables on ``device``: the card unless ``device="cpu"``."""
        device = table_device(device, "FadeGeneration")
        kers = np.ones((image_size, image_size), dtype=np.float64)
        stack = []
        for i in range(timesteps):
            k = fade_mask(image_size, kernel_std * (i + initial_mask))
            if reverse:
                stack.append(kers.copy())
                kers = kers * k
            else:
                kers = kers * k
                stack.append(kers.copy())
        if reverse:
            # the reversed pre-products are one_minus_alphas (:371-373)
            stack.reverse()
            arr = 1.0 - np.stack(stack)
        else:
            arr = np.stack(stack)
        return cls(timesteps=timesteps,
                   alphas=torch.as_tensor(arr.astype(np.float32), device=device))

    def _alpha(self, n) -> tuple[torch.Tensor, torch.Tensor]:
        n = self._levels(n, self.alphas.device)
        idx = torch.clamp(n - 1, 0, self.timesteps - 1)
        return n, self.alphas[idx][..., None]  # [B, S, S, 1]

    def degrade(self, x, n, *, x_end=None, og=None, rng=None):
        if x_end is None:
            raise ValueError("FadeGeneration.degrade needs x_end (draw it with "
                             "sample_x_end)")
        n, a = self._alpha(n)
        y = a * x + (1.0 - a) * x_end
        return torch.where(bcast(n, x.dim()) == 0, x.to(y.dtype), y)

    def x_end_from_xt(self, x0_bar, xt, n):
        """(x_t - a x0) / (1 - a), with 1 - a floored at 1e-8."""
        _, a = self._alpha(n)
        return (xt - a * x0_bar) / torch.clamp(1.0 - a, min=1e-8)

    def sample_x_end(self, generator, x):
        """A constant color in [-0.5, 0.5) per sample and channel
        (defading...pytorch.py:769-774: torch.rand(B, 3) - 0.5)."""
        c = draw_rows(lambda n: torch.rand((n, 1, 1, x.shape[-1]), generator=generator,
                                           dtype=x.dtype, device=x.device), x.shape[0]) - 0.5
        return c.expand(x.shape)
