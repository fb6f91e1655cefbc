"""Naive fade degradation: scalar fade factors and spiral binary masks.

Port of ``colddiff/operators/fade_naive.py`` (reference:
defading_diffusion_naive.py:44-82 spiral utilities, :347-368
``get_fade_factors``, :561-605 q_sample).  Factors multiply and commute, so
the cumulative stacks ``F[n] = prod_{i<n} f_i`` ([T+1, 1, 1] scalars or
[T+1, S, S] spiral masks, built once on the host) are exact.  ``Spiral_2``
fades toward a constant color (an endpoint, as in Family B): after n steps
``x_n = F[n] * x0 + (1 - F[n]) * x_end``; its sampling routines are
``x0_step_down_spiral_2_fix`` / ``_rand`` (:418-445).

Where the JAX ``degrade`` draws the Spiral_2 endpoint from a key it is
given, the port's caller draws it with :meth:`sample_x_end` and passes
``x_end``, as the Trainer and the samplers do.

Inside a row-sharded ``parallel.image_rows`` a process takes its rows of
a spiral mask (``spatial.local``); the scalar factors and the Spiral_2
endpoint, a constant per image, need nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..parallel import spatial
from ..parallel.mesh import draw_rows
from .base import Degradation, bcast, table_device

__all__ = ["FadeNaive", "spiral_order"]

_ROUTINES = ("Incremental", "Constant", "Spiral", "Spiral_2")


def spiral_order(n: int) -> np.ndarray:
    """[n, n] spiral ordering used by the Spiral routines
    (defading_diffusion_naive.py:44-76): B.flat[base_spiral] = arange."""
    a = np.arange(n * n).reshape(n, n)
    # base_spiral: counterclockwise spiral of indices, reversed
    out = []
    m = a.copy()
    while m.size:
        out.append(m[0][::-1])
        m = m[1:][::-1].T
    base = np.concatenate(out)[::-1]
    b = np.empty_like(a)
    b.flat[base] = a.flat
    return b


class FadeNaive(Degradation):
    """``cum[n]`` (fp32) is the product of the first n factors or masks."""

    def __init__(self, *, timesteps: int, cum: torch.Tensor,
                 fade_routine: str = "Incremental", image_size: int = 32):
        super().__init__(timesteps)
        self.cum = cum
        self.fade_routine = fade_routine
        self.image_size = image_size
        self.requires_x_end = fade_routine == "Spiral_2"

    @classmethod
    def create(
        cls,
        *,
        image_size: int,
        timesteps: int,
        fade_routine: str = "Incremental",
        start_fade_factor: float = 0.1,
        device: torch.device | str = "cuda",
    ) -> "FadeNaive":
        """Build the tables on ``device``: the card unless ``device="cpu"``."""
        if fade_routine not in _ROUTINES:
            raise ValueError(f"unknown naive fade routine: {fade_routine}")
        device = table_device(device, "FadeNaive")
        if fade_routine in ("Spiral", "Spiral_2"):
            sp = spiral_order(image_size)
            # step mask i: spiral > i (defading_diffusion_naive.py:357-366)
            steps = [(sp > i).astype(np.float64) for i in range(timesteps)]
        elif fade_routine == "Incremental":
            steps = [np.full((1, 1), 1.0 - start_fade_factor * (i + 1))
                     for i in range(timesteps)]
        else:  # Constant
            steps = [np.full((1, 1), 1.0 - start_fade_factor)] * timesteps
        cum = np.empty((timesteps + 1,) + steps[0].shape)
        cum[0] = 1.0
        for i in range(timesteps):
            cum[i + 1] = cum[i] * steps[i]
        return cls(timesteps=timesteps,
                   cum=torch.as_tensor(cum.astype(np.float32), device=device),
                   fade_routine=fade_routine, image_size=image_size)

    def degrade(self, x, n, *, x_end=None, og=None, rng=None):
        n = self._levels(n, self.cum.device)
        f = self.cum[n][..., None]  # [B, 1 or S, 1 or S, 1]
        if f.shape[1] > 1:
            f = spatial.local(f, 1)
        y = x * f
        if self.requires_x_end and x_end is not None:
            y = y + (1.0 - f) * x_end
        return torch.where(bcast(n, x.dim()) == 0, x.to(y.dtype), y)

    def sample_x_end(self, generator, x):
        """Spiral_2: a constant color in [0, 1) per sample and channel
        (defading_diffusion_naive.py:380-383, torch.rand); None for the
        other routines, whose degrade has no endpoint."""
        if not self.requires_x_end:
            return None
        c = draw_rows(lambda n: torch.rand((n, 1, 1, x.shape[-1]), generator=generator,
                                           dtype=x.dtype, device=x.device), x.shape[0])
        return c.expand(x.shape)
