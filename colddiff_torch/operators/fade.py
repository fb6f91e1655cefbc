"""Conditional fade / inpainting-mask degradation.

Port of ``colddiff/operators/fade.py``.  The reference multiplies the image
by per-step masks ``1 - normalized Gaussian bump`` (defading_diffusion_
gaussian.py:298-554).  Masks compose elementwise, so the cumulative stacks
``M[n] = prod_{i<n} mask_i`` are built once on the host ([T+1, S, S], or
[T+1, 2S, 2S] for ``Random_Incremental``) and ``degrade`` is a gather and a
multiply.  ``Random_Incremental`` crops a per-sample S x S window at offsets
in [0, S] (inclusive) from the 2S grid; because crop(prod) == prod(crop)
this is exact.  The crops of a batch are one gather on the device.

Where the offsets come from (fade.py:87-103): the ``rng`` state given to
``degrade`` (one loss's draw, :meth:`sample_rng_state`), else the offsets
baked by :meth:`randomize` / :meth:`reset` for a whole sampling run, else
zeros.

Inside a row-sharded ``parallel.image_rows`` a process multiplies its
block by its rows of the mask: the stack's rows (``spatial.local``), or,
for ``Random_Incremental``, the rows ``off + index * h + [0, h)`` of the
2S grid, the crop offsets staying the whole batch's draw.
"""

from __future__ import annotations

import copy
from typing import Optional

import numpy as np
import torch

from ..parallel import spatial
from ..parallel.mesh import draw_rows, local_rows
from ..schedules import fade_routine_sigmas, gaussian_kernel_2d
from .base import Degradation, table_device

__all__ = ["Fade", "fade_mask"]


def fade_mask(size: int, sigma: float) -> np.ndarray:
    """One fade kernel: 1 - G/max(G) on an (size+1)^2 grid, cropped [1:, 1:]
    (defading_diffusion_gaussian.py:329-337)."""
    g = gaussian_kernel_2d((size + 1, size + 1), (sigma, sigma)).astype(np.float64)
    k = 1.0 - g / g.max()
    return k[1:, 1:]


class Fade(Degradation):
    """``cum_masks[n]`` (fp32) is the product of the first n masks;
    ``offsets`` ([B, 2] long) are the baked crop offsets, or None."""

    def __init__(self, *, timesteps: int, cum_masks: torch.Tensor,
                 fade_routine: str = "Incremental", image_size: int = 32,
                 discrete: bool = False, offsets: Optional[torch.Tensor] = None):
        super().__init__(timesteps)
        self.cum_masks = cum_masks
        self.fade_routine = fade_routine
        self.image_size = image_size
        self.discrete = discrete
        self.offsets = offsets

    @classmethod
    def create(
        cls,
        *,
        image_size: int,
        timesteps: int,
        fade_routine: str = "Incremental",
        kernel_std: float = 0.1,
        initial_mask: int = 11,
        discrete: bool = False,
        device: torch.device | str = "cuda",
    ) -> "Fade":
        """Build the tables on ``device``: the card unless ``device="cpu"``."""
        device = table_device(device, "Fade")
        sigmas = fade_routine_sigmas(fade_routine, timesteps, kernel_std, initial_mask)
        grid = 2 * image_size if fade_routine == "Random_Incremental" else image_size
        masks = np.stack([fade_mask(grid, s) for s in sigmas])
        cum = np.empty((timesteps + 1, grid, grid), dtype=np.float64)
        cum[0] = 1.0
        for i in range(timesteps):
            cum[i + 1] = cum[i] * masks[i]
        return cls(timesteps=timesteps,
                   cum_masks=torch.as_tensor(cum.astype(np.float32), device=device),
                   fade_routine=fade_routine, image_size=image_size, discrete=discrete)

    @property
    def random(self) -> bool:
        return "Random" in self.fade_routine

    def sample_rng_state(self, generator, batch_size):
        """[B, 2] crop offsets, each in [0, S] (fade.py:84-85), or None."""
        if not self.random:
            return None
        return draw_rows(lambda n: torch.randint(0, self.image_size + 1, (n, 2),
                                                 generator=generator,
                                                 device=self.cum_masks.device), batch_size)

    def randomize(self, generator, batch_size: int) -> "Fade":
        """Bake per-sample crop offsets for a whole sampling run
        (defading_diffusion_gaussian.py:357-367)."""
        if not self.random:
            return self
        new = copy.copy(self)
        new.offsets = self.sample_rng_state(generator, batch_size)
        return new

    def reset(self, generator, batch_size):
        return self.randomize(generator, batch_size)

    def degrade(self, x, n, *, x_end=None, og=None, rng=None):
        dev = self.cum_masks.device
        m = self.cum_masks[self._levels(n, dev)]  # [B, grid, grid]
        if self.random:
            b, s = x.shape[0], self.image_size
            if rng is not None:
                off = rng
            elif self.offsets is not None:
                off = self.offsets[local_rows(b)]  # the baked offsets are the whole batch's
            else:
                off = torch.zeros((b, 2), dtype=torch.long, device=dev)
            # clamped into [0, S], so the gather stays inside the 2S grid
            # (lax.dynamic_slice clamps starts past S the same way)
            off = torch.as_tensor(off, dtype=torch.long, device=dev).clamp(0, s)
            # m[b, o_b0 + i, o_b1 + j] for i, j < S: one gather for the batch;
            # a row block takes its rows i of the crop
            span = torch.arange(s, device=dev)
            here = spatial.current()
            first = 0 if here is None else here.index * x.shape[1]
            rows = (off[:, 0, None] + span[first:first + x.shape[1]])[:, :, None]  # [B, h, 1]
            cols = (off[:, 1, None] + span)[:, None, :]  # [B, 1, S]
            m = m[torch.arange(b, device=dev)[:, None, None], rows, cols]
        else:
            m = spatial.local(m, 1)
        return x * m[..., None]
