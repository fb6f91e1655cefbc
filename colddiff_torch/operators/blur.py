"""Scheduled Gaussian blur degradation (the paper's flagship "cold" operator).

Port of ``colddiff/operators/blur.py``.  The reference composes T depthwise
convs sequentially (deblurring_diffusion_pytorch.py:348-389, :927-960).  Each
per-step blur is a separable linear map ``A_i (x) A_i``, so the cumulative
products ``P[n] = A_{n-1} ... A_0`` are precomputed as a ``[T+1, S, S]``
tensor and ``degrade(x, n)`` is a gather plus two batched fp32 matmuls, for
both circular and reflect padding.

The ``discrete`` flag (unconditional generation path) collapses the final
level to the per-image channel mean (deblurring_diffusion_pytorch.py:413-415,
:937-940).

Inside a row-sharded ``parallel.image_rows`` the degrades run on this
process's rows (``linop.apply_rowcol``) and the collapse takes the group's
mean.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import linop
from ..parallel import spatial
from ..schedules import blur_routine_params, gaussian_kernel_1d
from .base import Degradation, table_device

__all__ = ["GaussianBlur"]


class GaussianBlur(Degradation):
    """All blur routines of the reference, as cumulative separable matrices.

    ``cum[n]`` ([T+1, S, S], fp32) applies n steps; ``steps[n]`` is the single
    step matrix A_{n-1} (``steps[0] = I``), used by ``Individual_Incremental``
    sampling and by :meth:`degrade_range`.
    """

    def __init__(self, *, timesteps: int, cum: torch.Tensor, steps: torch.Tensor,
                 blur_routine: str = "Incremental", discrete: bool = False):
        super().__init__(timesteps)
        self.cum = cum
        self.steps = steps
        self.blur_routine = blur_routine
        self.discrete = discrete

    @classmethod
    def create(
        cls,
        *,
        image_size: int,
        timesteps: int,
        blur_routine: str = "Incremental",
        kernel_size: int = 3,
        kernel_std: float = 0.1,
        start_kernel_std: float = 0.01,
        target_kernel_std: float = 1.0,
        discrete: bool = False,
        device: torch.device | str = "cuda",
    ) -> "GaussianBlur":
        """Build the tables on ``device``: the card by default, like the
        ``Trainer``; with no CUDA device, pass ``device="cpu"``."""
        device = table_device(device, "GaussianBlur")
        params = blur_routine_params(
            blur_routine, timesteps, kernel_size, kernel_std,
            start_kernel_std, target_kernel_std,
        )
        mats = [
            linop.conv1d_matrix(gaussian_kernel_1d(ks, std), image_size, mode)
            for (ks, std, mode) in params
        ]
        eye = np.eye(image_size, dtype=np.float64)
        return cls(
            timesteps=timesteps,
            cum=torch.as_tensor(linop.cumulative_matrices(mats), device=device),
            steps=torch.as_tensor(np.stack([eye] + mats).astype(np.float32),
                                  device=device),
            blur_routine=blur_routine,
            discrete=discrete,
        )

    def _collapse_discrete(self, y: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
        """At the final level the image collapses to its channel mean."""
        mean = spatial.group_mean(y, (1, 2))
        at_final = (n == self.timesteps).reshape(-1, 1, 1, 1)
        return torch.where(at_final, mean.expand_as(y), y)

    def degrade(self, x, n, *, x_end=None, og=None, rng=None):
        n = self._levels(n, self.cum.device)
        y = linop.apply_separable(x, self.cum, n)
        if self.discrete:
            y = self._collapse_discrete(y, n)
        return y

    def degrade_range(self, x, n0, n1, *, x_end=None):
        """Apply blur steps n0..n1-1 to a level-n0 state (host ints);
        the sample_from_blur forward preamble
        (deblurring_diffusion_pytorch.py:877-886), incl. the discrete
        collapse when the chain reaches T."""
        n0, n1 = int(n0), int(n1)
        if not 0 <= n0 <= n1 <= self.timesteps:
            raise ValueError(f"invalid range [{n0}, {n1}] for T={self.timesteps}")
        b = x.shape[0]
        nvec = torch.full((b,), n1, dtype=torch.long, device=self.cum.device)
        if n0 == 0:
            return self.degrade(x, nvec)
        linop.require_ieee_fp32(x)
        m = self.steps[n0 + 1] if n1 > n0 else torch.eye(
            self.cum.shape[1], dtype=self.cum.dtype, device=self.cum.device)
        for i in range(n0 + 2, n1 + 1):
            m = self.steps[i] @ m
        mb = m.expand(b, *m.shape)
        y = linop.apply_rowcol(x, mb, mb)
        if self.discrete:
            y = self._collapse_discrete(y, nvec)
        return y

    def degrade_sampling(self, x, n, **kw):
        if self.blur_routine == "Individual_Incremental":
            # single per-level kernel (deblurring_diffusion_pytorch.py:405,429)
            return linop.apply_separable(x, self.steps, self._levels(n, self.steps.device))
        return self.degrade(x, n, **kw)
