"""Degradation operator protocol.

Port of ``colddiff/operators/base.py``.  The JAX operators are immutable
pytrees; here an operator is a plain object that holds its tables as tensors
on one device (``to(device)`` returns a copy on another).

Time convention
---------------
``degrade(x, n)`` applies *n* degradation steps; ``n`` is a per-sample
integer vector in ``[0, T]`` and ``degrade(x, 0) == x``.  The reference's
``q_sample(x, t)`` (t an index into the step list) corresponds to
``degrade(x, t + 1)``, and its sampling loops' ``for i in range(t)`` chains to
``degrade(x, t)``.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["Degradation"]


class Degradation:
    """Base degradation operator."""

    # Family B operators (noise / mix / fade-generation) interpolate toward an
    # explicit endpoint ``x_end`` that the caller must supply.
    requires_x_end: bool = False

    def __init__(self, timesteps: int):
        self.timesteps = int(timesteps)

    def degrade(self, x: torch.Tensor, n: torch.Tensor, *,
                x_end: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Apply ``n`` degradation steps to NHWC batch ``x`` (n: integer [B])."""
        raise NotImplementedError

    def degrade_sampling(self, x: torch.Tensor, n: torch.Tensor, **kw) -> torch.Tensor:
        """Degradation used inside reverse-sampling loops.

        Identical to :meth:`degrade` for every operator except blur's
        ``Individual_Incremental`` routine, whose sampler applies a single
        per-level kernel (deblurring_diffusion_pytorch.py:405,429) while its
        q_sample still composes sequentially.
        """
        return self.degrade(x, n, **kw)

    def degrade_range(self, x: torch.Tensor, n0: int, n1: int, *,
                      x_end: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Apply steps ``n0..n1-1`` to a state already degraded to level
        ``n0`` (host ints), as ``sample_from_blur``'s partial forward chain
        does (deblurring_diffusion_pytorch.py:877-879)."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support partial-range degradation"
        )

    def total(self, x: torch.Tensor, *, x_end: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Fully degraded state x_T (used to initialize generation)."""
        n = torch.full((x.shape[0],), self.timesteps, dtype=torch.long,
                       device=x.device)
        return self.degrade(x, n, x_end=x_end)

    def reset(self, generator: Optional[torch.Generator], batch_size: int) -> "Degradation":
        """Redraw any stochastic operator state (snow fields, ...); the
        deterministic operators return themselves
        (``ForwardProcessBase.reset_parameters``, forward_process_impl.py:49-52)."""
        del generator, batch_size
        return self

    def sample_x_end(self, generator: Optional[torch.Generator],
                     x: torch.Tensor) -> Optional[torch.Tensor]:
        """The degradation endpoint for operators that draw their own (Family
        B); None for the deterministic operators, whose endpoint is implied."""
        del generator, x
        return None
