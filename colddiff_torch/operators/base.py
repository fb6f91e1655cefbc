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

Randomness
----------
Where the JAX ``degrade`` takes a key and draws inside (``rng``), the port's
``degrade`` takes the *drawn state*: what :meth:`sample_rng_state` drew from
a ``torch.Generator`` (fade's ``[B, 2]`` crop offsets).  One loss hands the
same key to both of its ``q_sample`` calls (colddiff/diffusion.py:103-120),
so x_t and x_{t-1} share their draws; a state drawn once and passed to both
keeps that, where a generator passed twice would draw twice.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

__all__ = ["Degradation", "bcast", "table_device"]


def bcast(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """Reshape a per-sample vector [B] to [B, 1, 1, ...] for broadcasting."""
    return v.reshape(v.shape[0], *((1,) * (ndim - 1)))


def table_device(device: torch.device | str, name: str) -> torch.device:
    """The device an operator's ``create`` builds its tables on (and the eval
    entry points run on): the card unless the caller asks for the CPU, and
    never the CPU unasked."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{name} on a CUDA device, but no CUDA device is "
                           "available; pass device='cpu' to build it on the CPU")
    return device


class Degradation:
    """Base degradation operator."""

    # Family B operators (noise / mix / fade-generation) interpolate toward an
    # explicit endpoint ``x_end`` that the caller must supply.
    requires_x_end: bool = False

    def __init__(self, timesteps: int):
        self.timesteps = int(timesteps)

    def to(self, device: torch.device | str) -> "Degradation":
        """A copy of this operator with its tables on ``device``."""
        new = copy.copy(self)
        for name, value in vars(self).items():
            if torch.is_tensor(value):
                setattr(new, name, value.to(device))
        return new

    def state(self) -> dict:
        """The operator's tensors by name: what a checkpoint keeps, as the
        JAX Trainer saves the operator pytree (colddiff/train.py:532-547)."""
        return {name: value for name, value in vars(self).items() if torch.is_tensor(value)}

    def with_state(self, state: dict, device: torch.device | str) -> "Degradation":
        """A copy holding the tensors of ``state`` (from :meth:`state`) on ``device``."""
        new = copy.copy(self)
        for name, value in state.items():
            setattr(new, name, value.to(device))
        return new

    def _levels(self, n, device: torch.device) -> torch.Tensor:
        return torch.as_tensor(n, dtype=torch.long, device=device)

    def degrade(self, x: torch.Tensor, n: torch.Tensor, *,
                x_end: Optional[torch.Tensor] = None, og: Optional[torch.Tensor] = None,
                rng=None) -> torch.Tensor:
        """Apply ``n`` degradation steps to NHWC batch ``x`` (n: integer [B]);
        ``og`` is the clean image the state came from (snow blends its
        brightness from it; the other operators ignore it), ``rng`` a state
        of :meth:`sample_rng_state`, or None."""
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

    def total(self, x: torch.Tensor, *, x_end: Optional[torch.Tensor] = None,
              og: Optional[torch.Tensor] = None, rng=None) -> torch.Tensor:
        """Fully degraded state x_T (used to initialize generation)."""
        n = torch.full((x.shape[0],), self.timesteps, dtype=torch.long,
                       device=x.device)
        return self.degrade(x, n, x_end=x_end, og=og, rng=rng)

    def reset(self, generator: Optional[torch.Generator], batch_size: int) -> "Degradation":
        """Redraw any stochastic operator state (snow fields, fade crops);
        the deterministic operators return themselves
        (``ForwardProcessBase.reset_parameters``, forward_process_impl.py:49-52)."""
        del generator, batch_size
        return self

    def sample_x_end(self, generator: Optional[torch.Generator],
                     x: torch.Tensor) -> Optional[torch.Tensor]:
        """The degradation endpoint for operators that draw their own (Family
        B); None for the deterministic operators, whose endpoint is implied."""
        del generator, x
        return None

    def sample_rng_state(self, generator: Optional[torch.Generator],
                         batch_size: int):
        """Draw the per-call randomness that ``degrade(..., rng=...)``
        consumes (the ``Random_Incremental`` fade crops redrawn at every
        q_sample call, defading_diffusion_gaussian.py:496-507); None, with
        nothing drawn, for operators that have none."""
        del generator, batch_size
        return None

    def x_end_from_xt(self, x0_bar: torch.Tensor, xt: torch.Tensor,
                      n: torch.Tensor) -> torch.Tensor:
        """Estimate the endpoint from x_t and an x0 estimate (Family B's
        ``get_x2_bar_from_xt``, denoising_diffusion_pytorch.py:377-381)."""
        raise NotImplementedError(
            f"{type(self).__name__} has no endpoint to estimate: only Family-B "
            "operators (requires_x_end) do")
