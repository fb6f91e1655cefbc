"""Diffusion configuration, the forward process and the training losses.

Port of ``ColdDiffusion`` in ``colddiff/diffusion.py``: the degradation,
the routine names, ``q_sample``, ``loss_func``, ``p_losses`` for the
deterministic routines (``Final``, ``Step``, ``Step_Gradient``,
``Gradient_norm``) and ``loss``.  The routines that draw noise
(``Final_small_noise``, ``Final_random_mean[_and_actual]``) raise
``NotImplementedError`` (ROADMAP.md section 1, item 10).

Time convention: ``t`` is the reference's step *index* in [0, T);
``q_sample(x, t)`` degrades by ``t + 1`` steps, and ``t = -1`` is a clean
passthrough (snowification diffusion.py:344-388).

Randomness: ``x_end`` is a Family-B operator's endpoint, and ``rng`` the
operator's drawn state (``op.sample_rng_state``), which ``loss`` draws once
and hands to every ``q_sample`` of that loss, as the JAX loss hands one key
to both (colddiff/diffusion.py:103-120).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from .operators.base import Degradation
from .ops.image import quantize_uint8

__all__ = ["ColdDiffusion", "DenoiseFn"]

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

_RNG_ROUTINES = ("Final_small_noise", "Final_random_mean",
                 "Final_random_mean_and_actual")


@dataclass(frozen=True)
class ColdDiffusion:
    """Degradation schedule + loss/sampling configuration.

    The UNet is not stored here; losses and samplers take a
    ``denoise_fn(x, t)``.
    """

    op: Degradation
    image_size: int = 32
    channels: int = 3
    loss_type: str = "l1"
    train_routine: str = "Final"
    sampling_routine: str = "default"
    discrete: bool = False
    recon_noise_std: float = 0.0

    @property
    def num_timesteps(self) -> int:
        return self.op.timesteps

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor, *,
                 x_end: Optional[torch.Tensor] = None, rng=None) -> torch.Tensor:
        """Degrade ``x_start`` to per-sample level ``t`` (index; -1 = clean)."""
        n = torch.clamp(t + 1, 0, self.num_timesteps)
        y = self.op.degrade(x_start, n, x_end=x_end, rng=rng)
        if self.discrete:
            # 8-bit quantization of the training input
            # (deblurring_diffusion_pytorch.py:954-958)
            y = quantize_uint8(y)
        clean = (t < 0).reshape(-1, *([1] * (x_start.dim() - 1))).to(y.device)
        return torch.where(clean, x_start, y)

    def loss_func(self, pred: torch.Tensor, true: torch.Tensor) -> torch.Tensor:
        if self.loss_type == "l1":
            return (pred - true).abs().mean()
        if self.loss_type == "l2":
            return (pred - true).square().mean()
        if self.loss_type == "sqrt":
            return (pred - true).abs().mean().sqrt()
        raise NotImplementedError(self.loss_type)

    def p_losses(self, denoise_fn: DenoiseFn, x_start: torch.Tensor,
                 t: torch.Tensor, *, x_end: Optional[torch.Tensor] = None,
                 rng=None) -> torch.Tensor:
        """Training loss at per-sample levels ``t`` (colddiff/diffusion.py:86-132)."""
        routine = self.train_routine
        if routine in _RNG_ROUTINES:
            raise NotImplementedError(
                f"train routine '{routine}' draws noise and is not ported yet; "
                "see ROADMAP.md section 1, item 10")
        x_t = self.q_sample(x_start, t, x_end=x_end, rng=rng)
        if routine == "Final":
            return self.loss_func(denoise_fn(x_t, t), x_start)
        if routine in ("Step", "Step_Gradient"):
            # predict x_{t-1} (Step) or x_{t-1} - x_t (Step_Gradient)
            # (snowification diffusion.py:416-429); t = 0 targets the clean image
            x_tm1 = self.q_sample(x_start, t - 1, x_end=x_end, rng=rng)
            target = x_tm1 if routine == "Step" else x_tm1 - x_t
            return self.loss_func(denoise_fn(x_t, t), target)
        if routine == "Gradient_norm":
            # predict the unit degradation direction
            # (resolution_diffusion_pytorch.py:734-748)
            grad = x_t - x_start
            norm = grad.reshape(grad.shape[0], -1).norm(dim=1)
            grad_n = grad / (norm.reshape(-1, 1, 1, 1) + 1e-5)
            return self.loss_func(denoise_fn(x_t, t), grad_n)
        raise NotImplementedError(routine)

    def loss(self, denoise_fn: DenoiseFn, x_start: torch.Tensor,
             generator: Optional[torch.Generator], *,
             t: Optional[torch.Tensor] = None, x_end: Optional[torch.Tensor] = None,
             rng=None) -> torch.Tensor:
        """Draw t ~ U[0, T) per sample from ``generator``, then the operator's
        state (``op.sample_rng_state``, nothing for a deterministic operator),
        and compute the training loss (reference ``forward``,
        deblurring_diffusion_pytorch.py:977-981).  A given ``t`` or ``rng``
        replaces its draw; ``x_end`` is the Family-B endpoint."""
        b = x_start.shape[0]
        if t is None:
            t = torch.randint(0, self.num_timesteps, (b,), generator=generator,
                              device=x_start.device)
        if rng is None:
            rng = self.op.sample_rng_state(generator, b)
        return self.p_losses(denoise_fn, x_start, t, x_end=x_end, rng=rng)
