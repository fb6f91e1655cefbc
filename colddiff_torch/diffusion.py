"""Diffusion configuration, the forward process and the training losses.

Port of ``ColdDiffusion`` in ``colddiff/diffusion.py``: the degradation,
the routine names, ``q_sample``, ``loss_func``, ``p_losses`` for every
training routine (``Final``, ``Final_small_noise``, ``Final_random_mean``,
``Final_random_mean_and_actual``, ``Step``, ``Step_Gradient``,
``Gradient_norm``) and ``loss``.

Time convention: ``t`` is the reference's step *index* in [0, T);
``q_sample(x, t)`` degrades by ``t + 1`` steps, and ``t = -1`` is a clean
passthrough (snowification diffusion.py:344-388).

Randomness: ``x_end`` is a Family-B operator's endpoint, and ``rng`` the
operator's drawn state (``op.sample_rng_state``), which ``loss`` draws once
and hands to every ``q_sample`` of that loss, as the JAX loss hands one key
to both (colddiff/diffusion.py:103-120).  The noise routines draw their
noise from a ``torch.Generator`` (``loss`` hands down its own); a given
``noise`` replaces the draw, so the tests replay the JAX normals.  Inside
``parallel.batch_rows`` each batch-shaped draw (t, the noise) is made for
the global batch, and this process keeps its rows.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from .operators.base import Degradation
from .ops.image import quantize_uint8
from .parallel.mesh import draw_rows

__all__ = ["ColdDiffusion", "DenoiseFn", "X0_ROUTINES"]

DenoiseFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

# routines whose model predicts x0 (the three noise routines draw noise)
X0_ROUTINES = ("Final", "Final_small_noise", "Final_random_mean",
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
        y = self.op.degrade(x_start, n, x_end=x_end, og=x_start, rng=rng)
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
                 rng=None, generator: Optional[torch.Generator] = None,
                 noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Training loss at per-sample levels ``t`` (colddiff/diffusion.py:86-132).

        The noise routines draw from ``generator``: ``Final_small_noise`` a
        [B, H, W, C] normal, the ``Final_random_mean`` routines the [B, 1, 1,
        C] new channel means.  A given ``noise`` is that draw."""
        routine = self.train_routine
        if routine in X0_ROUTINES:
            if routine == "Final_small_noise":
                # resolution_diffusion_pytorch.py:671-676; the noisy image is
                # also the target
                x_start = x_start + 0.001 * self._normal(noise, x_start.shape, x_start,
                                                         generator)
            mean_shape = (x_start.shape[0], 1, 1, x_start.shape[-1])
            if routine == "Final_random_mean":
                x_start = self._randomize_mean(
                    x_start, self._normal(noise, mean_shape, x_start, generator))
            x_t = self.q_sample(x_start, t, x_end=x_end, rng=rng)
            loss = self.loss_func(denoise_fn(x_t, t), x_start)
            if routine == "Final_random_mean_and_actual":
                # a second loss on the mean-randomized image, through the
                # same operator state (JAX passes one key to both)
                x2 = self._randomize_mean(
                    x_start, self._normal(noise, mean_shape, x_start, generator))
                x2_t = self.q_sample(x2, t, x_end=x_end, rng=rng)
                loss = loss + self.loss_func(denoise_fn(x2_t, t), x2)
            return loss
        x_t = self.q_sample(x_start, t, x_end=x_end, rng=rng)
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

    def _normal(self, noise: Optional[torch.Tensor], shape, x: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        """``noise``, or a standard normal of ``shape`` in ``x``'s dtype
        drawn from ``generator``."""
        if noise is not None:
            if tuple(noise.shape) != tuple(shape):
                raise ValueError(f"train routine '{self.train_routine}' takes noise of "
                                 f"shape {tuple(shape)}, got {tuple(noise.shape)}")
            return noise.to(x.dtype)
        if generator is None:
            raise ValueError(f"train routine '{self.train_routine}' draws noise: it "
                             "needs a torch.Generator or the noise itself")
        return draw_rows(lambda n: torch.randn((n, *shape[1:]), generator=generator,
                                               dtype=x.dtype, device=x.device), shape[0])

    @staticmethod
    def _randomize_mean(x: torch.Tensor, new_mean: torch.Tensor) -> torch.Tensor:
        """Replace each image's per-channel spatial mean with ``new_mean``
        [B, 1, 1, C] (resolution_diffusion_pytorch.py:681-690)."""
        return x - x.mean(dim=(1, 2), keepdim=True) + new_mean

    def loss(self, denoise_fn: DenoiseFn, x_start: torch.Tensor,
             generator: Optional[torch.Generator], *,
             t: Optional[torch.Tensor] = None, x_end: Optional[torch.Tensor] = None,
             rng=None, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Draw t ~ U[0, T) per sample from ``generator``, then the operator's
        state (``op.sample_rng_state``, nothing for a deterministic operator),
        then a noise routine's noise, and compute the training loss (reference
        ``forward``, deblurring_diffusion_pytorch.py:977-981).  A given ``t``,
        ``rng`` or ``noise`` replaces its draw; ``x_end`` is the Family-B
        endpoint."""
        b = x_start.shape[0]
        if t is None:
            t = draw_rows(lambda n: torch.randint(0, self.num_timesteps, (n,),
                                                  generator=generator, device=x_start.device), b)
        if rng is None:
            rng = self.op.sample_rng_state(generator, b)
        return self.p_losses(denoise_fn, x_start, t, x_end=x_end, rng=rng,
                             generator=generator, noise=noise)
