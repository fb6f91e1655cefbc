"""Plain copies of the blur degrade, the ``x0_step_down`` loop, the ``Final``
l1 loss, Adam and the EMA, as the reference Cold Diffusion code defines them.

The blur matrices are rebuilt here from the routine, the kernel size and
std and the image size (deblurring_diffusion_pytorch.py:348-389): each step
is a 1-D Gaussian cross-correlation with reflect padding, applied along
rows and columns, so n steps are ``P[n] x P[n]^T`` with ``P[n] = A_{n-1}
... A_0``.  Degrades run in fp32 matmuls through ``q`` (the identity, or
the control's rounding of the operands).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import numpy as np
import torch

from .models import Cast, identity


def gaussian_kernel_1d(size: int, sigma: float) -> np.ndarray:
    x = np.arange(size, dtype=np.float64)
    g = np.exp(-((x - size // 2) ** 2) / (2.0 * float(sigma) ** 2))
    return (g / g.sum()).astype(np.float32)


def _reflect(i: int, n: int) -> int:
    while i < 0 or i >= n:
        i = -i if i < 0 else 2 * n - 2 - i
    return i


def reflect_conv_matrix(kernel: np.ndarray, n: int) -> np.ndarray:
    """[n, n] float64 matrix of a 1-D cross-correlation, padding len//2 by
    reflection (torch ``padding_mode='reflect'``)."""
    k = np.asarray(kernel, dtype=np.float64)
    p = (len(k) - 1) // 2
    m = np.zeros((n, n))
    for i in range(n):
        for j, w in enumerate(k):
            m[i, _reflect(i + j - p, n)] += w
    return m


def blur_steps(routine: str, timesteps: int, kernel_size: int,
               kernel_std: float) -> list[tuple[int, float]]:
    """(kernel size, sigma) of each step of the reflect-padded routines."""
    if routine == "Exponential_reflect":
        return [(kernel_size, float(np.exp(kernel_std * i))) for i in range(timesteps)]
    if routine == "Special_6_routine":
        return [(11, i / 100.0 + 0.35) for i in range(timesteps)]
    raise ValueError(f"no reference for blur routine {routine!r}")


def blur_matrices(degradation: dict, image_size: int, device) -> torch.Tensor:
    """[T+1, S, S] fp32 cumulative blur matrices, ``P[0] = I``."""
    steps = blur_steps(degradation["blur_routine"], degradation["time_steps"],
                       degradation["blur_size"], degradation["blur_std"])
    out = [np.eye(image_size)]
    for size, sigma in steps:
        out.append(reflect_conv_matrix(gaussian_kernel_1d(size, sigma), image_size) @ out[-1])
    return torch.as_tensor(np.stack(out).astype(np.float32), device=device)


def degrade(cum: torch.Tensor, x: torch.Tensor, n: torch.Tensor, q: Cast = identity):
    """NHWC ``x`` blurred by ``n[b]`` steps: ``P x P^T`` per channel, fp32."""
    m = q(cum[n])
    y = torch.einsum("bij,bjwc->biwc", m, q(x))
    return torch.einsum("bij,bhjc->bhic", m, q(y))


def x0_step_down(model: Callable, cum: torch.Tensor, clean: torch.Tensor,
                 q_unet: Cast = identity, q_degrade: Cast = identity):
    """Algorithm 2 from level T (deblurring_diffusion_pytorch.py:436-451):
    ``x_{t-1} = x_t - D(x0_hat, t) + D(x0_hat, t-1)``.  Returns (x_T, the
    first x0_hat, the final image)."""
    steps = cum.shape[0] - 1
    b = clean.shape[0]
    xt = degrade(cum, clean, torch.full((b,), steps, device=clean.device), q_degrade)
    x, direct = xt, None
    for k in range(steps):
        n = torch.full((b,), steps - k, device=clean.device)
        x0 = model(x, n - 1, q_unet)
        direct = x0 if direct is None else direct
        x = x - degrade(cum, x0, n, q_degrade) + degrade(cum, x0, n - 1, q_degrade)
    return xt, direct, x


def final_l1_loss(model: Callable, cum: torch.Tensor, x: torch.Tensor, t: torch.Tensor,
                  rows: int, q_unet: Cast = identity, q_degrade: Cast = identity):
    """The ``Final`` routine's l1 loss of microbatch ``x`` at levels ``t``
    (index; the input is blurred ``t + 1`` steps), its gradients left on the
    parameters; run ``rows`` images at a time.  Returns the loss (a float)."""
    total = 0.0
    for lo in range(0, x.shape[0], rows):
        xb, tb = x[lo:lo + rows], t[lo:lo + rows]
        xt = degrade(cum, xb, (tb + 1).clamp(0, cum.shape[0] - 1), q_degrade)
        part = (model(xt, tb, q_unet) - xb).abs().sum() / x.numel()
        part.backward()
        total += float(part.detach())
    return total


class Adam:
    """Adam (Kingma & Ba) on fp32 tensors, the update of ``torch.optim.Adam``."""

    def __init__(self, params: Sequence[torch.Tensor], lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params = list(params)
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(self.b1).add_(g, alpha=1 - self.b1)
            v.mul_(self.b2).add_(g * g, alpha=1 - self.b2)
            p.sub_(self.lr / c1 * m / (v.sqrt() / math.sqrt(c2) + self.eps))


@torch.no_grad()
def ema(shadow: Sequence[torch.Tensor], params: Sequence[torch.Tensor], step: int,
        decay: float, every: int, start: int) -> None:
    """The reference EMA after optimizer step ``step``: every ``every``
    steps, a copy of the parameters before ``start``, the decayed average
    after it (deblurring_diffusion_pytorch.py:66-81, 1160-1170)."""
    if step % every:
        return
    for e, p in zip(shadow, params):
        if step < start:
            e.copy_(p)
        else:
            e.mul_(decay).add_(p, alpha=1 - decay)
