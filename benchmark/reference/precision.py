"""Operand roundings for the benchmark's control: the reference computed one
precision step below what a configuration states.

A configuration that computes its UNet in bf16 is controlled with fp8 (e4m3,
one scale a tensor) operands, and fp32 degrade math with TF32 operands (10
mantissa bits).  Both are emulated: the operand is rounded and the product
runs in fp32, which is what a tensor core does with such operands, so the
control reads the same on a card and on a CPU.  The rounding passes
gradients through unchanged (a straight-through estimator), so a control
training step rounds its forward and keeps an exact backward.
"""

from __future__ import annotations

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def _straight_through(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x + (y - x).detach() if x.requires_grad else y


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8_e4m3fn after scaling its largest |x| to 448."""
    with torch.no_grad():
        scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
        y = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return _straight_through(x, y)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32's 10 mantissa bits (to nearest, ties away)."""
    with torch.no_grad():
        bits = x.detach().contiguous().view(torch.int32)
        y = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return _straight_through(x, y)
