"""Small shared utilities: the EMA update, the bf16 parameter cast, cycling,
image grids.

Port of ``colddiff/utils.py``.  ``cycle``, ``to_uint8_grid``,
``save_image_grid`` and ``create_folder`` are numpy/PIL copies of the
originals; ``ema_update`` and ``bf16_params`` work on torch tensors.
``apply_in_chunks`` and ``save_gif`` are not ported yet.
"""

from __future__ import annotations

import math
import os
from pathlib import Path
from typing import Dict, Iterable, Iterator, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "ema_update",
    "bf16_params",
    "cycle",
    "to_uint8_grid",
    "save_image_grid",
    "create_folder",
]


@torch.no_grad()
def ema_update(ema: Sequence[torch.Tensor], new: Sequence[torch.Tensor],
               decay: float) -> None:
    """In place: ``e = e * decay + p * (1 - decay)`` for each pair
    (reference EMA.update_average, deblurring_diffusion_pytorch.py:66-81).

    The JAX formula, two products and a sum, not ``lerp_``, which rounds
    differently."""
    ema, new = list(ema), list(new)
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, torch._foreach_mul(new, 1.0 - decay))


def bf16_params(named_params: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """``{name: p.to(bfloat16)}`` for the floating tensors of ``named_params``.

    The caller keeps the fp32 masters; the cast is differentiable, so the
    gradients of a forward run on the copies land on the masters.  Integer
    tensors are left out (``functional_call`` then uses the module's own).
    This is the JAX package's bf16 recipe: cast the parameters and the
    input, not per-op autocast."""
    return {name: p.to(torch.bfloat16) for name, p in named_params
            if p.is_floating_point()}


def cycle(iterable: Iterable) -> Iterator:
    while True:
        empty = True
        for item in iterable:
            empty = False
            yield item
        if empty:
            # a drop_last loader over a too-small dataset yields no batches;
            # spinning here would hang the caller silently
            raise ValueError(
                "cycle(): underlying iterable produced no items "
                "(dataset smaller than the loader batch size?)")


def to_uint8_grid(images: np.ndarray, nrow: int = 6) -> np.ndarray:
    """[B, H, W, C] in [-1, 1] -> one [gH, gW, 3] uint8 grid (2px padding),
    matching torchvision save_image((x+1)*0.5, nrow=6) usage in the Trainers."""
    images = np.asarray(images)
    b, h, w, c = images.shape
    if c == 1:
        images = np.repeat(images, 3, axis=-1)
        c = 3
    ncol = min(nrow, b)
    nrw = math.ceil(b / ncol)
    pad = 2
    grid = np.ones((nrw * (h + pad) + pad, ncol * (w + pad) + pad, 3), dtype=np.float32)
    for i in range(b):
        r, cl = divmod(i, ncol)
        y0 = pad + r * (h + pad)
        x0 = pad + cl * (w + pad)
        grid[y0 : y0 + h, x0 : x0 + w] = (images[i] + 1.0) * 0.5
    return (np.clip(grid, 0.0, 1.0) * 255).astype(np.uint8)


def save_image_grid(images: np.ndarray, path: str | os.PathLike, nrow: int = 6) -> None:
    from PIL import Image

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(to_uint8_grid(images, nrow)).save(path)


def create_folder(path: str | os.PathLike) -> None:
    Path(path).mkdir(parents=True, exist_ok=True)
