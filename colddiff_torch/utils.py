"""Small shared utilities: the EMA update, the bf16 parameter cast, chunked
model calls, cycling, image grids and GIFs.

Port of ``colddiff/utils.py``.  ``cycle``, ``to_uint8_grid``,
``save_image_grid``, ``add_title_bar``, ``save_gif`` and ``create_folder``
are numpy/PIL copies of the originals; ``ema_update``, ``bf16_params`` and
``apply_in_chunks`` work on torch tensors.
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
    "apply_in_chunks",
    "cycle",
    "to_uint8_grid",
    "save_image_grid",
    "add_title_bar",
    "save_gif",
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


class _BF16Copies(torch.autograd.Function):
    """bf16 copies of floating tensors as one autograd node: one foreach copy
    forward, and one back into each tensor's own dtype.  Per tensor, a
    ``.to`` would cost a node and a launch each way, and the host's share
    of a step grows with the parameter count (566 tensors in ADM)."""

    @staticmethod
    def forward(ctx, *tensors):
        ctx.set_materialize_grads(False)
        ctx.dtypes = [t.dtype for t in tensors]
        out = [torch.empty_like(t, dtype=torch.bfloat16) for t in tensors]
        torch._foreach_copy_(out, list(tensors))
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        got = [i for i, g in enumerate(grads) if g is not None]
        out = [None] * len(grads)
        for i in got:
            out[i] = torch.empty_like(grads[i], dtype=ctx.dtypes[i])
        if got:
            torch._foreach_copy_([out[i] for i in got], [grads[i] for i in got])
        return tuple(out)


def bf16_params(named_params: Iterable[Tuple[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """``{name: p.to(bfloat16)}`` for the floating tensors of ``named_params``.

    The caller keeps the fp32 masters; the cast is differentiable, so the
    gradients of a forward run on the copies land on the masters (all at
    once, when the backward has reached every copy: :class:`_BF16Copies`).
    Integer tensors are left out (``functional_call`` then uses the
    module's own).  This is the JAX package's bf16 recipe: cast the
    parameters and the input, not per-op autocast."""
    named = [(name, p) for name, p in named_params if p.is_floating_point()]
    if not named:
        return {}
    return dict(zip((name for name, _ in named), _BF16Copies.apply(*(p for _, p in named))))


def apply_in_chunks(fn, chunk_size: int, *args: torch.Tensor) -> torch.Tensor:
    """``fn(*args)`` over the batch in sequential chunks of ``chunk_size``.

    The JAX package chunks big eval batches because XLA schedules the 128 px
    UNet poorly above B=16 (colddiff/utils.py:64-92); a ``lax.map`` needs
    equal chunks, so it zero-pads the last one.  Here the loop runs eagerly,
    so the last chunk is simply the rest of the batch: the rows are
    independent, and the output holds the batch's ``b`` rows."""
    b = args[0].shape[0]
    if b <= chunk_size:
        return fn(*args)
    return torch.cat([fn(*(a[lo:lo + chunk_size] for a in args))
                      for lo in range(0, b, chunk_size)])


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


def add_title_bar(frame: np.ndarray, titles: list[str]) -> np.ndarray:
    """10px black border + 20px magenta title strip with evenly spaced texts
    (reference Trainer.add_title, snowification/diffusion/diffusion.py:682-706)."""
    from PIL import Image, ImageDraw

    frame = np.pad(frame, ((10, 10), (10, 10), (0, 0)))
    bar = np.zeros((20, frame.shape[1], 3), np.uint8)
    bar[:] = (180, 0, 255)  # the reference's BGR (255, 0, 180), as RGB
    img = Image.fromarray(np.concatenate([bar, frame], axis=0))
    draw = ImageDraw.Draw(img)
    n = max(len(titles), 1)
    for i, title in enumerate(titles):
        x = i * (frame.shape[1] // n) + frame.shape[1] // (2 * n)
        draw.text((x, 4), str(title), fill=(0, 0, 0))
    return np.asarray(img)


def save_gif(frames: list[np.ndarray], path: str | os.PathLike, fps: int = 5,
             titles: bool = False) -> None:
    """Save a list of [B, H, W, C] batches in [-1, 1] as an animated grid GIF
    (reference save_gif, snowification/diffusion/diffusion.py:764-807).
    ``titles=True`` adds the reference's per-frame step-index title bar."""
    from PIL import Image

    Path(path).parent.mkdir(parents=True, exist_ok=True)
    grids = [to_uint8_grid(f) for f in frames]
    if titles:
        grids = [add_title_bar(g, [str(i)]) for i, g in enumerate(grids)]
    pil = [Image.fromarray(g) for g in grids]
    pil[0].save(
        path, save_all=True, append_images=pil[1:], duration=int(1000 / fps), loop=0
    )


def create_folder(path: str | os.PathLike) -> None:
    Path(path).mkdir(parents=True, exist_ok=True)
