"""Row (spatial) sharding: each process of a space group holds a contiguous
block of every image's rows, and the row-coupled ops exchange what they need.

Under ``image_sharding``'s ``P('data', 'space')`` the JAX package lets
XLA's SPMD partitioner insert a halo exchange for every convolution, the
token collectives of the linear attention and the sharded-H contraction of
the degrade (colddiff/parallel/mesh.py:44-66).  Torch has no partitioner,
so each row-coupled op of the flagship path asks this module for its
exchange, inside ``parallel.image_rows`` (which sets :func:`current`):

  - :func:`halo` gives a row block ``top`` rows of the process above and
    ``bottom`` rows of the one below, zeros at the image's top and bottom
    edge (a convolution's own zero padding); its backward returns the halo
    rows' gradients to their owners, who add them;
  - :func:`gather` joins the group's blocks into the whole rows (its
    backward sums the whole gradient over the group and keeps this
    process's rows), and :func:`local` cuts this process's block out of a
    whole tensor: the thin-shard rule, where a block is thinner than the
    halo it needs (colddiff/ops/pallas/convnext_front.py:295-299), and the
    degrade's row product;
  - :func:`group_sum`, :func:`group_max` and :func:`group_mean` reduce
    over the group (the GroupNorm statistics, the token softmax, the
    losses' whole-image means);
  - :func:`conv2d` and :func:`conv_transpose2d` run a zero-padded
    convolution on a halo'd block.

Callers: the ConvNeXt and ResNet UNets' convs, fronts, attentions and
norms (``models/layers.py``, ``models/unet_resnet.py``), the degrades of
the nine operators (``ops/linop.py`` and ``operators/``: per-pixel tables
cut to this process's rows with :func:`local`) and ``ColdDiffusion``'s
losses.

Every exchange is an ``all_gather`` or ``all_reduce`` of a contiguous slab
on the space group, which gloo takes with CUDA tensors as NCCL does (gloo's
``send``/``recv`` refuse them).  Every process of a group runs the same ops
in the same order, so their collectives pair up.  Outside the context, or
on a space axis of one process, :func:`current` is None and the callers
run their plain code, bit for bit.

``collectives`` counts the exchanges by kind and by the shape of the slab
this process sends (``("halo", shape)``, ``("rows", shape)``,
``("sum", shape)``, ``("max", shape)``), so a run can show what crossed.
"""

from __future__ import annotations

import contextvars
import dataclasses
from collections import Counter
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

__all__ = ["Rows", "current", "collectives", "halo", "gather", "local", "group_sum",
           "group_max", "group_mean", "conv2d", "conv_transpose2d", "check_height"]

collectives: Counter = Counter()


@dataclasses.dataclass(frozen=True)
class Rows:
    """The space axis of ``parallel.image_rows``: its process group, this
    process's place on it and its size; a process holds rows [index h,
    (index + 1) h) of every image of H = size h rows."""

    group: Any
    index: int
    size: int


# set by parallel.image_rows when its space axis has more than one process
_SPACE: contextvars.ContextVar = contextvars.ContextVar("colddiff_torch_space", default=None)


def current() -> Optional[Rows]:
    """The enclosing ``image_rows`` context's space axis, or None: outside
    one, or on a space axis of one process, every op runs on whole images."""
    return _SPACE.get()


def _wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the collectives move it: contiguous, and in fp32 where it is
    narrower (exact for bf16 and fp16), which gloo and NCCL both reduce."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return x.float()
    return x.contiguous()


def _all_gather(slab: torch.Tensor, kind: str, rows: Rows) -> list:
    wire = _wire(slab)
    out = [torch.empty_like(wire) for _ in range(rows.size)]
    dist.all_gather(out, wire, group=rows.group)
    collectives[(kind, tuple(slab.shape))] += 1
    return [o.to(slab.dtype) for o in out]


def _all_reduce(x: torch.Tensor, op, kind: str, rows: Rows) -> torch.Tensor:
    wire = _wire(x).clone()
    dist.all_reduce(wire, op=op, group=rows.group)
    collectives[(kind, tuple(x.shape))] += 1
    return wire.to(x.dtype)


def _empty_like_layout(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """An empty tensor of ``shape`` in ``x``'s dtype and device, and in
    channels_last memory when ``x`` is (the layout the front kernel reads)."""
    fmt = (torch.channels_last if x.dim() == 4 and x.shape[1] > 1 and x.stride(1) == 1
           else torch.contiguous_format)
    return torch.empty(tuple(shape), dtype=x.dtype, device=x.device, memory_format=fmt)


def _resized(x: torch.Tensor, dim: int, n: int) -> list:
    shape = list(x.shape)
    shape[dim] = n
    return shape


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, top: int, bottom: int, dim: int, rows: Rows):
        ctx.top, ctx.bottom, ctx.dim, ctx.rows = top, bottom, dim, rows
        h = x.shape[dim]
        # this process's first `bottom` rows go to the one above, its last
        # `top` rows to the one below
        got = _all_gather(torch.cat([x.narrow(dim, 0, bottom), x.narrow(dim, h - top, top)],
                                    dim), "halo", rows)
        out = _empty_like_layout(x, _resized(x, dim, top + h + bottom))
        out.narrow(dim, top, h).copy_(x)
        above, below = out.narrow(dim, 0, top), out.narrow(dim, top + h, bottom)
        if rows.index > 0:
            above.copy_(got[rows.index - 1].narrow(dim, bottom, top))
        else:
            above.zero_()
        if rows.index < rows.size - 1:
            below.copy_(got[rows.index + 1].narrow(dim, 0, bottom))
        else:
            below.zero_()
        return out

    @staticmethod
    def backward(ctx, g):
        top, bottom, dim, rows = ctx.top, ctx.bottom, ctx.dim, ctx.rows
        h = g.shape[dim] - top - bottom
        # the halo rows' gradients go back to their owners
        got = _all_gather(torch.cat([g.narrow(dim, 0, top), g.narrow(dim, top + h, bottom)],
                                    dim), "halo", rows)
        grad = g.narrow(dim, top, h).clone()
        if rows.index < rows.size - 1 and top:  # the one below's top halo is my last rows
            grad.narrow(dim, h - top, top).add_(got[rows.index + 1].narrow(dim, 0, top))
        if rows.index > 0 and bottom:  # the one above's bottom halo is my first rows
            grad.narrow(dim, 0, bottom).add_(got[rows.index - 1].narrow(dim, top, bottom))
        return grad, None, None, None, None


def halo(x: torch.Tensor, top: int, bottom: int, dim: int) -> torch.Tensor:
    """``x``, this process's row block along ``dim``, with ``top`` rows of
    the process above and ``bottom`` of the one below (zeros past the
    image's edges); differentiable.  A block thinner than either halo
    raises: gather the rows instead (:func:`gather`)."""
    rows = current()
    if rows is None or top == bottom == 0:
        return x
    h = x.shape[dim]
    if max(top, bottom) > h:
        raise ValueError(f"a block of {h} rows cannot give a halo of {max(top, bottom)} rows: "
                         "gather the rows (spatial.gather) instead")
    return _Halo.apply(x, top, bottom, dim, rows)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, rows: Rows):
        ctx.dim, ctx.rows = dim, rows
        h = x.shape[dim]
        out = _empty_like_layout(x, _resized(x, dim, h * rows.size))
        for i, block in enumerate(_all_gather(x, "rows", rows)):
            out.narrow(dim, i * h, h).copy_(block)
        return out

    @staticmethod
    def backward(ctx, g):
        whole = _all_reduce(g, dist.ReduceOp.SUM, "sum", ctx.rows)
        return local(whole, ctx.dim, ctx.rows), None, None


def gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The group's row blocks along ``dim`` joined in order: the whole rows,
    on every process; differentiable (each process's gradient is the sum
    of the group's on its rows).  Tokens ``[B, h*W, C]`` of a block join
    along ``dim=1`` in the whole image's token order: rows are the slow
    axis of the h*W, so block r's tokens are the whole image's [r h W,
    (r + 1) h W)."""
    rows = current()
    return x if rows is None else _Gather.apply(x, dim, rows)


def local(whole: torch.Tensor, dim: int, rows: Optional[Rows] = None) -> torch.Tensor:
    """This process's row block of ``whole`` along ``dim`` (a view)."""
    rows = rows or current()
    if rows is None:
        return whole
    h = whole.shape[dim] // rows.size
    return whole.narrow(dim, rows.index * h, h)


class _GroupSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, rows: Rows):
        ctx.rows = rows
        return _all_reduce(x, dist.ReduceOp.SUM, "sum", rows)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, dist.ReduceOp.SUM, "sum", ctx.rows), None


def group_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the space group (``x`` itself outside it); differentiable."""
    rows = current()
    return x if rows is None else _GroupSum.apply(x, rows)


def group_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over the space group, detached (a
    softmax's shift, which its gradient does not see)."""
    rows = current()
    return x if rows is None else _all_reduce(x.detach(), dist.ReduceOp.MAX, "max", rows)


class _SeededSum(torch.autograd.Function):
    """The group sum of a value that every process then holds and seeds
    alike: its backward passes the upstream gradient on as it is."""

    @staticmethod
    def forward(ctx, x, rows: Rows):
        return _all_reduce(x, dist.ReduceOp.SUM, "sum", rows)

    @staticmethod
    def backward(ctx, g):
        return g, None


def group_mean(x: torch.Tensor, dim: Sequence[int], *, loss: bool = False) -> torch.Tensor:
    """``x.mean(dim, keepdim=True)`` over the whole images, where ``dim``
    holds the row axis: the group's block means, averaged (the blocks are
    of one size).

    The gradient's scale.  Autograd through these exchanges differentiates
    the sum, over the group, of what each process seeds: a group sum's
    backward sums the upstream gradients, right for a mean that flows on
    into each process's block (a norm's statistics, blur's collapse), where
    each process's upstream gradient is its block's part.  A loss is not
    such a part: every process holds the same value and seeds it with 1,
    and summing those seeds would make every gradient S times the
    loss's.  So ``loss=True`` passes the upstream gradient on unsummed:
    each process's parameter gradients are then its block's part of the
    loss's, and their sum over the group equals one process's gradients
    on the whole images."""
    rows = current()
    mean = x.mean(dim=tuple(dim), keepdim=True)
    if rows is None:
        return mean
    total = _SeededSum.apply(mean, rows) if loss else group_sum(mean)
    return total / rows.size


def _rows_only(conv: nn.Module) -> None:
    if conv.padding_mode != "zeros" or isinstance(conv.padding, str) \
            or tuple(conv.dilation) != (1, 1):
        raise NotImplementedError(f"row sharding takes zero-padded, undilated convolutions "
                                  f"with numeric padding, not {conv}")


def conv2d(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` on this process's rows of NCHW ``x``: the conv's row
    padding p comes as a halo of p rows above and ``k - s - p`` below, and
    the conv runs with no row padding, so block r's output is rows [r h / s,
    (r + 1) h / s) of the whole output (the 3x3 convs: 1 and 1; the 4x4
    stride-2 Downsample: 1 and 1)."""
    if current() is None:
        return nn.Conv2d.forward(conv, x)
    _rows_only(conv)
    k, s, p = conv.kernel_size[0], conv.stride[0], conv.padding[0]
    if x.shape[2] % s:
        raise ValueError(f"a block of {x.shape[2]} rows does not divide by the stride {s}")
    xe = halo(x, p, max(0, k - s - p), 2)
    return F.conv2d(xe, conv.weight, conv.bias, conv.stride, (0, conv.padding[1]),
                    conv.dilation, conv.groups)


def conv_transpose2d(conv: nn.ConvTranspose2d, x: torch.Tensor) -> torch.Tensor:
    """``conv(x)`` on this process's rows of NCHW ``x``: input row i reaches
    output rows [s i - p, s i - p + k), so block r's outputs need ceil((k -
    1 - p) / s) rows above and floor((p - 1) / s) + 1 below; the conv runs
    with no row padding on the halo'd block, and rows [s top + p, s top + p
    + s h) of its output are block r's (the 4x4 stride-2 Upsample: halos 1
    and 1, rows [3, 3 + 2h))."""
    if current() is None:
        return nn.ConvTranspose2d.forward(conv, x)
    _rows_only(conv)
    k, s, p = conv.kernel_size[0], conv.stride[0], conv.padding[0]
    if conv.output_padding[0]:
        raise NotImplementedError("row sharding takes no output_padding on the rows")
    top, bottom = -((p + 1 - k) // s), (p - 1) // s + 1
    h = x.shape[2]
    y = F.conv_transpose2d(halo(x, top, bottom, 2), conv.weight, conv.bias, conv.stride,
                           (0, conv.padding[1]), (0, conv.output_padding[1]), conv.groups,
                           conv.dilation)
    return y.narrow(2, s * top + p, s * h)


def check_height(h: int, multiple: int, what: str) -> None:
    """Raise unless a block of ``h`` rows makes images of H = space x h rows
    that divide by space x ``multiple`` (every level's block then holds
    whole rows, the same count on every process)."""
    rows = current()
    if rows is not None and h % multiple:
        raise ValueError(f"{what} under row sharding needs H divisible by space * "
                         f"{multiple} = {rows.size * multiple}, got H = {h * rows.size}")

