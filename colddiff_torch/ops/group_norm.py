"""GroupNorm + affine + optional swish of [B, C, H, W] images, one pass on the card.

    out = swish(round(round(GN(x) * gamma) + beta))

with the statistics in fp32 and ``GN(x)`` rounded to ``x``'s dtype before the
affine (the JAX package's order, ``colddiff/models/layers.py``
``group_norm_swish``; ``F.group_norm``'s own affine would run before the
cast).  ``eps`` is added to the biased variance.

On a CUDA tensor the call launches the hand-written Hopper kernel of
``colddiff_torch/csrc/group_norm_swish.cu``, which replaces no TPU kernel
(the JAX package leaves its GroupNorm to XLA's fusion) and exists because
eager PyTorch ran this chain as eight kernels, 21.1 of a 39.3 ms CIFAR-10
ResNet call on the H100 (``PERF.md``).  It reads the channels_last ``x`` once
and writes a new channels_last output in ``x``'s dtype (float32 or
bfloat16), with the rounding points of :func:`group_norm_swish_plain`: the
order in which the statistics are summed is the only difference, but for
swish in bf16, which takes the hardware's exp2 and reciprocal and rounds as
``F.silu`` does (the source says where it does not).  The form
follows the shape (:func:`kernel_form`): the image held in the registers of
one block or of a thread block cluster, or, for images larger than a
cluster holds, a streaming form that reads ``x`` twice.  A CUDA tensor never
falls back to the plain version: the kernel launches or the call raises.

On a CPU tensor the call runs :func:`group_norm_swish_plain`, which the tests
hold against the JAX package and ``chip_smoke.py`` holds the kernel against.
The backward, on either device, recomputes through the plain version and
saves only the inputs; its gradients are autograd's through the plain
version.

Inside a row-sharded ``parallel.image_rows`` the (C/G, H, W) statistics are
the whole images': the mean, then the mean of the squared deviations from
it (what ``jnp.var`` computes), two group means and so two all-reduces a
norm; ``F.group_norm`` and the kernel take no outside statistics, so that
path normalizes the block explicitly in plain PyTorch.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from ..parallel import spatial
from . import _build

__all__ = ["group_norm_swish", "group_norm_swish_plain", "kernel_form"]

MAX_VECTORS = 512  # the most 16-byte vectors of channels a pixel may have (kThreads)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _stat_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.promote_types(x.dtype, torch.float32)


def _affine_swish(xn, gamma, beta, swish: bool):
    xn = xn * gamma.view(1, -1, 1, 1) + beta.view(1, -1, 1, 1)
    return F.silu(xn) if swish else xn


def group_norm_swish_plain(x, gamma, beta, num_groups: int, eps: float = 1e-6,
                           swish: bool = True):
    """The plain PyTorch version: ``F.group_norm`` on a copy in at least
    fp32, cast back to ``x``'s dtype, then ``* gamma + beta`` and swish."""
    xn = F.group_norm(x.to(_stat_dtype(x)), num_groups, eps=eps).to(x.dtype)
    return _affine_swish(xn, gamma, beta, swish)


def _row_sharded(x, gamma, beta, num_groups: int, eps: float, swish: bool):
    xg = x.to(_stat_dtype(x)).unflatten(1, (num_groups, -1))  # [B, G, C/G, h, W]
    dev = xg - spatial.group_mean(xg, (2, 3, 4))
    var = spatial.group_mean(dev.square(), (2, 3, 4))
    xn = (dev * torch.rsqrt(var + eps)).flatten(1, 2).to(x.dtype)
    return _affine_swish(xn, gamma, beta, swish)


@functools.cache
def _kernel():
    fn = _build.load_library().colddiff_group_norm_swish
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def kernel_form(hw: int, c: int, dtype: torch.dtype) -> dict:
    """The form the kernel takes for images of ``hw`` pixels and ``c``
    channels in ``dtype``: ``threads`` a block, 16-byte ``vectors`` a thread,
    ``blocks`` an image (a cluster when > 1), ``pixels`` a block and
    ``chunks`` a block (> 1: the streaming form, which reads x twice).
    Loads (and builds) the library."""
    fn = _build.load_library().colddiff_group_norm_swish_config
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    cfg = (ctypes.c_int * 5)()
    if dtype not in _DTYPE_CODE or fn(hw, c, _DTYPE_CODE[dtype], cfg) != 0:
        raise ValueError(f"group_norm_swish kernel does not take C={c} in {dtype}")
    return dict(zip(("threads", "vectors", "blocks", "pixels", "chunks"), cfg))


@functools.lru_cache(maxsize=256)
def _check(x_kind, shape, channels_last: bool, dtype, device, vectors,
           num_groups: int) -> None:
    """Raise unless the kernel takes x of ``shape`` and ``dtype`` with
    ``vectors``, the (name, type, shape, dtype, device) of gamma and beta.
    Cached, since a model passes the same few shapes; a refusal is not
    cached and raises every time."""
    for name, kind in (("x", x_kind), *((v[0], v[1]) for v in vectors)):
        if issubclass(kind, DTensor):
            raise TypeError(f"group_norm_swish: {name} is a DTensor, and the kernel reads "
                            "whole tensors: gather it first (fully_shard's forward does)")
    if len(shape) != 4:
        raise ValueError(f"group_norm_swish: x must be [B, C, H, W], got {tuple(shape)}")
    c = shape[1]
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"group_norm_swish kernel takes float32 or bfloat16, got {dtype}")
    if num_groups <= 0 or c % num_groups != 0:
        raise ValueError(f"group_norm_swish: C={c} does not split into {num_groups} groups")
    per_vector = 16 // dtype.itemsize
    if c % per_vector != 0 or c // per_vector > MAX_VECTORS:
        raise ValueError(f"group_norm_swish kernel takes C a multiple of {per_vector} up to "
                         f"{per_vector * MAX_VECTORS} in {dtype} (16-byte vectors of "
                         f"channels), got {c}")
    for name, _, t_shape, t_dtype, t_device in vectors:
        if tuple(t_shape) != (c,):
            raise ValueError(f"group_norm_swish: {name} has shape {tuple(t_shape)}, "
                             f"kernel takes ({c},)")
        if t_device != device:
            raise ValueError(f"group_norm_swish: {name} is on {t_device}, x on {device}")
        if torch.promote_types(t_dtype, dtype) != dtype:
            raise TypeError(f"group_norm_swish: {name} is {t_dtype}, wider than x's "
                            f"{dtype}: the kernel computes the affine in x's dtype")
    if not channels_last:
        raise ValueError("group_norm_swish kernel needs x in torch.channels_last memory")


def _pairs(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """gamma or beta as the kernel reads it, in pairs of ``dtype``: copied
    only when it is in another dtype, strided or at an odd element (a view
    of a flat buffer)."""
    if t.dtype == dtype and t.is_contiguous() and t.data_ptr() % 4 == 0:
        return t
    return t.to(dtype, memory_format=torch.contiguous_format, copy=True)


def _launch(x, gamma, beta, num_groups: int, eps: float, swish: bool) -> torch.Tensor:
    """Check what the kernel takes, then launch it on the current stream."""
    _check(type(x), x.shape, x.is_contiguous(memory_format=torch.channels_last), x.dtype,
           x.device,
           tuple((name, type(t), t.shape, t.dtype, t.device)
                 for name, t in (("gamma", gamma), ("beta", beta))), num_groups)
    if x.data_ptr() % 16 != 0:
        raise ValueError("group_norm_swish kernel needs x 16-byte aligned (a view at an "
                         "offset is not)")
    gamma, beta = _pairs(gamma, x.dtype), _pairs(beta, x.dtype)
    bsz, c, hgt, wid = x.shape
    out = torch.empty_like(x, memory_format=torch.channels_last)
    index = x.get_device()
    with (contextlib.nullcontext() if index == torch.cuda.current_device()
          else torch.cuda.device(index)):
        err = _kernel()(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
                        bsz, hgt * wid, c, num_groups, float(eps), int(swish),
                        _DTYPE_CODE[x.dtype], torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(f"group_norm_swish kernel launch failed: cudaError {err}")
    group_norm_swish.launches += 1
    return out


def _forward(x, gamma, beta, num_groups: int, eps: float, swish: bool) -> torch.Tensor:
    """The kernel (CUDA) or the plain version (CPU)."""
    if x.is_cuda:
        return _launch(x, gamma, beta, num_groups, eps, swish)
    if x.device.type != "cpu":
        raise ValueError(f"group_norm_swish runs on CUDA or CPU tensors, got {x.device}")
    return group_norm_swish_plain(x, gamma, beta, num_groups, eps, swish)


def _match_layout(g: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``g`` in ``like``'s strides, on the card: F.group_norm's CUDA output is
    NCHW, the kernel's (and so the incoming gradient's) channels_last, and
    on mixed layouts torch's elementwise kernels take their strided path."""
    if g.is_cuda and g.stride() != like.stride():
        return torch.empty_like(like).copy_(g)
    return g


class _GroupNormSwish(torch.autograd.Function):
    """Forward: :func:`_forward`, saving only the inputs.  Backward
    recomputes through the plain version: its forward ops, then the ops
    autograd runs for its backward, called directly, so the gradients are
    autograd's through :func:`group_norm_swish_plain`.  Not a second
    autograd graph, as ``_Front``'s backward builds: on the H100 that made
    a host-paced ResNet train step (B=128 bf16) ~9% slower (``PERF.md``)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, num_groups, eps, swish):
        ctx.save_for_backward(x, gamma, beta)
        ctx.args = (num_groups, eps, swish)
        return _forward(x, gamma, beta, num_groups, eps, swish)

    @staticmethod
    def backward(ctx, g):
        x, gamma, beta = ctx.saved_tensors
        num_groups, eps, swish = ctx.args
        need_x, need_gamma, need_beta = ctx.needs_input_grad[:3]
        aten = torch.ops.aten
        n, c, hw = x.shape[0], x.shape[1], x[0, 0].numel()
        xf = x.to(_stat_dtype(x))
        big_x = xf.contiguous() if x.is_cuda else xf  # what F.group_norm hands native_group_norm
        yg, mean, rstd = aten.native_group_norm(big_x, None, None, n, c, hw, num_groups, eps)
        xn = yg.to(x.dtype)
        a, b = gamma.view(1, -1, 1, 1), beta.view(1, -1, 1, 1)
        if swish:
            y = xn * a + b
            dy = aten.silu_backward(_match_layout(g, y), y)
        else:
            dy = _match_layout(g, xn)
        dgamma = (dy * xn).sum((0, 2, 3), keepdim=True).view(c) if need_gamma else None
        dbeta = dy.sum((0, 2, 3), keepdim=True).view(c) if need_beta else None
        dx = None
        if need_x:
            dyg = (dy * a).to(yg.dtype)
            # autograd's formula: the gradient in the input's memory format
            # on the CPU, contiguous on the card
            fmt = (torch.channels_last if not x.is_cuda and not big_x.is_contiguous()
                   else torch.contiguous_format)
            dx = aten.native_group_norm_backward(dyg.contiguous(memory_format=fmt), big_x, mean,
                                                 rstd, None, n, c, hw, num_groups,
                                                 [True, False, False])[0].to(x.dtype)
        return dx, dgamma, dbeta, None, None, None


def group_norm_swish(x, gamma, beta, num_groups: int, eps: float = 1e-6,
                     swish: bool = True) -> torch.Tensor:
    """GroupNorm of [B, C, H, W] ``x`` with ``num_groups`` groups, ``* gamma +
    beta`` ([C]) and optional swish; see the module docstring.

    ``group_norm_swish.launches`` counts the kernel's launches (CPU calls do
    not count); ``group_norm_swish.row_sharded_calls`` the calls inside a
    row-sharded ``parallel.image_rows``, which compute the statistics
    across processes in plain PyTorch.
    """
    if spatial.current() is not None:
        group_norm_swish.row_sharded_calls += 1
        return _row_sharded(x, gamma, beta, num_groups, eps, swish)
    if torch.is_grad_enabled() and (x.requires_grad or gamma.requires_grad
                                    or beta.requires_grad):
        return _GroupNormSwish.apply(x, gamma, beta, num_groups, eps, swish)
    return _forward(x, gamma, beta, num_groups, eps, swish)  # sampling: no autograd node


group_norm_swish.launches = 0
group_norm_swish.row_sharded_calls = 0
