"""Fused ConvNeXt block front: depthwise 7x7 conv + bias + time conditioning + LayerNorm.

    out = LN_c(dwconv7x7(x) + b_dw + cond[b]) * gamma + beta

(ConvNextBlock, deblurring_diffusion_pytorch.py:135-165).  Zero padding 3;
the LayerNorm runs over channels with biased variance; ``norm=False`` skips
it and ``cond=None`` adds only ``b_dw``.

On a CUDA tensor this launches one of the hand-written Hopper kernels in
``colddiff_torch/csrc/convnext_front.cu``, which replace the TPU kernel of
``colddiff/ops/pallas/convnext_front.py`` (``_pallas_forward_packed`` ->
``_kernel_packed``); the C entry point picks the kernel by the channel
count.  Each accumulates taps and statistics in fp32 for fp32 and bf16
inputs and rounds the output once.

- C < 32 (``SMALL_C``; the C=3 stem, C=1, narrow test UNets): the small-C
  kernel, one thread per output pixel holding all C channels, over a 16x16
  output tile whose input halo sits in shared memory.
- C >= 32, up to 1024: the tile kernel.  A block owns a spatial tile of one
  image (8x16 pixels at C <= 64 down to 4x4 above C = 256) and all C
  channels; each channel chunk's input halo is staged in shared memory,
  and each thread slides a register window over W for one channel pair,
  so the LayerNorm closes inside the block.
- C > 1024, up to ``MAX_CHANNELS`` (the 16*dim front of a ``dim`` > 64
  UNet): the tile kernel's cluster form.  The k <= 8 blocks of a thread
  block cluster share one spatial tile, each holds a slab of the channels
  (256, 512 or 1024 by C; the last may be short), and the LayerNorm's
  per-pixel sums cross between them through distributed shared memory;
  the call allocates only its output.
  A larger C raises.

All take the weights in their torch layout [C, 49], so a call whose w is
already contiguous in the compute dtype copies nothing: the kernel reads
``w``'s own storage.

So all 17 block fronts of the flagship UNet run through a kernel (the TPU
kernel took only C | 128 with C < 128).

Inside ``parallel.image_rows`` x is this process's block of the image
rows, and the call takes the TPU kernel's partition rule for row-sharded
input (colddiff/ops/pallas/convnext_front.py:290-315): the block gains 3
rows of each neighbour (zeros past the image's edges, the conv's own
padding), the same kernel runs on the [B, C, h + 6, W] block, and rows
3..h+2 of its output are kept; a block of fewer than 3 rows gathers the
whole rows instead and keeps its own.  One launch a call either way, and
the backward recomputes on the extended block, the exchange returning the
halo rows' gradients (``parallel.spatial``).

On a CPU tensor the same call runs :func:`convnext_front_plain`, the plain
PyTorch version, which the tests hold against the JAX reference and which
``chip_smoke.py`` holds the kernel against.  A CUDA tensor never falls back
to it: the kernel launches or the call raises.

Layouts: x and the output are NCHW tensors; the kernel needs x in
``torch.channels_last`` memory (NHWC), and its output is channels_last.
w is the torch depthwise weight [C, 1, 7, 7].
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from .. import tracing
from ..parallel import spatial
from . import _build

__all__ = ["convnext_front", "convnext_front_plain", "cluster_config", "MAX_CHANNELS",
           "SMALL_C", "TILE_MAX_CHANNELS"]

TILE_MAX_CHANNELS = 1024  # the tile kernel's largest C (kTileMaxChannels in the .cu)
MAX_CHANNELS = 8192  # the cluster form's largest C (kMaxChannels in the .cu)
SMALL_C = 32  # C < SMALL_C launches the small-C kernel (kSmallCLimit in the .cu)
HALO = 3  # rows of each neighbour a row block needs: the 7x7 conv's reach
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def convnext_front_plain(x, w, b, cond, gamma, beta, *, norm: bool = True,
                         eps: float = 1e-5):
    """Plain PyTorch front; a transcription of ``convnext_front_reference``.

    x: [B, C, H, W]; w: [C, 1, 7, 7]; b, gamma, beta: [C]; cond: [B, C] or
    None (gamma and beta may be None when ``norm=False``).  Computes in
    ``promote(x, w)`` like a Flax conv with mixed dtypes; LayerNorm
    statistics run in at least fp32 and are cast back before
    ``* gamma + beta``.
    """
    c = x.shape[1]
    dt = torch.promote_types(x.dtype, w.dtype)
    x, w = x.to(dt), w.to(dt)
    h = F.conv2d(x, w, padding=3, groups=c) + b[:, None, None]
    if cond is not None:
        h = h + cond[:, :, None, None]
    if norm:
        hf = h.to(torch.promote_types(h.dtype, torch.float32))
        mean = hf.mean(dim=1, keepdim=True)
        var = hf.var(dim=1, unbiased=False, keepdim=True)
        h = ((hf - mean) * torch.rsqrt(var + eps)).to(h.dtype)
        h = h * gamma[:, None, None] + beta[:, None, None]
    return h


@functools.cache
def _kernel():
    fn = _build.load_library().colddiff_convnext_front
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def cluster_config(c: int, dtype: torch.dtype) -> dict:
    """The cluster form's configuration at ``c`` channels (1024 < c <=
    ``MAX_CHANNELS``) in ``dtype``, as the kernel library picks it: blocks
    per cluster ``k``, slab ``slab``, tile ``tile`` (H x W), run ``run``
    along W, chunk ``chunk``.  Loads (and builds) the library."""
    fn = _build.load_library().colddiff_convnext_front_cluster
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    cfg = (ctypes.c_int * 6)()
    if dtype not in _DTYPE_CODE or fn(c, _DTYPE_CODE[dtype], cfg) != 0:
        raise ValueError(f"convnext_front: C={c} in {dtype} does not take the cluster "
                         f"form ({TILE_MAX_CHANNELS} < C <= {MAX_CHANNELS}, fp32 or bf16)")
    k, slab, th, tw, run, chunk = cfg
    return dict(k=k, slab=slab, tile=[th, tw], run=run, chunk=chunk)


def _check_vector(name: str, t: Optional[torch.Tensor], shape: tuple,
                  x: torch.Tensor, dt: torch.dtype) -> None:
    if t is None:
        return
    if tuple(t.shape) != shape:
        raise ValueError(f"convnext_front: {name} has shape {tuple(t.shape)}, "
                         f"kernel takes {shape}")
    if t.device != x.device:
        raise ValueError(f"convnext_front: {name} is on {t.device}, x on {x.device}")
    if torch.promote_types(t.dtype, dt) != dt:
        raise TypeError(f"convnext_front: {name} is {t.dtype}, wider than the "
                        f"compute dtype {dt} = promote(x, w)")


def _launch(x, w, b, cond, gamma, beta, norm: bool, eps: float) -> torch.Tensor:
    """Check what the kernel takes, then launch it on the current stream."""
    for name, t in (("x", x), ("w", w), ("b", b), ("cond", cond), ("gamma", gamma),
                    ("beta", beta)):
        if isinstance(t, DTensor):
            raise TypeError(f"convnext_front: {name} is a DTensor {t.placements}, and the "
                            "kernel reads whole tensors: gather it first (fully_shard's "
                            "forward does)")
    if x.dim() != 4:
        raise ValueError(f"convnext_front: x must be [B, C, H, W], got {tuple(x.shape)}")
    bsz, c, hgt, wid = x.shape
    dt = torch.promote_types(x.dtype, w.dtype)
    if dt not in _DTYPE_CODE:
        raise TypeError(f"convnext_front kernel takes float32 or bfloat16, got {dt}")
    if not 1 <= c <= MAX_CHANNELS:
        raise ValueError(f"convnext_front kernels take 1..{MAX_CHANNELS} channels "
                         f"(MAX_CHANNELS), got {c}")
    _check_vector("w", w, (c, 1, 7, 7), x, dt)
    _check_vector("b", b, (c,), x, dt)
    _check_vector("cond", cond, (bsz, c), x, dt)
    _check_vector("gamma", gamma if norm else None, (c,), x, dt)
    _check_vector("beta", beta if norm else None, (c,), x, dt)
    x = x.to(dt)
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("convnext_front kernel needs x in torch.channels_last memory")
    wk = w.reshape(c, 49).to(dt).contiguous()  # a view of w's storage when it is dt
    b = b.to(dt).contiguous()
    if cond is not None:
        cond = cond.to(dt).contiguous()
    if norm:
        gamma, beta = gamma.to(dt).contiguous(), beta.to(dt).contiguous()
    out = torch.empty((bsz, c, hgt, wid), dtype=dt, device=x.device,
                      memory_format=torch.channels_last)
    ptrs = (x.data_ptr(), wk.data_ptr(), b.data_ptr(),
            None if cond is None else cond.data_ptr(),
            gamma.data_ptr() if norm else None, beta.data_ptr() if norm else None,
            out.data_ptr())
    tail = (int(norm), float(eps), _DTYPE_CODE[dt])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(*ptrs, bsz, hgt, wid, c, *tail, stream)
    if err != 0:
        raise RuntimeError(f"convnext_front kernel launch failed: cudaError {err}")
    convnext_front.launches += 1
    if c < SMALL_C:
        convnext_front.small_c_launches += 1
    elif c > TILE_MAX_CHANNELS:
        convnext_front.wide_c_launches += 1
    return out


class _Front(torch.autograd.Function):
    """Forward: the kernel (CUDA) or the plain version (CPU).  Backward
    recomputes through the plain version, as the JAX package's ``_front_bwd``
    does; a backward kernel is not written yet."""

    @staticmethod
    def forward(ctx, x, w, b, cond, gamma, beta, norm, eps):
        ctx.save_for_backward(x, w, b, cond, gamma, beta)
        ctx.norm, ctx.eps = norm, eps
        if x.is_cuda:
            return _launch(x, w, b, cond, gamma, beta, norm, eps)
        if x.device.type != "cpu":
            raise ValueError(f"convnext_front runs on CUDA or CPU tensors, got {x.device}")
        return convnext_front_plain(x, w, b, cond, gamma, beta, norm=norm, eps=eps)

    @staticmethod
    def backward(ctx, g):
        with tracing.span("convnext_front.backward"), torch.enable_grad():
            need = ctx.needs_input_grad[:6]
            args = [t.detach().requires_grad_() if (t is not None and n) else t
                    for t, n in zip(ctx.saved_tensors, need)]
            y = convnext_front_plain(*args, norm=ctx.norm, eps=ctx.eps)
            wrt = [a for a, n in zip(args, need) if n]
            grads = iter(torch.autograd.grad(y, wrt, g))
        return (*(next(grads) if n else None for n in need), None, None)


def convnext_front(x, w, b, cond, gamma, beta, *, norm: bool = True,
                   eps: float = 1e-5) -> torch.Tensor:
    """Fused dw7x7 + bias + cond + LayerNorm; see the module docstring.

    ``convnext_front.launches`` counts the launches of every kernel,
    ``convnext_front.small_c_launches`` those of the small-C kernel alone and
    ``convnext_front.wide_c_launches`` those with C > 1024, the cluster
    form (one per call; CPU calls and comparisons made through
    :func:`convnext_front_plain` do not count).
    """
    if norm and (gamma is None or beta is None):
        raise ValueError("convnext_front: norm=True needs gamma and beta")
    if spatial.current() is None:
        return _Front.apply(x, w, b, cond, gamma, beta, norm, eps)
    h = x.shape[2]
    if h < HALO:  # thinner than the halo: the whole rows, then this block's
        whole = spatial.gather(x, 2)
        return spatial.local(_Front.apply(whole, w, b, cond, gamma, beta, norm, eps), 2)
    xe = spatial.halo(x, HALO, HALO, 2)
    return _Front.apply(xe, w, b, cond, gamma, beta, norm, eps).narrow(2, HALO, h)


convnext_front.launches = 0
convnext_front.small_c_launches = 0
convnext_front.wide_c_launches = 0
