"""Layers of both UNet families (NCHW, channels_last memory).

Port of ``colddiff/models/layers.py``: the ConvNeXt pieces, and the ResNet
family's GroupNorm-swish, softmax attention and ``swish``, with Flax's
dropout.  Module and parameter names are the reference's torch names
(deblurring_diffusion_pytorch.py:83-187, Model2.py:6-188), so a reference
state dict loads with ``load_state_dict`` and no conversion.  The ResNet
layers are stock torch ops, but for the GroupNorm-swish, which runs as one
hand-written kernel on the card (``ops/group_norm.py``).

Inside ``parallel.image_rows`` both families' pieces run on this
process's block of the image rows: the front and the 3x3, Downsample and
Upsample convs take halos (``RowConv2d``, ``RowConvTranspose2d``), the
linear attention's token softmax and context sum over the space group, the
GroupNorm's statistics are the group's, the softmax attention's keys and
values are gathered, dropout keeps its rows of the whole images' mask, and
the per-pixel pieces stay local.

:func:`init_as_flax` gives a freshly built UNet of either family the JAX
package's initial distribution (Flax's defaults).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import group_norm
from ..ops.convnext_front import convnext_front
from ..parallel import spatial
from ..parallel.mesh import draw_rows
from ..tracing import span

__all__ = [
    "gelu",
    "GELU",
    "SinusoidalPosEmb",
    "ChannelLayerNorm",
    "ConvNextBlock",
    "RowConv2d",
    "RowConvTranspose2d",
    "linear_attention",
    "linear_attention_blockdiag",
    "linear_attention_folded",
    "LinearAttention",
    "Downsample",
    "Upsample",
    "swish",
    "group_norm_swish",
    "FusedGroupNormSwish",
    "SoftmaxAttention",
    "dropout",
    "init_as_flax",
]


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU: exact erf form in fp32 and wider, tanh form for narrower floats.

    The same dtype rule as the JAX package (``colddiff/models/layers.py``):
    torch ``nn.GELU``'s default erf form keeps fp32/fp64 parity with the
    reference, and bf16 activations take the tanh form, whose difference
    (at most 4.8e-4 absolute) lies below bf16's rounding step.
    """
    exact = x.dtype.is_floating_point and torch.finfo(x.dtype).bits >= 32
    return F.gelu(x, approximate="none" if exact else "tanh")


class GELU(nn.Module):
    """:func:`gelu` as a module (holds the slot of the reference's nn.GELU)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gelu(x)


class SinusoidalPosEmb(nn.Module):
    """Transformer sinusoidal timestep embedding (deblurring...py:91-103),
    computed in fp32."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.dim // 2
        freq = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                         * (-math.log(10000.0) / (half - 1)))
        ang = t.to(torch.float32)[:, None] * freq[None, :]
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def swish(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x) (Model2.py:27-29)."""
    return F.silu(x)


def _stat_dtype(x: torch.Tensor) -> torch.dtype:
    """Statistics (mean/var/softmax) run in at least fp32."""
    return torch.promote_types(x.dtype, torch.float32)


class ChannelLayerNorm(nn.Module):
    """Per-pixel channel LayerNorm with biased variance (deblurring...py:111-121).

    Parameters ``g`` and ``b`` are [1, C, 1, 1], as in the reference.
    """

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1))
        self.b = nn.Parameter(torch.zeros(1, dim, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(_stat_dtype(x))
        mean = xf.mean(dim=1, keepdim=True)
        var = xf.var(dim=1, unbiased=False, keepdim=True)
        xn = ((xf - mean) / torch.sqrt(var + self.eps)).to(x.dtype)
        return xn * self.g + self.b


class RowConv2d(nn.Conv2d):
    """``nn.Conv2d``; inside a row-sharded ``parallel.image_rows``, the conv
    of this process's row block with a halo (``spatial.conv2d``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return spatial.conv2d(self, x)


class RowConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d``; inside a row-sharded ``parallel.image_rows``,
    this process's output rows from its halo'd block
    (``spatial.conv_transpose2d``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return spatial.conv_transpose2d(self, x)


class ConvNextBlock(nn.Module):
    """ConvNeXt block: depthwise 7x7 + (norm -> 3x3 -> GELU -> 3x3) + residual.

    Parity: deblurring_diffusion_pytorch.py:135-165.  The front (``ds_conv``,
    the time conditioning ``mlp`` and the LayerNorm ``net.0``) runs as one
    :func:`convnext_front` call; ``ds_conv`` and ``net.0`` hold its weights.
    """

    def __init__(self, dim: int, dim_out: int, *, time_emb_dim: Optional[int] = None,
                 mult: int = 2, norm: bool = True):
        super().__init__()
        self.norm = norm
        self.mlp = (nn.Sequential(GELU(), nn.Linear(time_emb_dim, dim))
                    if time_emb_dim is not None else None)
        self.ds_conv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.net = nn.Sequential(
            ChannelLayerNorm(dim) if norm else nn.Identity(),
            RowConv2d(dim, dim_out * mult, 3, padding=1),
            GELU(),
            RowConv2d(dim_out * mult, dim_out, 3, padding=1),
        )
        self.res_conv = nn.Conv2d(dim, dim_out, 1) if dim != dim_out else nn.Identity()

    def forward(self, x: torch.Tensor, t: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x.contiguous(memory_format=torch.channels_last)
        cond = self.mlp(t) if self.mlp is not None and t is not None else None
        gamma = beta = None
        if self.norm:
            c = x.shape[1]
            gamma, beta = self.net[0].g.view(c), self.net[0].b.view(c)
        h = convnext_front(x, self.ds_conv.weight, self.ds_conv.bias, cond,
                           gamma, beta, norm=self.norm)
        h = self.net[3](gelu(self.net[1](h)))
        return h + self.res_conv(x)


def linear_attention(q, k, v, scale: float):
    """softmax(k) over tokens -> context = k^T v -> out = q context, per group.

    Port of the JAX ``linear_attention`` (deblurring_diffusion_pytorch.py:180-186
    torch einsum semantics): q, k, v are [G, N, D] with G = batch * heads.
    A reference form: ``LinearAttention`` computes
    :func:`linear_attention_folded`.
    """
    ks = torch.softmax(k, dim=1)
    context = torch.einsum("gnd,gne->gde", ks, v)
    return torch.einsum("gde,gnd->gne", context, q * scale)


def linear_attention_blockdiag(q, k, v, heads: int, scale: float):
    """:func:`linear_attention` with the heads never split.

    Port of the JAX ``linear_attention_blockdiag``: q, k, v are [B, N,
    heads*D] in head-major channel order (h*D + d).  The token softmax is
    per channel, so the per-head contexts are the diagonal blocks of one
    [C, C] contraction, kept by a block mask.  A reference form, as
    :func:`linear_attention` is.
    """
    c = q.shape[-1]
    d = c // heads
    i = torch.arange(c, device=q.device)
    mask = ((i[:, None] // d) == (i[None, :] // d)).to(q.dtype)
    ks = torch.softmax(k, dim=1)
    context = torch.einsum("bnc,bne->bce", ks, v) * mask
    return torch.einsum("bce,bnc->bne", context, q * scale)


def linear_attention_folded(xt, wqkv, wout, bout, heads: int, scale: float):
    """Linear attention with the q-side algebra folded into the weights.

    Port of the JAX ``linear_attention_folded``, with torch weight layouts:
    xt: [B, N, c]; wqkv: [3*hidden, c]; wout: [c_out, hidden]; bout: [c_out].
    softmax(k) over tokens, per-head contexts as the diagonal blocks of one
    [hidden, hidden] product, and q (and, when c <= hidden, the out
    projection) folded into one per-batch weight.

    Inside a row-sharded ``parallel.image_rows`` the N tokens are this
    process's: the softmax takes the group's max and sum (at least fp32),
    ``ks`` is cast to xt's dtype where the whole-image code casts it, and
    the context is summed over the group in at least fp32 and cast once.
    """
    c = xt.shape[-1]
    hidden = wqkv.shape[0] // 3
    d = hidden // heads
    i = torch.arange(hidden, device=xt.device)
    mask = ((i[:, None] // d) == (i[None, :] // d)).to(xt.dtype)
    kv = torch.einsum("bnc,kc->bnk", xt, wqkv[hidden:])
    # token softmax in at least fp32: a bf16 exp-sum over 16k tokens loses
    # bits.  Tokens go last, in one contiguous copy: torch's softmax over a
    # strided dim=1 runs a kernel that took 30 of a 41 ms flagship step on
    # the H100, and a non-contiguous input costs it another copy (PERF.md)
    sd = _stat_dtype(kv)
    k_last = kv[..., :hidden].transpose(1, 2).to(sd, memory_format=torch.contiguous_format)
    if spatial.current() is None:
        ks = torch.softmax(k_last, dim=-1).to(xt.dtype)
        ctx = torch.einsum("bdn,bne->bde", ks, kv[..., hidden:]) * mask
    else:
        e = torch.exp(k_last - spatial.group_max(k_last.amax(dim=-1, keepdim=True)))
        ks = (e / spatial.group_sum(e.sum(dim=-1, keepdim=True))).to(xt.dtype)
        ctx = spatial.group_sum(torch.einsum("bdn,bne->bde", ks.to(sd),
                                             kv[..., hidden:].to(sd))).to(xt.dtype) * mask
    w1 = torch.einsum("dc,bde->bce", wqkv[:hidden] * scale, ctx)
    if c <= hidden:
        return torch.einsum("bnc,bcf->bnf", xt, w1 @ wout.t()) + bout
    return torch.einsum("bne,fe->bnf", torch.einsum("bnc,bce->bne", xt, w1), wout) + bout


class LinearAttention(nn.Module):
    """Linear attention over H*W tokens (deblurring_diffusion_pytorch.py:167-187),
    run in the folded form of :func:`linear_attention_folded`."""

    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads = heads
        self.scale = dim_head ** -0.5
        hidden = heads * dim_head
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Conv2d(hidden, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hgt, wid = x.shape
        xt = x.permute(0, 2, 3, 1).reshape(b, hgt * wid, c)  # a view if channels_last
        out = linear_attention_folded(
            xt, self.to_qkv.weight[:, :, 0, 0], self.to_out.weight[:, :, 0, 0],
            self.to_out.bias, self.heads, self.scale)
        return out.reshape(b, hgt, wid, c).permute(0, 3, 1, 2)


def Downsample(dim: int) -> nn.Module:
    """Stride-2 4x4 conv (deblurring...py:105-109)."""
    return RowConv2d(dim, dim, 4, 2, 1)


def Upsample(dim: int) -> nn.Module:
    """Stride-2 4x4 transposed conv (deblurring...py:105-106)."""
    return RowConvTranspose2d(dim, dim, 4, 2, 1)


def group_norm_swish(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     num_groups: int, eps: float = 1e-6, swish: bool = True) -> torch.Tensor:
    """GroupNorm of [B, C, H, W] ``x`` + optional swish (Model2.py Normalize
    :32-33, nonlinearity :27-29), in the JAX package's order: statistics in
    at least fp32, the normalized value cast to ``x``'s dtype, then
    ``* gamma + beta`` in that dtype.  ``ops.group_norm.group_norm_swish``
    inside the ``unet.group_norm`` span: the hand-written kernel on a CUDA
    tensor, the plain version on a CPU one, and the whole images' statistics
    inside a row-sharded ``parallel.image_rows``."""
    with span("unet.group_norm"):
        return group_norm.group_norm_swish(x, gamma, beta, num_groups, eps, swish)


class FusedGroupNormSwish(nn.GroupNorm):
    """GroupNorm(32, eps 1e-6), optionally followed by swish; ``weight`` and
    ``bias`` are [C], the reference ``torch.nn.GroupNorm``'s names."""

    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-6,
                 swish: bool = True):
        super().__init__(num_groups, num_channels, eps=eps)
        self.swish = swish

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return group_norm_swish(x, self.weight, self.bias, self.num_groups, self.eps,
                                self.swish)


class SoftmaxAttention(nn.Module):
    """Full softmax self-attention over the H*W tokens (Model2.py:136-188).

    As in the JAX package: the q.k logits in the activation dtype, cast to
    at least fp32, scaled by C^-0.5, a softmax over the keys, the weights
    cast back to q's dtype.  The keys are the last axis of the logits (a
    softmax over a strided axis is slow on the card: PERF.md).

    Inside a row-sharded ``parallel.image_rows`` the queries stay this
    process's and the keys and values are gathered (one ``spatial.gather``
    of their [B, h*W, 2C] tokens), so the softmax runs over all H*W keys
    and each query row's arithmetic is one process's."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = FusedGroupNormSwish(dim, swish=False)
        self.q = nn.Conv2d(dim, dim, 1)
        self.k = nn.Conv2d(dim, dim, 1)
        self.v = nn.Conv2d(dim, dim, 1)
        self.proj_out = nn.Conv2d(dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hgt, wid = x.shape
        h = self.norm(x)

        def tokens(conv):  # [B, N, C]; a view of a channels_last output
            return conv(h).permute(0, 2, 3, 1).reshape(b, hgt * wid, c)

        q, k, v = tokens(self.q), tokens(self.k), tokens(self.v)
        if spatial.current() is not None:
            k, v = spatial.gather(torch.cat([k, v], dim=-1), 1).split(c, dim=-1)
        w = torch.bmm(q, k.transpose(1, 2)).to(_stat_dtype(q)) * (c ** -0.5)
        w = torch.softmax(w, dim=-1).to(q.dtype)
        out = torch.bmm(w, v).reshape(b, hgt, wid, c).permute(0, 3, 1, 2)
        return x + self.proj_out(out)


def _keep_mask(x: torch.Tensor, p: float, generator: torch.Generator) -> torch.Tensor:
    """Flax's dropout mask for ``x``: keep where a uniform draw is below
    1 - p.  The draws take ``x``'s memory format, so the mask of a
    channels_last activation is channels_last too.  Under
    ``parallel.batch_rows`` the draw is the global batch's, made with
    ``x``'s strides, so each process keeps the 1-process mask's rows.
    Inside a row-sharded ``parallel.image_rows`` the draw is the whole
    images' in ``x``'s memory format, and each process keeps its block's
    rows of it."""
    rows = spatial.current()
    if rows is not None:
        fmt = (torch.channels_last if x.is_contiguous(memory_format=torch.channels_last)
               else torch.contiguous_format)

        def whole(n: int) -> torch.Tensor:
            shape = (n, x.shape[1], x.shape[2] * rows.size, x.shape[3])
            return torch.empty(shape, dtype=torch.float32, device=x.device,
                               memory_format=fmt).uniform_(generator=generator)

        return spatial.local(draw_rows(whole, x.shape[0]), 2) < 1.0 - p

    def draw(n: int) -> torch.Tensor:
        if n == x.shape[0]:  # one process: x's own layout, whatever its strides
            u = torch.empty_like(x, dtype=torch.float32)
        else:
            u = torch.empty_strided((n, *x.shape[1:]), x.stride(), dtype=torch.float32,
                                    device=x.device)
        return u.uniform_(generator=generator)

    return draw_rows(draw, x.shape[0]) < 1.0 - p


def dropout(x: torch.Tensor, p: float, training: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """Flax ``nn.Dropout``: ``where(keep, x / (1 - p), 0)`` with the keep
    mask drawn from ``generator`` alone (``F.dropout`` would draw from the
    device's global stream).  The identity outside training or at p = 0; a
    training call with p > 0 and no generator raises."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError(f"dropout p={p} in training mode draws its mask from a "
                         "torch.Generator: pass generator=, or call .eval()")
    if p >= 1.0:
        return torch.zeros_like(x)
    keep = _keep_mask(x, p, generator)
    return torch.where(keep, x / (1.0 - p), 0.0)


# std of a unit normal truncated to [-2, 2]: Flax's variance_scaling
# divides by it so that the truncated draw keeps the variance asked for
_TRUNC_STD = 0.87962566103423978


def _flax_fan_in(m: nn.Module) -> int:
    """fan_in of the Flax kernel that ``convert.py`` maps ``m.weight`` from:
    a conv's (kh, kw, I/groups, O) gives kh * kw * I/groups (49 for the
    depthwise ``ds_conv``), a dense's (I, O) gives I, and a transposed
    conv's (kh, kw, I, O) gives kh * kw * I, I being torch's
    ``weight.shape[0]`` (torch's own rule takes the output channels)."""
    w = m.weight
    if isinstance(m, nn.Linear):
        return w.shape[1]
    if isinstance(m, nn.ConvTranspose2d):
        return w.shape[0] * w.shape[2] * w.shape[3]
    return w[0].numel()


@torch.no_grad()
def init_as_flax(module: nn.Module,
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    """Draw ``module``'s parameters from the JAX package's initial
    distribution, Flax's defaults, and return ``module``.

    Every ``nn.Conv2d``, ``nn.ConvTranspose2d`` and ``nn.Linear`` weight
    (the ``Row*`` subclasses too) takes ``lecun_normal``
    (``variance_scaling(1, "fan_in", "truncated_normal")``): a normal of
    std sqrt(1 / fan_in) / 0.8796 truncated at +-2 of that std, so its
    variance is 1 / fan_in, with fan_in from :func:`_flax_fan_in`.  Biases
    are zeros.  The ``ChannelLayerNorm`` and ``GroupNorm`` scales and
    offsets keep their construction values, ones and zeros, Flax's.  The
    weights are drawn in ``module.modules()`` order from ``generator``
    (torch's default generator when None), which must live on the
    parameters' device: models are built on the CPU, so a seed gives the
    same weights whatever device the model moves to.
    """
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            # jax.random.truncated_normal's inverse-CDF draw: U(erf(-2/sqrt2),
            # erf(2/sqrt2)) through sqrt2 * erfinv.  torch's trunc_normal_
            # samples by rejection from 2.13 on (other draws for one seed
            # across torch versions) and takes ~8x longer
            lim = math.erf(math.sqrt(2.0))
            m.weight.uniform_(-lim, lim, generator=generator).erfinv_()
            m.weight.mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(
                math.sqrt(1.0 / _flax_fan_in(m)) / _TRUNC_STD)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
    return module
