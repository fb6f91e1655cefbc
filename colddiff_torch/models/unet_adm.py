"""ADM, the UNet of Dhariwal & Nichol, "Diffusion Models Beat GANs on Image
Synthesis" (arXiv:2105.05233), as a torch module.

The module tree, its names and its equations are openai/guided-diffusion's
``UNetModel`` (``guided_diffusion/unet.py``, ``nn.py``):
``time_embed.{0,2}``, ``input_blocks.{i}.{j}``, ``middle_block.{0,1,2}``,
``output_blocks.{i}.{j}``, ``out.{0,2}``; a ``ResBlock`` holds
``in_layers``, ``emb_layers``, ``out_layers`` and ``skip_connection``, an
``AttentionBlock`` ``norm``, ``qkv`` and ``proj_out``.  So a guided-diffusion
state dict would load by name, but for ``qkv`` and ``proj_out``, which are
1x1 ``nn.Conv2d`` here (guided-diffusion's are ``Conv1d``: a reshape of their
weights).  The slots of guided-diffusion's parameterless SiLU and Dropout
modules hold ``nn.Identity``: the norm's kernel applies the SiLU, and the
dropout is the published 0.

The flags are those of ``256x256_diffusion_uncond.pt`` that shape the
blocks, fixed: ``use_scale_shift_norm``, ``resblock_updown`` and dropout 0.
The widths, depths and resolutions are arguments.

- The time embedding: ``cat[cos, sin]`` of ``t * exp(-ln(1e4) i / half)``
  (guided-diffusion's ``timestep_embedding``, not fairseq's), computed in
  fp32 and cast to the activations' dtype, then Linear, SiLU, Linear.
- Every norm is GroupNorm32: 32 groups, eps 1e-5, through the GroupNorm
  kernel (``ops/group_norm.py``) with the SiLU that follows it.
- AdaGN (``use_scale_shift_norm``): a ResBlock's second norm is
  ``SiLU((GN(h) * gamma + beta) * (1 + scale) + shift)``, ``[scale, shift] =
  Linear(SiLU(emb))`` of each image.  :func:`ada_group_norm` folds it into a
  per-image affine ``gamma' = gamma (1 + scale)``, ``beta' = beta (1 + scale)
  + shift`` in fp32, rounds those to the activations' dtype, and makes one
  kernel launch; the kernel then rounds ``GN(h)``, ``GN(h) * gamma'`` and the
  sum with ``beta'`` to that dtype, where guided-diffusion's fp16 model
  rounds ``GN(h) * gamma + beta`` once, then its product with ``1 + scale``
  and the sum with ``shift``.
- BigGAN resampling (``resblock_updown``): a down or up ResBlock does ``h =
  in_conv(resample(SiLU(GN(x))))`` and ``x = resample(x)``, ``resample``
  being 2x2 average pooling or nearest x2, no conv.
- Attention: ``qkv`` is one 1x1 conv to 3C in guided-diffusion's legacy
  order (``QKVAttentionLegacy``: each head's q, k and v contiguous), C / 64
  heads of 64 channels, ``F.scaled_dot_product_attention`` with scale
  1/sqrt(64) (its softmax in fp32), ``proj_out`` and the residual.

``forward`` takes and returns NHWC images, like the other UNet families;
inside, the activations are NCHW in ``torch.channels_last`` memory.  The
3x3 convs are ``layers.RowConv2d``, but ADM does not run row-sharded: its
forward raises inside ``parallel.image_rows``.  Weights are drawn by the JAX
package's rule (``layers.init_as_flax``), as the other families' are.

Spans: ``unet.ada_group_norm`` around each AdaGN call, from the fold to the
kernel, and ``unet.attention`` around an attention block after its norm.  The
other norms run inside ``unet.group_norm`` (``layers.group_norm_swish``), so
the two norm spans partition the norms' forward time.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import group_norm
from ..parallel import spatial
from ..tracing import span
from .layers import FusedGroupNormSwish, RowConv2d, init_as_flax

__all__ = ["UnetADM", "ResBlock", "AttentionBlock", "ada_group_norm", "timestep_embedding"]

GROUPS, EPS = 32, 1e-5  # guided-diffusion's GroupNorm32


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """guided-diffusion's sinusoidal embedding, in fp32: ``cat[cos, sin]`` of
    ``t * exp(-ln(max_period) * i / half)`` (a zero column when ``dim`` is odd)."""
    half = dim // 2
    freq = torch.exp(-math.log(max_period)
                     * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    ang = t.to(torch.float32)[:, None] * freq[None, :]
    emb = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
    return F.pad(emb, (0, 1)) if dim % 2 else emb


def _norm(channels: int, swish: bool = True) -> FusedGroupNormSwish:
    return FusedGroupNormSwish(channels, GROUPS, EPS, swish)


def _channels_last(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous(memory_format=torch.channels_last)


def ada_group_norm(h: torch.Tensor, norm: nn.GroupNorm, scale: torch.Tensor,
                   shift: torch.Tensor) -> torch.Tensor:
    """``SiLU((GN(h) * gamma + beta) * (1 + scale) + shift)`` with ``norm``'s
    gamma and beta and a [B, C] ``scale`` and ``shift``: the affine folded in
    fp32 into each image's own gamma and beta, then one call of the
    GroupNorm kernel with swish, inside the ``unet.ada_group_norm`` span."""
    with span("unet.ada_group_norm"):
        scale = 1.0 + scale.float()
        gamma = (norm.weight.float() * scale).to(h.dtype)
        beta = (norm.bias.float() * scale + shift.float()).to(h.dtype)
        return group_norm.group_norm_swish(h, gamma, beta, norm.num_groups, norm.eps, True)


class ResBlock(nn.Module):
    """guided-diffusion's ``ResBlock`` with AdaGN, optionally resampling
    (``up`` or ``down``)."""

    def __init__(self, channels: int, emb_channels: int, out_channels: int,
                 up: bool = False, down: bool = False):
        super().__init__()
        self.up, self.down = up, down
        # slot 1: guided-diffusion's SiLU, applied by the norm's kernel
        self.in_layers = nn.Sequential(_norm(channels), nn.Identity(),
                                       RowConv2d(channels, out_channels, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_channels, 2 * out_channels))
        # slots 1 and 2: the SiLU (the norm's kernel) and the dropout (0)
        self.out_layers = nn.Sequential(_norm(out_channels), nn.Identity(), nn.Identity(),
                                        RowConv2d(out_channels, out_channels, 3, padding=1))
        self.skip_connection = (nn.Identity() if out_channels == channels
                                else nn.Conv2d(channels, out_channels, 1))

    def _resample(self, x: torch.Tensor) -> torch.Tensor:
        if self.up:
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        elif self.down:
            x = F.avg_pool2d(x, 2, 2)
        return _channels_last(x)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        h = self.in_layers[0](x)
        if self.up or self.down:
            h, x = self._resample(h), self._resample(x)
        h = self.in_layers[2](h)
        scale, shift = self.emb_layers(emb).chunk(2, dim=1)
        h = self.out_layers[3](ada_group_norm(h, self.out_layers[0], scale, shift))
        return self.skip_connection(x) + h


class AttentionBlock(nn.Module):
    """guided-diffusion's ``AttentionBlock`` with heads of ``head_channels``
    and the legacy q, k, v order, through ``F.scaled_dot_product_attention``."""

    def __init__(self, channels: int, head_channels: int):
        super().__init__()
        if channels % head_channels:
            raise ValueError(f"AttentionBlock: {channels} channels do not split into heads "
                             f"of {head_channels}")
        self.heads = channels // head_channels
        self.norm = _norm(channels, swish=False)
        self.qkv = nn.Conv2d(channels, 3 * channels, 1)
        self.proj_out = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, hgt, wid = x.shape
        h = self.norm(x)
        with span("unet.attention"):
            d = c // self.heads
            # channel = head * 3d + (0 q, 1 k, 2 v) * d + i; tokens are pixels
            qkv = self.qkv(h).permute(0, 2, 3, 1).reshape(b, hgt * wid, self.heads, 3, d)
            q, k, v = qkv.permute(3, 0, 2, 1, 4).unbind(0)  # [B, heads, T, d] each
            a = F.scaled_dot_product_attention(q, k, v)
            a = a.transpose(1, 2).reshape(b, hgt, wid, c).permute(0, 3, 1, 2)
            return x + self.proj_out(_channels_last(a))


class TimestepEmbedSequential(nn.Sequential):
    """Layers run in turn; a ResBlock takes the embedding too."""

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        for layer in self:
            x = layer(x, emb) if isinstance(layer, ResBlock) else layer(x)
        return x


class UnetADM(nn.Module):
    """ADM at the flags of ``256x256_diffusion_uncond.pt`` by default (the
    guided-diffusion README), but ``out_channels`` 3 for the published 6,
    whose second half is ``learn_sigma``'s variance, which Cold Diffusion
    has no use for.  ``attention_resolutions`` are in pixels, as the
    ``--attention_resolutions`` flag gives them.  AdaGN, BigGAN resampling
    and dropout 0 are fixed (the module docstring)."""

    def __init__(self, image_size: int = 256, in_channels: int = 3, model_channels: int = 256,
                 out_channels: int = 3, num_res_blocks: int = 2,
                 attention_resolutions: Sequence[int] = (32, 16, 8),
                 channel_mult: Sequence[int] = (1, 1, 2, 2, 4, 4),
                 num_head_channels: int = 64, *, generator: Optional[torch.Generator] = None):
        """The weights are drawn by the JAX package's rule
        (``layers.init_as_flax``) from ``generator``, torch's default
        generator when None."""
        super().__init__()
        self.image_size, self.model_channels = image_size, model_channels
        attention_ds = {image_size // r for r in attention_resolutions}
        emb_ch = 4 * model_channels
        self.time_embed = nn.Sequential(nn.Linear(model_channels, emb_ch), nn.SiLU(),
                                        nn.Linear(emb_ch, emb_ch))

        def res(ch_in, ch_out, **kw):
            return ResBlock(ch_in, emb_ch, ch_out, **kw)

        def attn(ch):
            return AttentionBlock(ch, num_head_channels)

        ch = int(channel_mult[0] * model_channels)
        self.input_blocks = nn.ModuleList(
            [TimestepEmbedSequential(RowConv2d(in_channels, ch, 3, padding=1))])
        skips, ds = [ch], 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [res(ch, mult * model_channels)]
                ch = mult * model_channels
                if ds in attention_ds:
                    layers.append(attn(ch))
                self.input_blocks.append(TimestepEmbedSequential(*layers))
                skips.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(TimestepEmbedSequential(res(ch, ch, down=True)))
                skips.append(ch)
                ds *= 2
        self.middle_block = TimestepEmbedSequential(res(ch, ch), attn(ch), res(ch, ch))
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [res(ch + skips.pop(), model_channels * mult)]
                ch = model_channels * mult
                if ds in attention_ds:
                    layers.append(attn(ch))
                if level and i == num_res_blocks:
                    layers.append(res(ch, ch, up=True))
                    ds //= 2
                self.output_blocks.append(TimestepEmbedSequential(*layers))
        # slot 1: the SiLU, applied by the norm's kernel
        self.out = nn.Sequential(_norm(ch), nn.Identity(),
                                 RowConv2d(ch, out_channels, 3, padding=1))
        init_as_flax(self, generator)

    def forward(self, x: torch.Tensor, t: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [B, H, W, C] images at ``image_size``; t: [B] integer levels.
        ``generator`` is taken and ignored (the dropout is 0), as the
        Trainer passes one to every UNet.  Returns NHWC."""
        if spatial.current() is not None:
            raise ValueError("UnetADM does not run row-sharded (parallel.image_rows): "
                             "call it on whole images")
        if not x.shape[1] == x.shape[2] == self.image_size:
            raise ValueError(f"UnetADM(image_size={self.image_size}) got images of "
                             f"{tuple(x.shape[1:3])}")
        h = _channels_last(x.permute(0, 3, 1, 2))
        # sin/cos in fp32, then the activations' dtype: an fp32 embedding
        # would promote every block out of bf16
        emb = self.time_embed(timestep_embedding(t, self.model_channels).to(h.dtype))
        hs = []
        for block in self.input_blocks:
            h = block(h, emb)
            hs.append(h)
        h = self.middle_block(h, emb)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb)
        return self.out[2](self.out[0](h)).permute(0, 2, 3, 1)
