"""Plain PyTorch copy of ADM, the UNet of Dhariwal & Nichol (arXiv:2105.05233),
as openai/guided-diffusion's ``UNetModel`` defines it (``unet.py``, ``nn.py``).

The module tree and names are guided-diffusion's, so one state dict loads
into this reference and into the port's ``UnetADM``; qkv and proj_out are
1x1 ``Conv2d`` (guided-diffusion's are ``Conv1d``), and the slots of
guided-diffusion's SiLU and Dropout hold parameterless modules.  Everything
is stock torch in fp32, and nothing of the port is imported:

- every norm is an ``nn.GroupNorm`` module with 32 groups and eps 1e-5,
  its affine included; in a ResBlock the second norm is then ``* (1 +
  scale) + shift`` and SiLU, in guided-diffusion's order
  (``use_scale_shift_norm``);
- a down or up ResBlock resamples by 2x2 average pooling or nearest x2
  (``resblock_updown``), and there is no dropout (the published 0);
- the time embedding is ``cat[cos, sin]`` of ``t * exp(-ln(1e4) i / half)``;
- attention is two einsums over heads of ``num_head_channels`` in the
  legacy q, k, v order, the softmax over the keys in fp32, scale 1/sqrt(d);
- every convolution, linear layer and matrix product takes its operands
  through ``q``, as in ``reference/models.py``.

With gradients enabled (a train cell's reference), each input, middle and
output block runs under ``torch.utils.checkpoint`` (non-reentrant), so that
16 images at 256 px fit on the card in fp32: the blocks' activations are
recomputed in the backward, the values and gradients are those of the plain
forward.  Under ``no_grad`` (the sampler's reference, ``flops.forward_flops``)
the forward runs plainly.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .models import Cast, conv, einsum, identity, linear

GROUPS, EPS = 32, 1e-5


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freq = torch.exp(-math.log(10000.0)
                     * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    ang = t.to(torch.float32)[:, None] * freq[None, :]
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)


def _gn(ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(GROUPS, ch, eps=EPS)


def _resample(x: torch.Tensor, up: bool, down: bool) -> torch.Tensor:
    if up:
        return F.interpolate(x, scale_factor=2.0, mode="nearest")
    return F.avg_pool2d(x, 2, 2) if down else x


class ResBlock(nn.Module):
    def __init__(self, ch: int, emb_ch: int, out_ch: int, up: bool = False, down: bool = False):
        super().__init__()
        self.up, self.down = up, down
        self.in_layers = nn.Sequential(_gn(ch), nn.SiLU(), nn.Conv2d(ch, out_ch, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_ch, 2 * out_ch))
        self.out_layers = nn.Sequential(_gn(out_ch), nn.SiLU(), nn.Identity(),
                                        nn.Conv2d(out_ch, out_ch, 3, padding=1))
        self.skip_connection = nn.Identity() if out_ch == ch else nn.Conv2d(ch, out_ch, 1)

    def forward(self, x, emb, q: Cast):
        h = _resample(F.silu(self.in_layers[0](x)), self.up, self.down)
        x = _resample(x, self.up, self.down)
        h = conv(q, self.in_layers[2], h)
        emb_out = linear(q, self.emb_layers[1], F.silu(emb))[:, :, None, None]
        scale, shift = emb_out.chunk(2, dim=1)
        h = self.out_layers[0](h) * (1 + scale) + shift
        h = conv(q, self.out_layers[3], F.silu(h))
        skip = x if isinstance(self.skip_connection, nn.Identity) else conv(
            q, self.skip_connection, x)
        return skip + h


class AttentionBlock(nn.Module):
    def __init__(self, ch: int, head_channels: int):
        super().__init__()
        self.heads = ch // head_channels
        self.norm = _gn(ch)
        self.qkv = nn.Conv2d(ch, 3 * ch, 1)
        self.proj_out = nn.Conv2d(ch, ch, 1)

    def forward(self, x, q: Cast):
        b, c, hgt, wid = x.shape
        d = c // self.heads
        qkv = conv(q, self.qkv, self.norm(x)).reshape(b, self.heads, 3, d, hgt * wid)
        qq, kk, vv = qkv.unbind(2)  # [B, heads, d, T]
        w = torch.softmax(einsum(q, "bhdt,bhds->bhts", qq, kk).float() * d ** -0.5, dim=-1)
        a = einsum(q, "bhts,bhds->bhdt", w, vv).reshape(b, c, hgt, wid)
        return x + conv(q, self.proj_out, a)


class Block(nn.Sequential):
    """guided-diffusion's ``TimestepEmbedSequential``."""

    def forward(self, x, emb, q: Cast):
        for layer in self:
            if isinstance(layer, ResBlock):
                x = layer(x, emb, q)
            elif isinstance(layer, nn.Conv2d):
                x = conv(q, layer, x)
            else:
                x = layer(x, q)
        return x


class UnetADM(nn.Module):
    """guided-diffusion's ``UNetModel``, NHWC in and out, without dropout:
    the benchmark compares it at the published dropout, 0.
    ``attention_resolutions`` are in pixels, as the flag gives them."""

    def __init__(self, image_size: int, in_channels: int, model_channels: int,
                 out_channels: int, num_res_blocks: int, attention_resolutions: Sequence[int],
                 channel_mult: Sequence[int], num_head_channels: int):
        super().__init__()
        self.model_channels = model_channels
        attention_ds = {image_size // r for r in attention_resolutions}
        emb_ch = 4 * model_channels
        self.time_embed = nn.Sequential(nn.Linear(model_channels, emb_ch), nn.SiLU(),
                                        nn.Linear(emb_ch, emb_ch))

        def res(ch_in, ch_out, **kw):
            return ResBlock(ch_in, emb_ch, ch_out, **kw)

        ch = channel_mult[0] * model_channels
        self.input_blocks = nn.ModuleList([Block(nn.Conv2d(in_channels, ch, 3, padding=1))])
        skips, ds = [ch], 1
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                layers = [res(ch, mult * model_channels)]
                ch = mult * model_channels
                if ds in attention_ds:
                    layers.append(AttentionBlock(ch, num_head_channels))
                self.input_blocks.append(Block(*layers))
                skips.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(Block(res(ch, ch, down=True)))
                skips.append(ch)
                ds *= 2
        self.middle_block = Block(res(ch, ch), AttentionBlock(ch, num_head_channels),
                                  res(ch, ch))
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                layers = [res(ch + skips.pop(), mult * model_channels)]
                ch = mult * model_channels
                if ds in attention_ds:
                    layers.append(AttentionBlock(ch, num_head_channels))
                if level and i == num_res_blocks:
                    layers.append(res(ch, ch, up=True))
                    ds //= 2
                self.output_blocks.append(Block(*layers))
        self.out = nn.Sequential(_gn(ch), nn.SiLU(), nn.Conv2d(ch, out_channels, 3, padding=1))

    def forward(self, x: torch.Tensor, t: torch.Tensor, q: Cast = identity):
        def run(block, h):
            if torch.is_grad_enabled():
                return checkpoint(block, h, emb, q, use_reentrant=False)
            return block(h, emb, q)

        h = x.permute(0, 3, 1, 2)
        emb = linear(q, self.time_embed[0], timestep_embedding(t, self.model_channels))
        emb = linear(q, self.time_embed[2], F.silu(emb))
        hs = []
        for block in self.input_blocks:
            h = run(block, h)
            hs.append(h)
        h = run(self.middle_block, h)
        for block in self.output_blocks:
            h = run(block, torch.cat([h, hs.pop()], dim=1))
        h = conv(q, self.out[2], F.silu(self.out[0](h)))
        return h.permute(0, 2, 3, 1)
