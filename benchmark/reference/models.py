"""Plain PyTorch copies of the two UNets the benchmark runs.

Frozen copies of the arithmetic of ``colddiff_torch.models.unet_convnext``
(the reference Cold Diffusion ``Unet``) and ``colddiff_torch.models.unet_resnet``
(the DDPM CIFAR-10 ``Model``), with their module trees, so one state dict
loads into either side under the same names.  Everything is stock torch:
the ConvNeXt block front is a depthwise conv, a bias, the time conditioning
and a channel LayerNorm; no kernel of the port runs here and nothing of the
port is imported.  The linear attention keeps the port's folded form, so a
FLOP counter reads the same convolutions and matrix products on both sides.

Every convolution, linear layer and matrix product takes its operands
through ``q``: the identity for the reference, a lower-precision rounding
for the benchmark's control (``benchmark.reference.precision``).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

Cast = Callable[[torch.Tensor], torch.Tensor]


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def conv(q: Cast, m: nn.Conv2d, x: torch.Tensor, padding=None) -> torch.Tensor:
    return F.conv2d(q(x), q(m.weight), m.bias, m.stride,
                    m.padding if padding is None else padding, m.dilation, m.groups)


def linear(q: Cast, m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    return F.linear(q(x), q(m.weight), m.bias)


def einsum(q: Cast, eq: str, *xs: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, *(q(x) for x in xs))


def sinusoidal(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                     * (-math.log(10000.0) / (half - 1)))
    ang = t.to(torch.float32)[:, None] * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# --------------------------------------------------------------------------
# ConvNeXt UNet (deblurring_diffusion_pytorch.py:83-282)


class ChannelLayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(1, dim, 1, 1))
        self.b = nn.Parameter(torch.zeros(1, dim, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=1, keepdim=True)
        var = x.var(dim=1, unbiased=False, keepdim=True)
        return (x - mean) / torch.sqrt(var + self.eps) * self.g + self.b


class ConvNextBlock(nn.Module):
    def __init__(self, dim: int, dim_out: int, *, time_emb_dim: Optional[int] = None,
                 mult: int = 2, norm: bool = True):
        super().__init__()
        self.mlp = (nn.Sequential(nn.GELU(), nn.Linear(time_emb_dim, dim))
                    if time_emb_dim is not None else None)
        self.ds_conv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.net = nn.Sequential(
            ChannelLayerNorm(dim) if norm else nn.Identity(),
            nn.Conv2d(dim, dim_out * mult, 3, padding=1),
            nn.GELU(),
            nn.Conv2d(dim_out * mult, dim_out, 3, padding=1),
        )
        self.res_conv = nn.Conv2d(dim, dim_out, 1) if dim != dim_out else None

    def forward(self, x, t, q: Cast):
        h = conv(q, self.ds_conv, x)
        if self.mlp is not None and t is not None:
            h = h + linear(q, self.mlp[1], F.gelu(t))[:, :, None, None]
        h = self.net[0](h)
        h = conv(q, self.net[3], F.gelu(conv(q, self.net[1], h)))
        return h + (x if self.res_conv is None else conv(q, self.res_conv, x))


class LinearAttention(nn.Module):
    def __init__(self, dim: int, heads: int = 4, dim_head: int = 32):
        super().__init__()
        self.heads = heads
        self.scale = dim_head ** -0.5
        hidden = heads * dim_head
        self.to_qkv = nn.Conv2d(dim, hidden * 3, 1, bias=False)
        self.to_out = nn.Conv2d(hidden, dim, 1)

    def forward(self, x, q: Cast):
        b, c, hgt, wid = x.shape
        xt = x.permute(0, 2, 3, 1).reshape(b, hgt * wid, c)
        wqkv = self.to_qkv.weight[:, :, 0, 0]
        wout, bout = self.to_out.weight[:, :, 0, 0], self.to_out.bias
        hidden = wqkv.shape[0] // 3
        d = hidden // self.heads
        i = torch.arange(hidden, device=x.device)
        mask = ((i[:, None] // d) == (i[None, :] // d)).to(x.dtype)
        kv = einsum(q, "bnc,kc->bnk", xt, wqkv[hidden:])
        ks = torch.softmax(kv[..., :hidden].transpose(1, 2), dim=-1)
        ctx = einsum(q, "bdn,bne->bde", ks, kv[..., hidden:]) * mask
        w1 = einsum(q, "dc,bde->bce", wqkv[:hidden] * self.scale, ctx)
        if c <= hidden:
            out = einsum(q, "bnc,bcf->bnf", xt, q(w1) @ q(wout.t())) + bout
        else:
            out = einsum(q, "bne,fe->bnf", einsum(q, "bnc,bce->bne", xt, w1), wout) + bout
        return out.reshape(b, hgt, wid, c).permute(0, 3, 1, 2)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.fn = fn
        self.norm = ChannelLayerNorm(dim)


class Residual(nn.Module):
    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x, q: Cast):
        return x + self.fn.fn(self.fn.norm(x), q)


class UnetConvNext(nn.Module):
    """``Unet(dim, dim_mults)`` of the reference, NHWC in and out."""

    def __init__(self, dim: int, dim_mults: Sequence[int] = (1, 2, 4, 8), channels: int = 3):
        super().__init__()
        dims = [channels] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        self.time_mlp = nn.Sequential(nn.Identity(), nn.Linear(dim, dim * 4), nn.GELU(),
                                      nn.Linear(dim * 4, dim))
        self.dim = dim
        self.downs = nn.ModuleList()
        for ind, (dim_in, dim_out) in enumerate(in_out):
            last = ind == len(in_out) - 1
            self.downs.append(nn.ModuleList([
                ConvNextBlock(dim_in, dim_out, time_emb_dim=dim, norm=ind != 0),
                ConvNextBlock(dim_out, dim_out, time_emb_dim=dim),
                Residual(PreNorm(dim_out, LinearAttention(dim_out))),
                nn.Conv2d(dim_out, dim_out, 4, 2, 1) if not last else nn.Identity(),
            ]))
        mid = dims[-1]
        self.mid_block1 = ConvNextBlock(mid, mid, time_emb_dim=dim)
        self.mid_attn = Residual(PreNorm(mid, LinearAttention(mid)))
        self.mid_block2 = ConvNextBlock(mid, mid, time_emb_dim=dim)
        self.ups = nn.ModuleList()
        for dim_in, dim_out in reversed(in_out[1:]):
            self.ups.append(nn.ModuleList([
                ConvNextBlock(dim_out * 2, dim_in, time_emb_dim=dim),
                ConvNextBlock(dim_in, dim_in, time_emb_dim=dim),
                Residual(PreNorm(dim_in, LinearAttention(dim_in))),
                nn.ConvTranspose2d(dim_in, dim_in, 4, 2, 1),
            ]))
        self.final_conv = nn.Sequential(ConvNextBlock(dim, dim), nn.Conv2d(dim, channels, 1))

    def forward(self, x: torch.Tensor, time: torch.Tensor, q: Cast = identity):
        x = x.permute(0, 3, 1, 2)
        t = linear(q, self.time_mlp[1], sinusoidal(time, self.dim))
        t = linear(q, self.time_mlp[3], F.gelu(t))
        hs = []
        for block1, block2, attn, down in self.downs:
            x = attn(block2(block1(x, t, q), t, q), q)
            hs.append(x)
            x = x if isinstance(down, nn.Identity) else conv(q, down, x)
        x = self.mid_block2(self.mid_attn(self.mid_block1(x, t, q), q), t, q)
        for block1, block2, attn, up in self.ups:
            x = attn(block2(block1(torch.cat([x, hs.pop()], dim=1), t, q), t, q), q)
            x = F.conv_transpose2d(q(x), q(up.weight), up.bias, 2, 1)
        x = conv(q, self.final_conv[1], self.final_conv[0](x, None, q))
        return x.permute(0, 2, 3, 1)


# --------------------------------------------------------------------------
# DDPM ResNet UNet (Model2.py:6-332)


def group_norm(m: nn.GroupNorm, x: torch.Tensor, swish: bool = True) -> torch.Tensor:
    y = F.group_norm(x, m.num_groups, m.weight, m.bias, m.eps)
    return F.silu(y) if swish else y


def _group_norm(ch: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, ch, eps=1e-6)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_ch: int):
        super().__init__()
        self.norm1 = _group_norm(in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.temb_proj = nn.Linear(temb_ch, out_ch)
        self.norm2 = _group_norm(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.nin_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x, temb, q: Cast):
        h = conv(q, self.conv1, group_norm(self.norm1, x))
        h = h + linear(q, self.temb_proj, F.silu(temb))[:, :, None, None]
        h = conv(q, self.conv2, group_norm(self.norm2, h))
        return h + (x if self.nin_shortcut is None else conv(q, self.nin_shortcut, x))


class SoftmaxAttention(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = _group_norm(dim)
        self.q = nn.Conv2d(dim, dim, 1)
        self.k = nn.Conv2d(dim, dim, 1)
        self.v = nn.Conv2d(dim, dim, 1)
        self.proj_out = nn.Conv2d(dim, dim, 1)

    def forward(self, x, q: Cast):
        b, c, hgt, wid = x.shape
        h = group_norm(self.norm, x, swish=False)

        def tokens(m):
            return conv(q, m, h).permute(0, 2, 3, 1).reshape(b, hgt * wid, c)

        qq, kk, vv = tokens(self.q), tokens(self.k), tokens(self.v)
        w = torch.softmax(torch.bmm(q(qq), q(kk.transpose(1, 2))) * (c ** -0.5), dim=-1)
        out = torch.bmm(q(w), q(vv)).reshape(b, hgt, wid, c).permute(0, 3, 1, 2)
        return x + conv(q, self.proj_out, out)


class _Level(nn.Module):
    def __init__(self):
        super().__init__()
        self.block = nn.ModuleList()
        self.attn = nn.ModuleList()


class UnetResNet(nn.Module):
    """The DDPM CIFAR-10 ``Model``, NHWC in and out, without dropout: the
    benchmark compares it in evaluation only."""

    def __init__(self, ch: int = 128, ch_mult: Sequence[int] = (1, 2, 2, 2),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (16,),
                 resolution: int = 32, channels: int = 3):
        super().__init__()
        self.ch = ch
        temb_ch = ch * 4
        self.temb = nn.Module()
        self.temb.dense = nn.ModuleList([nn.Linear(ch, temb_ch), nn.Linear(temb_ch, temb_ch)])
        self.conv_in = nn.Conv2d(channels, ch, 3, padding=1)
        in_mult = (1,) + tuple(ch_mult)
        res = resolution
        self.down = nn.ModuleList()
        for i, mult in enumerate(ch_mult):
            level = _Level()
            block_in, block_out = ch * in_mult[i], ch * mult
            for _ in range(num_res_blocks):
                level.block.append(ResnetBlock(block_in, block_out, temb_ch))
                block_in = block_out
                if res in attn_resolutions:
                    level.attn.append(SoftmaxAttention(block_in))
            if i != len(ch_mult) - 1:
                level.downsample = nn.Module()
                level.downsample.conv = nn.Conv2d(block_in, block_in, 3, stride=2)
                res //= 2
            self.down.append(level)
        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(block_in, block_in, temb_ch)
        self.mid.attn_1 = SoftmaxAttention(block_in)
        self.mid.block_2 = ResnetBlock(block_in, block_in, temb_ch)
        ups = []
        for i in reversed(range(len(ch_mult))):
            level = _Level()
            block_out = ch * ch_mult[i]
            for j in range(num_res_blocks + 1):
                skip = ch * ch_mult[i] if j < num_res_blocks else ch * in_mult[i]
                level.block.append(ResnetBlock(block_in + skip, block_out, temb_ch))
                block_in = block_out
                if res in attn_resolutions:
                    level.attn.append(SoftmaxAttention(block_in))
            if i != 0:
                level.upsample = nn.Module()
                level.upsample.conv = nn.Conv2d(block_in, block_in, 3, padding=1)
                res *= 2
            ups.insert(0, level)
        self.up = nn.ModuleList(ups)
        self.norm_out = _group_norm(block_in)
        self.conv_out = nn.Conv2d(block_in, channels, 3, padding=1)

    def forward(self, x: torch.Tensor, t: torch.Tensor, q: Cast = identity):
        x = x.permute(0, 3, 1, 2)
        temb = linear(q, self.temb.dense[0], sinusoidal(t, self.ch))
        temb = linear(q, self.temb.dense[1], F.silu(temb))
        hs = [conv(q, self.conv_in, x)]
        for level in self.down:
            for j, block in enumerate(level.block):
                h = block(hs[-1], temb, q)
                hs.append(level.attn[j](h, q) if len(level.attn) else h)
            if hasattr(level, "downsample"):
                hs.append(conv(q, level.downsample.conv, F.pad(hs[-1], (0, 1, 0, 1))))
        h = self.mid.block_1(hs[-1], temb, q)
        h = self.mid.block_2(self.mid.attn_1(h, q), temb, q)
        for level in reversed(self.up):
            for j, block in enumerate(level.block):
                h = block(torch.cat([h, hs.pop()], dim=1), temb, q)
                if len(level.attn):
                    h = level.attn[j](h, q)
            if hasattr(level, "upsample"):
                h = conv(q, level.upsample.conv, F.interpolate(h, scale_factor=2.0,
                                                               mode="nearest"))
        return conv(q, self.conv_out, group_norm(self.norm_out, h)).permute(0, 2, 3, 1)


def build(config: dict) -> nn.Module:
    """The reference UNet of a benchmark configuration (``configs/*.json``),
    from its family's file (``benchmark/families/<family>.py``)."""
    from .. import families  # here, not above: the family files import this module

    return families.find(config).reference(config)
