"""DDPM ResNet UNet (Ho et al.) as a torch module.

Port of ``colddiff/models/unet_resnet.py``, with the module tree of the
reference's ``Model`` (deblurring-diffusion-pytorch/.../Model2.py:191-332,
plus the ``with_time_emb`` flag of snowification/diffusion/model/
unet_resnet.py), so its state-dict names are the reference's:
``temb.dense.{0,1}``, ``conv_in``, ``down.{i}.block.{j}``,
``down.{i}.attn.{j}``, ``down.{i}.downsample.conv``, ``mid.block_1``,
``mid.attn_1``, ``mid.block_2``, ``up.{i}.block.{j}``, ``up.{i}.attn.{j}``,
``up.{i}.upsample.conv``, ``norm_out``, ``conv_out``.

``forward`` takes and returns NHWC images, like the JAX module; inside, the
activations are NCHW tensors in ``torch.channels_last`` memory.  Dropout
draws its masks only from the ``generator`` passed to ``forward``
(``layers.dropout``).  No hand-written kernel runs here: the JAX twin
reaches no Pallas kernel.

Canonical CIFAR-10 config (cifar10_train.py:71-78):
``UnetResNet(resolution=32, ch=128, ch_mult=(1,2,2,2), num_res_blocks=2,
attn_resolutions=(16,), dropout=0.1)``.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import FusedGroupNormSwish, SoftmaxAttention, dropout, swish

__all__ = ["UnetResNet", "timestep_embedding"]


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Fairseq-style sinusoidal embedding (Model2.py:6-24), in fp32."""
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                     * (-math.log(10000.0) / (half - 1)))
    ang = t.to(torch.float32)[:, None] * freq[None, :]
    emb = torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class ResnetBlock(nn.Module):
    """GroupNorm(32) + swish ResNet block with a time bias (Model2.py:76-133);
    dropout after ``norm2``."""

    def __init__(self, in_ch: int, out_ch: int, temb_ch: Optional[int], p: float):
        super().__init__()
        self.p = p
        self.norm1 = FusedGroupNormSwish(in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.temb_proj = nn.Linear(temb_ch, out_ch) if temb_ch is not None else None
        self.norm2 = FusedGroupNormSwish(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.nin_shortcut = nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch else None

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.conv1(self.norm1(x))
        if temb is not None and self.temb_proj is not None:
            h = h + self.temb_proj(swish(temb))[:, :, None, None]
        h = dropout(self.norm2(h), self.p, self.training, generator)
        h = self.conv2(h)
        if self.nin_shortcut is not None:
            x = self.nin_shortcut(x)
        return x + h


class _Downsample(nn.Module):
    """A (0, 1) bottom/right pad and a VALID stride-2 3x3 conv, or 2x2
    average pooling (Model2.py:54-73)."""

    def __init__(self, ch: int, with_conv: bool):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2) if with_conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.conv is not None:
            return self.conv(F.pad(x, (0, 1, 0, 1)))
        return F.avg_pool2d(x, 2, 2)


class _Upsample(nn.Module):
    """Nearest x2, then a 3x3 conv (Model2.py:36-51)."""

    def __init__(self, ch: int, with_conv: bool):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1) if with_conv else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        return self.conv(x) if self.conv is not None else x


class _Level(nn.Module):
    """One resolution level: ``block``, ``attn`` and the resampler."""

    def __init__(self):
        super().__init__()
        self.block = nn.ModuleList()
        self.attn = nn.ModuleList()


class UnetResNet(nn.Module):
    def __init__(self, ch: int, out_ch: int = 3, ch_mult: Sequence[int] = (1, 2, 4, 8),
                 num_res_blocks: int = 2, attn_resolutions: Sequence[int] = (16,),
                 dropout: float = 0.0, resamp_with_conv: bool = True,
                 in_channels: int = 3, resolution: int = 32, with_time_emb: bool = True):
        super().__init__()
        self.ch = ch
        self.resolution = resolution
        self.num_res_blocks = num_res_blocks
        self.attn_resolutions = tuple(attn_resolutions)
        self.with_time_emb = with_time_emb
        temb_ch = ch * 4 if with_time_emb else None
        if with_time_emb:
            self.temb = nn.Module()
            self.temb.dense = nn.ModuleList([nn.Linear(ch, temb_ch),
                                             nn.Linear(temb_ch, temb_ch)])
        self.conv_in = nn.Conv2d(in_channels, ch, 3, padding=1)

        num_res = len(ch_mult)
        in_mult = (1,) + tuple(ch_mult)
        curr_res = resolution
        self.down = nn.ModuleList()
        for i in range(num_res):
            level = _Level()
            block_in, block_out = ch * in_mult[i], ch * ch_mult[i]
            for _ in range(num_res_blocks):
                level.block.append(ResnetBlock(block_in, block_out, temb_ch, dropout))
                block_in = block_out
                if curr_res in self.attn_resolutions:
                    level.attn.append(SoftmaxAttention(block_in))
            if i != num_res - 1:
                level.downsample = _Downsample(block_in, resamp_with_conv)
                curr_res //= 2
            self.down.append(level)

        self.mid = nn.Module()
        self.mid.block_1 = ResnetBlock(block_in, block_in, temb_ch, dropout)
        self.mid.attn_1 = SoftmaxAttention(block_in)
        self.mid.block_2 = ResnetBlock(block_in, block_in, temb_ch, dropout)

        # up[i] is level i, as the reference's up.insert(0, ...) leaves it
        ups = []
        for i in reversed(range(num_res)):
            level = _Level()
            block_out = ch * ch_mult[i]
            for j in range(num_res_blocks + 1):
                skip_in = ch * ch_mult[i] if j < num_res_blocks else ch * in_mult[i]
                level.block.append(ResnetBlock(block_in + skip_in, block_out, temb_ch,
                                               dropout))
                block_in = block_out
                if curr_res in self.attn_resolutions:
                    level.attn.append(SoftmaxAttention(block_in))
            if i != 0:
                level.upsample = _Upsample(block_in, resamp_with_conv)
                curr_res *= 2
            ups.insert(0, level)
        self.up = nn.ModuleList(ups)

        self.norm_out = FusedGroupNormSwish(block_in)
        self.conv_out = nn.Conv2d(block_in, out_ch, 3, padding=1)

    def forward(self, x: torch.Tensor, t: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [B, H, W, C] images at ``resolution``; t: [B] integer levels.
        ``generator`` draws the dropout masks in training mode.  Returns NHWC."""
        if not x.shape[1] == x.shape[2] == self.resolution:
            raise ValueError(f"UnetResNet(resolution={self.resolution}) got images of "
                             f"{tuple(x.shape[1:3])}")
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        temb = None
        if self.with_time_emb and t is not None:
            # sin/cos in fp32, then cast to the activation dtype: an fp32
            # embedding would promote every block out of bf16
            temb = timestep_embedding(t, self.ch).to(x.dtype)
            temb = self.temb.dense[1](swish(self.temb.dense[0](temb)))

        hs = [self.conv_in(x)]
        for level in self.down:
            for j, block in enumerate(level.block):
                h = block(hs[-1], temb, generator)
                if len(level.attn):
                    h = level.attn[j](h)
                hs.append(h)
            if hasattr(level, "downsample"):
                hs.append(level.downsample(hs[-1]))

        h = self.mid.block_1(hs[-1], temb, generator)
        h = self.mid.attn_1(h)
        h = self.mid.block_2(h, temb, generator)

        for level in reversed(self.up):
            for j, block in enumerate(level.block):
                h = block(torch.cat([h, hs.pop()], dim=1), temb, generator)
                if len(level.attn):
                    h = level.attn[j](h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)

        return self.conv_out(self.norm_out(h)).permute(0, 2, 3, 1)
