"""ConvNeXt UNet: the default Cold Diffusion backbone, as a torch module.

Port of ``colddiff/models/unet_convnext.py``, with the reference's module
tree (``Unet`` in deblurring_diffusion_pytorch.py:191-282), so its state-dict
names are the reference's: ``time_mlp.1``, ``downs.{i}.{0,1,2,3}``,
``mid_block1``, ``mid_attn``, ``ups.{i}.*``, ``final_conv.{0,1}``.

``forward`` takes and returns NHWC images, like the JAX module; inside, the
activations are NCHW tensors in ``torch.channels_last`` memory, which is the
NHWC layout the ConvNeXt-front kernel reads and which cuDNN takes natively.

Canonical config (celebA_128.py:78-84):
``UnetConvNext(dim=64, dim_mults=(1, 2, 4, 8), channels=3)``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .layers import (
    GELU,
    ChannelLayerNorm,
    ConvNextBlock,
    Downsample,
    LinearAttention,
    SinusoidalPosEmb,
    Upsample,
    gelu,
)

__all__ = ["UnetConvNext"]


class Residual(nn.Module):
    """x + fn(x) (deblurring...py:83-89)."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.fn(x)


class PreNorm(nn.Module):
    """fn(LayerNorm(x)) (deblurring...py:123-131)."""

    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.fn = fn
        self.norm = ChannelLayerNorm(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(self.norm(x))


def _prenorm_attention(dim: int) -> nn.Module:
    return Residual(PreNorm(dim, LinearAttention(dim)))


class UnetConvNext(nn.Module):
    def __init__(self, dim: int, out_dim: Optional[int] = None,
                 dim_mults: Sequence[int] = (1, 2, 4, 8), channels: int = 3,
                 with_time_emb: bool = True, residual: bool = False,
                 output_mean_scale: bool = False):
        super().__init__()
        self.channels = channels
        self.residual = residual
        self.output_mean_scale = output_mean_scale
        dims = [channels] + [dim * m for m in dim_mults]
        in_out = list(zip(dims[:-1], dims[1:]))
        n_res = len(in_out)

        time_dim = dim if with_time_emb else None
        self.time_mlp = nn.Sequential(
            SinusoidalPosEmb(dim), nn.Linear(dim, dim * 4), GELU(),
            nn.Linear(dim * 4, dim),
        ) if with_time_emb else None

        self.downs = nn.ModuleList()
        for ind, (dim_in, dim_out) in enumerate(in_out):
            is_last = ind >= n_res - 1
            self.downs.append(nn.ModuleList([
                ConvNextBlock(dim_in, dim_out, time_emb_dim=time_dim, norm=ind != 0),
                ConvNextBlock(dim_out, dim_out, time_emb_dim=time_dim),
                _prenorm_attention(dim_out),
                Downsample(dim_out) if not is_last else nn.Identity(),
            ]))

        mid_dim = dims[-1]
        self.mid_block1 = ConvNextBlock(mid_dim, mid_dim, time_emb_dim=time_dim)
        self.mid_attn = _prenorm_attention(mid_dim)
        self.mid_block2 = ConvNextBlock(mid_dim, mid_dim, time_emb_dim=time_dim)

        # every up level upsamples: the reference's is_last test over
        # reversed(in_out[1:]) is never true
        self.ups = nn.ModuleList()
        for dim_in, dim_out in reversed(in_out[1:]):
            self.ups.append(nn.ModuleList([
                ConvNextBlock(dim_out * 2, dim_in, time_emb_dim=time_dim),
                ConvNextBlock(dim_in, dim_in, time_emb_dim=time_dim),
                _prenorm_attention(dim_in),
                Upsample(dim_in),
            ]))

        self.final_conv = nn.Sequential(
            ConvNextBlock(dim, dim),
            nn.Conv2d(dim, out_dim if out_dim is not None else channels, 1),
        )

    def forward(self, x: torch.Tensor, time: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x: [B, H, W, C] images; time: [B] integer levels.  Returns NHWC.
        ``generator`` is taken and ignored (this UNet has no dropout), as the
        JAX module ignores ``train``, so a Trainer calls both families alike."""
        orig_x = x
        x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        t = None
        if self.time_mlp is not None and time is not None:
            # sin/cos in fp32, then cast to the activation dtype: an fp32
            # embedding would promote every later layer out of bf16
            t = self.time_mlp[0](time).to(x.dtype)
            t = self.time_mlp[3](gelu(self.time_mlp[1](t)))

        original_mean = x.mean(dim=(1, 2, 3), keepdim=True)

        hs = []
        for block1, block2, attn, downsample in self.downs:
            x = block1(x, t)
            x = block2(x, t)
            x = attn(x)
            hs.append(x)
            x = downsample(x)

        x = self.mid_block1(x, t)
        x = self.mid_attn(x)
        x = self.mid_block2(x, t)

        # hs[0] (the level-0 skip) is never popped, as in the reference
        for block1, block2, attn, upsample in self.ups:
            x = torch.cat([x, hs.pop()], dim=1)
            x = block1(x, t)
            x = block2(x, t)
            x = attn(x)
            x = upsample(x)

        out = self.final_conv[1](self.final_conv[0](x)).permute(0, 2, 3, 1)

        if self.residual:
            return out + orig_x
        if self.output_mean_scale:
            out_mean = out.mean(dim=(1, 2, 3), keepdim=True)
            out = out - original_mean + out_mean
        return out
