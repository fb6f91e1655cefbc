"""Model selector, the twin of ``colddiff/models/get_model.py``
(snowification/diffusion/model/get_model.py:4-36).  Models are built on the
CPU, their weights drawn by the JAX package's rule from ``generator``
(``layers.init_as_flax``; torch's default generator when None); the caller
moves them."""

from __future__ import annotations

import torch

from .unet_convnext import UnetConvNext
from .unet_resnet import UnetResNet

__all__ = ["get_model"]


def get_model(
    model: str = "UnetConvNext",
    *,
    dataset: str = "",
    image_size: int | None = None,
    channels: int = 3,
    with_time_emb: bool = True,
    residual: bool = False,
    dim: int = 64,
    dim_mults=(1, 2, 4, 8),
    dropout: float = 0.1,
    output_mean_scale: bool = False,
    generator: torch.Generator | None = None,
):
    if model == "UnetConvNext":
        return UnetConvNext(
            dim=dim,
            dim_mults=tuple(dim_mults),
            channels=channels,
            with_time_emb=with_time_emb,
            residual=residual,
            output_mean_scale=output_mean_scale,
            generator=generator,
        )
    if model == "UnetResNet":
        if image_size is None:
            image_size = 32 if "cifar10" in dataset else 128
        return UnetResNet(
            resolution=image_size,
            in_channels=channels,
            out_ch=channels,
            ch=128,
            ch_mult=(1, 2, 2, 2),
            num_res_blocks=2,
            attn_resolutions=(16,),
            with_time_emb=with_time_emb,
            dropout=dropout,
            generator=generator,
        )
    raise ValueError(f"unknown model: {model}")
