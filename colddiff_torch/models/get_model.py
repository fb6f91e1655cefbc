"""Model selector, the twin of ``colddiff/models/get_model.py``
(snowification/diffusion/model/get_model.py:4-36).  Models are built on the
CPU, their weights drawn by the JAX package's rule from ``generator``
(``layers.init_as_flax``; torch's default generator when None); the caller
moves them."""

from __future__ import annotations

import torch

from .unet_adm import UnetADM
from .unet_convnext import UnetConvNext
from .unet_resnet import UnetResNet

__all__ = ["get_model"]

ADM_IMAGE_SIZE = 256  # the one ADM preset: 256x256_diffusion_uncond.pt's flags


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
    if model == "UnetADM":
        if image_size not in (None, ADM_IMAGE_SIZE):
            raise ValueError(f"UnetADM is built at {ADM_IMAGE_SIZE} px, the published "
                             f"256x256_diffusion_uncond flags; got image_size={image_size}")
        if not with_time_emb or residual or output_mean_scale:
            raise ValueError("UnetADM takes its published 256 px flags: a time embedding, no "
                             "residual and no output mean scale")
        # guided-diffusion's README flags for 256x256_diffusion_uncond.pt;
        # 3 output channels, not learn_sigma's 6
        return UnetADM(
            image_size=ADM_IMAGE_SIZE,
            in_channels=channels,
            model_channels=256,
            out_channels=channels,
            num_res_blocks=2,
            attention_resolutions=(32, 16, 8),
            channel_mult=(1, 1, 2, 2, 4, 4),
            num_head_channels=64,
            generator=generator,
        )
    raise ValueError(f"unknown model: {model}")
