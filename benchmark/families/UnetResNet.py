"""The DDPM CIFAR-10 ResNet UNet (Ho et al. 2020, ``Model``)."""

from __future__ import annotations

import torch

from ..reference.models import UnetResNet


def port(config: dict) -> torch.nn.Module:
    from colddiff_torch.models import UnetResNet as Port

    m, c = config["model"], config["channels"]
    with torch.device("meta"):
        return Port(m["ch"], out_ch=c, ch_mult=tuple(m["ch_mult"]),
                    num_res_blocks=m["num_res_blocks"],
                    attn_resolutions=tuple(m["attn_resolutions"]), dropout=m["dropout"],
                    in_channels=c, resolution=config["image_size"])


def reference(config: dict) -> torch.nn.Module:
    m = config["model"]
    return UnetResNet(m["ch"], tuple(m["ch_mult"]), m["num_res_blocks"],
                      tuple(m["attn_resolutions"]), config["image_size"], config["channels"])
