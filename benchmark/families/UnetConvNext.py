"""The ConvNeXt UNet of Cold Diffusion (the reference ``Unet(dim, dim_mults)``)."""

from __future__ import annotations

import torch

from ..reference.models import UnetConvNext


def port(config: dict) -> torch.nn.Module:
    from colddiff_torch.models import UnetConvNext as Port

    m = config["model"]
    with torch.device("meta"):
        return Port(m["dim"], dim_mults=tuple(m["dim_mults"]), channels=config["channels"])


def reference(config: dict) -> torch.nn.Module:
    m = config["model"]
    return UnetConvNext(m["dim"], tuple(m["dim_mults"]), config["channels"])


def fronts(config: dict) -> list[dict]:
    """The block fronts of one forward, in launch order (``flops.fronts``)."""
    m = config["model"]
    dims = [config["channels"]] + [m["dim"] * k for k in m["dim_mults"]]
    in_out = list(zip(dims[:-1], dims[1:]))
    res, out = config["image_size"], []

    def add(c, cond=True, norm=True):
        out.append({"h": res, "c": c, "cond": cond, "norm": norm})

    for i, (d_in, d_out) in enumerate(in_out):
        add(d_in, norm=i != 0)
        add(d_out)
        if i != len(in_out) - 1:
            res //= 2
    add(dims[-1])
    add(dims[-1])
    for d_in, d_out in reversed(in_out[1:]):
        add(d_out * 2)
        add(d_in)
        res *= 2
    add(m["dim"], cond=False)
    return out
