"""ADM, guided-diffusion's UNet (Dhariwal & Nichol, arXiv:2105.05233).

The configuration's ``model`` group holds guided-diffusion's flags under
their names (``num_channels``, ``num_res_blocks``, ``attention_resolutions``
in pixels, ``channel_mult``, ``num_head_channels``, ``dropout``,
``resblock_updown``, ``use_scale_shift_norm``).  The last three are those of
``256x256_diffusion_uncond.pt``, which the port and the reference fix: 0,
true and true, and any other value is refused.  ``learn_sigma`` must be
false: Cold Diffusion predicts the image alone, so the UNet has
``channels`` outputs, not the variance half besides.

Besides ``port`` and ``reference`` this family defines the optional
``norms(config)``: every GroupNorm call of one forward, in order, each as
``{"hw": pixels, "c": channels, "per_image_affine": AdaGN's [B, C] affine,
"swish": SiLU after it}``, read off the reference's forward on the meta
device.  ``metrics/norm_roofline.py`` counts the bytes those calls need from
it; a family without ``norms`` has no such metric.
"""

from __future__ import annotations

import torch
from torch import nn

from ..reference.adm import UnetADM

FIXED = {"dropout": 0.0, "resblock_updown": True, "use_scale_shift_norm": True}


def _flags(config: dict) -> dict:
    m = config["model"]
    if config.get("learn_sigma", False):
        raise ValueError("UnetADM: learn_sigma is not taken (Cold Diffusion predicts the "
                         "image alone, no variance)")
    if any(m[k] != v for k, v in FIXED.items()):
        raise ValueError(f"UnetADM runs only {FIXED}, the 256x256_diffusion_uncond flags")
    c = config["channels"]
    return dict(image_size=config["image_size"], in_channels=c,
                model_channels=m["num_channels"], out_channels=c,
                num_res_blocks=m["num_res_blocks"],
                attention_resolutions=tuple(m["attention_resolutions"]),
                channel_mult=tuple(m["channel_mult"]),
                num_head_channels=m["num_head_channels"])


def port(config: dict) -> torch.nn.Module:
    from colddiff_torch.models import UnetADM as Port

    with torch.device("meta"):
        return Port(**_flags(config))


def reference(config: dict) -> torch.nn.Module:
    return UnetADM(**_flags(config))


def norms(config: dict) -> list[dict]:
    """The GroupNorm calls of one forward, in order (see the module
    docstring): the reference's ``nn.GroupNorm`` modules as a forward on the
    meta device calls them.  A ResBlock's ``out_layers.0`` takes AdaGN's
    per-image affine; a norm followed by an ``nn.SiLU`` in its block has
    swish."""
    with torch.device("meta"):
        model = reference(config)
    mods = dict(model.named_modules())
    calls = []

    def hook(name):
        block, _, slot = name.rpartition(".")
        swish = slot.isdigit() and isinstance(mods.get(f"{block}.{int(slot) + 1}"), nn.SiLU)

        def record(module, args, out):
            x = args[0]
            calls.append({"hw": x.shape[2] * x.shape[3], "c": x.shape[1],
                          "per_image_affine": name.endswith("out_layers.0"), "swish": swish})
        return record

    for name, m in mods.items():
        if isinstance(m, nn.GroupNorm):
            m.register_forward_hook(hook(name))
    s = config["image_size"]
    with torch.no_grad(), torch.device("meta"):
        model(torch.zeros(1, s, s, config["channels"]), torch.zeros(1, dtype=torch.long))
    return calls
