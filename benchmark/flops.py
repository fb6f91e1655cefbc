"""The work a configuration asks for, counted from its shapes, and the
H100's published peaks (SXM, dense; NVIDIA's data sheet, at 700 W).

The model FLOPs of a forward are the convolutions and matrix products of
the plain reference model, counted by ``FlopCounterMode`` on the meta
device: elementwise work and norms are left out.  The ConvNeXt block fronts
are listed by their family file from the configuration's block list, each
with the least time the card could take for it (``front_bound``, a copy of
``chip_smoke``'s).
"""

from __future__ import annotations

import functools
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from . import families
from .reference import models

PEAK_BF16_FLOPS = 989e12  # tensor cores, bf16 dense
PEAK_FP32_FLOPS = 67e12  # fp32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12  # HBM3


@functools.cache
def _forward_flops(config_json: str) -> int:
    config = json.loads(config_json)
    s, c = config["image_size"], config["channels"]
    with torch.device("meta"):
        model = models.build(config)
        x, t = torch.zeros(1, s, s, c), torch.zeros(1, dtype=torch.long)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(x, t)
    return counter.get_total_flops()


def forward_flops(config: dict) -> int:
    """Model FLOPs of one image's forward at the configuration's size."""
    return _forward_flops(json.dumps(config, sort_keys=True))


def fronts(config: dict) -> list[dict]:
    """The block fronts of one forward, in launch order, as the family file's
    optional ``fronts(config)`` lists them: side ``h``, channels ``c``,
    whether a time conditioning is added and whether the LayerNorm runs
    (none for a family that defines no ``fronts``)."""
    family = families.find(config)
    return family.fronts(config) if hasattr(family, "fronts") else []


def bound(nbytes: float, flops: float):
    """(ms, "bytes" or "operations"): the least time the card could take."""
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def front_bound(b, h, w, c, has_cond, norm, esize):
    """The front's bound: x read and out written once, the weights, bias,
    cond and LayerNorm parameters read once; 49 FMAs per output."""
    outputs = b * h * w * c
    nbytes = esize * (2 * outputs + 49 * c + c + (b * c if has_cond else 0)
                      + (2 * c if norm else 0))
    return bound(nbytes, 2 * 49 * outputs)


def fronts_bound_ms(config: dict, batch: int, esize: int) -> float:
    """Least ms of one forward's fronts at ``batch`` images."""
    return sum(front_bound(batch, f["h"], f["h"], f["c"], f["cond"], f["norm"], esize)[0]
               for f in fronts(config))
