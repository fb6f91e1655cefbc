"""The Mosaic bisection probes of ``scripts/bisect_mosaic.py``, on the GPU.

    python -m colddiff_torch.scripts.bisect_mosaic

Draws the JAX script's inputs (``np.random.default_rng(0)``, in the same
order and shapes), runs its four probes as the CUDA kernels of
``colddiff_torch.ops.bisect_mosaic`` on ``cuda:0`` and prints one
``"<name>: OK sum=<float>"`` line each, as the JAX script does.  On the TPU
a compiler crash was the finding and the script caught it; here a failure
is a fault, so it propagates and the script exits non-zero.  Without a CUDA
device the script exits non-zero at once.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from colddiff_torch.ops.bisect_mosaic import (
    probe_dyn_sublane,
    probe_masked_norm,
    probe_roll,
    probe_roll_slice,
)

ROLL = 64  # the TPU probes roll each row left by 64 lanes
SPLIT = 8192  # roll_then_slice keeps the rolled row up to this column


def inputs(device) -> dict:
    """The JAX script's three fp32 inputs, drawn in its order."""
    rng = np.random.default_rng(0)

    def draw(shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)

    return {"x": draw((1, 64, 8576)), "xn": draw((1, 64, 8192)), "xd": draw((1, 70, 8576))}


def probes(device) -> list:
    """(name, output) of the four probes on ``device``."""
    a = inputs(device)
    w = a["x"].shape[-1]
    return [
        ("roll_whole_row", probe_roll(a["x"], w - ROLL)),
        ("roll_then_slice", probe_roll_slice(a["x"], w - ROLL, SPLIT)),
        ("masked_norm", probe_masked_norm(a["xn"])),
        ("dyn_sublane", probe_dyn_sublane(a["xd"])),
    ]


def main() -> int:
    if not torch.cuda.is_available():
        print("bisect_mosaic: no CUDA device; the probes run on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    for name, y in probes(torch.device("cuda", 0)):
        print(f"{name}: OK sum={float(torch.sum(y)):.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
