"""Model families, each found by the name a configuration gives under
``model.family``, as drivers are found by a traffic's ``kind``.

``families/<family>.py`` defines two functions of the configuration:

- ``port(config)``: the port's UNet, built under ``torch.device("meta")``
  (the benchmark loads its own weights into it); it imports
  ``colddiff_torch`` inside the function, so that resolving a family loads
  nothing of the program;
- ``reference(config)``: the plain fp32 reference UNet (``reference/``),
  NHWC in and out, ``forward(x, t, q)``;
- optionally ``fronts(config)``: the port's block front kernels a forward
  launches (``flops.fronts``), for a family that has them.

A new family is new files only: this family file and its reference module.
"""

from __future__ import annotations

import importlib
from pathlib import Path
from types import ModuleType


def find(config: dict) -> ModuleType:
    """The family module of ``config``'s ``model.family``."""
    family = config["model"]["family"]
    name = f"{__name__}.{family}"
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name != name:  # the family file is there, and imports what is not
            raise
    looked = " or ".join(str(Path(p) / f"{family}.py") for p in __path__)
    raise ValueError(f"no model family {family!r}: looked for {looked}")
