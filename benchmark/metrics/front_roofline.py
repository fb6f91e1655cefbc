"""The least time of the stretch's block fronts over their device time, in
%.  The least time is counted from the configuration: every forward's
fronts (``flops.fronts``) at the forward's batch, in ``dtype_bytes``-byte
elements, bounded by bytes or fp32 operations (``flops.front_bound``).  The
device time is that of the kernels whose names start with
``kernel_prefix``."""

import re

from .. import flops


def _kernel_name(name: str) -> str:
    """``void (anonymous namespace)::k<...>(...)`` -> ``k``."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", name)[0].rsplit("::", 1)[-1]


def read(stretch, params, cell):
    device_ns = sum(hi - lo for name, lo, hi, _ in stretch.ops
                    if _kernel_name(name).startswith(params["kernel_prefix"]))
    calls = stretch.work.get("forward_calls", 0)
    if not device_ns or not calls:
        return None
    least_ms = calls * flops.fronts_bound_ms(cell["config"], stretch.work["forward_batch"],
                                             params["dtype_bytes"])
    return 100.0 * least_ms * 1e6 / device_ns
