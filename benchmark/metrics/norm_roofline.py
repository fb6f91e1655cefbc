"""The least time of the stretch's GroupNorm forwards over the device time of
their kernel, in %.  The least time is counted from the configuration's
shapes: every forward's GroupNorm calls (the family file's ``norms``) at the
forward's batch, each reading x once and writing its output once in
``dtype_bytes``-byte elements, and reading gamma and beta once (each
image's own for a per-image affine), over ``flops.PEAK_BYTES_PER_S``.  The
device time is that of the kernels whose names start with
``kernel_prefix``.  None for a family that lists no norms, or a stretch
with no such kernel."""

from .. import families, flops
from .front_roofline import _kernel_name


def least_ms(config: dict, batch: int, dtype_bytes: int):
    """Least ms of one forward's GroupNorm calls at ``batch`` images; None
    for a family that lists no norms."""
    family = families.find(config)
    if not hasattr(family, "norms"):
        return None
    nbytes = 0
    for n in family.norms(config):
        affines = batch if n["per_image_affine"] else 1
        nbytes += dtype_bytes * (2 * batch * n["hw"] * n["c"] + 2 * affines * n["c"])
    return 1e3 * nbytes / flops.PEAK_BYTES_PER_S


def read(stretch, params, cell):
    device_ns = sum(hi - lo for name, lo, hi, _ in stretch.ops
                    if _kernel_name(name).startswith(params["kernel_prefix"]))
    calls = stretch.work.get("forward_calls", 0)
    if not device_ns or not calls:
        return None
    least = least_ms(cell["config"], stretch.work["forward_batch"], params["dtype_bytes"])
    return None if least is None else 100.0 * calls * least * 1e6 / device_ns
