"""Model FLOPs of the stretch's forwards (and backwards) over the stretch's
seconds times a peak: ``multiplier`` x the forward FLOPs of an image x the
images that went through a forward, over (host seconds x ``peak_flops``),
in %."""

from .. import flops


def read(stretch, params, cell):
    images = stretch.work.get("forward_calls", 0) * stretch.work.get("forward_batch", 0)
    if not images or stretch.wall_s <= 0:
        return None
    work = params["multiplier"] * flops.forward_flops(cell["config"]) * images
    return 100.0 * work / (stretch.wall_s * params["peak_flops"])
