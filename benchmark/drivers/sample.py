"""Driver of the ``sample`` traffic kind: one client sends requests back to
back.  A request is ``batch`` fresh clean images of the pool, degraded to
level T by ``sampling.prepare_start`` and restored by ``sampling.sample``
through ``EvalHarness.denoise`` (the harness's bf16 copy of the model, in
chunks of ``model_chunk`` rows).

After the window, ``checked_requests`` of the finished requests, drawn
from the seed, are run again by the reference, and their every image is
held against it.  Readings, each against its limit in
``limits/<cell>.json``, as the worst image's ``|program - reference| /
|reference|`` (L2 norms over the image):

- ``start_gap``: the degraded start x_T;
- ``direct_gap``: the first direct reconstruction (the UNet at level T);
- ``final_gap``: the restored image.
"""

from __future__ import annotations

import gc
import random
import time

import torch

from .. import common
from ..reference import diffusion as ref_diffusion
from ..reference import models as ref_models
from ..reference import precision
from ..trace import Recorder, traced

MAX_REQUESTS = 512  # requests a run can send before their images repeat
REFERENCE_ROWS = 128  # images the reference samples at once
FAULTS = ("state_unchanged", "answer_altered")


def inputs(cell: dict, seed: int, device) -> dict:
    """Weights, the pool of clean images and each request's rows of it."""
    config, traffic = cell["config"], cell["traffic"]
    with torch.device("meta"):
        shapes = ref_models.build(config)
    gen = torch.Generator(device=device).manual_seed(seed + (2 << 40))
    order = torch.rand(MAX_REQUESTS, traffic["pool_images"], generator=gen, device=device)
    return {"weights": common.make_weights(shapes, seed, device),
            "pool": common.make_pool(seed + (1 << 40), traffic["pool_images"],
                                     config["image_size"], config["channels"], device),
            "rows": order.argsort(dim=1)[:, :traffic["batch"]]}


class Program:
    """The port's sampler behind an ``EvalHarness``, set up from the seed."""

    def __init__(self, cell: dict, seed: int, device):
        from colddiff_torch import sampling
        from colddiff_torch.eval import EvalHarness

        config, traffic = cell["config"], cell["traffic"]
        self.device = torch.device(device)
        self.cell, self.seed, self.sampling = cell, seed, sampling
        self.inputs = inputs(cell, seed, self.device)
        self.harness = EvalHarness(
            common.port_diffusion(config, self.device),
            common.port_model(config, self.inputs.pop("weights"), self.device),
            results_folder=str(common.scratch_dir("sample")),
            model_chunk=traffic["model_chunk"],
            bf16=config["precision"]["unet"] == "bfloat16", device=self.device)
        self.results, self.rec = [], Recorder(self.device)
        # the cell's shapes, warmed: a request of two reverse steps
        d, clean = self.harness.d, self.inputs["pool"][self.inputs["rows"][0]]
        sampling.sample(d, self.harness.denoise, sampling.prepare_start(d, clean), t=2)

    def _denoise(self):
        if not self.rec.on:
            return self.harness.denoise

        def denoise(x, t):
            with self.rec.span("unet.forward"):
                return self.harness.denoise(x, t)

        return denoise

    def _request(self) -> None:
        d, s = self.harness.d, self.sampling
        clean = self.inputs["pool"][self.inputs["rows"][len(self.results) % MAX_REQUESTS]]
        with self.rec.span("prepare_start"):
            start = s.prepare_start(d, clean)
        with self.rec.span("sampler"):
            res = s.sample(d, self._denoise(), start)
        self.results.append((res.xt, res.direct_recons, res.img))

    def window(self, seconds: float, trace: bool) -> dict:
        """Requests until the first that ends at or after ``seconds``; with
        ``trace``, the first ``trace_requests`` of them under the profiler."""
        traffic, steps = self.cell["traffic"], self.cell["config"]["degradation"]["time_steps"]
        chunks = -(-traffic["batch"] // traffic["model_chunk"])
        stretch = None
        t0 = time.perf_counter()
        if trace:
            n = traffic["trace_requests"]

            def run():
                for _ in range(n):
                    self._request()
                return {"requests": n, "images": n * traffic["batch"],
                        "forward_calls": n * steps * chunks,
                        "forward_batch": min(traffic["batch"], traffic["model_chunk"])}

            stretch = traced(run, self.rec)
        while not self.results or time.perf_counter() - t0 < seconds:
            self._request()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        failed = sum(int(not torch.isfinite(img).all()) for _, _, img in self.results)
        images = len(self.results) * traffic["batch"]
        return {"seconds": elapsed, "attempted": len(self.results), "failed": failed,
                "rates": {"sample_images_per_s": images / elapsed}, "stretch": stretch}

    def finish(self) -> dict:
        """The checked requests' outputs; the program's state is freed."""
        n = self.cell["traffic"]["checked_requests"]
        picks = sorted(random.Random(self.seed).sample(range(len(self.results)),
                                                       min(n, len(self.results))))
        out = {"requests": {r: self.results[r] for r in picks}}
        del self.harness, self.results
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return out


def _reference(cell, inp, requests, device, casts=(ref_models.identity,) * 2) -> dict:
    config = cell["config"]
    model = ref_models.build(config).to(device).eval()
    model.load_state_dict(inp["weights"])
    cum = ref_diffusion.blur_matrices(config["degradation"], config["image_size"], device)
    out = {}
    with torch.no_grad():
        for r in requests:
            clean = inp["pool"][inp["rows"][r % MAX_REQUESTS]]
            parts = [ref_diffusion.x0_step_down(model, cum, clean[lo:lo + REFERENCE_ROWS], *casts)
                     for lo in range(0, len(clean), REFERENCE_ROWS)]
            out[r] = tuple(torch.cat(p) for p in zip(*parts))
    return out


def control(cell: dict, seed: int, device, unet: str = "fp8", degrade: str = "tf32") -> dict:
    """The reference in the program's place, its UNet operands rounded to
    ``unet`` and its degrade operands to ``degrade``, on the requests a run
    checks."""
    device = torch.device(device)
    inp = inputs(cell, seed, device)
    picks = range(cell["traffic"]["checked_requests"])
    casts = getattr(precision, unet), getattr(precision, degrade)
    return {"requests": _reference(cell, inp, picks, device, casts)}


def _worst_gap(prog: torch.Tensor, ref: torch.Tensor) -> float:
    diff = (prog.float() - ref).flatten(1).norm(dim=1)
    return float((diff / ref.flatten(1).norm(dim=1)).max())


def compare(cell: dict, seed: int, outputs: dict, device) -> dict:
    """The reference on the checked requests, and the readings of
    ``outputs`` against it."""
    device = torch.device(device)
    inp = inputs(cell, seed, device)
    got = outputs["requests"]
    ref = _reference(cell, inp, sorted(got), device)
    gaps = {name: max(_worst_gap(got[r][i], ref[r][i]) for r in got)
            for i, name in enumerate(("start_gap", "direct_gap", "final_gap"))}
    return dict(gaps, requests_checked=len(got))


def plant(fault):
    """A context in which the program runs with ``fault`` planted: each
    reverse step returns its state unchanged, or one image of each
    request's answer is altered where the sampler produces it."""
    import contextlib
    from unittest import mock

    from colddiff_torch import sampling

    if fault is None:
        return contextlib.nullcontext()
    if fault == "state_unchanged":
        return mock.patch.object(sampling, "_reverse_step",
                                 lambda d, img, t_cur, pred, *a: (img, pred))
    if fault == "answer_altered":
        sample = sampling.sample

        def altered(*args, **kw):
            res = sample(*args, **kw)
            img = res.img.clone()
            img[0] = -img[0]
            return res._replace(img=img)

        return mock.patch.object(sampling, "sample", altered)
    raise ValueError(f"the sample driver plants {FAULTS}, not {fault!r}")
