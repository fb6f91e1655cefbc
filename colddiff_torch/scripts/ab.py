"""Compare checkouts of the repository on one GPU, each in a process of its own.

    python -m colddiff_torch.scripts.ab fronts ROOT [ROOT ...]
    python -m colddiff_torch.scripts.ab main ROOT [ROOT ...]
    python -m colddiff_torch.scripts.ab sample ROOT [ROOT ...]
    python -m colddiff_torch.scripts.ab profile ROOT [ROOT ...]
    python -m colddiff_torch.scripts.ab probes ROOT [ROOT ...]
    python -m colddiff_torch.scripts.ab resnet ROOT [ROOT ...]

Each ROOT is a directory that holds a checkout (an unpacked ``git archive``
will do) with its own ``chip_smoke.py`` and ``colddiff_torch/``.  The roots
run in the order given, one child process each, which imports that root's
``chip_smoke`` and builds that root's kernels; name the two versions in
turns (``parent change change parent``) to see the spread between runs.
Each child prints one JSON line per measurement:

- ``fronts``: the block-front kernels at (16, H, H, C), all with
  conditioning, fp32 and bf16: the small-C kernel at 128 px for the stem
  (C=3, ``norm=False``) and C = 8, 16, 31, and the tile kernel at the
  flagship's C >= 32 shapes (C, H) = (64, 128), (64, 64), (128, 64),
  (256, 64), (256, 32), (512, 32), (512, 16), (1024, 16) (``norm=True``),
  and the wide-C kernel at (16, 16, 16, 1280), (16, 16, 16, 2048) and
  (2, 8, 8, 4096); for each, its max error against the plain version and
  three device-time runs of ``chip_smoke.device_ms`` (so the root's
  ``chip_smoke.py`` must have it);
- ``main``: sampled images/s of ``chip_smoke.main_path`` (phase 6) and train
  images/s of ``chip_smoke.train_main_path`` (phase 8, loader included);
- ``sample``: sampled images/s of three ``chip_smoke.main_path`` runs in a
  row, and the host's time to queue one bf16 UNet forward (B=16, 128 px)
  against the wall time of one that ends in a synchronise, each the mean
  of 10.
- ``profile``: the wide-C shapes of ``fronts`` under ``torch.profiler``, 50
  calls each, fp32 and bf16: the device us per call of every kernel that
  ran, by name, and the bytes a call leaves allocated beyond its output
  while it runs (a workspace).
- ``probes``: three runs of ``chip_smoke.probe_kernels`` (phase 9): for
  each of the four probe kernels its device us of each run, its
  single-call ``call_ms`` and max error against the plain version, and
  the launch floor (an empty ``torch.cuda._sleep(0)``) of each run.
- ``resnet``: phase 21's configuration (the CIFAR-10 ``UnetResNet``, blur
  Special_6 T=50, 32 px): a bf16 forward at B=32, 10 bf16 reverse steps and
  one ``Trainer.train_step`` (B=32 x accum 2, bf16, dropout live), each
  with its wall ms (the median of 5, ending in a synchronise), the host's
  ms to queue it, and under ``torch.profiler`` the device ms its kernels
  take, their count, the device's idle share (1 - device / wall) and the
  8 kernels that take the most device time.

Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

MODES = ("fronts", "main", "sample", "profile", "probes", "resnet")
WIDE = ((1280, 16, True), (2048, 16, True), (4096, 8, True, 2))  # C > 1024; B = 2 at 4096
FRONTS = ((3, 128, False), (8, 128, True), (16, 128, True), (31, 128, True),  # (C, H, norm[, B])
          (64, 128, True), (64, 64, True), (128, 64, True), (256, 64, True), (256, 32, True),
          (512, 32, True), (512, 16, True), (1024, 16, True), *WIDE)
PROFILE_CALLS = 50
PROBE_RUNS = 3


def _front_inputs(cs, gen, front, dev):
    """Row, fp32 and bf16 arguments of one ``FRONTS`` entry (B = 16 unless given)."""
    import torch

    c, h, norm, *batch = front
    b = batch[0] if batch else cs.BATCH
    args = cs.front_args(gen, b, c, h, h, True, dev)
    a16 = [None if a is None else a.to(torch.bfloat16) for a in args]
    a16[0] = a16[0].contiguous(memory_format=torch.channels_last)
    return {"B": b, "C": c, "H": h, "norm": norm}, (("fp32", args), ("bf16", a16))


def _fronts(cs, dev) -> None:
    import torch
    from colddiff_torch.ops.convnext_front import convnext_front, convnext_front_plain

    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    for front in FRONTS:
        row, runs = _front_inputs(cs, gen, front, dev)
        norm = row["norm"]
        for tag, a in runs:
            got = convnext_front(*a, norm=norm).float()
            want = convnext_front_plain(*[None if t is None else t.float() for t in a],
                                        norm=norm)
            row["max_abs_err_" + tag] = (got - want).abs().max().item()
            row["us_" + tag] = [1e3 * cs.device_ms(lambda: convnext_front(*a, norm=norm))[0]
                                for _ in range(3)]
        print(json.dumps(row), flush=True)


def _main_paths(cs, dev) -> None:
    import tempfile

    import torch

    model = cs.seeded_unet(cs.SEED, dev, **cs.FLAGSHIP).to(torch.bfloat16)
    res = cs.main_path(model, dev, cs.BATCH, cs.IMG, cs.T)
    print(json.dumps({"images_per_s": cs.BATCH / res[1], "launches": list(res[2:])}),
          flush=True)
    del model
    with tempfile.TemporaryDirectory() as folder:
        step_s = cs.train_main_path(dev, folder)[1]
    mean = sum(step_s) / len(step_s)
    print(json.dumps({"train_ms": 1e3 * mean, "train_images_per_s": cs.BATCH * cs.ACCUM / mean,
                      "step_ms": [1e3 * s for s in step_s]}), flush=True)


def _sample(cs, dev) -> None:
    import time

    import torch

    model = cs.seeded_unet(cs.SEED, dev, **cs.FLAGSHIP).to(torch.bfloat16)
    rates = [cs.BATCH / cs.main_path(model, dev, cs.BATCH, cs.IMG, cs.T)[1] for _ in range(3)]
    x = torch.zeros(cs.BATCH, cs.IMG, cs.IMG, 3, device=dev, dtype=torch.bfloat16)
    t = torch.full((cs.BATCH,), cs.T // 2, device=dev)
    with torch.inference_mode():
        model(x, t)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(10):
            model(x, t)
        queue_ms = 1e2 * (time.perf_counter() - t0)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(10):
            model(x, t)
            torch.cuda.synchronize(dev)
        wall_ms = 1e2 * (time.perf_counter() - t0)
    print(json.dumps({"images_per_s": rates, "forward_queue_ms": queue_ms,
                      "forward_wall_ms": wall_ms}), flush=True)


def _profile(cs, dev) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from colddiff_torch.ops.convnext_front import convnext_front

    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    for front in WIDE:
        row, runs = _front_inputs(cs, gen, front, dev)
        for tag, a in runs:
            convnext_front(*a)
            torch.cuda.synchronize(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            out = convnext_front(*a)
            torch.cuda.synchronize(dev)
            row["scratch_bytes_" + tag] = (torch.cuda.max_memory_allocated(dev) - base
                                           - out.nbytes)
            del out
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(PROFILE_CALLS):
                    convnext_front(*a)
                torch.cuda.synchronize(dev)
            row["device_us_" + tag] = {
                e.key: getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0) for e in prof.key_averages()}
            row["device_us_" + tag] = {k: v / PROFILE_CALLS
                                       for k, v in row["device_us_" + tag].items() if v}
        print(json.dumps(row), flush=True)


def _device_kernels(fn, dev):
    """(device ms, launches, {kernel name: device ms}) of one call of ``fn``
    under torch.profiler (CUDA activity only: the kernels)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    kernels, launches = {}, 0
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        if us:
            kernels[e.key] = us / 1e3
            launches += e.count
    return sum(kernels.values()), launches, kernels


def _resnet(cs, dev) -> None:
    import statistics
    import tempfile
    import time

    import torch

    d = cs.cifar_blur(dev)
    model = cs.seeded_resnet(cs.SEED, dev).to(torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    x = torch.rand(cs.RESNET_BATCH, cs.CIFAR, cs.CIFAR, 3, generator=gen, device=dev) * 2 - 1
    t = torch.full((cs.RESNET_BATCH,), cs.CIFAR_T // 2, device=dev)
    denoise = cs.bf16_denoise(model)
    start = cs.prepare_start(d, x)
    with tempfile.TemporaryDirectory() as folder:
        tr = cs.Trainer(d, cs.seeded_resnet(cs.SEED, dev), cs.SyntheticDataset(cs.CIFAR, 3),
                        train_batch_size=cs.RESNET_BATCH, gradient_accumulate_every=cs.ACCUM,
                        bf16=True, results_folder=folder, num_workers=1, seed=cs.SEED,
                        device=dev)
        batch = tr._next_superbatch()
        steps = 10
        calls = {"forward": lambda: torch.inference_mode()(denoise)(x, t),
                 f"sample_{steps}_steps": lambda: cs.sample(d, denoise, start, t=steps),
                 "train_step": lambda: tr.train_step(batch)}
        for name, fn in calls.items():
            for _ in range(3):
                fn()
            torch.cuda.synchronize(dev)
            walls, queues = [], []
            for _ in range(5):
                t0 = time.perf_counter()
                fn()
                queues.append(1e3 * (time.perf_counter() - t0))
                torch.cuda.synchronize(dev)
                walls.append(1e3 * (time.perf_counter() - t0))
            wall = statistics.median(walls)
            busy, launches, kernels = _device_kernels(fn, dev)
            top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
            print(json.dumps({"call": name, "batch": cs.RESNET_BATCH, "wall_ms": wall,
                              "walls_ms": walls, "queue_ms": statistics.median(queues),
                              "device_ms": busy, "launches": launches,
                              "idle_share": 1 - busy / wall, "top_kernels_ms": top}),
                  flush=True)


def _probes(cs, dev) -> None:
    runs = [cs.probe_kernels(dev) for _ in range(PROBE_RUNS)]
    for i, row in enumerate(runs[0][0]):
        same = [rows[i] for rows, _ in runs]
        print(json.dumps({"probe": row["probe"], "name": row["name"],
                          "bound_us": row["bound_us"], "us": [1e3 * r["ms"] for r in same],
                          "call_ms": [r["call_ms"] for r in same],
                          "max_abs_err": [r["max_abs_err"] for r in same],
                          "host_paced": [r.get("host_paced", []) for r in same]}), flush=True)
    print(json.dumps({"probe": "launch floor", "us": [1e3 * floor["ms"] for _, floor in runs]}),
          flush=True)


def child(mode: str, root: str) -> int:
    """Measure ``root`` (this process imports only that root's code)."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from colddiff_torch.ops import _build

    for mod in (cs, _build):
        if not Path(mod.__file__).resolve().is_relative_to(Path(root).resolve()):
            raise RuntimeError(f"{mod.__name__} came from {mod.__file__}, not {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    print(json.dumps({"root": root, "mode": mode, "card": cs.gpu_name_and_power()}), flush=True)
    {"fronts": _fronts, "main": _main_paths, "sample": _sample,
     "profile": _profile, "probes": _probes,
     "resnet": _resnet}[mode](cs, torch.device("cuda", 0))
    return 0


def main(argv: list[str]) -> int:
    if len(argv) >= 3 and argv[0] == "--child":
        return child(argv[1], argv[2])
    if len(argv) < 2 or argv[0] not in MODES:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("ab: no CUDA device; the comparison runs on an NVIDIA GPU", file=sys.stderr)
        return 2
    for root in argv[1:]:
        proc = subprocess.run([sys.executable, __file__, "--child", argv[0], root])
        if proc.returncode != 0:
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
