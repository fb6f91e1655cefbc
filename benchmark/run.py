"""Run one cell of the benchmark once, on this machine's card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic mix and limits are files found by the
names in ``BENCHMARK.json``; the traffic's ``kind`` names the driver
(``drivers/<kind>.py``) and each per-layer metric its reader
(``metrics/<metric>.json``).  Set-up (the kernel build on a checkout's
first run, the weights, the warm-up) is timed from the start of this
process; then the window runs for ``--seconds``; then the reference
judges what the window's program produced.

The last line of standard output is the result, one JSON object; the
compared numbers, each beside its limit, are the last lines of standard
error.  Without a CUDA card the run exits 2 and prints no result.
"""

from __future__ import annotations

import time

START = time.time()  # before anything heavy is imported: set-up counts from here

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def say(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def run(cell: dict, seed: int, seconds: float, trace: bool, device, start: float) -> dict:
    """One run of ``cell``: set-up, window, reference.  Returns the result
    object; device metrics only when ``device`` is a CUDA card."""
    import torch

    from benchmark import common

    common.program_env()
    device = torch.device(device)
    driver = importlib.import_module(f"benchmark.drivers.{cell['traffic']['kind']}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    program = driver.Program(cell, seed, device)
    setup_s = time.time() - start
    window = program.window(seconds, trace)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    outputs = program.finish()
    del program
    t0 = time.time()
    numbers = driver.compare(cell, seed, outputs, device)
    say(f"reference: {time.time() - t0:.3f} s")
    found = common.forbidden_modules()
    if found:
        raise SystemExit(f"the run loaded {found}: the JAX stack or the JAX package")
    ok, checks = common.judge(numbers, cell["limits"])
    result = {"correct": ok and window["failed"] == 0, "attempted": window["attempted"],
              "failed": window["failed"], "metrics": {},
              "device": common.device_record(device, peak)}
    if device.type == "cuda":  # a CPU run's numbers are never written under these names
        measured = dict(window["rates"], setup_s=setup_s)
        if trace:
            result["metrics"] = _per_layer(cell, window["stretch"])
            stretch = window["stretch"]
            result["device"].update(busy_s=stretch.busy_ns() / 1e9, window_s=stretch.wall_s)
            result["breakdown"] = stretch.breakdown()
            say(f"trace: {len(stretch.ops)} device ops, {len(stretch.spans)} spans")
        else:
            units = {m["name"]: m["unit"] for m in cell["end_to_end"]}
            result["metrics"] = {n: {"value": measured[n], "unit": u}
                                 for n, u in units.items() if n in measured}
    result["checks"] = checks
    return result


def _per_layer(cell: dict, stretch) -> dict:
    from benchmark import common

    out = {}
    for m in cell["per_layer"]:
        params = common.load_json(common.BENCH / "metrics" / f"{m['name']}.json")
        reader = importlib.import_module(f"benchmark.metrics.{params['reader']}")
        value = reader.read(stretch, params, cell)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from benchmark import common

    cell = common.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        say(f"{args.workload} needs {cell['chips']} CUDA card(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    import colddiff_torch

    if ROOT not in Path(colddiff_torch.__file__).resolve().parents:
        say(f"colddiff_torch comes from {colddiff_torch.__file__}, not from this checkout")
        return 2
    say("card:", common.power_limit(), "| torch", torch.__version__, torch.version.cuda)
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", START)
    print(json.dumps(result), flush=True)
    for name, check in result["checks"].items():
        say(f"check {name}: {check['value']} (limit {check['limit']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
