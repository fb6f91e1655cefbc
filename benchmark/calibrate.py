"""Readings behind a cell's limits, on the card: the program's on many
seeds, the control's (the reference one precision step down in the
program's place), and the program's with a fault planted.

    python3 benchmark/calibrate.py --workload <cell> --side program --seeds 1 2 3 \\
        [--seconds 3] [--out readings.jsonl]

``--side`` is ``program``, ``control`` or a fault the cell's driver plants
(``drivers/<kind>.py`` ``FAULTS``).  Each seed's readings are one JSON line;
the last line gives, for each number, the largest and the smallest reading.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(cell: dict, seed: int, side: str, seconds: float, device) -> dict:
    """One seed's readings of ``side``."""
    import torch

    from benchmark import common

    common.program_env()
    driver = importlib.import_module(f"benchmark.drivers.{cell['traffic']['kind']}")
    t0 = time.time()
    if side == "control":
        outputs, extra = driver.control(cell, seed, device), {}
    else:
        with driver.plant(None if side == "program" else side):
            program = driver.Program(cell, seed, device)
            window = program.window(seconds, False)
            outputs = program.finish()
            del program
        extra = {"rates": window["rates"], "attempted": window["attempted"]}
    t1 = time.time()
    numbers = driver.compare(cell, seed, outputs, torch.device(device))
    return {"seed": seed, "side": side, **numbers, **extra, "seconds": time.time() - t0,
            "reference_s": time.time() - t1}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--side", default="program")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from benchmark import common

    cell = common.cell(args.workload)
    rows = []
    for seed in args.seeds:
        row = readings(cell, seed, args.side, args.seconds, args.device)
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    span = {k: [min(r[k] for r in rows), max(r[k] for r in rows)]
            for k in cell["limits"] if all(isinstance(r.get(k), (int, float)) for r in rows)}
    print(json.dumps({"workload": args.workload, "side": args.side, "min_max": span}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
