"""SLURM job-array launcher: the reference's dispatch.py equivalent, a copy
of ``colddiff/cli/dispatch.py``.

The reference generates one sbatch script per line of a jobs file
(deblurring-diffusion-pytorch/dispatch.py:69-103).  This version does the
same for colddiff_torch CLI commands: each line of the jobs file is a full
``python -m colddiff_torch.cli.main ...`` invocation.

Usage:
  python -m colddiff_torch.cli.dispatch jobs.txt --partition gpu --time 48:00:00 \
      --out ./slurm_jobs [--submit]
"""

from __future__ import annotations

import argparse
import subprocess
from pathlib import Path

TEMPLATE = """#!/bin/bash
#SBATCH --job-name={name}
#SBATCH --partition={partition}
#SBATCH --time={time}
#SBATCH --output={log_dir}/{name}-%j.out
#SBATCH --requeue
{extra}
set -euo pipefail
cd {workdir}
{command}
"""


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("jobs_file")
    ap.add_argument("--partition", default="gpu")
    ap.add_argument("--time", default="48:00:00")
    ap.add_argument("--out", default="./slurm_jobs")
    ap.add_argument("--workdir", default=".")
    ap.add_argument("--extra", default="", help="extra #SBATCH lines")
    ap.add_argument("--submit", action="store_true", help="sbatch each script")
    args = ap.parse_args(argv)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    lines = [
        ln.strip() for ln in Path(args.jobs_file).read_text().splitlines()
        if ln.strip() and not ln.strip().startswith("#")
    ]
    scripts = []
    for i, cmd in enumerate(lines):
        name = f"colddiff-{i}"
        script = TEMPLATE.format(
            name=name, partition=args.partition, time=args.time,
            log_dir=str(out), extra=args.extra,
            workdir=str(Path(args.workdir).absolute()), command=cmd,
        )
        path = out / f"{name}.sh"
        path.write_text(script)
        scripts.append(path)
        print(f"wrote {path}")
        if args.submit:
            subprocess.run(["sbatch", str(path)], check=True)
    return scripts


if __name__ == "__main__":
    main()
