"""bf16 against fp32 training loss on the flagship configuration.

    python -m colddiff_torch.scripts.train_loss_parity [n_steps=400]
        [--out docs/examples/torch_train_bf16_parity.json] [--device cuda]
        [--runs runs/torch_train_bf16_parity]

The port's twin of ``scripts/train_loss_parity.py``: the 128 px blur
(``Exponential_reflect``, T=200, kernel 15, std 0.01) with
``UnetConvNext(64, (1, 2, 4, 8))`` on ``SyntheticDataset(128, 3, 256)``,
B=16 x accumulation 2, seed 0, trained ``n_steps`` optimizer steps twice
from the same initial weights, data and draws: fp32 compute, then the bf16
recipe (``Trainer(bf16=True)``: bf16 parameter copies and inputs at each
forward, fp32 masters, Adam and EMA).  Each step is one
``Trainer.train_step`` (JAX: ``tr._train_step``), and every loss is read.
The record has the JAX record's keys (``loss_first10_mean``,
``loss_tail50_mean``, ``losses_every10``, ``wall_s`` a run,
``tail50_rel_diff``) and the card's name and power limit.  Each run keeps
its checkpoint under ``--runs/<fp32|bf16>/``, so a cut call resumes.
"""

from __future__ import annotations

import argparse
import functools
import sys
from pathlib import Path

import numpy as np

from . import _records as rec
from .refresh_quality import diffusion

T, IMG = 200, 128
CONFIG = ("blur128 Exponential_reflect T=200, UnetConvNext(64,(1,2,4,8)), B=16 accum x2, "
          "seed 0")
EXTRA_KEYS = {"card", "torch", "device"}  # beside the JAX record's keys


# the run's Trainer (``_records.make_trainer``; ``bf16=True`` for the
# recipe), resuming from ``folder/model.pt`` if it is there
make_trainer = functools.partial(rec.make_trainer, diffusion, image_size=IMG, timesteps=T)


def evaluate(points: list, seconds: float) -> dict:
    """One run's entry of the record from its loss points (``run_steps``
    with ``every=1``), as ``scripts/train_loss_parity.py:83-90`` writes it."""
    losses = [p["loss"] for p in points]
    return {"loss_first10_mean": float(np.mean(losses[:10])),
            "loss_tail50_mean": float(np.mean(losses[-50:])),
            "losses_every10": [round(x, 5) for x in losses[::10]],
            "wall_s": round(seconds, 1)}


def record(runs: dict, n_steps: int, device) -> dict:
    """The record from ``{"fp32": entry, "bf16": entry}``."""
    out = {**rec.stamp(device), "config": CONFIG, "n_steps": n_steps, **runs}
    f32, b16 = runs["fp32"]["loss_tail50_mean"], runs["bf16"]["loss_tail50_mean"]
    out["tail50_rel_diff"] = abs(b16 - f32) / f32
    return out


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n_steps", nargs="?", type=int, default=400)
    p.add_argument("--out", default=str(rec.REPO / "docs/examples/torch_train_bf16_parity.json"))
    p.add_argument("--device", default="cuda")
    p.add_argument("--runs", default=str(rec.REPO / "runs/torch_train_bf16_parity"))
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    out = rec.out_path(args.out)
    device = rec.require_device(args.device)
    runs = {}
    for tag, bf16 in (("fp32", False), ("bf16", True)):
        tr = make_trainer(rec.out_path(Path(args.runs) / tag), bf16=bf16, device=device)
        runs[tag] = evaluate(*rec.run_steps(tr, args.n_steps, every=1, save_every=100,
                                            quiet=True))
        del tr
        print(f"{tag}: tail50 loss {runs[tag]['loss_tail50_mean']:.5f} "
              f"({runs[tag]['wall_s']:.0f}s)", flush=True)
    result = record(runs, args.n_steps, device)
    print(f"tail50 rel diff: {result['tail50_rel_diff']:.3%}", flush=True)
    rec.write_json(out, result)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
