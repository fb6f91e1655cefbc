"""The quality rows that need no training, against the JAX records.

    python -m colddiff_torch.scripts.untrained_rows [--device cuda]
        [--out docs/examples/torch_untrained_rows.json]

Two rows depend only on the operator, the data and the proxy-FID extractor,
which the port pins to the JAX package, so an untrained model must give the
JAX records' numbers:

1. the degraded row of the 128 px manifold record
   (``runs/convergence_blur128/manifold/manifold_metrics.json``): the
   command line as ``docs/examples/convergence.md:31-36`` and ``:60-66``
   runs it, ``python -m colddiff_torch.cli.main train`` with
   ``--train_steps 0`` (a ``model.pt`` of the seeded initial weights; the
   restart flags, which only make a long run cut-proof, dropped), then
   ``test --test_type test_fid_distance_decrease_from_manifold --test_end
   256`` from it in fp32, as the JAX record was made (it stamps ``bf16:
   false``); ``rmse_degraded``, ``ssim_degraded`` and
   ``proxy_fid_degraded`` are compared, the sampled and direct rows of the
   untrained model only recorded;
2. the same-distribution anchor of the 64 px generation records
   (``docs/examples/gmm_generation.json``, ``calibration``):
   proxy-FID(images 0-127, images 128-255) of ``SyntheticDataset(64, 3,
   length=256)`` with the fallback extractor at ``batch_size=32``, as
   ``scripts/gmm_generation.py:82-92`` computes it, and the 256 images'
   mean and std.

Each value is written beside the JAX value and the file it came from, with
the difference and whether it lies within RMSE/SSIM 1e-4 absolute and
proxy-FID 1% relative, the mean and std within 4 float32 ulps of the JAX
value (``_records.compare_ulps``): both packages run the same numpy code,
and only the host's numpy rounds apart.  The JSON is written in
any case; the exit code is 1 if a row misses.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from ._records import FID_REL_LIMIT, REPO, card, compare_ulps

MANIFOLD_RECORD = "runs/convergence_blur128/manifold/manifold_metrics.json"
ANCHOR_RECORD = "docs/examples/gmm_generation.json"
# docs/examples/convergence.md:31-36 and :60-66
FLAGS = ["--degradation", "blur", "--dataset", "synthetic", "--image_size", "128",
         "--time_steps", "200", "--blur_routine", "Exponential_reflect", "--blur_size",
         "15", "--blur_std", "0.01", "--sampling_routine", "x0_step_down"]
TRAIN_FLAGS = ["--batch_size", "16", "--train_steps", "0", "--save_and_sample_every",
               "3000", "--exp_name", "convergence_blur128_30k"]
TEST_FLAGS = ["--model", "UnetConvNext", "--batch_size", "16", "--test_type",
              "test_fid_distance_decrease_from_manifold"]
TEST_END = 256
ABS_LIMIT = 1e-4  # RMSE and SSIM
ANCHOR_IMG, ANCHOR_N = 64, 256


def _cli(args: list, env: dict) -> tuple:
    cmd = [sys.executable, "-m", "colddiff_torch.cli.main", *args]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if r.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)}: exit {r.returncode}\n{r.stderr[-4000:]}")
    return seconds, r.stdout


def _compare(port: float, jax: float, rel: bool) -> dict:
    diff = port - jax
    limit = FID_REL_LIMIT * abs(jax) if rel else ABS_LIMIT
    return {"port": port, "jax": jax, "diff": diff, "rel_diff": diff / jax,
            "limit": f"{FID_REL_LIMIT:g} relative" if rel else f"{ABS_LIMIT:g} absolute",
            "within": abs(diff) <= limit}


def degraded_row(device: str, work: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(REPO)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    train_s, _ = _cli(["train", *FLAGS, *TRAIN_FLAGS, "--save_folder", str(work),
                       "--device", device], env)
    model = work / "convergence_blur128_30k" / "model.pt"
    test_s, stdout = _cli(["test", *FLAGS, *TEST_FLAGS, "--test_end", str(TEST_END),
                           "--load_path", str(model), "--save_folder",
                           str(work / "manifold"), "--device", device], env)
    got = json.loads((work / "manifold" / "manifold_metrics.json").read_text())
    want = json.loads((REPO / MANIFOLD_RECORD).read_text())
    if got["bf16"] or got["extractor"] != want["extractor"]:
        raise RuntimeError(f"the test ran bf16={got['bf16']} with {got['extractor']}")
    return {
        "source": MANIFOLD_RECORD,
        "command": "python -m colddiff_torch.cli.main train " + " ".join(FLAGS + TRAIN_FLAGS)
                   + " ...; test " + " ".join(FLAGS + TEST_FLAGS)
                   + f" --test_end {TEST_END} --load_path .../model.pt",
        "images": TEST_END, "extractor": got["extractor"], "bf16": got["bf16"],
        "refresh_every": got["refresh_every"],
        "compared": {k: _compare(got[k], want[k], rel=k.startswith("proxy_fid"))
                     for k in ("rmse_degraded", "ssim_degraded", "proxy_fid_degraded")},
        "untrained_not_compared": {k: got[k] for k in (
            "rmse_sampled", "ssim_sampled", "proxy_fid_sampled", "rmse_direct",
            "ssim_direct", "proxy_fid_direct", "proxy_fid_improvement")},
        "train_seconds": train_s, "test_seconds": test_s,
        "test_stdout_tail": stdout[-2000:],
    }


def anchor(device: str) -> dict:
    from ..data import SyntheticDataset
    from ..eval.fid import calculate_fid_given_samples, fid_features_fn

    t0 = time.perf_counter()
    ds = SyntheticDataset(ANCHOR_IMG, 3, length=ANCHOR_N)
    train = np.stack([ds[i] for i in range(ANCHOR_N)])
    feats = fid_features_fn(device=device)
    half = ANCHOR_N // 2
    fid = calculate_fid_given_samples([train[:half], train[half:]], batch_size=32,
                                      features=feats)
    record = json.loads((REPO / ANCHOR_RECORD).read_text())
    stats = next(iter(record["gmm"].values()))
    mean, std = float(train.mean()), float(train.std())
    return {
        "source": ANCHOR_RECORD, "extractor": feats.name,
        "compared": {
            "proxy_fid_train_half_vs_half": _compare(
                fid, record["calibration"]["proxy_fid_train_half_vs_half"], rel=True),
            "train_mean": compare_ulps(mean, stats["train_mean"]),
            "train_std": compare_ulps(std, stats["train_std"]),
        },
        "seconds": time.perf_counter() - t0,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=str(REPO / "docs/examples/torch_untrained_rows.json"))
    args = p.parse_args(argv)

    import tempfile

    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        out = {"card": card(), "torch": torch.__version__, "device": args.device,
               "anchor": anchor(args.device),
               "degraded_row": degraded_row(args.device, Path(tmp))}
    rows = [r for part in ("anchor", "degraded_row") for r in out[part]["compared"].values()]
    out["all_within"] = all(r["within"] for r in rows)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=2) + "\n")
    for part in ("anchor", "degraded_row"):
        for k, r in out[part]["compared"].items():
            print(f"{part} {k}: port {r['port']!r} jax {r['jax']!r} diff {r['diff']!r} "
                  f"({r['limit']}) {'ok' if r['within'] else 'MISS'}", flush=True)
    print(f"untrained (recorded, not compared): "
          f"{json.dumps(out['degraded_row']['untrained_not_compared'])}")
    print(f"card: {out['card']}; wrote {args.out}")
    return 0 if out["all_within"] else 1


if __name__ == "__main__":
    sys.exit(main())
