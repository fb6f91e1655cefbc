"""What the record scripts share: the card check, the resumable training
loop, the timed call, the proxy FID, the limits against the JAX records,
the guard on where a record may be written, and the generation records'
command line and ``main``.

The record scripts are the port's twins of the JAX package's record
workflows under ``scripts/`` (``train_loss_parity``, ``refresh_quality``,
``family_b_generation``, ``family_b_refresh_quality``, ``gmm_generation``).
Each writes only ``docs/examples/torch_*`` files and ``runs/torch_*``
folders, never a JAX record.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from ..eval.fid import calculate_fid_given_samples

REPO = Path(__file__).resolve().parents[2]
ULP_LIMIT = 4  # float32 ulps between two hosts' numpy statistics of one array
FID_REL_LIMIT = 1e-2  # a proxy FID that depends only on the data and the extractor
SAVE_EVERY = 1000  # a generation record's steps between checkpoints (~1 GB each at 64 px)


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip() or "no nvidia-smi output"
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"


def require_device(device: str | torch.device) -> torch.device:
    """``device``, raising if it is a CUDA device and there is no card; on a
    card, TF32 is refused (the degrade, the Trainer and the metrics need
    full fp32 and raise otherwise)."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("this record runs on a CUDA device, and none is available; "
                               "the tests pass device='cpu'")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device


def out_path(path: str | Path) -> Path:
    """``path``, refusing one inside ``docs/examples/`` or ``runs/`` whose
    name there does not start with ``torch_``: those are the JAX records."""
    path = Path(path).resolve()
    for top in ("docs/examples", "runs"):
        root = (REPO / top).resolve()
        if root in path.parents:
            first = path.relative_to(root).parts[0]
            if not first.startswith("torch_"):
                raise ValueError(f"{path} would overwrite a JAX record; the port writes "
                                 f"only {top}/torch_*")
    return path


def write_json(path: str | Path, obj: dict) -> Path:
    path = out_path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(obj, indent=2) + "\n")
    return path


def emit(entry: dict) -> None:
    """Print one measured entry as JSON as soon as it is measured."""
    print(json.dumps(entry), flush=True)


def key_paths(obj, prefix: str = "") -> set:
    """The key paths of a record: dicts by key, a list of dicts by its
    first element (``sweep[]/rmse``)."""
    out = set()
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.add(prefix + k)
            out |= key_paths(v, prefix + k + "/")
    elif isinstance(obj, list) and obj and isinstance(obj[0], dict):
        out |= key_paths(obj[0], prefix.rstrip("/") + "[]/")
    return out


def compare_rel(port: float, jax: float, rel: float = FID_REL_LIMIT) -> dict:
    diff = port - jax
    return {"port": port, "jax": jax, "diff": diff, "rel_diff": diff / jax,
            "limit": f"{rel:g} relative", "within": abs(diff) <= rel * abs(jax)}


def compare_ulps(port: float, jax: float, n: int = ULP_LIMIT) -> dict:
    """``port`` against ``jax`` within ``n`` float32 ulps of the JAX value
    (``np.spacing(np.float32(jax))``): both packages run the same numpy
    code on the same data, and only the host's numpy rounds apart."""
    ulp = abs(float(np.spacing(np.float32(jax))))
    diff = port - jax
    return {"port": port, "jax": jax, "diff": diff, "ulps": abs(diff) / ulp,
            "limit": f"{n} float32 ulps (np.spacing(np.float32(jax)) = {ulp:.6g})",
            "within": abs(diff) <= n * ulp}


def make_trainer(diffusion: Callable, folder, *, image_size: int, timesteps: int,
                 dim: int = 64, dim_mults=(1, 2, 4, 8), batch: int = 16, accum: int = 2,
                 n_data: int = 256, seed: int = 0, bf16: bool = False, device="cuda",
                 **trainer_kw):
    """The JAX record scripts' ``Trainer``: ``diffusion(timesteps=,
    image_size=, device=)`` and ``UnetConvNext(dim, dim_mults)`` from
    ``torch.manual_seed(seed)`` on ``SyntheticDataset(image_size, 3,
    n_data)``, B=16 x accumulation 2, one loader thread, no snapshots,
    resuming from ``folder/model.pt`` if it is there.  Raises on ``cuda``
    without a card."""
    from ..data import SyntheticDataset
    from ..models import UnetConvNext
    from ..train import Trainer

    device = require_device(device)
    d = diffusion(timesteps=timesteps, image_size=image_size, device=device)
    torch.manual_seed(seed)  # the initial weights
    model = UnetConvNext(dim=dim, dim_mults=dim_mults, channels=3)
    kw = dict(train_batch_size=batch, train_num_steps=10**9, gradient_accumulate_every=accum,
              save_and_sample_every=10**9, num_workers=1, seed=seed, bf16=bf16,
              auto_resume=True, device=device)
    return Trainer(d, model, SyntheticDataset(image_size, 3, length=n_data),
                   results_folder=str(out_path(folder)), **{**kw, **trainer_kw})


def train_images(ds, n: int) -> np.ndarray:
    return np.stack([ds[i] for i in range(n)])


def pfid(a, b, feats) -> float:
    """Proxy FID between two NHWC image sets at the JAX scripts' batch 32."""
    host = [x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x) for x in (a, b)]
    return float(calculate_fid_given_samples(host, batch_size=32, features=feats))


def fid_key(feats) -> str:
    return "fid" if getattr(feats, "is_inception", False) else "proxy_fid"


def anchors(train: np.ndarray, noise: np.ndarray, feats, record: Optional[dict]) -> tuple:
    """(the calibration block under the JAX record's keys, the same-
    distribution anchor and the train mean and std held against ``record``:
    proxy FID 1% relative, mean and std 4 float32 ulps).  ``noise`` is the
    ceiling's noise, already the 128 images the JAX scripts use."""
    key = fid_key(feats)
    half = train.shape[0] // 2
    cal = {f"{key}_train_half_vs_half": pfid(train[:half], train[half:], feats),
           f"{key}_noise_vs_train": pfid(np.clip(noise, -1, 1), train, feats)}
    if record is None:
        return cal, None
    stats = next(iter(record.get("gmm", record.get("routines", {})).values()))
    held = {
        f"{key}_train_half_vs_half": compare_rel(
            cal[f"{key}_train_half_vs_half"], record["calibration"][f"{key}_train_half_vs_half"]),
        "train_mean": compare_ulps(float(train.mean()), stats["train_mean"]),
        "train_std": compare_ulps(float(train.std()), stats["train_std"]),
    }
    return cal, held


def under_ceiling(fids: dict, ceiling: float) -> dict:
    """The generation records' claim that each row's proxy FID lies far
    below the noise ceiling, checked as under a tenth of it (JAX's rows lie
    under a seventeenth)."""
    return {"ceiling": ceiling, **fids, "held": max(fids.values()) < ceiling / 10}


def jax_record(name: str) -> Optional[dict]:
    path = REPO / "docs" / "examples" / name
    return json.loads(path.read_text()) if path.exists() else None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm_step(denoise, x: torch.Tensor, timesteps: int, chunk: int) -> Callable[[], torch.Tensor]:
    """One reverse step's model call on one chunk of ``x``, at the top
    level: enough to build the front kernels and load the CUDA modules
    before a timed call, at a fraction of a whole sample's cost."""
    xc = x[:chunk]
    t = torch.full((xc.shape[0],), timesteps - 1, dtype=torch.long, device=x.device)
    return lambda: denoise(xc, t)


def timed_call(fn: Callable[[], torch.Tensor], warm: Callable[[], object],
               device: torch.device) -> tuple:
    """(the result of ``fn()``, its seconds), after an untimed ``warm()``
    (``warm_step``).  On the card ``fn`` runs between synchronizations,
    timed by CUDA events; on the CPU by the host's clock."""
    with torch.no_grad():
        warm()
    _sync(device)
    if device.type == "cuda":
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        stop.record()
        torch.cuda.synchronize(device)
        return out, start.elapsed_time(stop) / 1e3
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def run_steps(tr, steps: int, *, every: int, save_every: int,
              draws: Optional[Callable[[int], dict]] = None, quiet: bool = False) -> tuple:
    """Train ``tr`` (a ``Trainer`` made with ``auto_resume=True``) from its
    step to ``steps``; returns (the loss points, training seconds).

    A loss point ``{"step": i, "loss": ...}`` is taken after the i-th step
    (0-based) where ``i % every == 0`` and after the last, as the JAX
    scripts take them, and appended to ``losses.jsonl`` in the run folder.
    The checkpoint (``model.pt``) and ``progress.json`` (step, seconds) are
    written every ``save_every`` steps and at the end, so a cut run resumes
    where its last checkpoint stopped: the Trainer reloads the weights, Adam,
    its generators and its loaders' place, and the points after that step
    are dropped and taken again.  ``draws(i)`` gives step i's ``train_step``
    keywords (``t``, ``x_end``) where a test replays another package's
    draws.  The seconds exclude the checkpoint writes."""
    folder = Path(tr.results_folder)
    log, progress = folder / "losses.jsonl", folder / "progress.json"
    points = ([json.loads(s) for s in log.read_text().splitlines() if s]
              if log.exists() else [])
    points = [p for p in points if p["step"] < tr.step]
    log.write_text("".join(json.dumps(p) + "\n" for p in points))
    seconds = 0.0
    if tr.step and progress.exists():
        prior = json.loads(progress.read_text())
        seconds = prior["seconds"] if prior["step"] == tr.step else 0.0
    if tr.step > steps:
        raise ValueError(f"{folder} holds a run at step {tr.step}, past the {steps} asked for")
    t0 = time.perf_counter()
    for i in range(tr.step, steps):
        loss = tr.train_step(tr._next_superbatch(), **(draws(i) if draws else {}))
        if i % every == 0 or i == steps - 1:
            p = {"step": i, "loss": float(loss)}
            points.append(p)
            with open(log, "a") as f:
                f.write(json.dumps(p) + "\n")
            if not quiet:
                emit(p)
        if (i + 1) % save_every == 0 or i == steps - 1:
            _sync(tr.device)
            seconds += time.perf_counter() - t0
            tr.save()
            progress.write_text(json.dumps({"step": tr.step, "seconds": seconds}) + "\n")
            t0 = time.perf_counter()
    return points, seconds


def stamp(device) -> dict:
    """What every record states of where it ran."""
    return {"card": card(), "torch": torch.__version__, "device": str(device)}


def train_parser(description: str, out: str, run: str, n_gen: int) -> argparse.ArgumentParser:
    """The generation records' command line: ``[train_steps=15000] --out
    --device --run --n_gen``."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("train_steps", nargs="?", type=int, default=15000)
    p.add_argument("--out", default=str(REPO / out))
    p.add_argument("--device", default="cuda")
    p.add_argument("--run", default=str(REPO / run))
    p.add_argument("--n_gen", type=int, default=n_gen)
    return p


def train_record(tr, config: str, steps: int, losses: list, seconds: float) -> dict:
    """A generation record's head: the stamp, the configuration and the
    training of ``tr``."""
    return {**stamp(tr.device), "config": config, "train_steps": steps,
            "train_time_s": round(seconds, 1), "loss_trajectory": losses,
            "checkpoint": str(Path(tr.results_folder) / "model.pt")}


def exit_code(result: dict) -> int:
    """1 if an anchor held against the JAX record is out of its limit, else
    0.  A claim that missed is printed, and stays in the record as a miss."""
    for name, c in result.get("claims", {}).items():
        if not c["held"]:
            print(f"claim missed: {name} {json.dumps(c)}", flush=True)
    missed = {k: v for k, v in result.get("anchors_vs_jax", {}).items() if not v["within"]}
    if missed:
        print(f"anchors out of their limits against the JAX record: {json.dumps(missed)}",
              flush=True)
    return 1 if missed else 0


def train_and_record(args, make_trainer, every: int, config: Callable,
                     evaluate: Callable) -> int:
    """A generation record's ``main``: train ``args.train_steps`` steps in
    ``args.run`` (resuming there, a checkpoint every ``SAVE_EVERY``), write
    the record (``train_record`` with ``config(tr)``, then ``evaluate(tr,
    out)``) to ``args.out``, and return its ``exit_code``."""
    out = out_path(args.out)
    device = require_device(args.device)
    tr = make_trainer(args.run, device=device)
    losses, seconds = run_steps(tr, args.train_steps, every=every, save_every=SAVE_EVERY)
    result = {**train_record(tr, config(tr), args.train_steps, losses, seconds),
              **evaluate(tr, out)}
    write_json(out, result)
    print(f"wrote {out}")
    return exit_code(result)
