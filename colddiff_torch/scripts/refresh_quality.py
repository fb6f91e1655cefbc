"""Quality cost of ``refresh_every`` on a trained deblurring checkpoint.

    python -m colddiff_torch.scripts.refresh_quality
        [--checkpoint runs/torch_convergence_blur128/model.pt]
        [--out docs/examples/torch_refresh_quality.json] [--n_images 64]
        [--device cuda]

The port's twin of ``scripts/eval_refresh_quality.py``.  ``refresh_every=K``
reuses the UNet's x0 prediction for K reverse steps (``sampling.sample``),
cutting the sampler's model calls K-fold.  On the canonical 128 px blur
configuration (``Exponential_reflect``, T=200, kernel 15, std 0.01,
``UnetConvNext(64, (1, 2, 4, 8))``) this loads a port checkpoint
(``model.pt``, through ``Trainer(train_num_steps=0, load_path=...)``),
takes its EMA model, degrades the first ``n_images`` of
``SyntheticDataset(128, 3)`` with ``prepare_start`` and samples them back
for K in {1, 2, 4, 8} in fp32 and K in {1, 4, 8} through the bf16 recipe
(``utils.bf16_params``: bf16 parameter copies and inputs, fp32 outputs, so
the reverse loop and every degrade stay fp32).  Each row has RMSE, SSIM (on
[0, 1], ``data_range=1``), proxy-FID against the originals and images/s of
one call after an untimed reverse step on one chunk, timed between
synchronizations on the card.  The
model runs in chunks of 16 images, as the JAX script runs it.  The record
has the JAX record's keys, its ``summary`` at 4 significant digits, and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import sys
import tempfile

import torch

from . import _records as rec

T, IMG, CHUNK = 200, 128, 16
FP32_KS, BF16_KS = (1, 2, 4, 8), (1, 4, 8)
EXTRA_KEYS = {"card", "torch", "device"}


def diffusion(*, image_size: int = IMG, timesteps: int = T, device="cuda"):
    from ..diffusion import ColdDiffusion
    from ..operators import get_operator

    op = get_operator("blur", image_size=image_size, timesteps=timesteps,
                      blur_routine="Exponential_reflect", kernel_size=15, kernel_std=0.01,
                      device=device)
    return ColdDiffusion(op=op, image_size=image_size, channels=3,
                         sampling_routine="x0_step_down")


def load_ema(checkpoint, d, *, dim: int = 64, dim_mults=(1, 2, 4, 8), device="cuda"):
    """The EMA model of a port checkpoint, in ``eval()``."""
    from ..data import SyntheticDataset
    from ..models import UnetConvNext
    from ..train import Trainer

    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(d, UnetConvNext(dim=dim, dim_mults=dim_mults, channels=3),
                     SyntheticDataset(d.image_size, 3, length=16), train_batch_size=16,
                     train_num_steps=0, results_folder=tmp, load_path=str(checkpoint),
                     num_workers=1, device=device)
    return tr.ema_model.eval()


def denoisers(model, chunk: int = CHUNK):
    """(the fp32 denoiser, the bf16 recipe's), each over chunks of ``chunk``."""
    from ..utils import apply_in_chunks, bf16_params

    def fp32(x, t):
        return apply_in_chunks(lambda xc, tc: model(xc, tc), chunk, x, t)

    pb = bf16_params(model.named_parameters())

    def one(xc, tc):
        return torch.func.functional_call(model, pb, (xc.to(torch.bfloat16), tc)).to(
            torch.float32)

    def bf16(x, t):
        return apply_in_chunks(one, chunk, x, t)

    return fp32, bf16


def _row(og01, img, k, seconds, n, feats, og) -> dict:
    from ..eval.metrics import rmse, ssim

    img = img.clamp(-1, 1)
    return {"refresh_every": k, "img_per_s": round(n / seconds, 3),
            "rmse": float(rmse(og01, (img + 1) / 2)),
            # SSIM on [0,1] images with data_range=1, as the manifold harness
            # and the reference's ssim(a, b, data_range=1)
            "ssim": float(ssim(og01, (img + 1) / 2)),
            rec.fid_key(feats): rec.pfid(og, img, feats)}


def sig(x: float, digits: int = 4) -> float:
    """Significant digits (scripts/eval_refresh_quality.py:150-153): the
    proxy-FID values are ~1e-4, and decimal places would zero them."""
    return float(f"{x:.{digits}g}")


def summary(results: dict, key: str) -> dict:
    """``summary`` as scripts/eval_refresh_quality.py:150-174 writes it."""
    by_k = {e["refresh_every"]: e for e in results["sweep"]}
    out = {}
    if 1 in by_k and 4 in by_k:
        out = {"rmse_refresh1": sig(by_k[1]["rmse"]), "rmse_refresh4": sig(by_k[4]["rmse"]),
               "ssim_refresh1": sig(by_k[1]["ssim"]), "ssim_refresh4": sig(by_k[4]["ssim"]),
               f"{key}_refresh1": sig(by_k[1][key]), f"{key}_refresh4": sig(by_k[4][key])}
    bf_by_k = {e["refresh_every"]: e for e in results.get("bf16_sweep", [])}
    for k in (4, 8):
        if k in bf_by_k and out:
            e = bf_by_k[k]
            out[f"bf16_refresh{k}_img_per_s"] = e["img_per_s"]
            out[f"bf16_refresh{k}_rmse"] = sig(e["rmse"])
            out[f"bf16_refresh{k}_ssim"] = sig(e["ssim"])
            out[f"bf16_refresh{k}_{key}"] = sig(e[key])
    return out


def evaluate(model, d, og: torch.Tensor, *, checkpoint: str = "", ks=FP32_KS,
             bf16_ks=BF16_KS, chunk: int = CHUNK, feats=None, generator=None,
             keep=None) -> dict:
    """The record's measurements on the originals ``og`` (NHWC in [-1, 1],
    on the model's device); ``keep`` (a dict) receives each row's images
    under ``(sweep, K)``."""
    from ..eval.fid import fid_features_fn
    from ..eval.metrics import rmse, ssim
    from ..sampling import prepare_start, sample

    device = og.device
    feats = feats or fid_features_fn(device=device)
    key, n = rec.fid_key(feats), og.shape[0]
    og01 = (og + 1) / 2
    start = prepare_start(d, og)
    start01 = (start.clamp(-1, 1) + 1) / 2
    results = {"checkpoint": str(checkpoint), "n_images": n, "timesteps": d.num_timesteps,
               "extractor": getattr(feats, "name", "inception"),
               "degraded": {"rmse": float(rmse(og01, start01)),
                            "ssim": float(ssim(og01, start01))},
               "sweep": []}
    fp32, bf16 = denoisers(model, chunk)
    for tag, fn, kk in (("sweep", fp32, ks), ("bf16_sweep", bf16, bf16_ks)):
        results[tag] = []
        for k in kk:
            def run(fn=fn, k=k):
                gen = generator or torch.Generator(device=device).manual_seed(0)
                return sample(d, fn, start, generator=gen, refresh_every=k).img

            img, seconds = rec.timed_call(run, rec.warm_step(fn, start, d.num_timesteps, chunk),
                                          device)
            if keep is not None:
                keep[tag, k] = img
            entry = _row(og01, img, k, seconds, n, feats, og)
            results[tag].append(entry)
            rec.emit(entry if tag == "sweep" else {"bf16": entry})
    # kept for readers of the JAX record's older layout
    results["bf16_compute_refresh1"] = {
        k: v for k, v in results["bf16_sweep"][0].items()
        if k not in ("refresh_every", "img_per_s")} if results["bf16_sweep"] else {}
    results["summary"] = summary(results, key)
    return results


def record(evaluated: dict, device) -> dict:
    return {**rec.stamp(device), **evaluated}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint",
                   default=str(rec.REPO / "runs/torch_convergence_blur128/model.pt"))
    p.add_argument("--out", default=str(rec.REPO / "docs/examples/torch_refresh_quality.json"))
    p.add_argument("--n_images", type=int, default=64)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    out = rec.out_path(args.out)
    device = rec.require_device(args.device)
    from ..data import SyntheticDataset

    d = diffusion(device=device)
    model = load_ema(args.checkpoint, d, device=device)
    ds = SyntheticDataset(IMG, 3, length=max(args.n_images, 64))
    og = torch.from_numpy(rec.train_images(ds, args.n_images)).to(device)
    result = record(evaluate(model, d, og, checkpoint=args.checkpoint), device)
    rec.write_json(out, result)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
