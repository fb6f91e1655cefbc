"""``refresh_every`` on the Family-B generation path (hot noise).

    python -m colddiff_torch.scripts.family_b_refresh_quality
        [--checkpoint runs/torch_family_b_hot64/model.pt]
        [--out docs/examples/torch_family_b_refresh_quality.json]
        [--n_gen 256] [--device cuda]

The port's twin of ``scripts/family_b_refresh_quality.py``: on the
checkpoint of ``family_b_generation`` (its EMA model), generate ``n_gen``
images from pure noise with ``x0_step_down`` and the noise as the fixed
endpoint, for K in {1, 2, 4, 8}, where the x0 prediction really moves along
the reverse pass; each row has proxy-FID(generated, the 256 training
images), images/s of one call after an untimed reverse step on one chunk
(timed between synchronizations on the card) and the generated mean and std, beside the
floor and ceiling anchors of the generation record.  The noise is drawn from
a generator seeded 7 and the sampler's from one seeded 1 (JAX: threefry
keys 7 and 1), so the rows compare with JAX's as a band.
"""

from __future__ import annotations

import argparse
import sys

from . import _records as rec
from .family_b_generation import IMG, N_GEN, T, diffusion, draw_noise, generate

KS = (1, 2, 4, 8)
EXTRA_KEYS = {"card", "torch", "device"}


def evaluate(model, ds, d, *, n_gen: int = N_GEN, n_train: int = 256, noise=None,
             generator=None, ks=KS, chunk: int = 16, feats=None, keep=None) -> dict:
    """The sweep's measurements of ``model`` (on its device); ``noise`` and
    ``generator`` replace the seeded draws (the tests pass JAX's); ``keep``
    (a dict) receives each K's images."""
    from ..eval.fid import fid_features_fn

    device = next(model.parameters()).device
    feats = feats or fid_features_fn(device=device)
    key = rec.fid_key(feats)
    train = rec.train_images(ds, n_train)
    noise = draw_noise(n_gen, d.image_size, device) if noise is None else noise.to(device)
    cal, _ = rec.anchors(train, noise[:n_train // 2].cpu().numpy(), feats, None)
    out = {"n_generated": n_gen, "extractor": getattr(feats, "name", "inception"),
           "calibration": cal, "sweep": []}
    rec.emit(cal)
    for k in ks:
        img, seconds = rec.timed_call(
            lambda: generate(model, d, noise, "x0_step_down", refresh_every=k, chunk=chunk,
                             generator=generator),
            rec.warm_step(model, noise, d.num_timesteps, chunk), device)
        img = img.clamp(-1, 1).cpu().numpy()
        if keep is not None:
            keep[k] = img
        entry = {"refresh_every": k, "img_per_s": round(n_gen / seconds, 2),
                 f"{key}_generated_vs_train": rec.pfid(img, train, feats),
                 "gen_mean": float(img.mean()), "gen_std": float(img.std())}
        out["sweep"].append(entry)
        rec.emit(entry)
    return out


def record(checkpoint: str, evaluated: dict, device) -> dict:
    return {**rec.stamp(device), "checkpoint": str(checkpoint),
            "config": f"GaussianNoise (hot) T={T} @{IMG}px, x0_step_down fixed-endpoint "
                      "generation, fp32 sampler",
            **evaluated}


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--checkpoint", default=str(rec.REPO / "runs/torch_family_b_hot64/model.pt"))
    p.add_argument("--out",
                   default=str(rec.REPO / "docs/examples/torch_family_b_refresh_quality.json"))
    p.add_argument("--n_gen", type=int, default=N_GEN)
    p.add_argument("--device", default="cuda")
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    out = rec.out_path(args.out)
    device = rec.require_device(args.device)
    from ..data import SyntheticDataset
    from .refresh_quality import load_ema

    d = diffusion(device=device)
    model = load_ema(args.checkpoint, d, device=device)
    result = record(args.checkpoint, evaluate(model, SyntheticDataset(IMG, 3, length=256), d,
                                              n_gen=args.n_gen), device)
    rec.write_json(out, result)
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
