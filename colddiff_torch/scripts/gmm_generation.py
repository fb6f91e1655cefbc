"""Cold generation without noise: discrete deblurring and a channel-mean GMM.

    python -m colddiff_torch.scripts.gmm_generation [train_steps=15000]
        [--out docs/examples/torch_gmm_generation.json] [--device cuda]
        [--run runs/torch_gmm_gen64]

The port's twin of ``scripts/gmm_generation.py``: train the discrete blur
(``Exponential``, T=150, kernel 15, std 0.01, the channel-mean collapse) at
64 px with ``UnetConvNext(64, (1, 2, 4, 8))`` on ``SyntheticDataset(64, 3,
256)`` (B=16 x accumulation 2, seed 0, the bf16 recipe), then
``EvalHarness.gmm_mean_samples`` (one cluster, 256 images, fp32): fit a GMM
to the training images' channel means, expand its draws to constant images,
add symmetry-breaking noise 0.0 or 0.002 and reverse-sample; each row has
proxy-FID(generated, the 256 training images), images/s with the fit, and
the generated mean and std, beside the floor and ceiling anchors
(reference README.md:87-99, deblurring_diffusion_pytorch.py:1391-1456).
The loss is recorded and the run checkpointed in ``--run`` every 1,000
steps, so a cut call resumes there.  The
floor anchor and the train mean and std are also held against the JAX
record (proxy-FID 1% relative, 4 float32 ulps).  The ceiling's noise and
the GMM draw from generators seeded 7 and 3 (JAX: threefry keys 7 and 3),
so the generated rows compare with JAX's as a band.  The record's
``claims`` check the JAX record's: each level far below the noise ceiling,
noise 0.002 within 10% of 0.0.  The script exits 1 if an anchor misses its
limit; a claim that misses is printed and recorded as a miss.
"""

from __future__ import annotations

import functools
import sys
import time
from pathlib import Path

import torch

from . import _records as rec
from .family_b_generation import draw_noise, grid

T, IMG, N_GEN = 150, 64, 256
LOSS_EVERY = 1000
NOISE_LEVELS = (0.0, 0.002)
JAX_RECORD = "gmm_generation.json"
EXTRA_KEYS = {"card", "torch", "device", "checkpoint", "anchors_vs_jax", "claims"}


def diffusion(*, timesteps: int = T, image_size: int = IMG, device="cuda"):
    from ..diffusion import ColdDiffusion
    from ..operators import get_operator

    op = get_operator("blur", image_size=image_size, timesteps=timesteps,
                      blur_routine="Exponential", kernel_size=15, kernel_std=0.01,
                      discrete=True, device=device)
    return ColdDiffusion(op=op, image_size=image_size, channels=3,
                         sampling_routine="x0_step_down", discrete=True)


# the run's Trainer (``_records.make_trainer``, the bf16 recipe), resuming
# from ``folder/model.pt`` if it is there
make_trainer = functools.partial(rec.make_trainer, diffusion, image_size=IMG, timesteps=T,
                                 bf16=True)


def evaluate(model, ds, d, *, n_gen: int = N_GEN, n_train: int = 256, noise=None,
             generator=None, noise_levels=NOISE_LEVELS, chunk: int = 16, feats=None,
             eval_folder=None, png_prefix=None, record=None, keep=None) -> dict:
    """The record's measurements of ``model`` (the EMA model, on its
    device): the anchors, then ``gmm_mean_samples`` at each noise level in
    fp32.  ``noise`` (the ceiling's 128 images) and ``generator`` (a
    callable giving each level's generator) replace the seeded draws;
    ``png_prefix`` writes ``<prefix>_noise<level>.png`` and
    ``<prefix>_train_set.png``; ``record`` (a JAX record) adds the anchors
    held against it; ``keep`` (a dict) receives each level's images."""
    import tempfile

    from ..eval import EvalHarness
    from ..eval.fid import fid_features_fn

    device = next(model.parameters()).device
    feats = feats or fid_features_fn(device=device)
    key = rec.fid_key(feats)
    train = rec.train_images(ds, n_train)
    noise = (draw_noise(n_train // 2, d.image_size, device) if noise is None
             else torch.as_tensor(noise))
    cal, held = rec.anchors(train, noise.cpu().numpy(), feats, record)
    out = {"extractor": getattr(feats, "name", "inception"), "calibration": cal, "gmm": {}}
    if held is not None:
        out["anchors_vs_jax"] = held
    rec.emit(cal)
    with tempfile.TemporaryDirectory() as tmp:
        harness = EvalHarness(d, model, results_folder=str(eval_folder or tmp),
                              model_chunk=chunk, device=device)
        for level in noise_levels:
            gen = (generator(level) if generator is not None
                   else torch.Generator(device=device).manual_seed(3))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            res = harness.gmm_mean_samples(ds, clusters=1, num=n_gen, noise_level=level,
                                           generator=gen)
            img = res.img.clamp(-1, 1).cpu().numpy()
            seconds = time.perf_counter() - t0
            if keep is not None:
                keep[level] = img
            entry = {"noise_level": level,
                     f"{key}_generated_vs_train": rec.pfid(img, train, feats),
                     "img_per_s_incl_gmm_fit": round(n_gen / seconds, 2),
                     "gen_mean": float(img.mean()), "gen_std": float(img.std()),
                     "train_mean": float(train.mean()), "train_std": float(train.std())}
            out["gmm"][str(level)] = entry
            rec.emit(entry)
            if png_prefix:
                grid(f"{png_prefix}_noise{level}.png", img)
    if png_prefix:
        grid(f"{png_prefix}_train_set.png", train)
    out["claims"] = claims({lv: e[f"{key}_generated_vs_train"] for lv, e in out["gmm"].items()},
                           cal[f"{key}_noise_vs_train"])
    return out


def claims(fids: dict, ceiling: float) -> dict:
    """The JAX record's claims, each checked: every level far below the
    noise ceiling, and symmetry noise 0.002 not much worse than 0.0, read as
    within 10% of it (JAX: 0.440 and 0.442)."""
    out = {"far_below_noise_ceiling": rec.under_ceiling(fids, ceiling)}
    if {"0.0", "0.002"} <= set(fids):
        out["noise_0.002_within_10pct_of_0.0"] = {
            "0.0": fids["0.0"], "0.002": fids["0.002"],
            "held": fids["0.002"] <= 1.1 * fids["0.0"]}
    return out


def config(tr) -> str:
    return (f"discrete blur-generation T={tr.diffusion.num_timesteps} ks=15 Exponential "
            f"@{tr.diffusion.image_size}px, UnetConvNext(64,(1,2,4,8)), "
            f"{'bf16' if tr.bf16 else 'fp32'} train, seed 0 (reference 128px config "
            "README.md:87-99 scaled to 64px)")


def parser():
    return rec.train_parser(__doc__.split("\n\n")[0], "docs/examples/torch_gmm_generation.json",
                            "runs/torch_gmm_gen64", N_GEN)


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    return rec.train_and_record(args, make_trainer, LOSS_EVERY, config, lambda tr, out: evaluate(
        tr.ema_model.eval(), tr._dataset, tr.diffusion, record=rec.jax_record(JAX_RECORD),
        eval_folder=Path(tr.results_folder) / "eval", n_gen=args.n_gen,
        png_prefix=out.parent / "torch_gmm_generation"))


if __name__ == "__main__":
    sys.exit(main())
