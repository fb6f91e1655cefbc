"""Family-B (hot, interpolation to noise) generation quality record.

    python -m colddiff_torch.scripts.family_b_generation [train_steps=15000]
        [--out docs/examples/torch_family_b_generation.json] [--device cuda]
        [--run runs/torch_family_b_hot64]

The port's twin of ``scripts/family_b_generation.py``: train the
``GaussianNoise`` operator (T=200) at 64 px with ``UnetConvNext(64, (1, 2,
4, 8))`` on ``SyntheticDataset(64, 3, 256)`` (B=16 x accumulation 2, seed 0,
fp32), then generate 256 images from pure noise with ``x0_step_down`` (the
noise as the fixed endpoint) and with ``ddim`` (the endpoint estimated each
step), and record proxy-FID(generated, the 256 training images) between
the same-distribution floor (train half against train half) and the noise
ceiling (noise against train).  The loss is recorded every 500 steps, and
the run is checkpointed in ``--run`` every 1,000 steps, so a cut
call resumes there.  The floor anchor and the train mean and std are also
held against the JAX record (proxy-FID 1% relative, 4 float32 ulps).  The
noise and the samplers draw from seeded ``torch.Generator``s (JAX: threefry
keys 7 and 1), so the generated rows compare with JAX's as a band.  Images/s
is one call after an untimed reverse step on one chunk, timed between
synchronizations on the card.  The record's ``claims`` check the JAX
record's: each routine far below the noise ceiling, ``x0_step_down`` at or
below ``ddim``.  The script exits 1 if an anchor misses its limit; a claim
that misses is printed and recorded as a miss.
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from . import _records as rec

T, IMG, N_GEN = 200, 64, 256
LOSS_EVERY = 500
ROUTINES = ("x0_step_down", "ddim")
JAX_RECORD = "family_b_generation.json"
EXTRA_KEYS = {"card", "torch", "device", "checkpoint", "anchors_vs_jax", "claims"}


def diffusion(*, timesteps: int = T, image_size: int = IMG, device="cuda"):
    from ..diffusion import ColdDiffusion
    from ..operators import get_operator

    return ColdDiffusion(op=get_operator("noise", timesteps=timesteps, device=device),
                         image_size=image_size, channels=3, sampling_routine="x0_step_down")


# the run's Trainer (``_records.make_trainer``), resuming from
# ``folder/model.pt`` if it is there
make_trainer = functools.partial(rec.make_trainer, diffusion, image_size=IMG, timesteps=T)


def generate(model, d, noise: torch.Tensor, routine: str, *, refresh_every: int = 1,
             chunk: int = 16, generator=None) -> torch.Tensor:
    """Images from ``noise`` by ``routine``: ``x0_step_down`` with the noise
    as its fixed endpoint, ``ddim`` estimating it each step
    (scripts/family_b_generation.py:115-119)."""
    import dataclasses

    from ..sampling import sample
    from ..utils import apply_in_chunks

    dr = dataclasses.replace(d, sampling_routine=routine)

    def denoise(x, t):
        return apply_in_chunks(lambda xc, tc: model(xc, tc), chunk, x, t)

    gen = generator or torch.Generator(device=noise.device).manual_seed(1)
    return sample(dr, denoise, noise, x_end=noise if routine == "x0_step_down" else None,
                  generator=gen, refresh_every=refresh_every).img


def draw_noise(n: int, image_size: int, device, seed: int = 7) -> torch.Tensor:
    """The generation start: unit normal noise from a generator seeded 7
    (JAX: ``jax.random.normal(jax.random.key(7), ...)``)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((n, image_size, image_size, 3), generator=gen, device=device)


def grid(path, img: np.ndarray) -> None:
    from ..utils import save_image_grid

    save_image_grid(img[:64], rec.out_path(path), nrow=8)


def evaluate(model, ds, d, *, n_gen: int = N_GEN, n_train: int = 256, noise=None,
             generator=None, routines=ROUTINES, chunk: int = 16, feats=None,
             png_prefix=None, record=None, keep=None) -> dict:
    """The record's measurements of ``model`` (the EMA model, on its
    device): the calibration anchors, then each routine's images against
    the training images.  ``noise`` ([n_gen, H, W, 3]) and ``generator``
    replace the seeded draws (the tests pass JAX's); ``png_prefix`` writes
    the sample grids as ``<prefix>_<routine>_samples.png`` and
    ``<prefix>_train_set.png``; ``record`` (a JAX record) adds the anchors
    held against it; ``keep`` (a dict) receives each routine's images."""
    from ..eval.fid import fid_features_fn

    device = next(model.parameters()).device
    feats = feats or fid_features_fn(device=device)
    key = rec.fid_key(feats)
    train = rec.train_images(ds, n_train)
    noise = draw_noise(n_gen, d.image_size, device) if noise is None else noise.to(device)
    cal, held = rec.anchors(train, noise[:n_train // 2].cpu().numpy(), feats, record)
    out = {"extractor": getattr(feats, "name", "inception"), "calibration": cal,
           "routines": {}}
    if held is not None:
        out["anchors_vs_jax"] = held
    rec.emit(cal)
    for routine in routines:
        img, seconds = rec.timed_call(
            lambda: generate(model, d, noise, routine, chunk=chunk, generator=generator),
            rec.warm_step(model, noise, d.num_timesteps, chunk), device)
        img = img.clamp(-1, 1).cpu().numpy()
        if keep is not None:
            keep[routine] = img
        entry = {f"{key}_generated_vs_train": rec.pfid(img, train, feats),
                 "img_per_s": round(n_gen / seconds, 2),
                 "gen_mean": float(img.mean()), "gen_std": float(img.std()),
                 "train_mean": float(train.mean()), "train_std": float(train.std())}
        out["routines"][routine] = entry
        rec.emit({routine: entry})
        if png_prefix:
            grid(f"{png_prefix}_{routine}_samples.png", img)
    if png_prefix:
        grid(f"{png_prefix}_train_set.png", train)
    out["claims"] = claims({r: e[f"{key}_generated_vs_train"]
                            for r, e in out["routines"].items()},
                           cal[f"{key}_noise_vs_train"])
    return out


def claims(fids: dict, ceiling: float) -> dict:
    """The JAX record's claims, each checked: every routine far below the
    noise ceiling, and ``x0_step_down`` at or below ``ddim`` (JAX: 1.998
    and 2.497)."""
    out = {"far_below_noise_ceiling": rec.under_ceiling(fids, ceiling)}
    if set(ROUTINES) <= set(fids):
        out["x0_step_down_at_or_below_ddim"] = {
            **{r: fids[r] for r in ROUTINES},
            "held": fids["x0_step_down"] <= fids["ddim"]}
    return out


def config(tr) -> str:
    return (f"GaussianNoise (hot) T={tr.diffusion.num_timesteps} @{tr.diffusion.image_size}px, "
            f"UnetConvNext(64,(1,2,4,8)), B={tr.batch_size} accum x{tr.accum}, seed 0")


def parser():
    return rec.train_parser(__doc__.split("\n\n")[0],
                            "docs/examples/torch_family_b_generation.json",
                            "runs/torch_family_b_hot64", N_GEN)


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    return rec.train_and_record(args, make_trainer, LOSS_EVERY, config, lambda tr, out: evaluate(
        tr.ema_model.eval(), tr._dataset, tr.diffusion, record=rec.jax_record(JAX_RECORD),
        n_gen=args.n_gen, png_prefix=out.parent / "torch_family_b"))


if __name__ == "__main__":
    sys.exit(main())
