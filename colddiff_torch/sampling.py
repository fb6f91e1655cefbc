"""Reverse samplers: a Python loop over the levels.

Port of ``prepare_start``, ``sample`` and ``all_sample`` in
``colddiff/sampling.py``, where each is one ``lax.scan``:

  Algorithm 1 ('default'):       x_{t-1} = D(x0_hat, t-1)
      (deblurring_diffusion_pytorch.py:428-434)
  Algorithm 2 ('x0_step_down'):  x_{t-1} = x_t - D(x0_hat, t) + D(x0_hat, t-1)
      (deblurring_diffusion_pytorch.py:436-451; TACoS)
  Family B (operators with ``requires_x_end``): Algorithm 2 toward an
      endpoint x2: the given ``x_end``; estimated from x_t by
      ``op.x_end_from_xt`` under 'ddim' or when no ``x_end`` is given
      (denoising_diffusion_pytorch.py:377-381); redrawn every step by
      ``op.sample_x_end`` under 'x0_step_down_spiral_2_rand'
      (defading_diffusion_naive.py:430-445).

Every ``degrade`` is O(1) (a gather and a few fp32 products), so a T-step
run is T UNet calls and 2T small degrades.

Not ported yet (each raises ``NotImplementedError``; ROADMAP.md section 1):
models trained with ``Step``, ``Step_Gradient`` or ``Gradient_norm`` and
``sample_multi_step`` (item 10).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .diffusion import ColdDiffusion, DenoiseFn

__all__ = ["SampleResult", "prepare_start", "sample", "all_sample",
           "sample_multi_step"]

_ROUTINES = ("default", "x0_step_down")  # Family A
_X_END_ROUTINES = ("default", "x0_step_down", "ddim", "x0_step_down_spiral_2_fix",
                   "x0_step_down_spiral_2_rand")  # Family B
# train routines whose model predicts x0, the only kind this sampler steps
_X0_TRAIN_ROUTINES = ("Final", "Final_small_noise", "Final_random_mean",
                      "Final_random_mean_and_actual")


class SampleResult(NamedTuple):
    xt: torch.Tensor  # the (degraded) starting state x_T
    direct_recons: torch.Tensor  # the model's first direct reconstruction
    img: torch.Tensor  # the final reverse-sampled image
    x0_trajectory: Optional[torch.Tensor] = None  # [steps / stride, B, H, W, C]
    xt_trajectory: Optional[torch.Tensor] = None  # [steps / stride, B, H, W, C]


def prepare_start(diffusion: ColdDiffusion, img: torch.Tensor,
                  t: Optional[int] = None, *,
                  x_end: Optional[torch.Tensor] = None, rng=None) -> torch.Tensor:
    """Degrade a clean NHWC batch to the sampling start x_t (reference
    sample() preamble, deblurring_diffusion_pytorch.py:399-415: t
    degradation steps, with the discrete channel-mean collapse handled
    inside the operator).  ``x_end`` is a Family-B endpoint, ``rng`` an
    operator state of ``op.sample_rng_state``."""
    steps = diffusion.num_timesteps if t is None else int(t)
    n = torch.full((img.shape[0],), steps, dtype=torch.long, device=img.device)
    return diffusion.op.degrade_sampling(img, n, x_end=x_end, rng=rng)


def _reverse_step(diffusion: ColdDiffusion, img: torch.Tensor, t_cur: int,
                  x0_hat: torch.Tensor, x_end: Optional[torch.Tensor],
                  generator: Optional[torch.Generator]) -> torch.Tensor:
    """One reverse step from level t_cur (number of applied steps, >= 1).
    Sampling passes no ``rng``: an operator's baked state holds for the run
    (fade crops, defading_diffusion_gaussian.py:357-367)."""
    op = diffusion.op
    routine = diffusion.sampling_routine
    n_t = torch.full((img.shape[0],), t_cur, dtype=torch.long, device=img.device)
    n_tm1 = n_t - 1
    if op.requires_x_end:
        if routine == "x0_step_down_spiral_2_rand":
            x2 = op.sample_x_end(generator, x0_hat)
        elif routine == "ddim" or x_end is None:
            x2 = op.x_end_from_xt(x0_hat, img, n_t)
        else:  # a fixed endpoint
            x2 = x_end
        return img - op.degrade(x0_hat, n_t, x_end=x2) + op.degrade(x0_hat, n_tm1, x_end=x2)
    if routine == "default":
        return op.degrade_sampling(x0_hat, n_tm1)
    base = x0_hat
    if diffusion.recon_noise_std > 0.0:
        # snowification diffusion.py:222-225: perturb the reconstruction
        # before re-degrading
        base = x0_hat + diffusion.recon_noise_std * torch.randn(
            x0_hat.shape, generator=generator, dtype=x0_hat.dtype,
            device=x0_hat.device)
    return img - op.degrade(base, n_t) + op.degrade(base, n_tm1)


def sample(
    diffusion: ColdDiffusion,
    denoise_fn: DenoiseFn,
    img: torch.Tensor,
    t: Optional[int] = None,
    *,
    x_end: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    refresh_every: int = 1,
    trajectory: bool = False,
    traj_stride: int = 1,
    grad: bool = False,
) -> SampleResult:
    """Run the full reverse loop from NHWC state ``img`` at level ``t``.

    ``img`` must already be degraded (:func:`prepare_start`).
    ``denoise_fn(x, t)`` takes the state and the model's integer level index
    [B] and returns the x0 prediction.  For a Family-B operator ``x_end`` is
    the fixed endpoint of 'x0_step_down' (None, or 'ddim', estimates it per
    step).

    ``refresh_every > 1`` is the JAX package's opt-in acceleration: the x0
    prediction is refreshed only every K steps and reused in between.
    ``recon_noise_std > 0`` (Family A) and 'x0_step_down_spiral_2_rand'
    (Family B) draw from ``generator``, which is then required.

    ``trajectory=True`` also returns the frames (x0_hat, the state before
    the step) of every ``traj_stride``-th step, which must divide the steps:
    frame j is step j * traj_stride's, so frame 0 is (direct_recons, x_T).
    The frames go into tensors allocated once, [steps / traj_stride, B, H,
    W, C] each.  With ``grad=False`` (the default) the loop runs under
    ``torch.inference_mode()``.
    """
    op, routine = diffusion.op, diffusion.sampling_routine
    if diffusion.train_routine not in _X0_TRAIN_ROUTINES:
        raise NotImplementedError(
            f"sampling a '{diffusion.train_routine}' model is not ported yet; "
            "see ROADMAP.md section 1, item 10")
    routines = _X_END_ROUTINES if op.requires_x_end else _ROUTINES
    if routine not in routines:
        raise NotImplementedError(
            f"sampling routine '{routine}' is not one of {routines}, which "
            f"{type(op).__name__} takes (ddim and the spiral routines need an "
            "endpoint operator, as in colddiff/sampling.py)")
    if refresh_every < 1:
        raise ValueError(f"refresh_every must be >= 1, got {refresh_every}")
    if op.requires_x_end:
        draws = routine == "x0_step_down_spiral_2_rand"
    else:
        draws = routine == "x0_step_down" and diffusion.recon_noise_std > 0.0
    if draws and generator is None:
        raise ValueError(f"sampling routine '{routine}' with recon_noise_std="
                         f"{diffusion.recon_noise_std} draws noise: it needs a "
                         "torch.Generator")

    steps = diffusion.num_timesteps if t is None else int(t)
    if trajectory and (traj_stride < 1 or steps % traj_stride != 0):
        raise ValueError(f"traj_stride={traj_stride} must divide steps={steps}")
    x0_traj = xt_traj = None
    with torch.inference_mode(not grad):
        cur = img
        direct = torch.zeros_like(img)
        x0_hat = None
        for k in range(steps):
            t_cur = steps - k
            if k % refresh_every == 0:
                level = torch.full((img.shape[0],), t_cur - 1, dtype=torch.long,
                                   device=img.device)
                x0_hat = denoise_fn(cur, level)
            if k == 0:
                direct = x0_hat
            if trajectory and k % traj_stride == 0:
                if x0_traj is None:
                    frames = steps // traj_stride
                    x0_traj = x0_hat.new_empty((frames, *x0_hat.shape))
                    xt_traj = cur.new_empty((frames, *cur.shape))
                x0_traj[k // traj_stride] = x0_hat
                xt_traj[k // traj_stride] = cur
            cur = _reverse_step(diffusion, cur, t_cur, x0_hat, x_end, generator)
    return SampleResult(img, direct, cur, x0_traj, xt_traj)


def all_sample(diffusion: ColdDiffusion, denoise_fn: DenoiseFn, img: torch.Tensor,
               t: Optional[int] = None, *, x_end: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None, traj_stride: int = 1,
               refresh_every: int = 1) -> SampleResult:
    """Reverse loop that also returns the [steps / traj_stride, B, H, W, C]
    reconstruction and state trajectories (reference all_sample,
    deblurring_diffusion_pytorch.py:609-689); see :func:`sample`."""
    return sample(diffusion, denoise_fn, img, t, x_end=x_end, generator=generator,
                  trajectory=True, traj_stride=traj_stride, refresh_every=refresh_every)


def sample_multi_step(*args, **kwargs) -> torch.Tensor:
    """Per-sample partial reverse runs: not ported yet."""
    raise NotImplementedError(
        "sample_multi_step is not ported yet; see ROADMAP.md section 1, item 10")
