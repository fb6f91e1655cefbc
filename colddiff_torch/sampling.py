"""Reverse samplers: a Python loop over the levels.

Port of ``prepare_start``, ``sample``, ``all_sample`` and
``sample_multi_step`` in ``colddiff/sampling.py``, where each is one
``lax.scan``:

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
run is T UNet calls and 2T small degrades.  Each degrade is given ``og``,
the clean image its state stands for, where colddiff/sampling.py gives it:
the input of ``prepare_start``, and x0_hat in the reverse step, also when
``recon_noise_std`` perturbs the degrade's input (snow blends from ``og``;
the other operators ignore it).

Models trained to predict something else than x0 step as their routine
says, whatever the operator (snowification diffusion.py:239-245): ``Step``
models predict x_{t-1}, ``Step_Gradient`` models x_{t-1} - x_t, and
``Gradient_norm`` models the unit degradation direction, which is stepped
against (defading_diffusion_naive.py:451-456).

Inside ``parallel.batch_rows`` (the mesh ``EvalHarness``), the reverse
step's draws (``recon_noise_std``'s noise, a drawn endpoint) are the global
batch's, and this process keeps its rows; inside ``parallel.image_rows``
the samplers run on this process's block of the image rows, with every
operator and both UNet families, and ``recon_noise_std``'s noise and a
drawn endpoint are the whole images' draws; ``all_sample``'s frames are
row blocks, which ``parallel.gather_images`` joins frame by frame.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .diffusion import X0_ROUTINES, ColdDiffusion, DenoiseFn
from .parallel.mesh import draw_rows
from .tracing import span

__all__ = ["SampleResult", "prepare_start", "sample", "all_sample",
           "sample_multi_step"]

_ROUTINES = ("default", "x0_step_down")  # Family A
_X_END_ROUTINES = ("default", "x0_step_down", "ddim", "x0_step_down_spiral_2_fix",
                   "x0_step_down_spiral_2_rand")  # Family B


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
    return diffusion.op.degrade_sampling(img, n, x_end=x_end, og=img, rng=rng)


def _reverse_step(diffusion: ColdDiffusion, img: torch.Tensor, t_cur: int,
                  pred: torch.Tensor, x_end: Optional[torch.Tensor],
                  generator: Optional[torch.Generator]):
    """One reverse step from level t_cur (number of applied steps, >= 1)
    with the model's prediction ``pred``.  Returns (the next state, the
    "x0_hat" that the loop keeps: direct_recons at step 0, the x0
    trajectory's frame, and the prediction reused under ``refresh_every``),
    as colddiff/sampling.py's ``_reverse_step`` returns it.  For a
    ``Gradient_norm`` model that second element is ``img - pred``, not the
    model's output.  Sampling passes no ``rng``: an operator's baked state
    holds for the run (fade crops, defading_diffusion_gaussian.py:357-367)."""
    train_routine = diffusion.train_routine
    if train_routine == "Step":
        return pred, pred
    if train_routine == "Step_Gradient":
        return img + pred, pred
    if train_routine == "Gradient_norm":
        return img - pred, img - pred
    x0_hat = pred
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
        return (img - op.degrade(x0_hat, n_t, x_end=x2, og=x0_hat)
                + op.degrade(x0_hat, n_tm1, x_end=x2, og=x0_hat)), x0_hat
    if routine == "default":
        return op.degrade_sampling(x0_hat, n_tm1, og=x0_hat), x0_hat
    base = x0_hat
    if diffusion.recon_noise_std > 0.0:
        # snowification diffusion.py:222-225: perturb the reconstruction
        # before re-degrading; snow still blends from the clean x0_hat
        base = x0_hat + diffusion.recon_noise_std * draw_rows(
            lambda n, h: torch.randn((n, h, *x0_hat.shape[2:]), generator=generator,
                                     dtype=x0_hat.dtype, device=x0_hat.device),
            x0_hat.shape[0], h=x0_hat.shape[1])
    return (img - op.degrade(base, n_t, og=x0_hat)
            + op.degrade(base, n_tm1, og=x0_hat)), x0_hat


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
    [B] and returns the model's prediction: x0 under the ``Final`` routines,
    otherwise what ``diffusion.train_routine`` trained it to predict (see
    the module docstring).  For a Family-B operator ``x_end`` is the fixed
    endpoint of 'x0_step_down' (None, or 'ddim', estimates it per step).

    ``refresh_every > 1`` is the JAX package's opt-in acceleration: the
    model is called only every K steps, and the steps between reuse the
    last step's x0_hat (for ``Gradient_norm``, ``img - pred`` of that step).
    ``recon_noise_std > 0`` (Family A) and 'x0_step_down_spiral_2_rand'
    (Family B) with an x0 model draw from ``generator``, which is then
    required.

    ``trajectory=True`` also returns the frames (x0_hat, the state before
    the step) of every ``traj_stride``-th step, which must divide the steps:
    frame j is step j * traj_stride's, so frame 0 is (direct_recons, x_T).
    The frames go into tensors allocated once, [steps / traj_stride, B, H,
    W, C] each.  With ``grad=False`` (the default) the loop runs under
    ``torch.inference_mode()``.
    """
    op, routine = diffusion.op, diffusion.sampling_routine
    routines = _X_END_ROUTINES if op.requires_x_end else _ROUTINES
    if routine not in routines:
        raise NotImplementedError(
            f"sampling routine '{routine}' is not one of {routines}, which "
            f"{type(op).__name__} takes (ddim and the spiral routines need an "
            "endpoint operator, as in colddiff/sampling.py)")
    if refresh_every < 1:
        raise ValueError(f"refresh_every must be >= 1, got {refresh_every}")
    if diffusion.train_routine not in X0_ROUTINES:
        draws = False
    elif op.requires_x_end:
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
        direct = torch.zeros_like(img) if steps == 0 else None
        x0_hat = None
        for k in range(steps):
            t_cur = steps - k
            if k % refresh_every == 0:
                level = torch.full((img.shape[0],), t_cur - 1, dtype=torch.long,
                                   device=img.device)
                pred = denoise_fn(cur, level)
            else:
                pred = x0_hat
            with span("sample.degrade"):
                new, x0_hat = _reverse_step(diffusion, cur, t_cur, pred, x_end, generator)
            if k == 0:
                direct = x0_hat
            if trajectory and k % traj_stride == 0:
                if x0_traj is None:
                    frames = steps // traj_stride
                    x0_traj = x0_hat.new_empty((frames, *x0_hat.shape))
                    xt_traj = cur.new_empty((frames, *cur.shape))
                x0_traj[k // traj_stride] = x0_hat
                xt_traj[k // traj_stride] = cur
            cur = new
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


def sample_multi_step(diffusion: ColdDiffusion, denoise_fn: DenoiseFn,
                      img: torch.Tensor, t_start, t_end, *,
                      x_end: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample partial reverse runs: sample i goes from level t_start[i]
    down to t_end[i] (snowification diffusion.py:247-256), with
    colddiff/sampling.py's semantics.

    Each of at most T iterations calls the model on the whole batch at
    index ``max(level - 1, 0)`` and steps with ``n_t = max(level, 1)``; a
    sample whose level has reached its t_end keeps its state.  The loop
    ends once no sample is active, which leaves the output as it is.  The
    step: ``Step`` models' prediction is the next state, ``Step_Gradient``
    models' is added to it; every other routine (``Gradient_norm``
    included) steps as an x0 model, Family B toward ``x_end`` or, when it
    is None, the endpoint ``op.x_end_from_xt`` estimates, Family A by
    ``degrade_sampling`` under 'default' and by Algorithm 2 otherwise.
    Upstream's own loop keeps the raw prediction at every level (a
    tuple-order bug); the JAX package composes the step as intended, and so
    does this port.  ``recon_noise_std`` is ignored and nothing is drawn.
    Runs under ``torch.inference_mode()``.
    """
    op = diffusion.op
    b = img.shape[0]
    level = torch.as_tensor(t_start, device=img.device).long().broadcast_to((b,))
    t_end = torch.as_tensor(t_end, device=img.device).long().broadcast_to((b,))
    # sample i is active for t_start[i] - t_end[i] iterations
    iters = min(diffusion.num_timesteps, max(0, int((level - t_end).max())))
    with torch.inference_mode():
        cur = img
        for _ in range(iters):
            active = level > t_end
            x0_hat = denoise_fn(cur, torch.clamp(level - 1, min=0))
            n_t = torch.clamp(level, min=1)
            if diffusion.train_routine == "Step":
                new = x0_hat
            elif diffusion.train_routine == "Step_Gradient":
                new = cur + x0_hat
            elif op.requires_x_end:
                x2 = x_end if x_end is not None else op.x_end_from_xt(x0_hat, cur, n_t)
                new = (cur - op.degrade(x0_hat, n_t, x_end=x2, og=x0_hat)
                       + op.degrade(x0_hat, n_t - 1, x_end=x2, og=x0_hat))
            elif diffusion.sampling_routine == "default":
                new = op.degrade_sampling(x0_hat, n_t - 1, og=x0_hat)
            else:
                new = (cur - op.degrade(x0_hat, n_t, og=x0_hat)
                       + op.degrade(x0_hat, n_t - 1, og=x0_hat))
            cur = torch.where(active.reshape(-1, *([1] * (cur.dim() - 1))), new, cur)
            level = torch.where(active, level - 1, level)
    return cur
