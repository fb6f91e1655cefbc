"""The port's samplers on the noise, mix, snow and fade_naive operators ==
colddiff's, on the same weights, images, endpoints and draws.

The set-up and tolerances of ``tests/test_torch_sampling_ops.py`` (a dim-8
UNet at (1, 2) in fp32, 16 px, T = 8, B = 2): Algorithm 2 and every
Family-B routine at 1e-4, Algorithm 1 ('default') at 5e-4, since one fp32
UNet call differs by ~1e-5 between the frameworks and the sampler compounds
it.  Draws are replayed: endpoints from the JAX ``sample_x_end`` (noise,
Spiral_2) or a second numpy image set (mix); the per-step endpoints of
'x0_step_down_spiral_2_rand' and the per-step ``recon_noise_std`` noise of
snow's x0_step_down are JAX's own, fed to the port in the same order.  With
that noise the degrade's input (the noisy reconstruction) differs from its
``og`` (the clean one), which snow's blend reads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colddiff.diffusion import ColdDiffusion as JColdDiffusion
from colddiff.operators import get_operator as jget_operator
from colddiff.sampling import all_sample as jall_sample
from colddiff.sampling import prepare_start as jprepare_start
from colddiff.sampling import sample as jsample
from colddiff_torch import sampling
from colddiff_torch.diffusion import ColdDiffusion
from colddiff_torch.operators import get_operator
from colddiff_torch.sampling import all_sample, prepare_start, sample
from tests.test_torch_sampling_ops import B, S, _compare, _images, models  # noqa: F401

T = 8
OPS = {
    "noise": dict(timesteps=T),
    "mix": dict(timesteps=T),
    "snow": dict(image_size=S, timesteps=T, snow_level=4),
    "snow_single": dict(image_size=S, timesteps=T, snow_level=2, single_snow=True,
                        batch_size=B),
    "snow_fixed": dict(image_size=S, timesteps=T, snow_level=4, fix_brightness=True),
    "spiral_2": dict(image_size=S, timesteps=T, fade_routine="Spiral_2"),
    "incremental": dict(image_size=S, timesteps=T, fade_routine="Incremental",
                        start_fade_factor=0.1),
}
NAMES = {"snow_single": "snow", "snow_fixed": "snow", "spiral_2": "fade_naive",
         "incremental": "fade_naive"}


def _ops(key):
    name = NAMES.get(key, key)
    return jget_operator(name, **OPS[key]), get_operator(name, **OPS[key], device="cpu")


def _endpoint(key, jop, x):
    """The fixed endpoint: a JAX draw, or (mix) a second image set."""
    if key == "mix":
        return jnp.asarray(_images(20))
    return jop.sample_x_end(jax.random.key(8), jnp.asarray(x))


@pytest.mark.parametrize("key,routine,fixed", [
    ("noise", "ddim", True), ("noise", "x0_step_down", True), ("noise", "x0_step_down", False),
    ("noise", "default", True), ("mix", "x0_step_down", True), ("mix", "ddim", True),
    ("spiral_2", "x0_step_down_spiral_2_fix", True),
    ("spiral_2", "x0_step_down_spiral_2_rand", True), ("spiral_2", "x0_step_down", True),
])
def test_family_b_sample_matches_jax(models, key, routine, fixed):
    jdenoise, denoise = models
    jop, op = _ops(key)
    jd = JColdDiffusion(op=jop, image_size=S, sampling_routine=routine)
    d = ColdDiffusion(op=op, image_size=S, sampling_routine=routine)
    x = _images(2)
    rng = jax.random.key(9)
    x_end = _endpoint(key, jop, x)

    @jax.jit
    def run(img, x_end):
        start = jprepare_start(jd, img, x_end=x_end)
        res = jsample(jd, jdenoise, start, x_end=x_end if fixed else None, rng=rng)
        return res.xt, res.direct_recons, res.img

    want = run(jnp.asarray(x), x_end)
    gen = None
    if routine == "x0_step_down_spiral_2_rand":
        # colddiff/sampling.py: step k draws from split(fold_in(rng, 2), T)[k]
        keys = jax.random.split(jax.random.fold_in(rng, 2), T)
        draws = iter([torch.from_numpy(np.array(jop.sample_x_end(k, jnp.asarray(x))))
                      for k in keys])
        op.sample_x_end = lambda generator, like: next(draws)
        gen = torch.Generator()
    x_end_t = torch.from_numpy(np.array(x_end))
    res = sample(d, denoise, prepare_start(d, torch.from_numpy(x), x_end=x_end_t),
                 x_end=x_end_t if fixed else None, generator=gen)
    _compare(res, want, 1e-4)


@pytest.mark.parametrize("key,routine,noise_std", [
    ("snow", "x0_step_down", 0.0), ("snow", "default", 0.0), ("snow", "x0_step_down", 0.05),
    ("snow_single", "x0_step_down", 0.0), ("snow_fixed", "x0_step_down", 0.05),
    ("incremental", "x0_step_down", 0.0), ("incremental", "default", 0.0),
])
def test_family_a_sample_matches_jax(models, monkeypatch, key, routine, noise_std):
    """Snow (fixed fields) and the scalar naive fade; with recon_noise_std the
    JAX step's noise is replayed, so snow degrades the noisy reconstruction
    while blending from the clean one (og != x)."""
    jdenoise, denoise = models
    jop, op = _ops(key)
    jd = JColdDiffusion(op=jop, image_size=S, sampling_routine=routine,
                        recon_noise_std=noise_std)
    d = ColdDiffusion(op=op, image_size=S, sampling_routine=routine, recon_noise_std=noise_std)
    x = _images(3)
    rng = jax.random.key(10)

    @jax.jit
    def run(img):
        res = jsample(jd, jdenoise, jprepare_start(jd, img), rng=rng)
        return res.xt, res.direct_recons, res.img

    want = run(jnp.asarray(x))
    gen = None
    if noise_std > 0:
        keys = jax.random.split(jax.random.fold_in(rng, 2), T)
        draws = iter([torch.from_numpy(np.array(jax.random.normal(k, x.shape))) for k in keys])
        ogs = []
        degrade = op.degrade

        def spy(x_in, n, **kw):
            ogs.append((x_in, kw.get("og")))
            return degrade(x_in, n, **kw)

        op.degrade = spy
        monkeypatch.setattr(sampling.torch, "randn", lambda *a, **kw: next(draws))
        gen = torch.Generator()
    res = sample(d, denoise, prepare_start(d, torch.from_numpy(x)), generator=gen)
    atol = 1e-4 if routine == "x0_step_down" else 5e-4
    _compare(res, want, atol)
    if noise_std > 0:
        # prepare_start's degrade, then two a step, each of the noisy base
        assert len(ogs) == 1 + 2 * T and all(o is not None and not torch.equal(o, xi)
                                             for xi, o in ogs[1:])


def test_noise_all_sample_matches_jax(models):
    """Trajectories of hot-noise generation (stride 2): the Family-B path
    through ``all_sample``."""
    jdenoise, denoise = models
    jop, op = _ops("noise")
    jd = JColdDiffusion(op=jop, image_size=S, sampling_routine="ddim")
    d = ColdDiffusion(op=op, image_size=S, sampling_routine="ddim")
    x = _images(4)
    x_end = _endpoint("noise", jop, x)

    @jax.jit
    def run(img, x_end):
        res = jall_sample(jd, jdenoise, jprepare_start(jd, img, x_end=x_end), x_end=x_end,
                          traj_stride=2)
        return res.xt, res.direct_recons, res.img, res.x0_trajectory, res.xt_trajectory

    want = run(jnp.asarray(x), x_end)
    x_end_t = torch.from_numpy(np.array(x_end))
    res = all_sample(d, denoise, prepare_start(d, torch.from_numpy(x), x_end=x_end_t),
                     x_end=x_end_t, traj_stride=2)
    _compare(res, want[:3], 1e-4)
    for got, w in zip((res.x0_trajectory, res.xt_trajectory), want[3:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0, atol=1e-4)


@pytest.mark.parametrize("key,routine", [("noise", "x0_step_down"), ("noise", "ddim"),
                                         ("mix", "x0_step_down"), ("snow", "x0_step_down"),
                                         ("spiral_2", "x0_step_down_spiral_2_fix")])
def test_oracle_sampler_gives_back_the_clean_batch(key, routine):
    """With a perfect denoiser and the true endpoint, Algorithm 2 telescopes."""
    _, op = _ops(key)
    d = ColdDiffusion(op=op, image_size=S, sampling_routine=routine)
    clean = torch.from_numpy(_images(5))
    x_end = (torch.from_numpy(_images(6)) if key == "mix"
             else op.sample_x_end(torch.Generator().manual_seed(1), clean))
    res = sample(d, lambda xt, t: clean, prepare_start(d, clean, x_end=x_end), x_end=x_end)
    torch.testing.assert_close(res.img, clean, rtol=0, atol=1e-5)
