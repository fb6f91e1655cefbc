"""The port's samplers on the decolor, fade, resolution and fade-generation
operators, the Family-B branch and ``all_sample`` == colddiff's, on the same
weights, images, endpoints and draws.

A dim-8 UNet at (1, 2) in fp32, 16 px, T <= 8, B = 2.  As in
``tests/test_torch_sampling.py``, one fp32 UNet call differs by up to ~1e-5
between the frameworks (their summation orders), and the sampler compounds
it over the steps: Algorithm 2 ('x0_step_down', and every Family-B routine,
which are Algorithm 2 toward an endpoint) is held at 1e-4, Algorithm 1
('default') at 5e-4.  Lab-space decolor carries values up to 100 through the
UNet and is held at 1e-4 relative to them (atol 1e-2).  Family-B draws are
replayed: the endpoint x_end comes from the JAX ``sample_x_end``, and the
per-step endpoints of 'x0_step_down_spiral_2_rand' are JAX's own, fed to the
port's operator in the same order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colddiff.diffusion import ColdDiffusion as JColdDiffusion
from colddiff.models import UnetConvNext as JUnetConvNext
from colddiff.operators import get_operator as jget_operator
from colddiff.ops import image as jimage
from colddiff.sampling import all_sample as jall_sample
from colddiff.sampling import prepare_start as jprepare_start
from colddiff.sampling import sample as jsample
from colddiff_torch.diffusion import ColdDiffusion
from colddiff_torch.models import UnetConvNext
from colddiff_torch.models.convert import convnext_state_dict_from_flax
from colddiff_torch.operators import get_operator
from colddiff_torch.sampling import all_sample, prepare_start, sample
from tests.test_torch_unet_convnext import flax_convnext_params

DIM, MULTS, S, B = 8, (1, 2), 16, 2
BLUR = dict(image_size=S, timesteps=8, blur_routine="Exponential_reflect",
            kernel_size=15, kernel_std=0.01)
OPS = {
    "decolor": dict(timesteps=6, decolor_routine="Linear", decolor_total_remove=True),
    "decolor_lab": dict(timesteps=6, decolor_routine="Linear", decolor_total_remove=True,
                        to_lab=True),
    "fade": dict(image_size=S, timesteps=8, fade_routine="Incremental", kernel_std=0.2,
                 initial_mask=3),
    "fade_random": dict(image_size=S, timesteps=6, fade_routine="Random_Incremental",
                        kernel_std=0.1, initial_mask=1),
    "resolution": dict(image_size=S, timesteps=3, resolution_routine="Incremental_factor_2"),
    "fade_generation": dict(image_size=S, timesteps=8, kernel_std=0.3, initial_mask=2),
    "fade_generation_reverse": dict(image_size=S, timesteps=8, kernel_std=0.3,
                                    initial_mask=2, reverse=True),
}


@pytest.fixture(scope="module")
def models():
    params = flax_convnext_params(DIM, MULTS, seed=5)
    jmodel = JUnetConvNext(dim=DIM, dim_mults=MULTS)
    model = UnetConvNext(dim=DIM, dim_mults=MULTS)
    model.load_state_dict(convnext_state_dict_from_flax(params), strict=True)
    model.eval()

    def jdenoise(xt, t):
        return jmodel.apply(params, xt, t).astype(jnp.float32)

    def denoise(xt, t):
        return model(xt, t).float()

    return jdenoise, denoise


def _ops(key):
    name = key.replace("_lab", "").replace("_random", "").replace("_reverse", "")
    return jget_operator(name, **OPS[key]), get_operator(name, **OPS[key], device="cpu")


def _images(seed, lab=False):
    x = np.random.default_rng(seed).uniform(-1.0, 1.0, (B, S, S, 3)).astype(np.float32)
    return np.array(jimage.rgb2lab(jnp.asarray(x))) if lab else x


def _compare(res, want, atol):
    got = [res.xt, res.direct_recons, res.img]
    for name, g, w in zip(("xt", "direct_recons", "img"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol, err_msg=name)


@pytest.mark.parametrize("key,routine", [
    ("decolor", "x0_step_down"), ("decolor", "default"), ("decolor_lab", "x0_step_down"),
    ("fade", "x0_step_down"), ("fade", "default"), ("fade_random", "x0_step_down"),
    ("fade_random", "default"), ("resolution", "x0_step_down"), ("resolution", "default"),
])
def test_family_a_sample_matches_jax(models, key, routine):
    """Random_Incremental fade samples with offsets baked once for the run
    (JAX ``randomize``), which the port's operator is given."""
    jdenoise, denoise = models
    jop, op = _ops(key)
    if key == "fade_random":
        jop = jop.randomize(jax.random.key(4), B)
        op.offsets = torch.from_numpy(np.array(jop.offsets)).long()
    jd = JColdDiffusion(op=jop, image_size=S, sampling_routine=routine)
    d = ColdDiffusion(op=op, image_size=S, sampling_routine=routine)
    x = _images(1, lab=key.endswith("_lab"))

    @jax.jit
    def run(img):
        res = jsample(jd, jdenoise, jprepare_start(jd, img))
        return res.xt, res.direct_recons, res.img

    want = run(jnp.asarray(x))
    res = sample(d, denoise, prepare_start(d, torch.from_numpy(x)))
    atol = 1e-2 if key.endswith("_lab") else 1e-4 if routine == "x0_step_down" else 5e-4
    _compare(res, want, atol)


@pytest.mark.parametrize("key,routine,fixed", [
    ("fade_generation", "x0_step_down", True), ("fade_generation", "x0_step_down", False),
    ("fade_generation", "ddim", True), ("fade_generation", "default", True),
    ("fade_generation", "x0_step_down_spiral_2_fix", True),
    ("fade_generation", "x0_step_down_spiral_2_rand", True),
    ("fade_generation_reverse", "x0_step_down", True), ("fade_generation_reverse", "ddim", True),
])
def test_family_b_sample_matches_jax(models, key, routine, fixed):
    """The Family-B branch of the reverse step: a fixed x_end (given to
    ``sample``), estimated from x_t ('ddim', or no x_end given), or redrawn
    every step ('x0_step_down_spiral_2_rand', JAX's draws replayed)."""
    jdenoise, denoise = models
    jop, op = _ops(key)
    jd = JColdDiffusion(op=jop, image_size=S, sampling_routine=routine)
    d = ColdDiffusion(op=op, image_size=S, sampling_routine=routine)
    x = _images(2)
    rng = jax.random.key(9)
    x_end = jop.sample_x_end(jax.random.key(8), jnp.asarray(x))

    @jax.jit
    def run(img, x_end):
        start = jprepare_start(jd, img, x_end=x_end)
        res = jsample(jd, jdenoise, start, x_end=x_end if fixed else None, rng=rng)
        return res.xt, res.direct_recons, res.img

    want = run(jnp.asarray(x), x_end)
    gen = None
    if routine == "x0_step_down_spiral_2_rand":
        # sampling.py:170-172: step k draws from split(fold_in(rng, 2), T)[k]
        keys = jax.random.split(jax.random.fold_in(rng, 2), op.timesteps)
        draws = iter([torch.from_numpy(np.array(jop.sample_x_end(k, jnp.asarray(x))))
                      for k in keys])
        op.sample_x_end = lambda generator, like: next(draws)
        gen = torch.Generator()
    x_end_t = torch.from_numpy(np.array(x_end))
    res = sample(d, denoise, prepare_start(d, torch.from_numpy(x), x_end=x_end_t),
                 x_end=x_end_t if fixed else None, generator=gen)
    _compare(res, want, 1e-4)


@pytest.mark.parametrize("stride,refresh", [(1, 1), (2, 1), (1, 2), (2, 2)])
def test_all_sample_matches_jax(models, stride, refresh):
    """Trajectories of the flagship blur path: frame j is (x0_hat, the state
    before the step) of step j * stride."""
    jdenoise, denoise = models
    jd = JColdDiffusion(op=jget_operator("blur", **BLUR), image_size=S,
                        sampling_routine="x0_step_down")
    d = ColdDiffusion(op=get_operator("blur", **BLUR, device="cpu"), image_size=S,
                      sampling_routine="x0_step_down")
    x = _images(3)

    @jax.jit
    def run(img):
        res = jall_sample(jd, jdenoise, jprepare_start(jd, img), traj_stride=stride,
                          refresh_every=refresh)
        return res.xt, res.direct_recons, res.img, res.x0_trajectory, res.xt_trajectory

    want = run(jnp.asarray(x))
    res = all_sample(d, denoise, prepare_start(d, torch.from_numpy(x)), traj_stride=stride,
                     refresh_every=refresh)
    _compare(res, want[:3], 1e-4)
    frames = BLUR["timesteps"] // stride
    assert res.x0_trajectory.shape == res.xt_trajectory.shape == (frames, B, S, S, 3)
    np.testing.assert_allclose(res.x0_trajectory.numpy(), np.asarray(want[3]), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(res.xt_trajectory.numpy(), np.asarray(want[4]), rtol=0,
                               atol=1e-4)
    assert torch.equal(res.x0_trajectory[0], res.direct_recons)
    assert torch.equal(res.xt_trajectory[0], res.xt)


def test_strided_frames_are_frames_of_the_full_run():
    """Frame j of a stride-k run is frame j*k of the stride-1 run, bitwise;
    the last state frame, sampled on for the remaining k steps, gives the
    final image; a stride that does not divide the steps raises."""
    d = ColdDiffusion(op=get_operator("blur", **BLUR, device="cpu"), image_size=S,
                      sampling_routine="x0_step_down")
    start = prepare_start(d, torch.from_numpy(_images(4)))

    def denoise(xt, t):
        return torch.tanh(xt * 1.3) + 0.01 * t.reshape(-1, 1, 1, 1)

    full = all_sample(d, denoise, start)
    for k in (2, 4, 8):
        res = all_sample(d, denoise, start, traj_stride=k)
        assert torch.equal(res.x0_trajectory, full.x0_trajectory[::k])
        assert torch.equal(res.xt_trajectory, full.xt_trajectory[::k])
        assert torch.equal(res.img, full.img)
        tail = sample(d, denoise, res.xt_trajectory[-1], t=k)
        assert torch.equal(tail.img, full.img)
    plain = sample(d, denoise, start)
    assert plain.x0_trajectory is None and torch.equal(plain.img, full.img)
    with pytest.raises(ValueError, match="traj_stride=3 must divide steps=8"):
        all_sample(d, denoise, start, traj_stride=3)


def test_family_b_routines_and_their_limits():
    op = get_operator("fade_generation", **OPS["fade_generation"], device="cpu")
    x = torch.zeros(1, S, S, 3)
    ident = lambda xt, t: xt  # noqa: E731
    with pytest.raises(ValueError, match="Generator"):
        sample(ColdDiffusion(op=op, image_size=S,
                             sampling_routine="x0_step_down_spiral_2_rand"), ident, x)
    with pytest.raises(NotImplementedError, match="not one of"):
        sample(ColdDiffusion(op=op, image_size=S, sampling_routine="spiral"), ident, x)
    # the oracle: with a perfect x0 and the true endpoint, Algorithm 2 telescopes
    clean = torch.from_numpy(_images(6))
    x_end = op.sample_x_end(torch.Generator().manual_seed(1), clean)
    for routine, fixed in (("x0_step_down", True), ("ddim", True), ("x0_step_down", False)):
        d = ColdDiffusion(op=op, image_size=S, sampling_routine=routine)
        res = sample(d, lambda xt, t: clean, prepare_start(d, clean, x_end=x_end),
                     x_end=x_end if fixed else None)
        torch.testing.assert_close(res.img, clean, rtol=0, atol=1e-5)
