"""colddiff_torch blur degradation == colddiff's (JAX), on the same inputs.

The port's numpy builders are copies of the JAX package's and must agree
exactly.  Degrade results agree to fp32 rounding: both sides run two fp32
matmuls per call, summed in different orders (atol 1e-5 on [-1, 1] images).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colddiff import schedules as jschedules
from colddiff.diffusion import ColdDiffusion as JColdDiffusion
from colddiff.operators.blur import GaussianBlur as JGaussianBlur
from colddiff.ops import linop as jlinop
from colddiff_torch import schedules
from colddiff_torch.diffusion import ColdDiffusion
from colddiff_torch.operators import GaussianBlur, get_operator
from colddiff_torch.ops import linop

BENCH = dict(image_size=128, timesteps=200, blur_routine="Exponential_reflect",
             kernel_size=15, kernel_std=0.01)
ROUTINES = ["Incremental", "Constant", "Constant_reflect", "Exponential",
            "Exponential_reflect", "Individual_Incremental", "Special_6_routine",
            "Linear_Accum_Std", "Linear_Dec_Std"]


@pytest.fixture(scope="module")
def bench_ops():
    return JGaussianBlur.create(**BENCH), get_operator("blur", **BENCH, device="cpu")


def _images(rng, b, size):
    return rng.uniform(-1.0, 1.0, (b, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("routine", ROUTINES)
def test_blur_routine_params_copy_is_exact(routine):
    args = (routine, 12, 5, 0.3, 0.02, 1.5)
    assert schedules.blur_routine_params(*args) == jschedules.blur_routine_params(*args)


def test_gaussian_kernels_copy_is_exact():
    for size, sigma in [(3, 0.1), (15, 0.01), (15, 7.3), (11, 2.0), (4, 1.0)]:
        np.testing.assert_array_equal(schedules.gaussian_kernel_1d(size, sigma),
                                      jschedules.gaussian_kernel_1d(size, sigma))
        np.testing.assert_array_equal(
            schedules.gaussian_kernel_2d((size, size + 2), (sigma, 2 * sigma)),
            jschedules.gaussian_kernel_2d((size, size + 2), (sigma, 2 * sigma)))


@pytest.mark.parametrize("mode", ["circular", "reflect", "replicate", "zeros"])
def test_linop_builders_copy_is_exact(mode):
    for idx in range(-20, 30):
        assert linop._pad_index(idx, 9, mode) == jlinop._pad_index(idx, 9, mode)
    mats = []
    for ks, sigma in [(3, 0.5), (7, 2.0), (15, 5.0)]:
        k = schedules.gaussian_kernel_1d(ks, sigma)
        m = linop.conv1d_matrix(k, 16, mode)
        np.testing.assert_array_equal(m, jlinop.conv1d_matrix(k, 16, mode))
        mats.append(m)
    np.testing.assert_array_equal(linop.cumulative_matrices(mats),
                                  jlinop.cumulative_matrices(mats))


def test_bench_operator_tables_equal(bench_ops):
    jop, op = bench_ops
    assert op.cum.dtype == torch.float32 and op.cum.shape == (201, 128, 128)
    np.testing.assert_array_equal(op.cum.numpy(), np.asarray(jop.cum))
    np.testing.assert_array_equal(op.steps.numpy(), np.asarray(jop.steps))


@pytest.mark.parametrize("levels", [[0, 1], [2, 57], [100, 199], [200, 150]])
def test_degrade_matches_jax_at_bench_config(rng, bench_ops, levels):
    jop, op = bench_ops
    x = _images(rng, 2, 128)
    n = np.asarray(levels, np.int32)
    want = np.asarray(jop.degrade(jnp.asarray(x), jnp.asarray(n)))
    got = op.degrade(torch.from_numpy(x), torch.from_numpy(n))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    want_s = np.asarray(jop.degrade_sampling(jnp.asarray(x), jnp.asarray(n)))
    got_s = op.degrade_sampling(torch.from_numpy(x), torch.from_numpy(n))
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=0, atol=1e-5)


def test_degrade_zero_steps_is_identity(rng, bench_ops):
    _, op = bench_ops
    x = torch.from_numpy(_images(rng, 2, 128))
    y = op.degrade(x, torch.zeros(2, dtype=torch.long))
    assert torch.equal(y, x)


@pytest.mark.parametrize("routine", ["Individual_Incremental", "Incremental"])
@pytest.mark.parametrize("discrete", [False, True])
def test_small_routines_and_discrete_collapse_match_jax(rng, routine, discrete):
    cfg = dict(image_size=16, timesteps=6, blur_routine=routine, kernel_size=5,
               kernel_std=0.7, discrete=discrete)
    jop, op = JGaussianBlur.create(**cfg), GaussianBlur.create(**cfg, device="cpu")
    x = _images(rng, 3, 16)
    n = np.asarray([0, 3, 6], np.int32)
    for name in ("degrade", "degrade_sampling"):
        want = np.asarray(getattr(jop, name)(jnp.asarray(x), jnp.asarray(n)))
        got = getattr(op, name)(torch.from_numpy(x), torch.from_numpy(n))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    for n0, n1 in [(0, 4), (2, 5), (3, 6), (4, 4)]:
        want = np.asarray(jop.degrade_range(jnp.asarray(x), n0, n1))
        got = op.degrade_range(torch.from_numpy(x), n0, n1)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    if discrete:  # the final level is the per-image channel mean
        got = op.degrade(torch.from_numpy(x), torch.full((3,), 6)).numpy()
        np.testing.assert_allclose(got, np.broadcast_to(
            got.mean(axis=(1, 2), keepdims=True), got.shape), atol=1e-6)


@pytest.mark.parametrize("discrete", [False, True])
def test_q_sample_matches_jax(rng, discrete):
    cfg = dict(image_size=16, timesteps=6, blur_routine="Incremental",
               kernel_size=5, kernel_std=0.7)
    jd = JColdDiffusion(op=JGaussianBlur.create(**cfg), image_size=16,
                        discrete=discrete)
    d = ColdDiffusion(op=GaussianBlur.create(**cfg, device="cpu"), image_size=16,
                      discrete=discrete)
    x = _images(rng, 4, 16)
    t = np.asarray([-1, 0, 2, 5], np.int32)
    want = np.asarray(jd.q_sample(jnp.asarray(x), jnp.asarray(t)))
    got = d.q_sample(torch.from_numpy(x), torch.from_numpy(t).long())
    # quantization can flip one 8-bit level where fp32 rounding straddles it
    atol = 2.0 / 255 + 1e-6 if discrete else 1e-5
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    np.testing.assert_array_equal(got[0].numpy(), x[0])  # t = -1 is clean


def test_get_operator_names():
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        get_operator("snow", image_size=16, timesteps=4)
    with pytest.raises(ValueError):
        get_operator("no_such_op")


def test_operator_tables_default_to_the_card():
    """Without ``device`` the tables go to the card; with no CUDA device the
    call raises rather than build them on the CPU unasked."""
    cfg = dict(image_size=8, timesteps=3, kernel_size=3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_operator("blur", **cfg)
        return
    op = get_operator("blur", **cfg)
    assert op.cum.is_cuda and op.steps.is_cuda


def test_operator_to_device_copies_tables():
    op = GaussianBlur.create(image_size=8, timesteps=3, kernel_size=3, device="cpu")
    moved = op.to("cpu")
    assert moved.cum.device.type == "cpu" and moved.timesteps == 3
    assert torch.equal(moved.cum, op.cum) and torch.equal(moved.steps, op.steps)
