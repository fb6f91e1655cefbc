"""colddiff_torch's decolor, fade, resolution and fade-generation operators
== colddiff's (JAX), on the same inputs, and the copied table functions ==
the originals.

Inputs are numpy-seeded 16 px batches with T <= 8.  Tolerances:
  - the numpy table functions (schedules, resize matrices, fade masks) and the
    operators' tables: exact, both sides run the same float64 code;
  - the resize matrices against torch's own ``F.interpolate`` on the CPU:
    1e-6 (float32 interpolation against a float64 matrix product);
  - degrades that are elementwise products (fade, fade generation): 1e-6,
    one or two fp32 roundings of O(1) values; the fade crops are exact
    gathers of the same fp32 tables, so they are held bitwise;
  - degrades through fp32 matmuls (decolor, resolution): 1e-5, the two
    sides sum in other orders (as tests/test_torch_blur.py);
  - Lab: torch's and XLA's fp32 ``pow`` differ by an ulp on some inputs
    (ROADMAP.md section 3), and Lab values reach 100, so Lab is held at
    1e-4 and RGB round trips at 1e-5;
  - ``x_end_from_xt`` divides by 1 - a: held at levels where 1 - a >= 1e-2
    to 1e-6 / (1 - a) per pixel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from colddiff import schedules as jschedules
from colddiff.operators.decolor import Decolorization as JDecolorization
from colddiff.operators.fade import Fade as JFade
from colddiff.operators.fade import fade_mask as jfade_mask
from colddiff.operators.fade_generation import FadeGeneration as JFadeGeneration
from colddiff.operators.resolution import Resolution as JResolution
from colddiff.ops import image as jimage
from colddiff.ops import linop as jlinop
from colddiff_torch import schedules
from colddiff_torch.operators import (Decolorization, Fade, FadeGeneration, Resolution,
                                      get_operator)
from colddiff_torch.operators.fade import fade_mask
from colddiff_torch.ops import image, linop

S, T, B = 16, 8, 4


def _images(seed, b=B, size=S, c=3):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (b, size, size, c)).astype(np.float32)


def _levels(seed, b=B, t=T):
    lv = np.random.default_rng(seed).integers(0, t + 1, b).astype(np.int32)
    lv[0], lv[-1] = 0, t  # the identity level and the last one
    return lv


def _port(name, device="cpu", **cfg):
    return get_operator(name, **cfg, device=device)


def _check_degrades(jop, op, x, n, atol, **kw):
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: torch.from_numpy(np.asarray(v)) for k, v in kw.items()}
    xj, nj = jnp.asarray(x), jnp.asarray(n)
    xt, nt = torch.from_numpy(x), torch.from_numpy(n).long()
    pairs = [(jop.degrade(xj, nj, **jkw), op.degrade(xt, nt, **tkw)),
             (jop.degrade_sampling(xj, nj, **jkw), op.degrade_sampling(xt, nt, **tkw)),
             (jop.total(xj, **jkw), op.total(xt, **tkw))]
    for name, (want, got) in zip(("degrade", "degrade_sampling", "total"), pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol,
                                   err_msg=name)
    # level 0 is the identity
    np.testing.assert_array_equal(pairs[0][1][0].numpy(), x[0])


# ---------------------------------------------------------------------- #
# copied table functions


@pytest.mark.parametrize("routine,total_remove", [("Constant", False), ("Constant", True),
                                                  ("Linear", False), ("Linear", True)])
def test_decolor_thetas_copy_is_exact(routine, total_remove):
    args = (routine, 7, 0.85, total_remove)
    assert schedules.decolor_routine_thetas(*args) == jschedules.decolor_routine_thetas(*args)


@pytest.mark.parametrize("routine", ["Incremental", "Random_Incremental", "Constant"])
def test_fade_sigmas_copy_is_exact(routine):
    args = (routine, 9, 0.15, 11)
    assert schedules.fade_routine_sigmas(*args) == jschedules.fade_routine_sigmas(*args)


@pytest.mark.parametrize("routine", ["Incremental", "Incremental_bilinear", "Incremental_area",
                                     "Incremental_bicubic", "Incremental_factor_2",
                                     "Incremental_with_blur", "Incremental_factor_2_with_blur"])
def test_resolution_sizes_copy_is_exact(routine):
    args = (routine, 4, 32)
    assert (schedules.resolution_routine_sizes(*args)
            == jschedules.resolution_routine_sizes(*args))


def test_unknown_routines_raise():
    for fn, args in [(schedules.decolor_routine_thetas, ("Cubic", 3)),
                     (schedules.fade_routine_sigmas, ("Cubic", 3, 0.1, 11)),
                     (schedules.resolution_routine_sizes, ("Cubic", 3, 16))]:
        with pytest.raises(ValueError):
            fn(*args)


@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "nearest", "nearest-exact", "area"])
def test_resize_matrix_copies_are_exact(mode):
    xs = np.linspace(-2.5, 2.5, 41)
    np.testing.assert_array_equal(linop._cubic_weight(xs), jlinop._cubic_weight(xs))
    for n_in, n_out in [(16, 8), (16, 5), (16, 16), (7, 16), (32, 1)]:
        np.testing.assert_array_equal(linop.resize1d_matrix(n_in, n_out, mode),
                                      jlinop.resize1d_matrix(n_in, n_out, mode))
    for target in (16, 13, 8, 2):
        np.testing.assert_array_equal(linop.resize_step_matrix(16, target, mode),
                                      jlinop.resize_step_matrix(16, target, mode))


@pytest.mark.parametrize("mode", ["bilinear", "bicubic", "nearest-exact", "area"])
def test_resize_matrices_match_torch_interpolate(mode):
    """The copies against torch's own F.interpolate (align_corners=False, no
    antialias), down and back up as a resolution step does."""
    x = torch.from_numpy(_images(1, 2, 16)).permute(0, 3, 1, 2).double()
    kw = {} if mode in ("nearest-exact", "area") else {"align_corners": False}
    for target in (15, 8, 5, 2):
        down = F.interpolate(x, size=(target, target), mode=mode, **kw)
        m = torch.from_numpy(linop.resize1d_matrix(16, target, mode))
        torch.testing.assert_close(m @ x @ m.T, down, rtol=0, atol=1e-6)
        up = F.interpolate(down, size=(16, 16), mode="nearest-exact")
        step = torch.from_numpy(linop.resize_step_matrix(16, target, mode))
        torch.testing.assert_close(step @ x @ step.T, up, rtol=0, atol=1e-6)


def test_fade_mask_copy_is_exact():
    for size, sigma in [(16, 0.1), (32, 1.5), (8, 7.0)]:
        np.testing.assert_array_equal(fade_mask(size, sigma), jfade_mask(size, sigma))


def test_lab_conversions_match_jax():
    x = _images(2, 2, 8)
    x[0, 0, 0] = [-1.0, -1.0, -1.0]  # black: the linear branches
    x[0, 0, 1] = [1.0, 1.0, 1.0]
    lab = image.rgb2lab(torch.from_numpy(x))
    np.testing.assert_allclose(lab.numpy(), np.asarray(jimage.rgb2lab(jnp.asarray(x))),
                               rtol=0, atol=1e-4)
    back = image.lab2rgb(lab)
    np.testing.assert_allclose(back.numpy(),
                               np.asarray(jimage.lab2rgb(jnp.asarray(lab.numpy()))),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=1e-5)
    # out-of-gamut Lab clips in both
    wild = np.asarray([[[[50.0, 120.0, -120.0], [90.0, -100.0, 100.0]]]], np.float32)
    np.testing.assert_allclose(image.lab2rgb(torch.from_numpy(wild)).numpy(),
                               np.asarray(jimage.lab2rgb(jnp.asarray(wild))),
                               rtol=0, atol=1e-5)


# ---------------------------------------------------------------------- #
# the operators


@pytest.mark.parametrize("routine,total_remove,to_lab", [
    ("Constant", False, False), ("Linear", True, False), ("Linear", True, True),
    ("Constant", True, True)])
def test_decolor_matches_jax(routine, total_remove, to_lab):
    cfg = dict(timesteps=T, decolor_routine=routine, decolor_ema_factor=0.8,
               decolor_total_remove=total_remove, to_lab=to_lab)
    jop, op = JDecolorization.create(**cfg), _port("decolor", **cfg)
    np.testing.assert_array_equal(op.cum.numpy(), np.asarray(jop.cum))
    x = _images(3)
    if to_lab:
        x = np.array(jimage.rgb2lab(jnp.asarray(x)))
    _check_degrades(jop, op, x, _levels(4), atol=1e-4 if to_lab else 1e-5)


@pytest.mark.parametrize("routine", ["Incremental", "Constant"])
def test_fade_matches_jax(routine):
    cfg = dict(image_size=S, timesteps=T, fade_routine=routine, kernel_std=0.2,
               initial_mask=3)
    jop, op = JFade.create(**cfg), _port("fade", **cfg)
    np.testing.assert_array_equal(op.cum_masks.numpy(), np.asarray(jop.cum_masks))
    assert op.sample_rng_state(torch.Generator(), B) is None
    assert op.reset(torch.Generator(), B) is op
    _check_degrades(jop, op, _images(5), _levels(6), atol=1e-6)


def test_random_fade_crops_match_jax():
    """Random_Incremental: the offsets JAX draws (``_draw_offsets``) given to
    the port as its drawn state crop the same windows, bitwise; baked
    offsets and the zeros default too."""
    cfg = dict(image_size=S, timesteps=T, fade_routine="Random_Incremental",
               kernel_std=0.1, initial_mask=1)
    jop, op = JFade.create(**cfg), _port("fade", **cfg)
    np.testing.assert_array_equal(op.cum_masks.numpy(), np.asarray(jop.cum_masks))
    assert op.cum_masks.shape == (T + 1, 2 * S, 2 * S)
    x, n = _images(7), _levels(8)
    xj, nj = jnp.asarray(x), jnp.asarray(n)
    xt, nt = torch.from_numpy(x), torch.from_numpy(n).long()
    key = jax.random.key(11)
    off = np.array(jop._draw_offsets(key, B))
    off[0], off[1] = [0, S], [S, 0]  # the extreme windows
    want = np.asarray(jax.vmap(lambda m, o: jax.lax.dynamic_slice(m, (o[0], o[1]), (S, S)))(
        jop.cum_masks[nj], jnp.asarray(off)))[..., None] * x
    got = op.degrade(xt, nt, rng=torch.from_numpy(off))
    np.testing.assert_array_equal(got.numpy(), want)
    # the JAX draw itself, and degrade given rng, agree
    got = op.degrade(xt, nt, rng=torch.from_numpy(np.array(jop._draw_offsets(key, B))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jop.degrade(xj, nj, rng=key)))
    # baked offsets (randomize / reset), then the zeros of a fresh operator
    jbaked = jop.randomize(jax.random.key(12), B)
    baked = op.to("cpu")
    baked.offsets = torch.from_numpy(np.array(jbaked.offsets)).long()
    np.testing.assert_array_equal(baked.degrade(xt, nt).numpy(),
                                  np.asarray(jbaked.degrade(xj, nj)))
    np.testing.assert_array_equal(op.degrade(xt, nt).numpy(), np.asarray(jop.degrade(xj, nj)))
    # offsets past S clamp to S, as lax.dynamic_slice's starts do (one call
    # per sample: under vmap the bounds are not checked); negative ones clamp
    # to 0 (dynamic_slice would count them from the end)
    wild = np.array([[0, S + 4], [2 * S, 1], [1, 2], [S, 3 * S]], np.int32)
    masks = np.stack([np.asarray(jax.lax.dynamic_slice(jop.cum_masks[n[i]], tuple(wild[i]),
                                                       (S, S))) for i in range(B)])
    np.testing.assert_array_equal(op.degrade(xt, nt, rng=torch.from_numpy(wild)).numpy(),
                                  masks[..., None] * x)
    neg = torch.tensor([[-3, 0], [0, -1], [-S, -S], [0, 0]])
    np.testing.assert_array_equal(op.degrade(xt, nt, rng=neg).numpy(),
                                  op.degrade(xt, nt, rng=torch.zeros(B, 2)).numpy())
    # the drawn state wins over baked offsets
    np.testing.assert_array_equal(
        baked.degrade(xt, nt, rng=torch.from_numpy(off)).numpy(),
        op.degrade(xt, nt, rng=torch.from_numpy(off)).numpy())


def test_random_fade_draws_cover_zero_to_s_inclusive():
    op = _port("fade", image_size=4, timesteps=2, fade_routine="Random_Incremental")
    gen = torch.Generator().manual_seed(0)
    draws = op.sample_rng_state(gen, 2000)
    assert draws.shape == (2000, 2) and draws.dtype == torch.long
    assert set(draws.flatten().tolist()) == set(range(5))
    reset = op.reset(gen, 3)
    assert reset is not op and reset.offsets.shape == (3, 2) and op.offsets is None
    assert torch.equal(reset.cum_masks, op.cum_masks)


@pytest.mark.parametrize("routine", ["Incremental", "Incremental_factor_2",
                                     "Incremental_bilinear_with_blur", "Incremental_area"])
def test_resolution_matches_jax(routine):
    t = 3 if "factor_2" in routine else T
    cfg = dict(image_size=S, timesteps=t, resolution_routine=routine)
    jop, op = JResolution.create(**cfg), _port("resolution", **cfg)
    np.testing.assert_array_equal(op.cum.numpy(), np.asarray(jop.cum))
    _check_degrades(jop, op, _images(9), _levels(10, t=t), atol=1e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_fade_generation_matches_jax(reverse):
    cfg = dict(image_size=S, timesteps=T, kernel_std=0.3, initial_mask=2, reverse=reverse)
    jop, op = JFadeGeneration.create(**cfg), _port("fade_generation", **cfg)
    assert op.requires_x_end and jop.requires_x_end
    np.testing.assert_array_equal(op.alphas.numpy(), np.asarray(jop.alphas))
    x = _images(13)
    x_end = np.asarray(jop.sample_x_end(jax.random.key(3), jnp.asarray(x)))
    _check_degrades(jop, op, x, _levels(14), atol=1e-6, x_end=x_end)
    with pytest.raises(ValueError, match="x_end"):
        op.degrade(torch.from_numpy(x), torch.ones(B, dtype=torch.long))
    # x_end_from_xt at every level where 1 - a >= 1e-2 somewhere
    x0_bar = _images(15)
    for level in range(1, T + 1):
        n = np.full(B, level, np.int32)
        want = np.asarray(jop.x_end_from_xt(jnp.asarray(x0_bar), jnp.asarray(x), jnp.asarray(n)))
        got = op.x_end_from_xt(torch.from_numpy(x0_bar), torch.from_numpy(x),
                               torch.from_numpy(n).long()).numpy()
        one_minus_a = 1.0 - np.asarray(jop.alphas)[level - 1][None, :, :, None]
        ok = np.broadcast_to(one_minus_a >= 1e-2, got.shape)
        bound = np.broadcast_to(1e-6 / np.maximum(one_minus_a, 1e-2), got.shape)
        assert (np.abs(got - want)[ok] <= bound[ok]).all(), f"level {level}"


def test_fade_generation_endpoint_is_a_constant_color():
    op = _port("fade_generation", image_size=S, timesteps=T)
    x = torch.zeros(64, S, S, 3)
    gen = torch.Generator().manual_seed(0)
    x_end = op.sample_x_end(gen, x)
    assert x_end.shape == x.shape
    assert torch.equal(x_end, x_end[:, :1, :1, :].expand_as(x))  # constant per image
    assert x_end.min() >= -0.5 and x_end.max() < 0.5
    again = op.sample_x_end(torch.Generator().manual_seed(0), x)
    assert torch.equal(x_end, again)
    # level T of the reverse schedule is pure x_end (alpha = 0)
    rev = _port("fade_generation", image_size=S, timesteps=T, reverse=True)
    y = rev.degrade(torch.from_numpy(_images(16, 64)), torch.full((64,), T), x_end=x_end)
    torch.testing.assert_close(y, x_end.contiguous(), rtol=0, atol=0)


def test_x_end_from_xt_raises_on_family_a():
    op = _port("fade", image_size=S, timesteps=T)
    with pytest.raises(NotImplementedError, match="Family-B"):
        op.x_end_from_xt(torch.zeros(1, S, S, 3), torch.zeros(1, S, S, 3), torch.ones(1))


@pytest.mark.parametrize("name,cfg", [
    ("decolor", dict(timesteps=3)),
    ("fade", dict(image_size=8, timesteps=3)),
    ("resolution", dict(image_size=8, timesteps=3)),
    ("fade_generation", dict(image_size=8, timesteps=3)),
])
def test_new_operators_build_on_the_card_by_default(name, cfg):
    """``device="cpu"`` builds on the CPU; without it the tables go to the
    card, and with no CUDA device the call raises."""
    op = get_operator(name, **cfg, device="cpu")
    cls = {"decolor": Decolorization, "fade": Fade, "resolution": Resolution,
           "fade_generation": FadeGeneration}[name]
    assert isinstance(op, cls)
    tables = [v for v in vars(op).values() if torch.is_tensor(v)]
    assert tables and all(v.device.type == "cpu" for v in tables)
    moved = op.to("cpu")
    assert moved is not op and all(torch.equal(a, b) for a, b in zip(
        tables, [v for v in vars(moved).values() if torch.is_tensor(v)]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_operator(name, **cfg)
        return
    op = get_operator(name, **cfg)
    assert all(v.is_cuda for v in vars(op).values() if torch.is_tensor(v))


@pytest.mark.parametrize("name", ["noise", "mix", "snow", "fade_naive"])
def test_pending_operators_name_their_item(name):
    with pytest.raises(NotImplementedError, match="ROADMAP.md section 1, item 8"):
        get_operator(name, image_size=8, timesteps=3)
