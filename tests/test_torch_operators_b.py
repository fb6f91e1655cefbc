"""colddiff_torch's noise, mix, snow and fade_naive operators == colddiff's
(JAX), on the same inputs, and the copied set-up functions == the originals.

Inputs are numpy-seeded 16 px batches with T <= 8.  Tolerances:
  - the copied numpy/scipy functions (cosine schedule, ``clipped_zoom``,
    ``spiral_order``) and ``rgb_to_grayscale``: exact, both sides run the
    same float64 code or the same fp32 products and sums in the same order;
  - the operators' host-built tables (noise, fade_naive): exact;
  - snow's fields: two fp32 einsums with the same [S, S] matrices on both
    sides, summed in other orders: 1e-6 (values in [0, 1]);
  - every degrade, ``degrade_range`` and ``x_end_from_xt``: 1e-6, one or
    two fp32 roundings of O(1) values (snow's blend adds a field held at
    1e-6; ``x_end_from_xt`` divides by sqrt(1 - acum) >= 0.2 at T = 8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colddiff import schedules as jschedules
from colddiff.operators import get_operator as jget_operator
from colddiff.operators.fade_naive import spiral_order as jspiral_order
from colddiff.ops import image as jimage
from colddiff_torch import schedules
from colddiff_torch.operators import (Animorphosis, FadeNaive, GaussianNoise, Snow,
                                      get_operator)
from colddiff_torch.operators.fade_naive import spiral_order
from colddiff_torch.ops import image
from tests.test_torch_operators import _check_degrades, _images, _levels

S, T, B = 16, 8, 4
ATOL = 1e-6


def _ops(name, **cfg):
    return jget_operator(name, **cfg), get_operator(name, **cfg, device="cpu")


def _noise(seed, b=B):
    return np.random.default_rng(seed).standard_normal((b, S, S, 3)).astype(np.float32)


# ---------------------------------------------------------------------- #
# copied set-up functions


@pytest.mark.parametrize("t,s", [(8, 0.008), (200, 0.008), (1000, 0.008), (20, 0.02)])
def test_cosine_schedule_copies_are_exact(t, s):
    np.testing.assert_array_equal(schedules.cosine_beta_schedule(t, s),
                                  jschedules.cosine_beta_schedule(t, s))
    np.testing.assert_array_equal(schedules.cosine_alphas_cumprod(t, s),
                                  jschedules.cosine_alphas_cumprod(t, s))


@pytest.mark.parametrize("size,zoom,channels", [(16, 2.5, 1), (32, 3.0, 1), (128, 2.5, 1),
                                                (17, 2.5, 3)])
def test_clipped_zoom_copy_is_exact(size, zoom, channels):
    img = np.random.default_rng(size).normal(0.5, 0.3, (size, size, channels))
    got = image.clipped_zoom(img, zoom)
    assert got.shape == img.shape
    np.testing.assert_array_equal(got, jimage.clipped_zoom(img, zoom))


def test_rgb_to_grayscale_matches_jax():
    x = (_images(1) + 1.0) * 0.5
    np.testing.assert_array_equal(image.rgb_to_grayscale(torch.from_numpy(x)).numpy(),
                                  np.asarray(jimage.rgb_to_grayscale(jnp.asarray(x))))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 16, 32])
def test_spiral_order_copy_is_exact(n):
    got = spiral_order(n)
    np.testing.assert_array_equal(got, jspiral_order(n))
    assert sorted(got.flat) == list(range(n * n))  # a permutation of the pixels


# ---------------------------------------------------------------------- #
# noise and mix


@pytest.mark.parametrize("name", ["noise", "mix"])
def test_interpolation_matches_jax(name):
    jop, op = _ops(name, timesteps=T)
    assert op.requires_x_end and jop.requires_x_end
    assert isinstance(op, GaussianNoise if name == "noise" else Animorphosis)
    np.testing.assert_array_equal(op.sqrt_ac.numpy(), np.asarray(jop.sqrt_ac))
    np.testing.assert_array_equal(op.sqrt_1mac.numpy(), np.asarray(jop.sqrt_1mac))
    x, x_end = _images(2), _noise(3)
    _check_degrades(jop, op, x, _levels(4), atol=ATOL, x_end=x_end)
    # og is ignored
    xt, nt = torch.from_numpy(x), torch.from_numpy(_levels(4)).long()
    assert torch.equal(op.degrade(xt, nt, x_end=torch.from_numpy(x_end), og=-xt),
                       op.degrade(xt, nt, x_end=torch.from_numpy(x_end)))
    with pytest.raises(ValueError, match="x_end"):
        op.degrade(xt, nt)


@pytest.mark.parametrize("n0,n1", [(0, 0), (0, 5), (3, 3), (2, 7), (1, 8), (7, 8)])
def test_interpolation_degrade_range_matches_jax(n0, n1):
    jop, op = _ops("noise", timesteps=T)
    x0, x_end = _images(5), _noise(6)
    # a state at level n0, then advanced to n1
    x = np.array(jop.degrade(jnp.asarray(x0), jnp.full((B,), n0), x_end=jnp.asarray(x_end)))
    want = np.asarray(jop.degrade_range(jnp.asarray(x), n0, n1, x_end=jnp.asarray(x_end)))
    got = op.degrade_range(torch.from_numpy(x), n0, n1, x_end=torch.from_numpy(x_end))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    # the closed form lands where degrading x0 to n1 does
    direct = op.degrade(torch.from_numpy(x0), torch.full((B,), n1), x_end=torch.from_numpy(x_end))
    np.testing.assert_allclose(got.numpy(), direct.numpy(), rtol=0, atol=1e-5)


def test_interpolation_degrade_range_refuses_bad_ranges():
    op = get_operator("noise", timesteps=T, device="cpu")
    x = torch.zeros(1, S, S, 3)
    for n0, n1 in [(3, 2), (-1, 2), (0, T + 1)]:
        with pytest.raises(ValueError, match="invalid range"):
            op.degrade_range(x, n0, n1, x_end=x)
    with pytest.raises(ValueError, match="x_end"):
        op.degrade_range(x, 1, 2)


def test_interpolation_x_end_from_xt_matches_jax():
    jop, op = _ops("mix", timesteps=T)
    x0_bar, xt = _images(7), _images(8)
    for level in range(0, T + 1):
        n = np.full(B, level, np.int32)
        want = np.asarray(jop.x_end_from_xt(jnp.asarray(x0_bar), jnp.asarray(xt), jnp.asarray(n)))
        got = op.x_end_from_xt(torch.from_numpy(x0_bar), torch.from_numpy(xt),
                               torch.from_numpy(n).long())
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL, err_msg=f"{level}")
    # with the true endpoint and x0, the estimate gives the endpoint back
    x_end = _noise(9)
    n = torch.from_numpy(_levels(10)).long().clamp(min=1)
    y = op.degrade(torch.from_numpy(x0_bar), n, x_end=torch.from_numpy(x_end))
    torch.testing.assert_close(op.x_end_from_xt(torch.from_numpy(x0_bar), y, n),
                               torch.from_numpy(x_end), rtol=0, atol=1e-5)


def test_endpoints_of_noise_and_mix():
    """noise draws N(0, I) from the generator; mix's endpoint comes from
    data, so it draws nothing."""
    noise = get_operator("noise", timesteps=T, device="cpu")
    x = torch.zeros(64, S, S, 3)
    gen = torch.Generator().manual_seed(0)
    e = noise.sample_x_end(gen, x)
    assert e.shape == x.shape and e.dtype == x.dtype
    assert abs(e.mean().item()) < 0.02 and abs(e.std().item() - 1.0) < 0.02
    assert torch.equal(e, noise.sample_x_end(torch.Generator().manual_seed(0), x))
    mix = get_operator("mix", timesteps=T, device="cpu")
    state = gen.get_state()
    assert mix.sample_x_end(gen, x) is None and torch.equal(gen.get_state(), state)


# ---------------------------------------------------------------------- #
# snow


SNOW_CASES = [
    dict(snow_level=1),
    dict(snow_level=4, fix_brightness=True),
    dict(snow_level=2, single_snow=True, batch_size=B),
    dict(snow_level=3, single_snow=True, batch_size=5),
    dict(snow_level=4, random_snow=True, seed=17),
    dict(snow_level=3, random_snow=True, single_snow=True, batch_size=B, seed=18),
]


@pytest.mark.parametrize("cfg", SNOW_CASES, ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_snow_fields_match_jax(cfg):
    """The fields of ``_generate`` at a fixed seed (123321, or the given one
    under random_snow), single_snow on and off."""
    jop, op = _ops("snow", image_size=S, timesteps=T, **cfg)
    layers = cfg.get("batch_size", B) if cfg.get("single_snow") else 1
    assert op.snow.shape == op.snow_rot.shape == (T, layers, S, S)
    for part in ("snow", "snow_rot"):
        np.testing.assert_allclose(getattr(op, part).numpy(), np.asarray(getattr(jop, part)),
                                   rtol=0, atol=ATOL, err_msg=part)
    np.testing.assert_array_equal(op.br_coefs.numpy(), np.asarray(jop.br_coefs))
    assert torch.equal(op.snow_rot, op.snow.flip(2, 3))
    assert (op.snow >= 0).all() and (op.snow <= 1).all()


def test_snow_base_is_taken_as_given():
    base = np.random.default_rng(3).uniform(0, 1, (S, S, 2))
    jop, op = _ops("snow", image_size=S, timesteps=T, snow_level=2, snow_base=base)
    assert op.snow.shape[1] == 2
    np.testing.assert_allclose(op.snow.numpy(), np.asarray(jop.snow), rtol=0, atol=ATOL)


@pytest.mark.parametrize("cfg", SNOW_CASES[:3], ids=["level1", "level4-fixed", "single"])
def test_snow_degrade_matches_jax(cfg):
    """The blend on og: the degraded x is a function of og alone except at
    level 0, where it is x itself (og differs from x in the sampler's
    noisy branch)."""
    jop, op = _ops("snow", image_size=S, timesteps=T, **cfg)
    x, og = _images(11), _images(12)
    _check_degrades(jop, op, x, _levels(13), atol=ATOL)
    n = _levels(14)
    want = np.asarray(jop.degrade(jnp.asarray(x), jnp.asarray(n), og=jnp.asarray(og)))
    got = op.degrade(torch.from_numpy(x), torch.from_numpy(n).long(), og=torch.from_numpy(og))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[0].numpy(), x[0])  # level 0
    same = op.degrade(torch.from_numpy(og), torch.from_numpy(n).long())
    torch.testing.assert_close(got[1:], same[1:], rtol=0, atol=0)
    with pytest.raises(NotImplementedError):
        op.degrade_range(torch.from_numpy(x), 0, 1)
    with pytest.raises(NotImplementedError):
        op.x_end_from_xt(torch.from_numpy(x), torch.from_numpy(x), torch.ones(B))


def test_snow_reset_redraws_only_random_snow():
    """reset draws a numpy seed from the generator and rebuilds the fields
    with it (the JAX reset draws its seed from a key); fixed snow stays."""
    fixed = get_operator("snow", image_size=S, timesteps=T, device="cpu")
    assert fixed.reset(torch.Generator().manual_seed(0), B) is fixed
    op = get_operator("snow", image_size=S, timesteps=T, random_snow=True, seed=1,
                      device="cpu")
    gen = torch.Generator().manual_seed(5)
    seed = int(torch.randint(0, 2**31 - 1, (), generator=torch.Generator().manual_seed(5)))
    new = op.reset(gen, B)
    assert new is not op and not torch.equal(new.snow, op.snow)
    want = Snow.create(image_size=S, timesteps=T, random_snow=True, seed=seed, device="cpu")
    assert torch.equal(new.snow, want.snow) and torch.equal(new.br_coefs, want.br_coefs)
    jop = jget_operator("snow", image_size=S, timesteps=T, random_snow=True, seed=seed)
    np.testing.assert_allclose(new.snow.numpy(), np.asarray(jop.snow), rtol=0, atol=ATOL)
    again = op.reset(torch.Generator().manual_seed(5), B)
    assert torch.equal(again.snow, new.snow)


def test_snow_state_round_trip():
    """The operator's tensors (what a checkpoint keeps) restore its fields."""
    op = get_operator("snow", image_size=S, timesteps=T, random_snow=True, device="cpu")
    other = op.reset(torch.Generator().manual_seed(2), B)
    assert set(op.state()) == {"snow", "snow_rot", "br_coefs"}
    back = other.with_state(op.state(), "cpu")
    assert back is not other and all(torch.equal(getattr(back, k), v)
                                     for k, v in op.state().items())


# ---------------------------------------------------------------------- #
# fade_naive


@pytest.mark.parametrize("routine", ["Incremental", "Constant", "Spiral", "Spiral_2"])
def test_fade_naive_matches_jax(routine):
    cfg = dict(image_size=S, timesteps=T, fade_routine=routine, start_fade_factor=0.1)
    jop, op = _ops("fade_naive", **cfg)
    assert isinstance(op, FadeNaive)
    assert op.requires_x_end == jop.requires_x_end == (routine == "Spiral_2")
    np.testing.assert_array_equal(op.cum.numpy(), np.asarray(jop.cum))
    x = _images(15)
    x_end = np.array(jop.sample_x_end(jax.random.key(3), jnp.asarray(x)))
    _check_degrades(jop, op, x, _levels(16), atol=ATOL, x_end=x_end)
    if routine != "Spiral_2":
        assert op.sample_x_end(torch.Generator(), torch.from_numpy(x)) is None
    with pytest.raises(NotImplementedError):
        op.degrade_range(torch.from_numpy(x), 0, 1)


def test_fade_naive_spiral_2_endpoint_and_masks():
    op = get_operator("fade_naive", image_size=S, timesteps=S * S, fade_routine="Spiral_2",
                      device="cpu")
    x = torch.from_numpy(_images(17, 64))
    e = op.sample_x_end(torch.Generator().manual_seed(0), x)
    assert e.shape == x.shape and torch.equal(e, e[:, :1, :1, :].expand_as(x))
    assert e.min() >= 0 and e.max() < 1
    # masks are binary; after all S*S steps every pixel is the endpoint
    assert set(op.cum.unique().tolist()) <= {0.0, 1.0}
    y = op.degrade(x, torch.full((64,), S * S), x_end=e)
    torch.testing.assert_close(y, e.contiguous(), rtol=0, atol=0)


def test_fade_naive_refuses_unknown_routines():
    with pytest.raises(ValueError, match="unknown naive fade routine"):
        get_operator("fade_naive", image_size=S, timesteps=T, fade_routine="Spiral_3",
                     device="cpu")


@pytest.mark.parametrize("name,cfg", [
    ("noise", dict(timesteps=3)),
    ("mix", dict(timesteps=3)),
    ("snow", dict(image_size=8, timesteps=3)),
    ("fade_naive", dict(image_size=8, timesteps=3, fade_routine="Spiral_2")),
])
def test_family_b_and_snow_build_on_the_card_by_default(name, cfg):
    """``device="cpu"`` builds on the CPU; without it the tables go to the
    card, and with no CUDA device the call raises."""
    op = get_operator(name, **cfg, device="cpu")
    tables = op.state()
    assert tables and all(v.device.type == "cpu" for v in tables.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            get_operator(name, **cfg)
        return
    op = get_operator(name, **cfg)
    assert all(v.is_cuda for v in op.state().values())


def test_registry_names_the_jax_operators():
    from colddiff.operators import _REGISTRY as JREGISTRY
    from colddiff_torch.operators import _REGISTRY

    assert set(_REGISTRY) == set(JREGISTRY)
    assert [c.__name__ for c in _REGISTRY.values()] == [
        JREGISTRY[k].__name__ for k in _REGISTRY]
