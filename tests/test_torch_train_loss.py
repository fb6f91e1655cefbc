"""The port's training losses == colddiff's ``ColdDiffusion.p_losses``.

Blur ``Exponential_reflect`` at 16 px with T=8 and a dim-8 UNet on the same
weights (``convnext_state_dict_from_flax``), at fixed levels t = 0, 3, 7
(t = 0 makes ``Step``'s target the clean image, through level t-1 = -1).

Tolerances:
  - the degrade is fp32 by design on both sides (ROADMAP.md section 3), so
    even with an fp64 UNet the losses agree to fp32 rounding of the degraded
    input, not to fp64: rtol 1e-5 under ``jax.enable_x64``;
  - with an fp32 UNet the frameworks' fp32 summation orders through ~30
    layers add ~1e-5 per output (``test_torch_unet_convnext.py``): 1e-4.
Gradients are compared per parameter tensor by relative L2 at the same
tolerances.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colddiff.diffusion import ColdDiffusion as JColdDiffusion
from colddiff.models import UnetConvNext as JUnetConvNext
from colddiff.operators.blur import GaussianBlur as JGaussianBlur
from colddiff_torch.diffusion import ColdDiffusion
from colddiff_torch.models import UnetConvNext
from colddiff_torch.models.convert import convnext_state_dict_from_flax
from colddiff_torch.operators import get_operator
from tests.test_torch_unet_convnext import flax_convnext_params

BLUR = dict(image_size=16, timesteps=8, blur_routine="Exponential_reflect",
            kernel_size=15, kernel_std=0.01)
DIM, MULTS = 8, (1, 2)
T_FIXED = np.asarray([0, 3, 7], np.int32)
TOL = {"float64": 1e-5, "float32": 1e-4}
ROUTINES = ("Final", "Step", "Step_Gradient", "Gradient_norm")


@pytest.fixture(scope="module")
def flax_params():
    return flax_convnext_params(DIM, MULTS, seed=7)


@pytest.fixture(scope="module")
def x_start():
    return np.random.default_rng(11).uniform(-1.0, 1.0, (3, 16, 16, 3))


@functools.lru_cache(maxsize=None)
def _jax_apply(dtype: str):
    """The Flax forward, jitted once per dtype (x64 mode is part of the key)."""
    model = JUnetConvNext(dim=DIM, dim_mults=MULTS)
    return jax.jit(model.apply)


def _diffusions(routine, loss_type):
    kw = dict(image_size=16, train_routine=routine, loss_type=loss_type)
    return (JColdDiffusion(op=JGaussianBlur.create(**BLUR), **kw),
            ColdDiffusion(op=get_operator("blur", **BLUR, device="cpu"), **kw))


def _port_model(flax_params, dtype):
    model = UnetConvNext(dim=DIM, dim_mults=MULTS)
    model.load_state_dict(convnext_state_dict_from_flax(flax_params), strict=True)
    return model.to(getattr(torch, dtype))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("loss_type", ["l1", "l2", "sqrt"])
@pytest.mark.parametrize("routine", ROUTINES)
def test_p_losses_match_jax(flax_params, x_start, routine, loss_type, dtype):
    jd, d = _diffusions(routine, loss_type)
    x = x_start.astype(dtype)
    with jax.enable_x64(dtype == "float64"):
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), flax_params)
        apply = _jax_apply(dtype)
        want = float(jd.p_losses(lambda xt, t: apply(params, xt, t),
                                 jnp.asarray(x), jnp.asarray(T_FIXED)))
    model = _port_model(flax_params, dtype)
    with torch.no_grad():
        got = d.p_losses(lambda xt, t: model(xt.to(model.time_mlp[1].weight.dtype), t),
                         torch.from_numpy(x), torch.from_numpy(T_FIXED).long()).item()
    np.testing.assert_allclose(got, want, rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_final_l1_gradients_match_jax(flax_params, x_start, dtype):
    jd, d = _diffusions("Final", "l1")
    x = x_start.astype(dtype)
    jmodel = JUnetConvNext(dim=DIM, dim_mults=MULTS)
    with jax.enable_x64(dtype == "float64"):
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), flax_params)

        @jax.jit
        def loss(p):
            return jd.p_losses(lambda xt, t: jmodel.apply(p, xt, t),
                               jnp.asarray(x), jnp.asarray(T_FIXED))

        want_loss, want_grads = jax.value_and_grad(loss)(params)
        want = convnext_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, want_grads))
    model = _port_model(flax_params, dtype)
    got_loss = d.p_losses(lambda xt, t: model(xt.to(getattr(torch, dtype)), t),
                          torch.from_numpy(x), torch.from_numpy(T_FIXED).long())
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=TOL[dtype])
    grads = dict(model.named_parameters())
    assert set(grads) == set(want)
    for name, p in grads.items():
        err = _rel_l2(p.grad.numpy(), want[name].numpy())
        assert err <= TOL[dtype], f"{name}: rel L2 {err}"


def test_loss_with_t_equals_p_losses(x_start):
    _, d = _diffusions("Final", "l1")
    x = torch.from_numpy(x_start.astype(np.float32))
    t = torch.from_numpy(T_FIXED).long()

    def denoise(xt, tt):
        return xt * 0.5 + tt.reshape(-1, 1, 1, 1) * 0.01

    assert torch.equal(d.loss(denoise, x, None, t=t), d.p_losses(denoise, x, t))


def test_loss_draws_every_t_from_the_generator(x_start):
    _, d = _diffusions("Final", "l1")
    x = torch.from_numpy(x_start.astype(np.float32))
    seen = []

    def denoise(xt, t):
        seen.extend(t.tolist())
        return xt

    gen = torch.Generator().manual_seed(0)
    for _ in range(40):
        d.loss(denoise, x, gen)
    assert set(seen) == set(range(BLUR["timesteps"]))
    gen.manual_seed(0)
    again = []
    d.loss(lambda xt, t: (again.extend(t.tolist()), xt)[1], x, gen)
    assert again == seen[:3]  # the generator alone decides the draws


@pytest.mark.parametrize("routine", ["Final_small_noise", "Final_random_mean",
                                     "Final_random_mean_and_actual"])
def test_noise_routines_name_their_roadmap_item(x_start, routine):
    _, d = _diffusions(routine, "l1")
    x = torch.from_numpy(x_start.astype(np.float32))
    with pytest.raises(NotImplementedError, match="item 10"):
        d.p_losses(lambda xt, t: xt, x, torch.zeros(3, dtype=torch.long))


def test_unknown_loss_type_raises(x_start):
    _, d = _diffusions("Final", "huber")
    with pytest.raises(NotImplementedError):
        d.p_losses(lambda xt, t: xt, torch.from_numpy(x_start), torch.zeros(3, dtype=torch.long))
