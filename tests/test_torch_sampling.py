"""The port's sampling slice == colddiff's: blur degrade + UnetConvNext +
``prepare_start``/``sample``, on the same weights and images.

Blur at 16 px with T=8 and a dim-8 UNet.

With the UNet in fp64 the tolerance cannot be 1e-9: the JAX ``apply_rowcol``
returns fp32 by design (``preferred_element_type=float32``), so both
samplers carry an fp32 state whatever the UNet's dtype, and the degrade
matmuls round in different orders on the two sides (one fp32 ulp of an O(1)
image is 1.2e-7, some 32 roundings per run, amplified by the UNet's
step-to-step gain).  Both routines are held at 1e-5 there.

With the UNet in fp32, one call differs by up to ~1e-5 between the
frameworks (their fp32 summation orders; rtol 2e-4 in
``test_torch_unet_convnext.py``).  Algorithm 2 cancels most of an x0 error
(it enters as D(e, t-1) - D(e, t)) and is held at 1e-4; Algorithm 1 feeds
the blurred prediction straight back into the model, so the 8 calls compound
it (about 20x on these random weights), and it is held at 5e-4.
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
from colddiff.sampling import prepare_start as jprepare_start
from colddiff.sampling import sample as jsample
from colddiff_torch.diffusion import ColdDiffusion
from colddiff_torch.models import UnetConvNext
from colddiff_torch.models.convert import convnext_state_dict_from_flax
from colddiff_torch.operators import get_operator
from colddiff_torch.sampling import prepare_start, sample, sample_multi_step
from tests.test_torch_unet_convnext import flax_convnext_params

BLUR = dict(image_size=16, timesteps=8, blur_routine="Exponential_reflect",
            kernel_size=15, kernel_std=0.01)
DIM, MULTS = 8, (1, 2)


@pytest.fixture(scope="module")
def flax_params():
    return flax_convnext_params(DIM, MULTS, seed=3)


def _diffusions(routine):
    jd = JColdDiffusion(op=JGaussianBlur.create(**BLUR), image_size=16,
                        sampling_routine=routine)
    d = ColdDiffusion(op=get_operator("blur", **BLUR, device="cpu"), image_size=16,
                      sampling_routine=routine)
    return jd, d


@pytest.mark.parametrize("routine,refresh,dtype,atol", [
    ("x0_step_down", 1, "float64", 1e-5),
    ("default", 1, "float64", 1e-5),
    ("x0_step_down", 1, "float32", 1e-4),
    ("default", 1, "float32", 5e-4),
    ("x0_step_down", 2, "float32", 1e-4),
])
def test_sample_matches_jax(flax_params, routine, refresh, dtype, atol):
    jd, d = _diffusions(routine)
    x = np.random.default_rng(5).uniform(-1.0, 1.0, (2, 16, 16, 3)).astype(dtype)
    jmodel = JUnetConvNext(dim=DIM, dim_mults=MULTS)
    with jax.enable_x64(dtype == "float64"):
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), flax_params)

        def jdenoise(xt, t):
            return jmodel.apply(params, xt, t).astype(jnp.float32)

        @jax.jit
        def run(img):
            res = jsample(jd, jdenoise, jprepare_start(jd, img), refresh_every=refresh)
            return res.xt, res.direct_recons, res.img

        want = [np.asarray(a) for a in run(jnp.asarray(x))]

    tdtype = getattr(torch, dtype)
    model = UnetConvNext(dim=DIM, dim_mults=MULTS)
    model.load_state_dict(convnext_state_dict_from_flax(flax_params), strict=True)
    model = model.to(tdtype).eval()

    def denoise(xt, t):
        return model(xt.to(tdtype), t).to(torch.float32)

    start = prepare_start(d, torch.from_numpy(x))
    res = sample(d, denoise, start, refresh_every=refresh)
    got = [res.xt, res.direct_recons, res.img]
    assert res.img.dtype == torch.float32 and res.img.is_inference()
    for name, g, w in zip(("xt", "direct_recons", "img"), got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol, err_msg=name)


def test_oracle_reconstruction_t200_32px():
    """Algorithm 2 telescopes: with a perfect x0 the sampler returns x0."""
    op = get_operator("blur", image_size=32, timesteps=200,
                      blur_routine="Exponential_reflect", kernel_size=15,
                      kernel_std=0.01, device="cpu")
    d = ColdDiffusion(op=op, image_size=32, sampling_routine="x0_step_down")
    clean = torch.from_numpy(
        np.random.default_rng(1).uniform(-1.0, 1.0, (2, 32, 32, 3)).astype(np.float32))
    start = prepare_start(d, clean)
    assert (start - clean).abs().max() > 0.1  # T=200 really blurs
    res = sample(d, lambda xt, t: clean, start)
    np.testing.assert_allclose(res.img.numpy(), clean.numpy(), rtol=0, atol=1e-4)


def test_recon_noise_uses_the_generator():
    op = get_operator("blur", **BLUR, device="cpu")
    d = ColdDiffusion(op=op, image_size=16, sampling_routine="x0_step_down",
                      recon_noise_std=0.01)
    x = torch.zeros(1, 16, 16, 3)
    with pytest.raises(ValueError, match="Generator"):
        sample(d, lambda xt, t: xt, x)
    runs = [sample(d, lambda xt, t: xt, x,
                   generator=torch.Generator().manual_seed(s)).img for s in (4, 4, 5)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])


def test_grad_flows_when_asked():
    d = ColdDiffusion(op=get_operator("blur", **BLUR, device="cpu"), image_size=16,
                      sampling_routine="x0_step_down")
    scale = torch.tensor(0.5, requires_grad=True)
    x = torch.ones(1, 16, 16, 3)
    res = sample(d, lambda xt, t: xt * scale, prepare_start(d, x), t=3, grad=True)
    res.img.sum().backward()
    assert scale.grad is not None and torch.isfinite(scale.grad)


@pytest.mark.parametrize("call,match", [("step_model", "ROADMAP.md"), ("ddim", "ddim"),
                                        ("multi_step", "ROADMAP.md")])
def test_unported_branches_raise(call, match):
    """What is still unported names its ROADMAP.md item; 'ddim' on a
    Family-A operator raises, as the JAX sampler does.  (The Family-B,
    trajectory and all_sample cases are ported: their parity tests are in
    tests/test_torch_sampling_ops.py.)"""
    op = get_operator("blur", **BLUR, device="cpu")
    x = torch.zeros(1, 16, 16, 3)
    ident = lambda xt, t: xt  # noqa: E731
    make = functools.partial(ColdDiffusion, op=op, image_size=16)
    calls = {
        "step_model": lambda: sample(make(train_routine="Step"), ident, x),
        "ddim": lambda: sample(make(sampling_routine="ddim"), ident, x),
        "multi_step": lambda: sample_multi_step(make(), ident, x, 3, 0),
    }
    with pytest.raises(NotImplementedError, match=match):
        calls[call]()
