"""colddiff_torch ConvNeXt block front == colddiff's, on the same inputs.

On CPU tensors the port's front runs its plain PyTorch version; it is held
against the JAX reference (``convnext_front_reference``) and against the
Pallas kernel in interpret mode, at the shapes of ``tests/test_pallas.py``.
fp32 tolerance 3e-5: the two sides sum 49 taps and C channels in different
orders.  The CUDA kernel itself is compared with the plain version by
``tests/test_torch_cuda.py`` and by ``chip_smoke.py`` on the GPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colddiff.ops.pallas.convnext_front import (
    _pallas_forward_packed,
    convnext_front_reference,
)
from colddiff.ops.pallas.convnext_front import convnext_front as jconvnext_front
from colddiff_torch.ops import convnext_front as front_mod
from colddiff_torch.ops.convnext_front import convnext_front, convnext_front_plain


def _args(rng, b, c):
    """JAX-layout front arguments, as numpy fp32 (test_pallas.py's draws)."""
    wk = (rng.standard_normal((7, 7, c)) * 0.05).astype(np.float32)
    bias = (rng.standard_normal(c) * 0.1).astype(np.float32)
    cond = rng.standard_normal((b, c)).astype(np.float32)
    gamma = (rng.random(c) + 0.5).astype(np.float32)
    beta = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return wk, bias, cond, gamma, beta


def _to_torch(x, wk, bias, cond, gamma, beta):
    """NHWC numpy -> NCHW channels_last tensor; [7,7,C] -> [C,1,7,7]."""
    xt = torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)
    wt = torch.from_numpy(np.ascontiguousarray(np.transpose(wk, (2, 0, 1))))[:, None]
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    return xt, wt, t(bias), t(cond), t(gamma), t(beta)


def _nhwc(y):
    return y.detach().permute(0, 2, 3, 1).float().numpy()


# test_pallas.py:30-57's cases: every norm/cond pair at (2,16,16,64), then
# norm True/False with cond across the packed-layout shapes
CASES = [((2, 16, 16, 64), norm, cond) for norm in (True, False) for cond in (True, False)]
CASES += [(shape, norm, True) for shape in [(2, 16, 16, 8), (1, 8, 8, 64),
                                            (1, 128, 16, 8), (2, 16, 8, 32)]
          for norm in (True, False)]


# C=1 and the C=3 stem: on the card these take the small-C kernel.  The
# Pallas interpret path takes only C | 128 with C >= 8, so here the port is
# held against convnext_front_reference alone.
SMALL_C_CASES = [((2, 9, 11, c), norm, cond) for c in (1, 3)
                 for norm in (True, False) for cond in (True, False)]


@pytest.mark.parametrize("shape,norm,with_cond", CASES)
def test_plain_matches_reference_and_interpret(rng, shape, norm, with_cond):
    b, h, w, c = shape
    x = rng.standard_normal(shape).astype(np.float32)
    wk, bias, cond, gamma, beta = _args(rng, b, c)
    cond = cond if with_cond else None
    jargs = [None if a is None else jnp.asarray(a) for a in (x, wk, bias, cond, gamma, beta)]
    want = np.asarray(convnext_front_reference(*jargs, norm=norm))
    interp = np.asarray(jconvnext_front(*jargs, norm=norm, force="interpret"))
    targs = _to_torch(x, wk, bias, cond, gamma, beta)
    plain = _nhwc(convnext_front_plain(*targs, norm=norm))
    wrapped = _nhwc(convnext_front(*targs, norm=norm))
    for got in (plain, wrapped):
        np.testing.assert_allclose(got, want, rtol=3e-5, atol=3e-5)
        np.testing.assert_allclose(got, interp, rtol=3e-5, atol=3e-5)


# the tile kernel's edge cases on the card (tests/test_torch_cuda.py): C not
# dividing 128, a tile cut by the edge, H and W below 7; and the widths of
# its cluster form (C > 1024: C just past the tile kernel and not a
# multiple of the 16-byte unit, the 16*dim front of dim = 80 on a 5x3
# image, dim = 128's); against the reference alone, as above
EDGE_CASES = [(shape, norm, cond)
              for shape in [(2, 9, 11, 33), (2, 9, 11, 48), (2, 9, 11, 100), (1, 5, 3, 64),
                            (2, 17, 33, 128), (1, 9, 11, 1025), (2, 5, 3, 1280),
                            (1, 8, 8, 2048)]
              for norm in (True, False) for cond in (True, False)]


@pytest.mark.parametrize("shape,norm,with_cond", SMALL_C_CASES)
def test_plain_matches_reference_at_small_c(rng, shape, norm, with_cond):
    _check_against_reference(rng, shape, norm, with_cond)


@pytest.mark.parametrize("shape,norm,with_cond", EDGE_CASES)
def test_plain_matches_reference_at_tile_kernel_edges(rng, shape, norm, with_cond):
    _check_against_reference(rng, shape, norm, with_cond)


def _check_against_reference(rng, shape, norm, with_cond):
    b, h, w, c = shape
    x = rng.standard_normal(shape).astype(np.float32)
    wk, bias, cond, gamma, beta = _args(rng, b, c)
    cond = cond if with_cond else None
    jargs = [None if a is None else jnp.asarray(a) for a in (x, wk, bias, cond, gamma, beta)]
    want = np.asarray(convnext_front_reference(*jargs, norm=norm))
    targs = _to_torch(x, wk, bias, cond, gamma, beta)
    for got in (convnext_front_plain(*targs, norm=norm), convnext_front(*targs, norm=norm)):
        np.testing.assert_allclose(_nhwc(got), want, rtol=3e-5, atol=3e-5)


def test_bf16_activations_fp32_params_promote_like_flax(rng):
    """bf16 x + fp32 params -> fp32 output (test_pallas.py:60-72's rule)."""
    b, h, w, c = 1, 8, 8, 64
    x16 = jnp.asarray(rng.standard_normal((b, h, w, c)), jnp.float32).astype(jnp.bfloat16)
    wk, bias, cond, gamma, beta = _args(rng, b, c)
    jargs = [jnp.asarray(a) for a in (wk, bias, cond, gamma, beta)]
    want = np.asarray(convnext_front_reference(x16, *jargs, norm=True))
    kernel = np.asarray(_pallas_forward_packed(x16, *jargs, True, 1e-5, interpret=True))
    x_t = torch.from_numpy(np.array(x16.astype(jnp.float32))).to(torch.bfloat16)
    targs = _to_torch(np.zeros((b, h, w, c), np.float32), wk, bias, cond, gamma, beta)
    got = convnext_front(x_t.permute(0, 3, 1, 2), *targs[1:], norm=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_nhwc(got), want, rtol=3e-5, atol=3e-5)
    np.testing.assert_allclose(_nhwc(got), kernel, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("with_cond", [True, False])
def test_autograd_function_grads_match_jax(rng, with_cond):
    b, h, w, c = 2, 12, 10, 16
    x = rng.standard_normal((b, h, w, c)).astype(np.float32)
    wk, bias, cond, gamma, beta = _args(rng, b, c)
    cond = cond if with_cond else None
    jargs = [jnp.asarray(a) for a in (x, wk, bias, cond, gamma, beta) if a is not None]

    def loss(x, wk, bias, *rest):
        cnd, gamma, beta = rest if with_cond else (None, *rest)
        return jnp.sum(convnext_front_reference(x, wk, bias, cnd, gamma, beta) ** 2)

    jgrads = jax.grad(loss, argnums=tuple(range(len(jargs))))(*jargs)
    targs = [None if a is None else a.clone().requires_grad_()
             for a in _to_torch(x, wk, bias, cond, gamma, beta)]
    (convnext_front(*targs) ** 2).sum().backward()
    tgrads = [a.grad for a in targs if a is not None]
    tgrads[0] = tgrads[0].permute(0, 2, 3, 1)  # dx back to NHWC
    tgrads[1] = tgrads[1][:, 0].permute(1, 2, 0)  # dw back to [7,7,C]
    for got, want in zip(tgrads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


def test_cpu_calls_do_not_count_launches(rng):
    targs = _to_torch(rng.standard_normal((1, 8, 8, 4)).astype(np.float32),
                      *_args(rng, 1, 4))
    before = convnext_front.launches
    convnext_front(*targs)
    assert convnext_front.launches == before


@pytest.mark.parametrize("case", ["dtype", "channels", "weight", "layout", "wide_param"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(case):
    """The kernel's argument checks run before any CUDA call."""
    c = front_mod.MAX_CHANNELS + 1 if case == "channels" else 8
    dt = torch.float64 if case == "dtype" else torch.float32
    x = torch.zeros(1, c, 4, 4, dtype=dt)
    if case != "layout":
        x = x.contiguous(memory_format=torch.channels_last)
    w = torch.zeros(c, 1, 5 if case == "weight" else 7, 7, dtype=dt)
    vec = torch.zeros(c, dtype=torch.float64 if case == "wide_param" else dt)
    with pytest.raises((TypeError, ValueError)):
        front_mod._launch(x, w, vec, None, vec, vec, True, 1e-5)
