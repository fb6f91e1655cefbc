"""colddiff_torch.ops.group_norm on the CPU: the autograd Function around the
GroupNorm-swish kernel (the kernel itself is held against the plain version
on the card, tests/test_torch_cuda.py).

On a CPU tensor the Function's forward is the plain version and its
backward recomputes through it, so both equal direct autograd through the
plain version bitwise.  ``_launch``'s refusals are checked here too: each
raises before anything reaches the card.
"""

import pytest
import torch

from colddiff_torch.models import UnetResNet
from colddiff_torch.ops import group_norm as gn


def _args(dtype, c=64, memory_format=torch.channels_last):
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn(2, c, 5, 6, generator=gen) * 3 + 1).to(dtype)
    gamma = (1 + 0.1 * torch.randn(c, generator=gen)).to(dtype)
    beta = (0.1 * torch.randn(c, generator=gen)).to(dtype)
    return x.contiguous(memory_format=memory_format), gamma, beta


@pytest.mark.parametrize("swish", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_recompute_backward_equals_direct_autograd(dtype, swish):
    args = _args(dtype)
    w = torch.randn(2, 64, 5, 6, generator=torch.Generator().manual_seed(1)).to(dtype)
    outs, grads = [], []
    for fn in (gn.group_norm_swish, gn.group_norm_swish_plain):
        leaves = [a.clone().requires_grad_() for a in args]
        y = fn(*leaves, 32, 1e-6, swish)
        (y.float() * w).sum().backward()
        outs.append(y.detach())
        grads.append([a.grad for a in leaves])
    assert torch.equal(*outs)
    for got, want in zip(*grads):
        assert torch.equal(got, want)


def test_cpu_calls_launch_nothing():
    model = UnetResNet(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,),
                       resolution=16, generator=torch.Generator().manual_seed(0)).eval()
    before = gn.group_norm_swish.launches, gn.group_norm_swish.row_sharded_calls
    with torch.no_grad():
        model(torch.rand(1, 16, 16, 3), torch.tensor([2]))
    assert (gn.group_norm_swish.launches, gn.group_norm_swish.row_sharded_calls) == before


@pytest.mark.parametrize("case,error,match", [
    ("nchw", ValueError, "channels_last"),
    ("float16", TypeError, "float32 or bfloat16"),
    ("groups", ValueError, "groups"),
    ("wide_gamma", TypeError, "wider"),
    ("c_not_in_vectors", ValueError, "multiple of 8"),
])
def test_launch_refuses_what_the_kernel_does_not_take(case, error, match):
    dtype = torch.float16 if case == "float16" else torch.bfloat16
    x, gamma, beta = _args(dtype, c=36 if case == "c_not_in_vectors" else 64,
                           memory_format=torch.contiguous_format if case == "nchw"
                           else torch.channels_last)
    groups = 24 if case == "groups" else 4
    if case == "wide_gamma":
        gamma = gamma.float()
    with pytest.raises(error, match=match):
        gn._launch(x, gamma, beta, groups, 1e-6, True)


def test_other_devices_raise():
    x, gamma, beta = (t.to("meta") for t in _args(torch.float32))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        gn.group_norm_swish(x, gamma, beta, 32)


def test_pairs_copies_only_what_the_kernel_cannot_read():
    """gamma and beta pass as they are when in x's dtype, contiguous and at
    an even element; otherwise a fresh contiguous copy in x's dtype."""
    flat = torch.arange(129, dtype=torch.bfloat16)
    gamma = flat[:64]
    assert gn._pairs(gamma, torch.bfloat16) is gamma
    for t in (gamma.float(), flat[:128:2], flat[1:65]):
        got = gn._pairs(t, torch.bfloat16)
        assert got.dtype == torch.bfloat16 and got.is_contiguous()
        assert got.data_ptr() % 4 == 0 and torch.equal(got, t.to(torch.bfloat16))


def test_launch_check_is_cached_for_what_it_takes_and_raises_each_time():
    x, gamma, beta = _args(torch.bfloat16)
    vectors = tuple((n, type(t), t.shape, t.dtype, t.device)
                    for n, t in (("gamma", gamma), ("beta", beta)))
    gn._check.cache_clear()
    for _ in range(2):
        gn._check(type(x), x.shape, True, x.dtype, x.device, vectors, 4)
    assert (gn._check.cache_info().hits, gn._check.cache_info().currsize) == (1, 1)
    for _ in range(2):
        with pytest.raises(ValueError, match="channels_last"):
            gn._check(type(x), x.shape, False, x.dtype, x.device, vectors, 4)
    assert gn._check.cache_info().currsize == 1


def _per_image(dtype, c=64):
    """x, and a [B, C] gamma and beta: AdaGN's fold of a [C] affine with a
    per-image scale and shift, as ``models.unet_adm.ada_group_norm`` makes it."""
    x, gamma, beta = _args(torch.float32, c)
    gen = torch.Generator().manual_seed(5)
    scale, shift = 0.3 * torch.randn(2, c, generator=gen), 0.2 * torch.randn(2, c, generator=gen)
    return (x.to(dtype), (gamma * (1 + scale)).to(dtype),
            (beta * (1 + scale) + shift).to(dtype), (gamma, beta, scale, shift))


def test_plain_per_image_affine_equals_the_ada_chain():
    """GN * gamma + beta, then * (1 + scale) + shift, then SiLU (guided-diffusion's
    order), against the plain version with the folded [B, C] affine and
    against ADM's own call, in fp32: the fold moves a rounding or two."""
    from colddiff_torch.models.unet_adm import ada_group_norm

    x, gamma2, beta2, (gamma, beta, scale, shift) = _per_image(torch.float32)
    chain = torch.nn.functional.group_norm(x, 32, gamma, beta, 1e-5)
    chain = torch.nn.functional.silu(chain * (1 + scale[..., None, None])
                                     + shift[..., None, None])
    norm = torch.nn.GroupNorm(32, 64, eps=1e-5)
    with torch.no_grad():
        norm.weight.copy_(gamma)
        norm.bias.copy_(beta)
    for got in (gn.group_norm_swish_plain(x, gamma2, beta2, 32, 1e-5, True),
                ada_group_norm(x, norm, scale, shift)):
        torch.testing.assert_close(got, chain, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("swish", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_per_image_affine_recompute_backward_equals_direct_autograd(dtype, swish):
    args = _per_image(dtype)[:3]
    w = torch.randn(2, 64, 5, 6, generator=torch.Generator().manual_seed(1)).to(dtype)
    outs, grads = [], []
    for fn in (gn.group_norm_swish, gn.group_norm_swish_plain):
        leaves = [a.clone().requires_grad_() for a in args]
        y = fn(*leaves, 32, 1e-6, swish)
        (y.float() * w).sum().backward()
        outs.append(y.detach())
        grads.append([a.grad for a in leaves])
    assert torch.equal(*outs)
    assert grads[0][1].shape == (2, 64)
    for got, want in zip(*grads):
        assert torch.equal(got, want)


@pytest.mark.parametrize("gamma_shape,beta_shape,match", [
    ((3, 64), (3, 64), r"\(2, 64\)"),
    ((2, 64), (64,), "both"),
])
def test_launch_refuses_an_affine_of_another_batch_or_mixed_shapes(gamma_shape, beta_shape,
                                                                    match):
    x, _, _ = _args(torch.bfloat16)
    gamma, beta = torch.ones(gamma_shape, dtype=x.dtype), torch.zeros(beta_shape, dtype=x.dtype)
    with pytest.raises(ValueError, match=match):
        gn._launch(x, gamma, beta, 32, 1e-6, True)


def test_launch_check_takes_a_per_image_affine():
    x, gamma, beta = _per_image(torch.bfloat16)[:3]
    vectors = tuple((n, type(t), t.shape, t.dtype, t.device)
                    for n, t in (("gamma", gamma), ("beta", beta)))
    gn._check(type(x), x.shape, True, x.dtype, x.device, vectors, 32)
