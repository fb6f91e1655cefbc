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
