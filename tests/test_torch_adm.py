"""colddiff_torch.models.UnetADM on the CPU: guided-diffusion's ADM against the
benchmark's plain fp32 reference (``benchmark/reference/adm.py``) on one
seeded state dict, its module names, its published size, its entry points
(``get_model``, a ``Trainer`` step, a sample), its GroupNorm calls, and its
refusal to run row-sharded."""

from unittest import mock

import pytest
import torch

from benchmark.common import make_pool, make_weights
from benchmark.reference import adm as ref_adm
from colddiff_torch.models import UnetADM, get_model
from colddiff_torch.ops import group_norm as gn
from colddiff_torch.parallel import spatial

PUBLISHED_PARAMETERS = 552_807_171  # 256x256_diffusion_uncond with 3 output channels


TINY = dict(image_size=16, in_channels=3, model_channels=32, out_channels=3,
            num_res_blocks=1, attention_resolutions=(8,), channel_mult=(1, 2),
            num_head_channels=16)


def _pair(seed=3):
    """The port and the reference holding one seeded state dict, the norms'
    scales and offsets drawn too, so that the affine shows."""
    flags = TINY
    ref = ref_adm.UnetADM(**flags)
    weights = make_weights(ref, seed, "cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    for name, w in weights.items():
        if ".norm." in name or "layers.0." in name or name.startswith("out.0."):
            base = 1.0 if name.endswith("weight") else 0.0
            weights[name] = base + 0.2 * torch.randn(w.shape, generator=gen)
    ref.load_state_dict(weights)
    port = UnetADM(**flags)
    port.load_state_dict(weights)
    return port, ref


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_port_matches_reference_output_and_gradients(seed):
    port, ref = _pair(seed)
    x = make_pool(7, 3, 16, 3, "cpu")
    t = torch.tensor([0, 57, 199])
    w = torch.randn(3, 16, 16, 3, generator=torch.Generator().manual_seed(9))
    outs = []
    for model in (port, ref):
        out = model(x, t)
        (out * w).sum().backward()
        outs.append(out.detach())
    got, want = outs
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    # each leaf's gradient gap over the larger of its reference norm and the
    # median leaf's (the benchmark's grad_diff): a conv bias in front of a
    # GroupNorm has a gradient of cancellation alone, ~1e-6 of the others
    ref_grads = dict(ref.named_parameters())
    pairs = [(name, p.grad, ref_grads[name].grad) for name, p in port.named_parameters()]
    assert all(g is not None and r is not None for _, g, r in pairs)
    floor = torch.stack([r.norm() for _, _, r in pairs]).median()
    for name, g, r in pairs:
        assert (g - r).norm() <= 1e-4 * torch.maximum(r.norm(), floor), name


def test_state_dict_names_and_shapes_equal_the_reference():
    port, ref = _pair()
    assert ({n: p.shape for n, p in port.state_dict().items()}
            == {n: p.shape for n, p in ref.state_dict().items()})
    assert list(port.state_dict()) == list(ref.state_dict())


def test_published_preset():
    with torch.device("meta"):
        model = get_model("UnetADM", image_size=256, channels=3)
    assert sum(p.numel() for p in model.parameters()) == PUBLISHED_PARAMETERS
    heads = [m.heads for m in model.modules() if hasattr(m, "heads")]
    assert heads == [8, 8, 16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 8, 8, 8]


@pytest.mark.parametrize("kwargs", [dict(image_size=128), dict(image_size=256, residual=True)])
def test_get_model_refuses_another_preset(kwargs):
    with pytest.raises(ValueError, match="256"):
        get_model("UnetADM", **kwargs)


def test_row_sharded_forward_raises():
    port, _ = _pair()
    token = spatial._SPACE.set(spatial.Rows(None, 0, 2))
    try:
        with pytest.raises(ValueError, match="row-sharded"):
            port(torch.zeros(1, 8, 16, 3), torch.tensor([1]))
    finally:
        spatial._SPACE.reset(token)


def _norm_calls(model, x, t):
    """(pixels, channels, per-image affine, swish) of each GroupNorm call of
    one forward, in order; on the meta device the call returns an empty
    tensor of the output's shape."""
    calls = []
    plain = gn.group_norm_swish

    def record(x, gamma, beta, num_groups, eps=1e-6, swish=True):
        calls.append((x.shape[2] * x.shape[3], x.shape[1], gamma.dim() == 2, swish))
        assert (num_groups, eps) == (32, 1e-5)
        return torch.empty_like(x) if x.is_meta else plain(x, gamma, beta, num_groups, eps,
                                                             swish)

    with mock.patch.object(gn, "group_norm_swish", record), torch.no_grad():
        model(x, t)
    return calls


def test_group_norm_calls_of_a_tiny_forward():
    port, _ = _pair()
    calls = _norm_calls(port, torch.zeros(2, 16, 16, 3), torch.tensor([1, 2]))
    res_blocks = [m for m in port.modules() if type(m).__name__ == "ResBlock"]
    attention = [m for m in port.modules() if type(m).__name__ == "AttentionBlock"]
    assert len(calls) == 2 * len(res_blocks) + len(attention) + 1
    assert sum(c[2] for c in calls) == len(res_blocks)
    assert sum(not c[3] for c in calls) == len(attention)
    assert calls[-1] == (256, 32, False, True)


def test_group_norm_calls_of_the_published_forward():
    with torch.device("meta"):
        model = get_model("UnetADM", image_size=256)
        calls = _norm_calls(model, torch.zeros(1, 256, 256, 3), torch.tensor([5]))
    assert (len(calls), sum(c[2] for c in calls)) == (101, 42)
    assert sum(hw * c for hw, c, _, _ in calls) == 400_228_352
    assert max(c for _, c, _, _ in calls) == 2048


def test_one_train_step_and_a_sample(tmp_path):
    from colddiff_torch import sampling
    from colddiff_torch.diffusion import ColdDiffusion
    from colddiff_torch.operators import get_operator
    from colddiff_torch.train import Trainer

    port, _ = _pair()
    op = get_operator("blur", device="cpu", timesteps=4, image_size=16,
                      blur_routine="Exponential_reflect", kernel_size=5, kernel_std=0.1)
    d = ColdDiffusion(op=op, image_size=16, channels=3, loss_type="l1",
                      train_routine="Final", sampling_routine="x0_step_down")
    pool = make_pool(11, 8, 16, 3, "cpu").numpy()
    tr = Trainer(d, port, pool, train_batch_size=2, gradient_accumulate_every=2, num_workers=0,
                 results_folder=str(tmp_path), device="cpu")
    before = [p.detach().clone() for p in tr.model.parameters()]
    loss = tr.train_step(tr._next_superbatch())
    assert torch.isfinite(loss) and tr.step == 1
    assert any(not torch.equal(a, b) for a, b in zip(before, tr.model.parameters()))
    clean = torch.from_numpy(pool[:2])
    with torch.no_grad():
        res = sampling.sample(d, lambda x, t: tr.model.eval()(x, t),
                              sampling.prepare_start(d, clean), t=2)
    assert res.img.shape == (2, 16, 16, 3) and torch.isfinite(res.img).all()
