"""The plain reference against the port at a small size, with one state
dict, and the reference's independence from the port and the JAX package."""

import subprocess
import sys

import pytest
import torch

from benchmark import common
from benchmark.reference import diffusion as ref_diffusion
from benchmark.reference import models as ref_models
from benchmark.reference import precision

SMALL = {
    "UnetConvNext": {"model": {"family": "UnetConvNext", "dim": 8, "dim_mults": [1, 2, 4]},
                     "image_size": 16, "channels": 3},
    "UnetResNet": {"model": {"family": "UnetResNet", "ch": 32, "ch_mult": [1, 2],
                             "num_res_blocks": 1, "attn_resolutions": [8], "dropout": 0.1},
                   "image_size": 16, "channels": 3},
}


def _pair(family: str, seed: int = 5):
    config = SMALL[family]
    ref = ref_models.build(config)
    weights = common.make_weights(ref, seed, "cpu")
    ref.load_state_dict(weights)
    return ref, common.port_model(config, weights, "cpu").eval(), config


@pytest.mark.parametrize("family", sorted(SMALL))
def test_reference_unet_matches_port(family):
    ref, port, config = _pair(family)
    x = common.make_pool(3, 4, config["image_size"], 3, "cpu")
    t = torch.tensor([0, 3, 17, 49])
    with torch.no_grad():
        want, got = port(x, t), ref(x, t)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("routine,size,std", [("Exponential_reflect", 15, 0.01),
                                              ("Special_6_routine", 3, 0.1)])
def test_reference_blur_matrices_match_port(routine, size, std):
    from colddiff_torch.operators import get_operator

    deg = {"blur_routine": routine, "time_steps": 20, "blur_size": size, "blur_std": std}
    op = get_operator("blur", device="cpu", timesteps=20, image_size=32, blur_routine=routine,
                      kernel_size=size, kernel_std=std)
    assert torch.equal(ref_diffusion.blur_matrices(deg, 32, "cpu"), op.cum)


def test_reference_sampler_matches_port():
    from colddiff_torch import sampling

    ref, port, config = _pair("UnetResNet")
    config = dict(config, loss_type="l1", train_routine="Final", sampling_routine="x0_step_down",
                  degradation={"kind": "blur", "blur_routine": "Special_6_routine",
                               "time_steps": 6, "blur_size": 3, "blur_std": 0.1})
    d = common.port_diffusion(config, "cpu")
    clean = common.make_pool(4, 3, 16, 3, "cpu")
    res = sampling.sample(d, lambda x, t: port(x, t), sampling.prepare_start(d, clean))
    cum = ref_diffusion.blur_matrices(config["degradation"], 16, "cpu")
    with torch.no_grad():
        xt, direct, img = ref_diffusion.x0_step_down(ref, cum, clean)
    for got, want in ((xt, res.xt), (direct, res.direct_recons), (img, res.img)):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_reference_adam_and_ema_match_torch():
    params = [torch.randn(5, 3, generator=torch.Generator().manual_seed(i)) for i in range(2)]
    mine = [p.clone() for p in params]
    theirs = [torch.nn.Parameter(p.clone()) for p in params]
    opt = torch.optim.Adam(theirs, lr=2e-5)
    adam = ref_diffusion.Adam(mine, 2e-5)
    for k in range(3):
        grads = [torch.randn(5, 3, generator=torch.Generator().manual_seed(10 + k + i))
                 for i in range(2)]
        for p, g in zip(theirs, grads):
            p.grad = g.clone()
        opt.step()
        adam.step(grads)
    for a, b in zip(mine, theirs):
        assert torch.allclose(a, b.detach(), rtol=0, atol=1e-9)
    shadow = [torch.zeros(2)]
    ref_diffusion.ema(shadow, [torch.ones(2)], 10, 0.995, 10, 2000)
    assert torch.equal(shadow[0], torch.ones(2))
    ref_diffusion.ema(shadow, [torch.zeros(2)], 2010, 0.995, 10, 2000)
    assert torch.allclose(shadow[0], torch.full((2,), 0.995))


def test_control_roundings():
    x = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, -3.0])
    rounded = torch.tensor([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -3.0])
    assert torch.equal(precision.tf32(x), rounded)
    y = torch.tensor([448.0, 1.0, 0.5, 0.3])
    assert torch.equal(precision.fp8(y)[:3], y[:3])
    assert precision.fp8(y)[3] != y[3]
    g = torch.tensor([0.3, 7.0], requires_grad=True)
    precision.fp8(g).sum().backward()
    assert torch.equal(g.grad, torch.ones(2))  # straight through


def test_reference_loads_nothing_of_the_program():
    """Neither the reference nor each configuration's family, resolved and
    built, loads the port or the JAX stack."""
    code = ("import json, sys, torch; sys.path.insert(0, sys.argv[1]); import benchmark.reference\n"
            "for f in sys.argv[2:]:\n"
            "    with torch.device('meta'): benchmark.reference.models.build(json.load(open(f)))\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    configs = sorted(str(f) for f in (common.BENCH / "configs").glob("*.json"))
    assert configs
    out = subprocess.run([sys.executable, "-c", code, str(common.ROOT), *configs],
                         capture_output=True, text=True, check=True).stdout
    loaded = set(eval(out))
    assert not loaded & {"colddiff_torch", "colddiff", "jax", "jaxlib", "flax"}
