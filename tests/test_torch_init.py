"""A freshly built port UNet draws its parameters from the JAX package's
initial distribution: Flax's defaults, ``lecun_normal`` weights and zero
biases (``colddiff_torch.models.layers.init_as_flax``).

For each family at a test width (``UnetConvNext(16, (1, 2))`` and a
``UnetResNet(ch=32, (1, 2))`` with one res block and attention at 16 px,
both at 32 px) the JAX model's
``model.init(key(s))`` is converted with ``state_dict_from_flax`` and held,
parameter by parameter, against the port model built with
``generator=torch.Generator().manual_seed(s)``.  The draws cannot match
(threefry against torch's generator), so the check is of the distribution:

  - biases and the norms' scales and offsets equal JAX's exactly;
  - no weight exceeds the truncation, 2 / 0.8796 / sqrt(fan_in) (fp32
    rounding: a factor 1 + 1e-6), fan_in read off the Flax kernel's shape;
  - each weight tensor of >= 1,024 entries has a std within 10% relative
    of the JAX tensor's (the two stds' sampling error is ~2.6% at 1,024
    entries: a truncated normal's std estimate has a relative SE of
    sqrt((kurtosis - 1) / 4n) ~ 1.8% each);
  - the pooled w * sqrt(fan_in) of all weights passes a two-sample KS test
    against JAX's pooled values at p >= 1e-3 (seeds fixed).

The same check on a copy of torch's default rule (the parent's: every
conv and linear's ``reset_parameters``) fails on biases, stds and the KS
test.  The CLI's ``--seed`` and the record twins' ``seed=`` give seeded,
reproducible weights by the rule.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import special, stats

from colddiff.models import UnetConvNext as JUnetConvNext
from colddiff.models import UnetResNet as JUnetResNet
from colddiff_torch.cli import main as pcli
from colddiff_torch.models import UnetConvNext, UnetResNet, get_model, layers
from colddiff_torch.models.convert import state_dict_from_flax
from colddiff_torch.scripts import family_b_generation

SIZE = 32
TRUNC = 0.87962566103423978  # std of a unit normal cut at +-2
BOUND = 2.0 / TRUNC  # the cut of w * sqrt(fan_in)
STD_RTOL = 0.10
KS_P = 1e-3
MIN_STD_N = 1024
FAMILIES = {
    "convnext": (lambda **kw: UnetConvNext(dim=16, dim_mults=(1, 2), **kw),
                 lambda: JUnetConvNext(dim=16, dim_mults=(1, 2))),
    "resnet": (lambda **kw: UnetResNet(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                                       attn_resolutions=(16,), resolution=SIZE, **kw),
               lambda: JUnetResNet(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                                   attn_resolutions=(16,), resolution=SIZE)),
}
SEEDS = {"convnext": 0, "resnet": 1}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs several test processes on the machine's cores: one
    torch thread each keeps these small CPU ops from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_init(family: str):
    """JAX's ``model.init(key(s))`` as a torch state dict, and each weight's
    fan_in read off its Flax kernel: a tree whose kernels hold their own
    prod(shape[:-1]), converted the same way.  The init is compiled at
    XLA's backend optimization level 0, which takes ~40% less time to
    compile its ~100 truncated-normal draws; the draws are the same
    distribution's."""
    args = (jax.random.key(SEEDS[family]), jnp.zeros((1, SIZE, SIZE, 3)),
            jnp.zeros((1,), jnp.int32))
    init = jax.jit(FAMILIES[family][1]().init).lower(*args).compile(
        {"xla_backend_optimization_level": 0})
    params = init(*args)["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    fans = jax.tree_util.tree_map_with_path(
        lambda path, a: np.full(a.shape, np.prod(a.shape[:-1]) if path[-1].key == "kernel"
                                else 0, np.float32), params)
    fan = {k: int(v.flatten()[0]) for k, v in state_dict_from_flax(fans).items()
           if v.flatten()[0] > 0}
    return state_dict_from_flax(params), fan


@pytest.fixture(scope="module")
def jax_inits():
    """Each family's JAX init, made once for the module."""
    return {family: _jax_init(family) for family in FAMILIES}


def rule_misses(port: dict, ref: dict, fan: dict) -> list:
    """What of ``port`` (a state dict) leaves JAX's initial distribution,
    held against ``ref`` (JAX's init, converted) with ``fan`` the weights'
    fan_in; empty when it keeps the rule."""
    assert sorted(port) == sorted(ref)
    misses, pooled_port, pooled_ref = [], [], []
    for name, want in ref.items():
        got = port[name].detach().float()
        if name not in fan:
            if not torch.equal(got, want):
                misses.append(f"{name}: not JAX's (max |diff| "
                              f"{(got - want).abs().max().item():.3g})")
            continue
        scale = math.sqrt(fan[name])
        if got.abs().max().item() * scale > BOUND * (1 + 1e-6):
            misses.append(f"{name}: |w| sqrt(fan_in) {got.abs().max().item() * scale:.4f} "
                          f"> {BOUND:.4f}")
        if got.numel() >= MIN_STD_N:
            rel = got.std().item() / want.std().item() - 1.0
            if abs(rel) > STD_RTOL:
                misses.append(f"{name}: std {rel:+.1%} of JAX's")
        pooled_port.append(got.flatten().numpy() * scale)
        pooled_ref.append(want.flatten().numpy() * scale)
    p = stats.ks_2samp(np.concatenate(pooled_port), np.concatenate(pooled_ref)).pvalue
    if p < KS_P:
        misses.append(f"pooled KS p {p:.3g} < {KS_P}")
    return misses


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_fresh_model_draws_from_jax_distribution(jax_inits, family):
    ref, fan = jax_inits[family]
    model = FAMILIES[family][0](generator=torch.Generator().manual_seed(SEEDS[family]))
    assert rule_misses(model.state_dict(), ref, fan) == []
    # the port's fan_in is JAX's, the transposed conv's and the depthwise's too
    got = {f"{n}.weight": layers._flax_fan_in(m) for n, m in model.named_modules()
           if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear))}
    assert got == fan
    if family == "convnext":
        assert fan["downs.0.1.ds_conv.weight"] == 49
        assert fan["ups.0.3.weight"] == 4 * 4 * 16  # Upsample(16): (4, 4, 16, 16)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_torch_default_rule_fails_the_check(jax_inits, family):
    """The parent's rule, torch's defaults, leaves the distribution: its
    biases are drawn, its weights' std is 1/sqrt(3) of JAX's."""
    ref, fan = jax_inits[family]
    model = FAMILIES[family][0]()
    torch.manual_seed(SEEDS[family])
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear)):
            m.reset_parameters()
    misses = rule_misses(model.state_dict(), ref, fan)
    assert any("bias" in m and "not JAX's" in m for m in misses)
    assert any("std -4" in m for m in misses)  # 1/sqrt(3) - 1 = -42%
    assert any("pooled KS" in m for m in misses)


def _weights(model) -> dict:
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _keeps_rule(sd: dict, model) -> None:
    """The rule held without a JAX twin: biases zero, norms one and zero,
    the truncation, and the pooled w * sqrt(fan_in) against the analytic
    truncated normal (one-sample KS, p >= 1e-3)."""
    fan = {f"{n}.weight": layers._flax_fan_in(m) for n, m in model.named_modules()
           if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d, torch.nn.Linear))}
    pooled = []
    for name, w in sd.items():
        if name in fan:
            pooled.append(w.flatten().numpy() * math.sqrt(fan[name]))
        elif name.endswith((".g", "norm1.weight", "norm2.weight", "norm.weight",
                            "norm_out.weight")):
            assert torch.equal(w, torch.ones_like(w)), name
        else:
            assert torch.equal(w, torch.zeros_like(w)), name
    pooled = np.concatenate(pooled)
    assert np.abs(pooled).max() <= BOUND * (1 + 1e-6)

    def cdf(x):  # w * sqrt(fan_in) * TRUNC is a unit normal cut at +-2
        lo = special.ndtr(-2.0)
        return (special.ndtr(x * TRUNC) - lo) / (1.0 - 2.0 * lo)

    # every 16th value: the CLI's ResNet has 35.7M
    assert stats.kstest(pooled[::16], cdf).pvalue >= KS_P


def test_generator_gives_bitwise_reproducible_weights():
    for family in FAMILIES:
        make = FAMILIES[family][0]
        a = _weights(make(generator=torch.Generator().manual_seed(5)))
        b = _weights(make(generator=torch.Generator().manual_seed(5)))
        c = _weights(make(generator=torch.Generator().manual_seed(6)))
        assert all(torch.equal(a[k], b[k]) for k in a), family
        assert not torch.equal(a["conv_out.weight" if family == "resnet"
                                  else "final_conv.1.weight"],
                               c["conv_out.weight" if family == "resnet"
                                 else "final_conv.1.weight"])
    a = get_model("UnetConvNext", dim=8, dim_mults=(1, 2),
                  generator=torch.Generator().manual_seed(5))
    b = UnetConvNext(dim=8, dim_mults=(1, 2), generator=torch.Generator().manual_seed(5))
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))


@pytest.mark.parametrize("model", ["UnetConvNext", "UnetResNet"])
def test_cli_seed_builds_by_the_rule(model):
    def build(seed):
        argv = ["train", "--dataset", "synthetic", "--image_size", "16", "--time_steps",
                "3", "--model", model, "--dim", "8", "--device", "cpu", "--seed", str(seed)]
        return pcli.build(pcli.build_parser().parse_args(argv))[1]

    net = build(3)
    a, b, c = _weights(net), _weights(build(3)), _weights(build(4))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
    _keeps_rule(a, net)


def test_record_trainer_seed_builds_by_the_rule(tmp_path):
    kw = dict(image_size=16, dim=8, dim_mults=(1, 2), n_data=4, device="cpu")
    a = family_b_generation.make_trainer(tmp_path / "a", seed=2, **kw)
    b = family_b_generation.make_trainer(tmp_path / "b", seed=2, **kw)
    c = family_b_generation.make_trainer(tmp_path / "c", seed=3, **kw)
    wa, wb, wc = _weights(a.model), _weights(b.model), _weights(c.model)
    assert all(torch.equal(wa[k], wb[k]) for k in wa)
    assert not all(torch.equal(wa[k], wc[k]) for k in wa)
    _keeps_rule(wa, a.model)
