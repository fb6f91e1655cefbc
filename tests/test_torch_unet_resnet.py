"""colddiff_torch UnetResNet == colddiff's Flax UnetResNet, same weights.

``ch=32, ch_mult=(1, 2)``, one res block, 16 px, attention at 8 px.  The
weights fill the parameter tree of Flax ``model.init`` (its structure from
``jax.eval_shape``, its values from a seeded numpy generator) and cross over
through ``resnet_state_dict_from_flax``.

Tolerances:
  - fp64, 1e-9: pins the architecture.  The time embedding is fp32 by
    design on both sides, and XLA's and torch's fp32 sin/cos differ by up
    to an ulp (ROADMAP.md section 3), so the port is fed the embedding the
    JAX program computed; the embedding itself is compared at fp32 rounding;
  - fp32, rtol 2e-4 / atol 2e-5: the two frameworks' fp32 summation orders
    through ~20 layers, as for the ConvNeXt UNet;
  - bf16, both under the ``bf16_params`` recipe (parameters and input cast
    to bf16): rel L2 3e-2 against the JAX bf16 output.  The frameworks round
    at other places: torch's silu and GroupNorm round once where XLA rounds
    sigmoid and product apart, and the convs accumulate in other orders.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from colddiff import utils as jutils
from colddiff.models import UnetResNet as JUnetResNet
from colddiff.models import layers as jlayers
from colddiff.models import unet_resnet as junet_resnet
from colddiff.models.get_model import get_model as jget_model
from colddiff.models.import_torch import import_unet_resnet
from colddiff_torch.models import UnetConvNext, UnetResNet, get_model, layers
from colddiff_torch.models import unet_resnet
from colddiff_torch.models.convert import (
    load_reference_checkpoint,
    resnet_state_dict_from_flax,
    state_dict_from_flax,
)
from tests.test_import_torch import _synth_resnet_sd
from tests.test_import_torch_full import _t, _t_ddpm_emb, torch_unet_resnet

CFG = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=16)
RES = CFG["resolution"]


def flax_resnet_params(seed=0, **cfg):
    """A Flax UnetResNet parameter tree of numpy fp32 arrays: kernels
    N(0, 1/fan_in), biases and GroupNorm offsets N(0, 0.1^2), GroupNorm
    scales 1 + N(0, 0.1^2)."""
    model = JUnetResNet(**{**CFG, **cfg})
    tree = jax.eval_shape(model.init, jax.random.key(0), jnp.zeros((1, RES, RES, 3)),
                          jnp.zeros((1,), jnp.int32))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        shape, name = leaf.shape, path[-1].key
        z = rng.standard_normal(shape)
        if name == "kernel":
            z = z / np.sqrt(np.prod(shape[:-1]))
        else:
            z = z * 0.1 + (1.0 if name == "scale" else 0.0)
        return z.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs several test processes on the machine's cores: one
    torch thread each keeps these small CPU ops from oversubscribing them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flax_params():
    return flax_resnet_params()


def _inputs(dtype=np.float64):
    rng = np.random.default_rng(42)
    return rng.uniform(-1.0, 1.0, (2, RES, RES, 3)).astype(dtype), np.asarray([3, 150], np.int32)


def _port(params, dtype, **cfg):
    model = UnetResNet(**{**CFG, **cfg})
    model.load_state_dict(resnet_state_dict_from_flax(params), strict=True)
    return model.to(dtype).eval()


def test_forward_matches_flax_fp64(flax_params, monkeypatch):
    """JAX runs op by op (no jit), so the embedding computed here is the one
    its forward used."""
    x, t = _inputs()
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), flax_params)
        want = np.asarray(JUnetResNet(**CFG).apply(p64, jnp.asarray(x), jnp.asarray(t)))
        emb = np.asarray(junet_resnet.timestep_embedding(jnp.asarray(t), CFG["ch"]))
    monkeypatch.setattr(unet_resnet, "timestep_embedding", lambda tt, dim: torch.tensor(emb))
    port = _port(flax_params, torch.float64)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("cfg", [{}, {"with_time_emb": False}, {"resamp_with_conv": False}])
def test_forward_matches_flax_fp32(flax_params, cfg):
    x, t = _inputs(np.float32)
    params = flax_resnet_params(**cfg) if cfg else flax_params
    model = JUnetResNet(**{**CFG, **cfg})
    want = np.asarray(jax.jit(model.apply)(params, jnp.asarray(x), jnp.asarray(t)))
    port = _port(params, torch.float32, **cfg)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t).long()).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)


def test_forward_matches_flax_bf16(flax_params):
    x, t = _inputs(np.float32)
    pb = jutils.bf16_params(jax.tree_util.tree_map(jnp.asarray, flax_params))
    want = jax.jit(JUnetResNet(**CFG).apply)(pb, jnp.asarray(x, jnp.bfloat16), jnp.asarray(t))
    want = np.asarray(want.astype(jnp.float32), np.float64)
    port = _port(flax_params, torch.bfloat16)
    with torch.no_grad():
        got = port(torch.from_numpy(x).bfloat16(), torch.from_numpy(t).long())
    assert got.dtype == torch.bfloat16
    got = got.double().numpy()
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 3e-2


# ---------------------------------------------------------------------- #
# the layers alone


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 1e-5)])
@pytest.mark.parametrize("swish", [True, False])
def test_group_norm_swish_matches_jax(rng, dtype, tol, swish):
    x = rng.standard_normal((2, 5, 6, 64)).astype(dtype) * 3 + 1
    g = (1 + 0.1 * rng.standard_normal(64)).astype(dtype)
    b = (0.1 * rng.standard_normal(64)).astype(dtype)
    with jax.enable_x64(dtype == "float64"):
        want = np.asarray(jlayers.group_norm_swish(jnp.asarray(x), jnp.asarray(g),
                                                   jnp.asarray(b), 32, 1e-6, swish))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    got = layers.group_norm_swish(xt, torch.from_numpy(g), torch.from_numpy(b), 32, 1e-6,
                                  swish)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=tol, atol=tol)


def test_group_norm_casts_before_the_affine():
    """bf16: the normalized value is rounded to bf16, then scaled and
    shifted in bf16, as in the JAX package."""
    x = torch.randn(2, 64, 4, 4, generator=torch.Generator().manual_seed(0)).bfloat16()
    g, b = torch.full((64,), 1.37).bfloat16(), torch.full((64,), 0.11).bfloat16()
    got = layers.group_norm_swish(x, g, b, 32, swish=False)
    xn = torch.nn.functional.group_norm(x.float(), 32, eps=1e-6).bfloat16()
    assert got.dtype == torch.bfloat16 and torch.equal(got, xn * g.view(1, -1, 1, 1)
                                                       + b.view(1, -1, 1, 1))


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12), ("float32", 2e-5)])
def test_softmax_attention_matches_flax(rng, dtype, tol):
    x = rng.standard_normal((2, 4, 4, 64)).astype(dtype)
    jmod = jlayers.SoftmaxAttention()
    params = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.key(1),
                                                          jnp.asarray(x, jnp.float32)))
    mod = layers.SoftmaxAttention(64)
    sd = resnet_state_dict_from_flax({"mid_attn": params["params"]})
    mod.load_state_dict({k[len("mid.attn_1."):]: v for k, v in sd.items()}, strict=True)
    with jax.enable_x64(dtype == "float64"):
        p = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), params)
        want = np.asarray(jmod.apply(p, jnp.asarray(x)))
    mod = mod.to(getattr(torch, dtype))
    with torch.no_grad():
        got = mod(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("dim", [32, 33])
def test_timestep_embedding_matches_jax_to_fp32_rounding(dim):
    """Odd dims pad one zero column; sin/cos differ by at most an fp32 ulp
    of the angle (ROADMAP.md section 3)."""
    t = np.arange(0, 1000, 7, dtype=np.int32)
    want = np.asarray(junet_resnet.timestep_embedding(jnp.asarray(t), dim))
    got = unet_resnet.timestep_embedding(torch.from_numpy(t), dim)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_swish_matches_jax(rng):
    x = rng.standard_normal(1000).astype(np.float32) * 4
    np.testing.assert_allclose(layers.swish(torch.from_numpy(x)).numpy(),
                               np.asarray(jlayers.swish(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------- #
# dropout


def test_dropout_with_flax_masks_matches_flax(monkeypatch):
    """A training forward at p = 0.5: the port, given the keep masks of
    Flax's Dropout modules in call order, matches Flax's output."""
    params = flax_resnet_params(seed=4)
    x, t = _inputs(np.float32)
    model = JUnetResNet(**CFG, dropout=0.5)
    want, state = jax.jit(lambda p, xx, tt: model.apply(
        p, xx, tt, train=True, rngs={"dropout": jax.random.key(9)},
        capture_intermediates=lambda m, _: isinstance(m, fnn.Dropout)))(
            params, jnp.asarray(x), jnp.asarray(t))
    outs = [np.asarray(state["intermediates"][name]["Dropout_0"]["__call__"][0])
            for name in _call_order()]
    masks = [torch.from_numpy(o != 0).permute(0, 3, 1, 2) for o in outs]
    assert 0.4 < np.mean([m.float().mean() for m in masks]) < 0.6
    pending = list(masks)
    monkeypatch.setattr(layers, "_keep_mask", lambda h, p, g: pending.pop(0))
    port = _port(params, torch.float32, dropout=0.5).train()
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(t).long(),
                   generator=torch.Generator().manual_seed(0))
    assert not pending
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-5)


def _call_order():
    """The Flax ResnetBlocks of CFG in forward order (each has one Dropout)."""
    names = ["down_0_block_0", "down_1_block_0", "mid_block1", "mid_block2"]
    for i in (1, 0):
        names += [f"up_{i}_block_{j}" for j in range(2)]
    return names


def test_dropout_draws_only_from_its_generator():
    x = torch.randn(2, RES, RES, 3, generator=torch.Generator().manual_seed(1))
    t = torch.tensor([1, 2])
    model = UnetResNet(**CFG, dropout=0.3).train()
    with pytest.raises(ValueError, match="generator"):
        model(x, t)
    torch.manual_seed(0)
    runs = [model(x, t, generator=torch.Generator().manual_seed(s)) for s in (5, 5, 6)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    torch.manual_seed(1)  # the global stream plays no part
    assert torch.equal(model(x, t, generator=torch.Generator().manual_seed(5)), runs[0])
    model.eval()
    assert torch.equal(model(x, t), model(x, t, generator=torch.Generator().manual_seed(5)))
    # p = 0 draws nothing: training needs no generator
    assert UnetResNet(**CFG, dropout=0.0).train()(x, t).shape == x.shape


def test_dropout_keeps_flax_semantics():
    x = torch.randn(4, 8, 16, 16).contiguous(memory_format=torch.channels_last)
    out = layers.dropout(x, 0.25, True, torch.Generator().manual_seed(2))
    keep = out != 0
    assert torch.equal(out[keep], x[keep] / 0.75)
    assert 0.7 < keep.float().mean().item() < 0.8
    assert out.is_contiguous(memory_format=torch.channels_last)
    assert layers.dropout(x, 0.25, False, None) is x


# ---------------------------------------------------------------------- #
# weights and get_model


def test_state_dict_round_trips_and_loads_reference_names():
    sd = _synth_resnet_sd(CFG["ch"], CFG["ch_mult"], 1, CFG["attn_resolutions"], RES)
    params = import_unet_resnet(sd, CFG["ch"], CFG["ch_mult"], 1, CFG["attn_resolutions"], RES)
    for back in (resnet_state_dict_from_flax(params), state_dict_from_flax(params)):
        assert set(back) == set(sd)
        for k, v in sd.items():
            np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)
    UnetResNet(**CFG).load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                                      strict=True)


def test_reference_state_dict_matches_reference_forward(monkeypatch):
    """A reference-named state dict loads with no conversion and runs as the
    functional transcription of the reference ``Model.forward``
    (tests/test_import_torch_full.py), fed that transcription's embedding."""
    sd = _synth_resnet_sd(CFG["ch"], CFG["ch_mult"], 1, CFG["attn_resolutions"], RES)
    sd = {k: v * 0.2 if v.ndim >= 2 else v for k, v in sd.items()}
    x, t = _inputs()
    tt = torch.from_numpy(t).long()
    want = torch_unet_resnet(_t(sd), torch.from_numpy(x).permute(0, 3, 1, 2), tt,
                             CFG["ch"], CFG["ch_mult"], 1, CFG["attn_resolutions"], RES)
    monkeypatch.setattr(unet_resnet, "timestep_embedding", _t_ddpm_emb)
    model = UnetResNet(**CFG).double().eval()
    model.load_state_dict(_t(sd), strict=True)
    with torch.no_grad():
        got = model(torch.from_numpy(x), tt)
    np.testing.assert_allclose(got.numpy(), want.permute(0, 2, 3, 1).numpy(),
                               rtol=1e-9, atol=1e-9)


def test_load_reference_checkpoint_keeps_resnet_tensors():
    sd = {k: torch.from_numpy(v) for k, v in
          _synth_resnet_sd(CFG["ch"], CFG["ch_mult"], 1, CFG["attn_resolutions"], RES).items()}
    blob = {"step": 3, "model": {f"module.denoise_fn.{k}": v for k, v in sd.items()},
            "ema": {f"module.{k}": v for k, v in sd.items()}}
    blob["model"]["module.gaussian_kernels.0.weight"] = torch.zeros(3, 1, 5, 5)
    for use_ema in (True, False):
        got = load_reference_checkpoint(blob, use_ema=use_ema)
        assert set(got) == set(sd)
        UnetResNet(**CFG).load_state_dict(got, strict=True)


def test_get_model_matches_jax_get_model():
    full = get_model("UnetResNet", dataset="cifar10")
    jfull = jget_model("UnetResNet", dataset="cifar10")
    tree = jax.eval_shape(jfull.init, jax.random.key(0), jnp.zeros((1, 32, 32, 3)),
                          jnp.zeros((1,), jnp.int32))
    want = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(tree))
    got = sum(p.numel() for p in full.parameters())
    assert got == want and 35_000_000 < got < 36_000_000
    assert (full.resolution, full.ch, full.num_res_blocks, full.attn_resolutions) == \
        (32, 128, 2, (16,))
    assert all(m.p == 0.1 for m in full.modules() if isinstance(m, unet_resnet.ResnetBlock))
    assert all(p.device.type == "cpu" for p in full.parameters())
    assert get_model("UnetResNet", dataset="celebA").resolution == 128
    assert get_model("UnetResNet", image_size=16, dropout=0.0).resolution == 16
    conv = get_model("UnetConvNext", dim=8, dim_mults=(1, 2))
    assert isinstance(conv, UnetConvNext)
    with pytest.raises(ValueError, match="unknown model"):
        get_model("Unet")


def test_convnext_accepts_and_ignores_a_generator():
    model = UnetConvNext(dim=8, dim_mults=(1, 2)).train()
    x, t = torch.zeros(1, 16, 16, 3), torch.tensor([2])
    with torch.no_grad():
        assert torch.equal(model(x, t), model(x, t, generator=torch.Generator()))


def test_rejects_a_wrong_resolution():
    with pytest.raises(ValueError, match="resolution"):
        UnetResNet(**CFG).eval()(torch.zeros(1, 8, 8, 3), torch.tensor([0]))
