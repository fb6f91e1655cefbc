"""The port's other training and sampling routines == colddiff's.

  - the noise routines (``Final_small_noise``, ``Final_random_mean``,
    ``Final_random_mean_and_actual``) with JAX's normals replayed: the port
    takes the draws of ``jax.random.normal`` on the key JAX's ``p_losses``
    is given.  A dim-8 UNet at (1, 2), blur T=8 at 16 px, fixed t.  As in
    ``tests/test_torch_train_loss.py``: rtol 1e-5 with an fp64 UNet (the
    degrade is fp32 by design, ROADMAP.md section 3), 1e-4 in fp32;
  - ``sample`` with ``Step``, ``Step_Gradient`` and ``Gradient_norm``
    models, on a Family-A and a Family-B operator, with ``refresh_every`` 1
    and 3 and trajectories.  These branches never degrade, so with an
    analytic fp64 denoiser both sides agree to 1e-9; with the fp32 UNet to
    1e-4 (its fp32 summation orders, as in ``tests/test_torch_sampling.py``);
  - ``sample_multi_step`` on blur, fade and the Family-B ``noise`` and
    ``fade_generation`` operators, with a fixed and an estimated endpoint,
    per-sample levels and an analytic fp64 denoiser: 1e-9 where no degrade
    runs (``Step``, ``Step_Gradient``), 1e-5 where the fp32 degrade does;
  - one ``Trainer`` step of ``UnetResNet`` (dropout 0; the masks are held
    against Flax's in ``tests/test_torch_unet_resnet.py``) from the JAX
    Trainer's state, with its t draws replayed, at the fp32 Trainer
    tolerances of ``tests/test_torch_train.py``; and the dropout generator.

Torch runs one thread in this file (a module fixture): the suite's test
processes share the machine's cores.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colddiff.data import datasets as jdatasets
from colddiff.diffusion import ColdDiffusion as JColdDiffusion
from colddiff.models import UnetResNet as JUnetResNet
from colddiff.operators import get_operator as jget_operator
from colddiff.parallel import make_mesh
from colddiff.sampling import sample as jsample
from colddiff.sampling import sample_multi_step as jsample_multi_step
from colddiff.train import Trainer as JTrainer
from colddiff_torch.data import datasets
from colddiff_torch.diffusion import ColdDiffusion
from colddiff_torch.models import UnetResNet, unet_resnet
from colddiff_torch.models.convert import train_state_from_flax
from colddiff_torch.operators import get_operator
from colddiff_torch.sampling import sample, sample_multi_step
from colddiff_torch.train import Trainer
from tests.test_torch_train import LR, _assert_fp32_params, _replayed_t
from tests.test_torch_train_loss import (
    BLUR,
    DIM,
    MULTS,
    T_FIXED,
    TOL,
    _diffusions,
    _jax_apply,
    _port_model,
)
from tests.test_torch_unet_convnext import flax_convnext_params

NOISE_ROUTINES = ("Final_small_noise", "Final_random_mean", "Final_random_mean_and_actual")
S = 16
OPS = {
    "blur": dict(BLUR),
    "fade": dict(image_size=S, timesteps=8, fade_routine="Incremental", kernel_std=0.2,
                 initial_mask=3),
    "noise": dict(timesteps=8),
    "fade_generation": dict(image_size=S, timesteps=8, kernel_std=0.3, initial_mask=2),
}


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
    return flax_convnext_params(DIM, MULTS, seed=7)


@pytest.fixture(scope="module")
def x_start():
    return np.random.default_rng(11).uniform(-1.0, 1.0, (3, S, S, 3))


def _jax_noise(routine, key, x):
    """The normals JAX's p_losses draws from ``key`` (colddiff/diffusion.py:
    97-109,134-140): [B, H, W, C] in the default float dtype for the small
    noise, [B, 1, 1, C] in x's dtype for a new mean."""
    if routine == "Final_small_noise":
        return np.asarray(jax.random.normal(key, x.shape))
    return np.asarray(jax.random.normal(key, (x.shape[0], 1, 1, x.shape[-1]), x.dtype))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("loss_type", ["l1", "l2", "sqrt"])
@pytest.mark.parametrize("routine", NOISE_ROUTINES)
def test_noise_routines_match_jax(flax_params, x_start, routine, loss_type, dtype):
    jd, d = _diffusions(routine, loss_type)
    x = x_start.astype(dtype)
    key = jax.random.key(17)
    with jax.enable_x64(dtype == "float64"):
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), flax_params)
        apply = _jax_apply(dtype)
        want = float(jd.p_losses(lambda xt, t: apply(params, xt, t), jnp.asarray(x),
                                 jnp.asarray(T_FIXED), rng=key))
        noise = _jax_noise(routine, key, jnp.asarray(x))
    model = _port_model(flax_params, dtype)
    with torch.no_grad():
        got = d.p_losses(lambda xt, t: model(xt.to(model.time_mlp[1].weight.dtype), t),
                         torch.from_numpy(x), torch.from_numpy(T_FIXED).long(),
                         noise=torch.tensor(noise)).item()
    np.testing.assert_allclose(got, want, rtol=TOL[dtype])


# ---------------------------------------------------------------------- #
# sampling Step / Step_Gradient / Gradient_norm models


def _jdenoise(x, t):
    """An analytic denoiser of correctly rounded operations only, in x's
    dtype, so both frameworks compute it to the last bit."""
    return x / (1.0 + x * x) + 0.003 * t.reshape(-1, 1, 1, 1).astype(x.dtype)


def _denoise(x, t):
    return x / (1.0 + x * x) + 0.003 * t.reshape(-1, 1, 1, 1).to(x.dtype)


def _pair(op_key, **kw):
    return (JColdDiffusion(op=jget_operator(op_key, **OPS[op_key]), image_size=S, **kw),
            ColdDiffusion(op=get_operator(op_key, **OPS[op_key], device="cpu"), image_size=S,
                          **kw))


def _images(seed, n=2):
    return np.random.default_rng(seed).uniform(-1.0, 1.0, (n, S, S, 3))


@pytest.mark.parametrize("op_key,routine,refresh", [
    ("blur", "x0_step_down", 1), ("blur", "x0_step_down", 3),
    ("noise", "ddim", 1), ("noise", "ddim", 3),
])
@pytest.mark.parametrize("train_routine", ["Step", "Step_Gradient", "Gradient_norm"])
def test_step_models_sample_like_jax(op_key, routine, refresh, train_routine):
    """Whatever the operator, these models step as trained; under
    refresh_every > 1 a Gradient_norm model reuses img - pred."""
    jd, d = _pair(op_key, train_routine=train_routine, sampling_routine=routine)
    x = _images(3)
    with jax.enable_x64(True):
        res = jax.jit(lambda img: jsample(jd, _jdenoise, img, trajectory=True,
                                          refresh_every=refresh))(jnp.asarray(x))
        want = [np.asarray(a) for a in (res.direct_recons, res.img, res.x0_trajectory,
                                        res.xt_trajectory)]
    res = sample(d, _denoise, torch.from_numpy(x), trajectory=True, refresh_every=refresh)
    for name, g, w in zip(("direct_recons", "img", "x0_trajectory", "xt_trajectory"),
                          (res.direct_recons, res.img, res.x0_trajectory, res.xt_trajectory),
                          want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-9, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("train_routine,refresh", [("Step_Gradient", 1), ("Gradient_norm", 3)])
def test_step_models_with_the_unet_match_jax(flax_params, train_routine, refresh):
    jd, d = _pair("blur", train_routine=train_routine, sampling_routine="x0_step_down")
    x = _images(4).astype(np.float32) * 0.1
    apply = _jax_apply("float32")
    # the output scaled by 0.1 keeps Step_Gradient's sum of 8 outputs O(1)
    res = jax.jit(lambda img: jsample(
        jd, lambda xt, t: 0.1 * apply(flax_params, xt, t), img, trajectory=True,
        refresh_every=refresh))(jnp.asarray(x))
    model = _port_model(flax_params, "float32").eval()
    got = sample(d, lambda xt, t: 0.1 * model(xt, t), torch.from_numpy(x), trajectory=True,
                 refresh_every=refresh)
    for g, w in ((got.img, res.img), (got.x0_trajectory, res.x0_trajectory)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)


def test_gradient_norm_keeps_img_minus_pred():
    """The JAX scan carries ``img - pred`` as its x0_hat for Gradient_norm
    (colddiff/sampling.py:77-79,159-178): it is direct_recons, the x0
    trajectory's frame, and, reused under refresh_every, the next step's
    prediction, so that step computes cur - (img_prev - pred)."""
    d = ColdDiffusion(op=get_operator("blur", **BLUR, device="cpu"), image_size=S,
                      train_routine="Gradient_norm", sampling_routine="x0_step_down")
    x0 = torch.from_numpy(_images(5))
    pred = torch.full_like(x0, 0.25)
    calls = []

    def denoise(x, t):
        calls.append(int(t[0]))
        return pred

    res = sample(d, denoise, x0, t=4, trajectory=True, refresh_every=2)
    x1 = x0 - pred  # step 0 calls the model
    x2 = x1 - (x0 - pred)  # step 1 reuses step 0's img - pred
    x3 = x2 - pred  # step 2 calls the model
    x4 = x3 - (x2 - pred)
    assert calls == [3, 1]
    assert torch.equal(res.direct_recons, x0 - pred)
    # each frame's x0_hat is its step's img - pred, the next state
    assert torch.equal(res.x0_trajectory, torch.stack([x1, x2, x3, x4]))
    assert torch.equal(res.xt_trajectory, torch.stack([x0, x1, x2, x3]))
    assert torch.equal(res.img, x4)


# ---------------------------------------------------------------------- #
# sample_multi_step


def _levels(seed, n, timesteps):
    rng = np.random.default_rng(seed)
    t_start = rng.integers(1, timesteps + 1, n)
    return t_start, np.array([rng.integers(0, s) for s in t_start])


@pytest.mark.parametrize("op_key,routine,train_routine,endpoint,tol", [
    ("blur", "x0_step_down", "Final", None, 1e-5),
    ("blur", "default", "Final", None, 1e-5),
    ("blur", "x0_step_down", "Gradient_norm", None, 1e-5),
    ("blur", "x0_step_down", "Step", None, 1e-9),
    ("blur", "x0_step_down", "Step_Gradient", None, 1e-9),
    ("fade", "x0_step_down", "Final", None, 1e-5),
    ("noise", "x0_step_down", "Final", "fixed", 1e-5),
    ("noise", "x0_step_down", "Final", "estimated", 1e-5),
    ("fade_generation", "ddim", "Final", "estimated", 1e-5),
])
def test_sample_multi_step_matches_jax(op_key, routine, train_routine, endpoint, tol):
    jd, d = _pair(op_key, train_routine=train_routine, sampling_routine=routine,
                  recon_noise_std=0.5)  # ignored, as in JAX
    x = _images(6, n=5)
    t_start, t_end = _levels(8, 5, d.num_timesteps)
    x_end = _images(7, n=5).astype(np.float32) if endpoint == "fixed" else None
    with jax.enable_x64(True):
        want = np.asarray(jsample_multi_step(
            jd, _jdenoise, jnp.asarray(x), jnp.asarray(t_start), jnp.asarray(t_end),
            x_end=None if x_end is None else jnp.asarray(x_end)))
    calls = []

    def denoise(xt, t):
        calls.append(t.clone())
        return _denoise(xt, t)

    got = sample_multi_step(d, denoise, torch.from_numpy(x), torch.from_numpy(t_start),
                            torch.from_numpy(t_end),
                            x_end=None if x_end is None else torch.from_numpy(x_end))
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    # the model sees the whole batch at max(level - 1, 0), until no sample is active
    assert len(calls) == (t_start - t_end).max()
    assert torch.equal(calls[0], torch.from_numpy(t_start - 1))


def test_sample_multi_step_oracle_ends_at_each_t_end():
    """With a perfect denoiser, Algorithm 2 telescopes per sample: each ends
    at the clean batch degraded to its own t_end (the clean image at 0)."""
    op = get_operator("blur", image_size=32, timesteps=50, blur_routine="Special_6_routine",
                      kernel_size=11, kernel_std=7, device="cpu")
    d = ColdDiffusion(op=op, image_size=32, sampling_routine="x0_step_down")
    clean = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (6, 32, 32, 3))
                             .astype(np.float32))
    t_start, t_end = (torch.from_numpy(a) for a in _levels(3, 6, 50))
    t_end[0] = 0
    start = op.degrade(clean, t_start)
    got = sample_multi_step(d, lambda xt, t: clean, start, t_start, t_end)
    want = op.degrade(clean, t_end)
    assert torch.equal(want[0], clean[0])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)
    assert got.is_inference()


# ---------------------------------------------------------------------- #
# the Trainer with the ResNet UNet

RESNET = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=S)
# one level (no resampling: the forward tests cover it) keeps the JAX
# Trainer's compile short
RESNET_ONE_LEVEL = dict(RESNET, ch_mult=(1,), attn_resolutions=(S,))
KW = dict(train_batch_size=2, gradient_accumulate_every=2, step_start_ema=2,
          update_ema_every=1, save_and_sample_every=10**9, num_workers=1, seed=0)


def _port_trainer(folder, dropout=0.0, routine="Final", cfg=RESNET, **kw):
    d = ColdDiffusion(op=get_operator("blur", **BLUR, device="cpu"), image_size=S,
                      sampling_routine="x0_step_down", train_routine=routine)
    return Trainer(d, UnetResNet(**cfg, dropout=dropout),
                   datasets.SyntheticDataset(S, 3, length=16), results_folder=str(folder),
                   device="cpu", **{**KW, **kw})


@pytest.fixture(scope="module")
def trainer(tmp_path_factory):
    """One port Trainer with a dropout ResNet, a batch and its first state,
    shared by the tests below: ``_from_start`` puts it back."""
    torch.manual_seed(0)
    tr = _port_trainer(tmp_path_factory.mktemp("resnet"), dropout=0.3)
    return tr, tr._next_superbatch(), copy.deepcopy(tr.state())


def _from_start(trainer, routine="Final"):
    tr, batch, blob = trainer
    tr.load_state(copy.deepcopy(blob))
    tr.diffusion = dataclasses.replace(tr.diffusion, train_routine=routine)
    return tr, batch


def test_resnet_trainer_steps_match_jax_trainer(tmp_path):
    d = JColdDiffusion(op=jget_operator("blur", **BLUR), image_size=S,
                       sampling_routine="x0_step_down")
    jtr = JTrainer(d, JUnetResNet(**RESNET_ONE_LEVEL, dropout=0.0),
                   jdatasets.SyntheticDataset(S, 3, length=16),
                   results_folder=str(tmp_path / "jax"), mesh=make_mesh(jax.devices()[:1]),
                   **KW)
    ptr = _port_trainer(tmp_path / "port", cfg=RESNET_ONE_LEVEL)
    names = [n for n, _ in ptr.model.named_parameters()]

    def blob():
        s = jax.device_get(jtr.state)
        return train_state_from_flax(s.params, s.ema_params, s.opt_state, int(s.step),
                                     param_names=names)

    ptr.load_state(blob())
    jbatch, _ = jtr._next_superbatch()
    t = _replayed_t(jtr.state.rng, BLUR["timesteps"])
    jtr.state, jloss = jtr._train_step(jtr.state, jtr.diffusion, jbatch, None)
    ploss = ptr.train_step(ptr._next_superbatch(), t=t)
    want = blob()
    assert ptr.step == want["step"] == 1
    np.testing.assert_allclose(ploss.item(), float(jloss), rtol=1e-5)
    # a tensor whose gradient is zero in exact arithmetic (a bias before a
    # GroupNorm of one channel a group, the key bias under the softmax) gets
    # rounding noise (|g| < 1e-7 here, against ~1e-3 for the others), which
    # Adam scales to a step anywhere within lr: such tensors are held to lr
    noise = {n for n, p in ptr.model.named_parameters() if p.grad.abs().max().item() < 1e-7}
    assert noise and len(noise) < len(names) // 3
    for part in ("model", "ema"):
        got = ptr.state()[part]
        _assert_fp32_params({n: got[n] for n in names if n not in noise},
                            {n: want[part][n] for n in names if n not in noise}, part)
        for n in noise:
            assert (got[n] - want[part][n]).abs().max().item() <= LR, f"{part} {n}"


def test_dropout_generator_is_its_own_stream(trainer):
    runs = {}
    for name, p, dseed in (("a", 0.3, None), ("b", 0.3, None), ("c", 0.3, 5),
                           ("off", 0.0, None)):
        tr, batch = _from_start(trainer)
        blocks = [m for m in tr.model.modules() if isinstance(m, unet_resnet.ResnetBlock)]
        for m in blocks:
            m.p = p
        if dseed is not None:
            tr.dropout_generator.manual_seed(dseed)
        try:
            loss = tr.train_step(batch).item()
        finally:
            for m in blocks:
                m.p = 0.3
        runs[name] = (loss, tr.generator.get_state(), tr.dropout_generator.get_state())
    assert runs["a"][0] == runs["b"][0] != runs["c"][0]
    assert runs["a"][0] != runs["off"][0]
    # the t draws' stream does not move with the masks
    assert torch.equal(runs["a"][1], runs["off"][1])
    assert not torch.equal(runs["a"][2], runs["off"][2])


def test_one_microbatch_draws_one_set_of_masks(trainer):
    """Every model call of a microbatch's loss draws the masks JAX's one
    dropout key gives them (Final_random_mean_and_actual calls it twice)."""
    tr, _ = _from_start(trainer)
    tr.model.train()
    fn = tr._denoise_fn(tr.model, tr.dropout_generator)
    x, t = torch.randn(2, S, S, 3), torch.tensor([1, 2])
    with torch.no_grad():
        assert torch.equal(fn(x, t), fn(x, t))
        other = tr._denoise_fn(tr.model, tr.dropout_generator)(x, t)
    assert not torch.equal(fn(x, t), other)


def test_checkpoint_carries_the_dropout_generator(trainer, tmp_path):
    """The dropout generator rides in model.pt; a blob of an earlier port,
    without it, still loads; EMA sampling runs the dropout model in eval()
    with no generator."""
    tr, batch = _from_start(trainer)
    tr.train_step(batch)
    tr.results_folder = tmp_path
    tr.save()
    tr.snapshot(1)
    assert (tmp_path / "sample-1.png").exists() and not tr.ema_model.training
    back = _port_trainer(tmp_path / "b", dropout=0.3, load_path=str(tmp_path / "model.pt"))
    assert back.step == 1
    assert torch.equal(tr.dropout_generator.get_state(), back.dropout_generator.get_state())
    blob = tr.state()
    del blob["dropout_generator"]
    back.dropout_generator.manual_seed(7)
    back.load_state(blob)
    assert torch.equal(back.dropout_generator.get_state(),
                       torch.Generator().manual_seed(7).get_state())


def test_load_torch_path_reads_a_resnet_reference_checkpoint(tmp_path):
    from tests.test_import_torch import _synth_resnet_sd

    sd = _synth_resnet_sd(RESNET["ch"], RESNET["ch_mult"], 1, RESNET["attn_resolutions"], S)
    path = tmp_path / "ref.pt"
    torch.save({"step": 4, "model": {f"module.denoise_fn.{k}": torch.from_numpy(v)
                                     for k, v in sd.items()},
                "ema": {f"module.denoise_fn.{k}": torch.from_numpy(v) * 0.5
                        for k, v in sd.items()}}, path)
    tr = _port_trainer(tmp_path / "r", load_torch_path=str(path))
    assert tr.step == 4
    for k, v in sd.items():
        np.testing.assert_array_equal(tr.model.state_dict()[k].numpy(), v, err_msg=k)
        np.testing.assert_array_equal(tr.ema_model.state_dict()[k].numpy(), v * 0.5)


@pytest.mark.parametrize("routine", NOISE_ROUTINES)
def test_trainer_draws_routine_noise_from_its_generator(trainer, routine):
    """A noise routine draws its noise from the training generator after t,
    the same state giving the same step; Final draws t alone, one [B] draw
    a microbatch, so the deterministic routines' stream is as it was."""
    losses, states = [], []
    for r in (routine, routine, "Final"):
        tr, batch = _from_start(trainer, r)
        before = tr.generator.get_state()
        losses.append(tr.train_step(batch).item())
        states.append(tr.generator.get_state())
    assert losses[0] == losses[1] != losses[2] and np.isfinite(losses[0])
    assert torch.equal(states[0], states[1]) and not torch.equal(states[0], states[2])
    gen = torch.Generator()
    gen.set_state(before)
    for _ in range(KW["gradient_accumulate_every"]):
        torch.randint(0, BLUR["timesteps"], (KW["train_batch_size"],), generator=gen)
    assert torch.equal(gen.get_state(), states[2])
