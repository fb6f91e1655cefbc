"""The port's Trainer == colddiff's Trainer, step by step from one state.

The JAX Trainer (dim-8 UNet at (1, 2), 16 px, blur T=8, B=2, accum 2,
``step_start_ema=2``, ``update_ema_every=1``, ``SyntheticDataset``, one
loader thread, a one-device mesh) starts from its own random init; the
port's Trainer loads that state through ``train_state_from_flax`` and both
run 3 optimizer steps on the same batches (the copied ``DataLoader`` with
the same seed gives them in the same order, which the test asserts).  The
port replays the JAX Trainer's t draws: ``train.py:277-286`` splits the
state key into accum microbatch keys, each into (loss, dropout, endpoint),
and ``diffusion.py:152-153`` draws t from the loss key's first half.
Step 1 takes the EMA's reset branch, steps 2-3 its lerp.

Tolerances:
  - fp64 UNet: the degrade and the denoiser's output cast are fp32 by
    design on both sides, and the fp32 time embeddings differ by an ulp on
    some levels (ROADMAP.md section 3); params, EMA and Adam moments agree
    to rtol 1e-6 with an atol of 1e-6 of each tensor's largest entry (a
    tensor's few entries near zero carry the embedding's ulp as a larger
    relative error), the loss to rtol 1e-6;
  - fp32 UNet: Adam's first steps move a parameter by about
    lr * g / (|g| + eps), so its error is lr times the relative error of its
    gradient.  That is ~1e-5 * lr for almost every entry, so params and EMA
    agree to atol 1e-7 + rtol 1e-5; but a gradient entry near zero has a
    large relative error under two fp32 summation orders, and its Adam step
    may differ by a good part of lr (one entry of the 83,868 here, by
    1.4e-6).  So at most 1 in 10^4 entries may exceed that bound, and none
    by more than lr.  The moments carry the gradients' own error and are
    held per tensor by relative L2 (5e-5; measured ~5e-6); the loss to
    rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from colddiff.data import datasets as jdatasets
from colddiff.diffusion import ColdDiffusion as JColdDiffusion
from colddiff.models import UnetConvNext as JUnetConvNext
from colddiff.operators.blur import GaussianBlur as JGaussianBlur
from colddiff.parallel import make_mesh
from colddiff.train import Trainer as JTrainer
from colddiff import utils as jutils
from colddiff_torch import utils
from colddiff_torch.data import datasets
from colddiff_torch.diffusion import ColdDiffusion
from colddiff_torch.models import UnetConvNext
from colddiff_torch.models.convert import train_state_from_flax
from colddiff_torch.operators import get_operator
from colddiff_torch.train import Trainer
from tests.test_import_torch import _synth_convnext_sd

BLUR = dict(image_size=16, timesteps=8, blur_routine="Exponential_reflect",
            kernel_size=15, kernel_std=0.01)
DIM, MULTS = 8, (1, 2)
B, ACCUM, STEPS = 2, 2, 3
LR = 2e-5  # both Trainers' default
KW = dict(train_batch_size=B, gradient_accumulate_every=ACCUM, step_start_ema=2,
          update_ema_every=1, save_and_sample_every=10**9, num_workers=1, seed=0)


def _jax_trainer(folder, **kw):
    d = JColdDiffusion(op=JGaussianBlur.create(**BLUR), image_size=16,
                       sampling_routine="x0_step_down")
    return JTrainer(d, JUnetConvNext(dim=DIM, dim_mults=MULTS),
                    jdatasets.SyntheticDataset(16, 3, length=16),
                    results_folder=str(folder), mesh=make_mesh(jax.devices()[:1]),
                    **KW, **kw)


def _port_trainer(folder, dtype=torch.float32, **kw):
    d = ColdDiffusion(op=get_operator("blur", **BLUR, device="cpu"), image_size=16,
                      sampling_routine="x0_step_down")
    args = {**KW, "device": "cpu", **kw}
    return Trainer(d, UnetConvNext(dim=DIM, dim_mults=MULTS).to(dtype),
                   datasets.SyntheticDataset(16, 3, length=16),
                   results_folder=str(folder), **args)


def _replayed_t(state_rng, timesteps):
    """The [accum, B] levels the JAX train step draws from ``state_rng``."""
    _, *rngs = jax.random.split(state_rng, ACCUM + 1)
    ts = []
    for r in rngs:
        loss_rng, _, _ = jax.random.split(r, 3)
        t_rng, _ = jax.random.split(loss_rng)
        ts.append(np.asarray(jax.random.randint(t_rng, (B,), 0, timesteps)))
    return torch.from_numpy(np.stack(ts)).long()


def _jax_blob(jtr, names):
    s = jax.device_get(jtr.state)
    return train_state_from_flax(s.params, s.ema_params, s.opt_state, int(s.step),
                                 param_names=names)


def _assert_close(got, want, rtol, atol_frac, what):
    got, want = got.double().numpy(), want.double().numpy()
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_frac * np.abs(want).max(),
                               err_msg=what)


def _assert_fp32_params(got: dict, want: dict, what: str):
    """atol 1e-7 + rtol 1e-5 for all but 1 in 10^4 entries, lr for all."""
    over, total = 0, 0
    for n, v in want.items():
        d = (got[n].double() - v.double()).abs()
        assert d.max().item() <= LR, f"{what} {n}: max err {d.max().item()}"
        over += (d > 1e-7 + 1e-5 * v.double().abs()).sum().item()
        total += d.numel()
    assert over <= total * 1e-4, f"{what}: {over} of {total} entries over 1e-7 + 1e-5 |p|"


def _rel_l2(got, want):
    got, want = got.double(), want.double()
    return ((got - want).norm() / want.norm()).item()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_three_steps_match_jax_trainer(tmp_path, dtype):
    tdtype = getattr(torch, dtype)
    with jax.enable_x64(dtype == "float64"):
        jtr = _jax_trainer(tmp_path / "jax")
        if dtype == "float64":
            p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                         jtr.state.params)
            jtr.state = jtr.state.replace(
                params=p64, ema_params=jax.tree_util.tree_map(jnp.copy, p64),
                opt_state=jtr.tx.init(p64))
        ptr = _port_trainer(tmp_path / "port", tdtype)
        names = [n for n, _ in ptr.model.named_parameters()]
        ptr.load_state(_jax_blob(jtr, names))
        for step in range(1, STEPS + 1):
            jbatch, _ = jtr._next_superbatch()
            pbatch = ptr._next_superbatch()
            np.testing.assert_array_equal(np.asarray(jbatch), pbatch.numpy())
            t = _replayed_t(jtr.state.rng, BLUR["timesteps"])
            jtr.state, jloss = jtr._train_step(jtr.state, jtr.diffusion, jbatch, None)
            ploss = ptr.train_step(pbatch, t=t)
            want = _jax_blob(jtr, names)
            assert ptr.step == want["step"] == step
            if dtype == "float64":
                np.testing.assert_allclose(ploss.item(), float(jloss), rtol=1e-6)
                for part in ("model", "ema"):
                    for n, v in want[part].items():
                        _assert_close(ptr.state()[part][n], v, 1e-6, 1e-6, f"{part} {n}")
            else:
                np.testing.assert_allclose(ploss.item(), float(jloss), rtol=1e-5)
                for part in ("model", "ema"):
                    _assert_fp32_params(ptr.state()[part], want[part], part)
            opt = ptr.opt.state_dict()["state"]
            for i, n in enumerate(names):
                assert opt[i]["step"].item() == want["opt"]["state"][i]["step"].item() == step
                for k in ("exp_avg", "exp_avg_sq"):
                    got, ref = opt[i][k], want["opt"]["state"][i][k]
                    if dtype == "float64":
                        _assert_close(got, ref, 1e-6, 1e-6, f"{k} {n}")
                    else:
                        assert _rel_l2(got, ref) <= 5e-5, f"{k} {n}"


def test_bf16_step_matches_jax_and_computes_in_bf16(tmp_path):
    """The port's twin of tests/test_train.py:149: bf16=True casts the
    parameters and the input, so the convs run in bf16, and the masters stay
    fp32.  One step's loss is within 2e-2 relative of JAX's (bf16 rounds at
    other places in the two frameworks)."""
    jtr = _jax_trainer(tmp_path / "jax", bf16=True)
    ptr = _port_trainer(tmp_path / "port", bf16=True)
    names = [n for n, _ in ptr.model.named_parameters()]
    ptr.load_state(_jax_blob(jtr, names))
    jbatch, _ = jtr._next_superbatch()
    t = _replayed_t(jtr.state.rng, BLUR["timesteps"])
    _, jloss = jtr._train_step(jtr.state, jtr.diffusion, jbatch, None)
    seen = []
    hooks = [m.register_forward_hook(lambda m, a, out: seen.append(out.dtype))
             for m in ptr.model.modules() if isinstance(m, torch.nn.Conv2d)]
    try:
        ploss = ptr.train_step(ptr._next_superbatch(), t=t)
    finally:
        for h in hooks:
            h.remove()
    assert seen and set(seen) == {torch.bfloat16}
    assert ploss.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in ptr.model.parameters())
    assert all(p.grad.dtype == torch.float32 for p in ptr.model.parameters())
    np.testing.assert_allclose(ploss.item(), float(jloss), rtol=2e-2)


# ---------------------------------------------------------------------- #
# checkpoints and the loop


def test_train_writes_metrics_grids_and_checkpoint(tmp_path):
    tr = _port_trainer(tmp_path, train_num_steps=2, save_and_sample_every=2)
    assert tr.train(log_every=1) == "done"
    lines = (tmp_path / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 2 and '"images_per_sec"' in lines[0]
    for name in ("og", "xt", "direct_recons", "sample"):
        assert (tmp_path / f"{name}-1.png").exists()
    assert (tmp_path / "model.pt").exists()


def test_save_load_round_trip_is_exact(tmp_path):
    tr = _port_trainer(tmp_path / "a", train_num_steps=2)
    tr.train(log_every=10)
    back = _port_trainer(tmp_path / "b", load_path=str(tmp_path / "a" / "model.pt"))
    a, b = tr.state(), back.state()
    assert b["step"] == 2
    for part in ("model", "ema"):
        assert all(torch.equal(a[part][n], b[part][n]) for n in a[part])
    for i, st in a["opt"]["state"].items():
        assert all(torch.equal(v, b["opt"]["state"][i][k]) for k, v in st.items())
    assert torch.equal(a["generator"], b["generator"])
    # a Trainer of another lr keeps its own: the checkpoint holds Adam's state
    other = _port_trainer(tmp_path / "c", train_lr=1e-3,
                          load_path=str(tmp_path / "a" / "model.pt"))
    assert other.opt.param_groups[0]["lr"] == 1e-3
    assert torch.equal(other.opt.state_dict()["state"][0]["exp_avg"],
                       a["opt"]["state"][0]["exp_avg"])
    # the restored generator continues the stream
    assert torch.equal(torch.randint(0, 8, (4,), generator=tr.generator),
                       torch.randint(0, 8, (4,), generator=back.generator))


def test_auto_resume_beats_load_path(tmp_path):
    _port_trainer(tmp_path / "warm", train_num_steps=1).train(log_every=10)
    _port_trainer(tmp_path / "run", train_num_steps=3).train(log_every=10)
    tr = _port_trainer(tmp_path / "run", load_path=str(tmp_path / "warm" / "model.pt"),
                       auto_resume=True)
    assert tr.step == 3


def test_load_torch_path_reads_a_reference_checkpoint(tmp_path):
    """The reference Trainer's {step, model, ema} with the DataParallel
    ``module.`` + ``denoise_fn.`` scoping and a degradation buffer, written
    as tests/test_load_torch_cli.py:23-37 writes it; Adam restarts at zero."""
    sd = _synth_convnext_sd(DIM, MULTS, 3)
    sd_ema = {k: v * 0.5 for k, v in sd.items()}

    def scoped(s):
        out = {f"module.denoise_fn.{k}": torch.as_tensor(v) for k, v in s.items()}
        out["module.gaussian_kernels.0.weight"] = torch.zeros(3, 1, 3, 3)
        return out

    path = tmp_path / "ref.pt"
    torch.save({"step": 7, "model": scoped(sd), "ema": scoped(sd_ema)}, path)
    tr = _port_trainer(tmp_path / "r", load_torch_path=str(path))
    assert tr.step == 7
    model, ema = tr.model.state_dict(), tr.ema_model.state_dict()
    for k, v in sd.items():
        np.testing.assert_array_equal(model[k].numpy(), v, err_msg=k)
        np.testing.assert_array_equal(ema[k].numpy(), sd_ema[k], err_msg=k)
    assert tr.opt.state_dict()["state"] == {}


def test_trainer_refuses_what_it_cannot_do(tmp_path):
    with pytest.raises(ValueError, match="not both"):
        _port_trainer(tmp_path, load_path="a", load_torch_path="b")
    # parallelism's arguments: an unknown mode, and FSDP without a process group
    with pytest.raises(ValueError, match="unknown param_sharding mode"):
        _port_trainer(tmp_path, param_sharding="zero3")
    with pytest.raises(ValueError, match="init_multihost"):
        _port_trainer(tmp_path, param_sharding="fsdp", fsdp_min_size=1)
    with pytest.raises(TypeError):
        _port_trainer(tmp_path, not_an_argument=1)
    if not torch.cuda.is_available():
        # no silent move to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _port_trainer(tmp_path, device="cuda")


# ---------------------------------------------------------------------- #
# copied data and utils


def _png_folder(tmp_path):
    rng = np.random.default_rng(0)
    folder = tmp_path / "imgs"
    (folder / "sub").mkdir(parents=True)
    for i, (h, w, mode) in enumerate([(40, 52, "RGB"), (33, 33, "L"), (64, 48, "RGB"),
                                      (20, 30, "RGBA")]):
        c = {"RGB": 3, "L": 1, "RGBA": 4}[mode]
        arr = rng.integers(0, 256, (h, w, c), dtype=np.uint8)
        Image.fromarray(arr[..., 0] if c == 1 else arr, mode).save(
            folder / ("sub" if i % 2 else "") / f"im{i}.png")
    return folder


@pytest.mark.parametrize("aug", ["aug1", "center"])
def test_image_folder_dataset_equals_original(tmp_path, monkeypatch, aug):
    """Both packages on their numpy path (the native helpers, on both sides,
    are held against each other in tests/test_torch_native.py)."""
    monkeypatch.setattr("colddiff.data.native.get_lib", lambda: None)
    monkeypatch.setattr("colddiff_torch.data.native.get_lib", lambda: None)
    folder = _png_folder(tmp_path)
    want = jdatasets.ImageFolderDataset(str(folder), 16, aug=aug, seed=3)
    got = datasets.ImageFolderDataset(str(folder), 16, aug=aug, seed=3)
    assert len(got) == len(want) == 4
    for _ in range(2):
        for i in range(len(want)):
            np.testing.assert_array_equal(got[i], want[i])


@pytest.mark.parametrize("aug,dtype", [(None, np.uint8), (None, np.float32),
                                       ("cifar", np.uint8), ("cifar", np.float32)])
def test_array_dataset_equals_original(monkeypatch, aug, dtype):
    monkeypatch.setattr("colddiff.data.native.get_lib", lambda: None)
    monkeypatch.setattr("colddiff_torch.data.native.get_lib", lambda: None)
    imgs = np.random.default_rng(1).integers(0, 256, (5, 12, 12, 3)).astype(dtype)
    want = jdatasets.ArrayDataset(imgs, aug=aug, seed=2)
    got = datasets.ArrayDataset(imgs, aug=aug, seed=2)
    for i in list(range(5)) * 2:
        a, b = got[i], want[i]
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_synthetic_dataset_and_loader_equal_original():
    want = jdatasets.SyntheticDataset(12, 3, length=10, seed=4)
    got = datasets.SyntheticDataset(12, 3, length=10, seed=4)
    for i in range(10):
        np.testing.assert_array_equal(got[i], want[i])
    want_batches = list(jdatasets.DataLoader(want, 3, num_workers=2, seed=5))
    got_batches = list(datasets.DataLoader(got, 3, num_workers=2, seed=5))
    assert len(got_batches) == len(want_batches) == 3
    for gb, wb in zip(got_batches, want_batches):
        np.testing.assert_array_equal(gb, wb)


def test_cycle_raises_on_an_empty_loader():
    it = utils.cycle(datasets.DataLoader(datasets.SyntheticDataset(8, length=2), 4))
    with pytest.raises(ValueError):
        next(it)


@pytest.mark.parametrize("shape", [(7, 5, 6, 3), (2, 4, 4, 1)])
def test_to_uint8_grid_equals_original(shape):
    x = np.random.default_rng(6).uniform(-1.2, 1.2, shape).astype(np.float32)
    np.testing.assert_array_equal(utils.to_uint8_grid(x), jutils.to_uint8_grid(x))


def test_ema_update_is_the_jax_formula():
    """Bitwise: both compute e * decay + p * (1 - decay) in fp32."""
    rng = np.random.default_rng(8)
    shapes = [(1000,), (8, 3, 7, 7)]
    e = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    p = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    want = jutils.ema_update([jnp.asarray(a) for a in e], [jnp.asarray(a) for a in p], 0.995)
    te = [torch.from_numpy(a.copy()) for a in e]
    utils.ema_update(te, [torch.from_numpy(a) for a in p], 0.995)
    for got, ref in zip(te, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_bf16_params_casts_floating_tensors_only():
    named = [("w", torch.ones(2, requires_grad=True)), ("n", torch.arange(3))]
    out = utils.bf16_params(named)
    assert list(out) == ["w"] and out["w"].dtype == torch.bfloat16
    out["w"].sum().backward()  # the cast is differentiable
    assert named[0][1].grad is not None
