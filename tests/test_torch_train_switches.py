"""The Trainer's switches: ``to_lab`` against the JAX Trainer, ``remat``
against the step without it, ``debug_nans``, the profiler window and the
restart boundary with its resume.

``to_lab`` uses the set-up of ``tests/test_torch_train.py`` (dim-8 UNet at
(1, 2), 16 px, blur T=8, B=2, accum 2, one loader thread, a one-device
mesh) with the JAX step's t draws replayed, and its fp32 tolerances: the
batches go through two ``rgb2lab`` copies, which agree to ~1e-5 of the
Lab range (rtol 1e-5, atol 1e-4 here), then the step as there.

``remat`` recomputes the same forward, so on the CPU the step is bitwise
the step without it: the loss and every parameter are held equal.  With a
dropout ``UnetResNet`` that holds only if the recompute draws the masks of
the forward (the generator's replay inside the checkpointed call).
"""

import numpy as np
import pytest
import torch

from colddiff_torch import tracing
from colddiff_torch.data import datasets
from colddiff_torch.diffusion import ColdDiffusion
from colddiff_torch.models import UnetConvNext, UnetResNet
from colddiff_torch.operators import get_operator
from colddiff_torch.train import Trainer
from tests.test_torch_train import (BLUR, DIM, KW, MULTS, _assert_fp32_params, _jax_blob,
                                    _jax_trainer, _port_trainer, _replayed_t)

S = 16
RESNET = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=S)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _states_equal(a: dict, b: dict) -> bool:
    return (a["step"] == b["step"]
            and all(torch.equal(a[k][n], b[k][n]) for k in ("model", "ema") for n in a[k])
            and all(torch.equal(v, b["opt"]["state"][i][name])
                    for i, st in a["opt"]["state"].items() for name, v in st.items())
            and torch.equal(a["generator"], b["generator"])
            and torch.equal(a["dropout_generator"], b["dropout_generator"]))


# ---------------------------------------------------------------------- #
# to_lab


def test_to_lab_step_matches_jax_trainer(tmp_path):
    jtr = _jax_trainer(tmp_path / "jax", to_lab=True)
    ptr = _port_trainer(tmp_path / "port", to_lab=True)
    names = [n for n, _ in ptr.model.named_parameters()]
    ptr.load_state(_jax_blob(jtr, names))
    jbatch, _ = jtr._next_superbatch()
    pbatch = ptr._next_superbatch()
    # Lab: L in 0..100, a/b in -127..127
    assert pbatch.abs().max().item() > 10.0
    np.testing.assert_allclose(pbatch.numpy(), np.asarray(jbatch), rtol=1e-5, atol=1e-4)
    t = _replayed_t(jtr.state.rng, BLUR["timesteps"])
    jtr.state, jloss = jtr._train_step(jtr.state, jtr.diffusion, jbatch, None)
    ploss = ptr.train_step(pbatch, t=t)
    want = _jax_blob(jtr, names)
    np.testing.assert_allclose(ploss.item(), float(jloss), rtol=1e-5)
    for part in ("model", "ema"):
        _assert_fp32_params(ptr.state()[part], want[part], part)


def test_to_lab_snapshot_saves_rgb_grids(tmp_path, monkeypatch):
    """The snapshot samples in Lab and saves its grids through lab2rgb, as
    the JAX Trainer's to_rgb does: the saved arrays lie in [-1, 1]."""
    saved = {}
    monkeypatch.setattr("colddiff_torch.train.save_image_grid",
                        lambda imgs, path: saved.__setitem__(path.name, np.asarray(imgs)))
    tr = _port_trainer(tmp_path, to_lab=True)
    tr.snapshot(1)
    assert sorted(saved) == ["direct_recons-1.png", "og-1.png", "sample-1.png", "xt-1.png"]
    for name, imgs in saved.items():
        assert imgs.shape == (2, S, S, 3) and np.abs(imgs).max() <= 1.0 + 1e-6, name


# ---------------------------------------------------------------------- #
# remat


def _step_pair(make, batch_fn=None, t=None):
    """(loss, state) of one step without and with remat, from one state."""
    runs = []
    for remat in (False, True):
        tr = make(remat)
        batch = tr._next_superbatch() if batch_fn is None else batch_fn(tr)
        loss = tr.train_step(batch, t=t)
        runs.append((loss, tr.state()))
    return runs


@pytest.mark.parametrize("bf16", [False, True])
def test_remat_step_equals_the_step_without(tmp_path, bf16):
    torch.manual_seed(0)
    init = UnetConvNext(dim=DIM, dim_mults=MULTS).state_dict()

    def make(remat):
        tr = _port_trainer(tmp_path / str(remat), bf16=bf16, remat=remat)
        tr.model.load_state_dict(init)
        tr.ema_model.load_state_dict(init)
        return tr

    t = torch.tensor([[0, 7], [3, 5]])
    (loss0, s0), (loss1, s1) = _step_pair(make, t=t)
    assert torch.equal(loss0, loss1)
    assert _states_equal(s0, s1)


def test_remat_recomputes_the_forward(tmp_path, monkeypatch):
    """Under remat each training call runs the model twice: once forward,
    once in the backward pass (the block fronts launch twice on the card)."""
    from colddiff_torch.models import layers

    calls = {"n": 0}
    forward = layers.ConvNextBlock.forward

    def counting(self, *args, **kw):
        calls["n"] += 1
        return forward(self, *args, **kw)

    monkeypatch.setattr(layers.ConvNextBlock, "forward", counting)
    blocks = sum(isinstance(m, layers.ConvNextBlock)
                 for m in UnetConvNext(dim=DIM, dim_mults=MULTS).modules())
    seen = []
    for remat in (False, True):
        tr = _port_trainer(tmp_path / str(remat), remat=remat)
        calls["n"] = 0
        tr.train_step(tr._next_superbatch())
        seen.append(calls["n"])
    assert seen == [blocks * KW["gradient_accumulate_every"],
                    2 * blocks * KW["gradient_accumulate_every"]]


def test_remat_keeps_the_dropout_masks(tmp_path):
    """A dropout ResNet: the recompute replays the dropout generator, so the
    masks of the backward are those of the forward, and the step, the
    generator's stream after it and the next step equal the run without
    remat.  A recompute drawing new masks would give other gradients."""
    torch.manual_seed(0)
    init = UnetResNet(**RESNET, dropout=0.3).state_dict()

    def make(remat):
        d = ColdDiffusion(op=get_operator("blur", **BLUR, device="cpu"), image_size=S,
                          sampling_routine="x0_step_down")
        model = UnetResNet(**RESNET, dropout=0.3)
        model.load_state_dict(init)
        return Trainer(d, model, datasets.SyntheticDataset(S, 3, length=16),
                       results_folder=str(tmp_path / str(remat)), device="cpu",
                       remat=remat, **KW)

    runs = []
    for remat in (False, True):
        tr = make(remat)
        losses = [tr.train_step(tr._next_superbatch()) for _ in range(2)]
        runs.append((losses, tr.state()))
    (l0, s0), (l1, s1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert _states_equal(s0, s1)
    # the masks matter here: without dropout the step is another one
    tr = make(False)
    for m in tr.model.modules():
        if hasattr(m, "p"):
            m.p = 0.0
    assert not torch.equal(tr.train_step(tr._next_superbatch()), l0[0])


# ---------------------------------------------------------------------- #
# debug_nans, the profiler


def _nan_trainer(tmp_path, **kw):
    d = ColdDiffusion(op=get_operator("blur", **BLUR, device="cpu"), image_size=S,
                      sampling_routine="x0_step_down")
    bad = np.full((8, S, S, 3), np.nan, np.float32)
    return Trainer(d, UnetConvNext(dim=DIM, dim_mults=MULTS), datasets.ArrayDataset(bad),
                   results_folder=str(tmp_path), device="cpu", **{**KW, **kw})


def test_debug_nans_raises_on_a_nonfinite_batch(tmp_path):
    """The twin of tests/test_train.py:175-201: a NaN batch raises
    FloatingPointError before it reaches the step."""
    tr = _nan_trainer(tmp_path / "on", debug_nans=True)
    with pytest.raises(FloatingPointError, match="batch"):
        tr.train_step(tr._next_superbatch())
    # without the switch the NaN passes silently into the loss
    tr = _nan_trainer(tmp_path / "off")
    assert torch.isnan(tr.train_step(tr._next_superbatch()))


def test_debug_nans_raises_on_a_nonfinite_loss(tmp_path):
    tr = _port_trainer(tmp_path, debug_nans=True)
    with torch.no_grad():
        next(tr.model.parameters()).fill_(float("nan"))
    with pytest.raises(FloatingPointError, match="microbatch 0 of step 1"):
        tr.train_step(tr._next_superbatch())


def test_profiler_writes_a_trace_of_its_window(tmp_path):
    tr = _port_trainer(tmp_path / "run", train_num_steps=3, profile_dir=str(tmp_path / "prof"),
                       profile_steps=(1, 3))
    assert tr.train(log_every=10) == "done"
    traces = list((tmp_path / "prof").iterdir())
    assert [p.name for p in traces] == ["trace_steps_1_3.json"]
    text = traces[0].read_text()
    assert '"traceEvents"' in text and "aten::conv2d" in text
    assert '"train.forward"' in text  # the port's spans, named in the window
    assert tr._profiler is None and not tracing._label


# ---------------------------------------------------------------------- #
# the restart boundary


def test_restart_boundary_then_resume_equals_an_unbroken_run(tmp_path):
    """restart_every_steps=2 over 5 steps: two workers return "restart" at
    steps 2 and 4 with the checkpoint saved, the third finishes; each
    resumes from model.pt, its loaders continuing the stream, and the end
    state is the unbroken run's, bit for bit."""
    def trainer(folder, **kw):
        torch.manual_seed(0)  # one init for every worker and the unbroken run
        return _port_trainer(folder, train_num_steps=5, **kw)

    whole = trainer(tmp_path / "whole")
    assert whole.train(log_every=10) == "done"
    results = []
    for _ in range(3):
        tr = trainer(tmp_path / "cut", restart_every_steps=2, auto_resume=True)
        results.append((tr.step, tr.train(log_every=10), tr.step))
    assert results == [(0, "restart", 2), (2, "restart", 4), (4, "done", 5)]
    assert _states_equal(tr.state(), whole.state())


def test_restart_rss_gb_below_the_baseline_warns_and_restarts(tmp_path, capsys):
    tr = _port_trainer(tmp_path, train_num_steps=3, restart_rss_gb=1e-3)
    assert "WARNING: --restart_rss_gb" in capsys.readouterr().out
    assert tr._host_rss_gb() > 1e-3
    assert tr.train(log_every=10) == "restart" and tr.step == 1
    assert (tmp_path / "model.pt").exists()
    # the last step never restarts: the run is done
    tr = _port_trainer(tmp_path / "last", train_num_steps=1, restart_every_steps=1)
    assert tr.train(log_every=10) == "done"


def test_loader_skip_continues_the_stream():
    ds = datasets.SyntheticDataset(4, 3, length=10)
    whole = datasets.DataLoader(ds, 3, num_workers=1, seed=5)
    stream = [b for _ in range(4) for b in whole]  # 4 epochs of 3 batches
    for skip in (0, 2, 3, 7):
        got = datasets.DataLoader(ds, 3, num_workers=1, seed=5, skip=skip)
        rest = [b for _ in range(2) for b in got]
        for a, b in zip(rest, stream[skip:]):
            np.testing.assert_array_equal(a, b)
        assert len(rest) == 6 - skip % 3


def test_switches_default_as_in_jax():
    import inspect

    from colddiff.train import Trainer as JTrainer

    jsig, psig = inspect.signature(JTrainer), inspect.signature(Trainer)
    for name in ("profile_dir", "profile_steps", "debug_nans", "remat", "restart_every_steps",
                 "restart_rss_gb", "to_lab"):
        assert psig.parameters[name].default == jsig.parameters[name].default, name
