"""The port's Trainer on mix (with ``second_dataset``) and on random snow ==
colddiff's Trainer, one step from one state; the operator in the
checkpoint.

The set-up and tolerances of ``tests/test_torch_train_ops.py`` (dim-8 UNet
at (1, 2), 16 px, B=2, accum 2, ``SyntheticDataset``, one loader thread, a
one-device mesh; loss rtol 1e-5; params and EMA atol 1e-7 + rtol 1e-5 for
all but 1 in 10^4 entries, lr for all), with the JAX step's t draws
replayed.  mix takes its endpoints from the second loader of each Trainer
(both seeded ``seed + 1``, checked equal).  Random snow is reset before the
step from the seed JAX draws from ``fold_in(key(997), step)``, replayed
into the port's operator; the fields then agree at 1e-6 (fp32 einsums, as
``tests/test_torch_operators_b.py``).
"""

import jax
import numpy as np
import torch

from colddiff.data import datasets as jdatasets
from colddiff.diffusion import ColdDiffusion as JColdDiffusion
from colddiff.models import UnetConvNext as JUnetConvNext
from colddiff.operators import get_operator as jget_operator
from colddiff.parallel import make_mesh
from colddiff.train import Trainer as JTrainer
from colddiff_torch.data import datasets
from colddiff_torch.diffusion import ColdDiffusion
from colddiff_torch.models import UnetConvNext
from colddiff_torch.operators import get_operator
from colddiff_torch.train import Trainer
from tests.test_torch_train import _assert_fp32_params, _jax_blob
from tests.test_torch_train_ops import ACCUM, DIM, KW, MULTS, S, _replayed

OPS = {
    "mix": dict(timesteps=8),
    "snow": dict(image_size=S, timesteps=6, snow_level=4, random_snow=True, batch_size=2),
}


def _trainers(tmp_path, name, second=False, **kw):
    jd = JColdDiffusion(op=jget_operator(name, **OPS[name]), image_size=S,
                        sampling_routine="x0_step_down")
    d = ColdDiffusion(op=get_operator(name, **OPS[name], device="cpu"), image_size=S,
                      sampling_routine="x0_step_down")
    jkw = pkw = {**KW, **kw}
    if second:
        jkw, pkw = dict(jkw), dict(pkw)
        jkw["second_dataset"] = jdatasets.SyntheticDataset(S, 3, length=16, seed=5)
        pkw["second_dataset"] = datasets.SyntheticDataset(S, 3, length=16, seed=5)
    jtr = JTrainer(jd, JUnetConvNext(dim=DIM, dim_mults=MULTS),
                   jdatasets.SyntheticDataset(S, 3, length=16),
                   results_folder=str(tmp_path / "jax"), mesh=make_mesh(jax.devices()[:1]),
                   **jkw)
    ptr = Trainer(d, UnetConvNext(dim=DIM, dim_mults=MULTS),
                  datasets.SyntheticDataset(S, 3, length=16),
                  results_folder=str(tmp_path / "port"), device="cpu", **pkw)
    names = [n for n, _ in ptr.model.named_parameters()]
    ptr.load_state(_jax_blob(jtr, names))
    return jtr, ptr, names


def _check_step(jtr, ptr, names, jloss, ploss):
    want = _jax_blob(jtr, names)
    assert ptr.step == want["step"] == 1
    np.testing.assert_allclose(ploss.item(), float(jloss), rtol=1e-5)
    for part in ("model", "ema"):
        _assert_fp32_params(ptr.state()[part], want[part], part)


def test_mix_step_with_second_dataset_matches_jax(tmp_path):
    """One optimizer step of demixing: each microbatch's endpoint is the
    second loader's batch, in both Trainers."""
    jtr, ptr, names = _trainers(tmp_path, "mix", second=True)
    jbatch, jbatch2 = jtr._next_superbatch()
    pbatch, pbatch2 = ptr._next_superbatch(), ptr._next_superbatch(ptr.dl2)
    np.testing.assert_array_equal(np.asarray(jbatch), pbatch.numpy())
    np.testing.assert_array_equal(np.asarray(jbatch2), pbatch2.numpy())
    assert not torch.equal(pbatch, pbatch2)
    t, x_end, _ = _replayed(jtr, jbatch)
    assert x_end is None  # mix draws no endpoint of its own
    jtr._maybe_reset_op()
    jtr.state, jloss = jtr._train_step(jtr.state, jtr.diffusion, jbatch, jbatch2)
    ploss = ptr.train_step(pbatch, t=t, x_end=pbatch2)
    _check_step(jtr, ptr, names, jloss, ploss)


def test_mix_trainer_trains_and_snapshots_from_the_second_dataset(tmp_path):
    """train() feeds the second loader's batches as endpoints; the snapshot
    pairs its images with endpoints from a second loader of its own (seed
    + 7920), one batch size for both, as the JAX Trainer's."""
    jtr, ptr, _ = _trainers(tmp_path, "mix", second=True, save_and_sample_every=2,
                            train_num_steps=2)
    for n in (2, 5):
        (jog, jend), (og, end) = jtr._snapshot_batch(n), ptr._snapshot_batch(n)
        np.testing.assert_array_equal(og, jog)
        np.testing.assert_array_equal(end, jend)
        assert end.shape == og.shape
    ends = []
    step = ptr.train_step
    ptr.train_step = lambda batch, x_end=None: (ends.append(x_end), step(batch, x_end=x_end))[1]
    assert ptr.train(log_every=1) == "done"
    assert len(ends) == 2 and all(e is not None and e.shape[:2] == (ACCUM, 2) for e in ends)
    for part in ("og", "xt", "direct_recons", "sample"):
        assert (tmp_path / "port" / f"{part}-1.png").exists()


def test_random_snow_step_matches_jax(tmp_path):
    """One step with the real random_snow Snow: both Trainers reset it
    before the step; the port's operator takes the seed JAX drew."""
    jtr, ptr, names = _trainers(tmp_path, "snow")
    jbatch, _ = jtr._next_superbatch()
    pbatch = ptr._next_superbatch()
    t, x_end, _ = _replayed(jtr, jbatch)
    assert x_end is None
    seed = int(jax.random.randint(jax.random.fold_in(jax.random.key(997), 0), (), 0,
                                  2**31 - 1))
    op = ptr.diffusion.op
    seen = []
    op.reset = lambda generator, batch_size: (seen.append(batch_size),
                                              op.reseed(seed, batch_size))[1]
    jtr._maybe_reset_op()
    jtr.state, jloss = jtr._train_step(jtr.state, jtr.diffusion, jbatch, None)
    ploss = ptr.train_step(pbatch, t=t)
    assert seen == [2] and ptr.diffusion.op is not op
    for part in ("snow", "snow_rot"):
        np.testing.assert_allclose(getattr(ptr.diffusion.op, part).numpy(),
                                   np.asarray(getattr(jtr.diffusion.op, part)), rtol=0,
                                   atol=1e-6, err_msg=part)
    assert not torch.equal(ptr.diffusion.op.snow, op.snow)
    _check_step(jtr, ptr, names, jloss, ploss)


def test_checkpoint_keeps_the_snow_fields(tmp_path):
    """save() holds the operator's tensors; load restores the exact fields
    the run had (each step redraws them); a blob without "op" (an older
    checkpoint, ``train_state_from_flax``) loads and keeps the operator."""
    def trainer(folder, **kw):
        d = ColdDiffusion(op=get_operator("snow", **OPS["snow"], device="cpu"), image_size=S)
        return Trainer(d, UnetConvNext(dim=DIM, dim_mults=MULTS),
                       datasets.SyntheticDataset(S, 3, length=16),
                       results_folder=str(tmp_path / folder), device="cpu", **{**KW, **kw})

    tr = trainer("a", train_num_steps=2)
    tr.train(log_every=10)
    saved = tr.diffusion.op
    fresh = trainer("b")
    assert not torch.equal(fresh.diffusion.op.snow, saved.snow)
    back = trainer("c", load_path=str(tmp_path / "a" / "model.pt"))
    assert back.step == 2
    for name, value in saved.state().items():
        assert torch.equal(getattr(back.diffusion.op, name), value), name
    blob = tr.state()
    assert set(blob["op"]) == {"snow", "snow_rot", "br_coefs"}
    del blob["op"]
    before = fresh.diffusion.op
    fresh.load_state(blob)
    assert fresh.diffusion.op is before and fresh.step == 2
