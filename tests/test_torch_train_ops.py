"""The port's Trainer on the fade-generation and Random_Incremental fade
operators == colddiff's Trainer, one step from one state, and the operator
reset rule of both Trainers.

The set-up of ``tests/test_torch_train.py`` (dim-8 UNet at (1, 2), 16 px,
B=2, accum 2, ``SyntheticDataset``, one loader thread, a one-device mesh),
with the JAX step's draws replayed into the port's ``train_step``:
``train.py:277-286`` splits the state key into accum microbatch keys, each
into (loss, dropout, endpoint); the endpoint key draws x_end
(``op.sample_x_end``), and ``diffusion.py:152-153`` splits the loss key into
the t key and the operator key, from which fade draws its crops
(``Fade._draw_offsets``).  Tolerances are those of the fp32 case of
``tests/test_torch_train.py`` (loss rtol 1e-5; params and EMA atol 1e-7 +
rtol 1e-5 for all but 1 in 10^4 entries, lr for all), for the same reasons.
"""

import jax
import numpy as np
import pytest
import torch

from colddiff.data import datasets as jdatasets
from colddiff.diffusion import ColdDiffusion as JColdDiffusion
from colddiff.models import UnetConvNext as JUnetConvNext
from colddiff.operators import get_operator as jget_operator
from colddiff.operators.snow import Snow as JSnow
from colddiff.parallel import make_mesh
from colddiff.train import Trainer as JTrainer
from colddiff_torch.data import datasets
from colddiff_torch.diffusion import ColdDiffusion
from colddiff_torch.models import UnetConvNext
from colddiff_torch.operators import get_operator
from colddiff_torch.operators.base import Degradation
from colddiff_torch.train import Trainer
from tests.test_torch_train import _assert_fp32_params, _jax_blob

DIM, MULTS, S = 8, (1, 2), 16
B, ACCUM = 2, 2
KW = dict(train_batch_size=B, gradient_accumulate_every=ACCUM, step_start_ema=2,
          update_ema_every=1, save_and_sample_every=10**9, num_workers=1, seed=0)
OPS = {
    "fade_generation": dict(image_size=S, timesteps=8, kernel_std=0.3, initial_mask=2,
                            reverse=True),
    "fade": dict(image_size=S, timesteps=6, fade_routine="Random_Incremental",
                 kernel_std=0.1, initial_mask=1),
}


def _trainers(tmp_path, name, **kw):
    jd = JColdDiffusion(op=jget_operator(name, **OPS[name]), image_size=S,
                        sampling_routine="x0_step_down")
    jtr = JTrainer(jd, JUnetConvNext(dim=DIM, dim_mults=MULTS),
                   jdatasets.SyntheticDataset(S, 3, length=16),
                   results_folder=str(tmp_path / "jax"), mesh=make_mesh(jax.devices()[:1]),
                   **KW, **kw)
    d = ColdDiffusion(op=get_operator(name, **OPS[name], device="cpu"), image_size=S,
                      sampling_routine="x0_step_down")
    ptr = Trainer(d, UnetConvNext(dim=DIM, dim_mults=MULTS),
                  datasets.SyntheticDataset(S, 3, length=16),
                  results_folder=str(tmp_path / "port"), device="cpu", **KW, **kw)
    names = [n for n, _ in ptr.model.named_parameters()]
    ptr.load_state(_jax_blob(jtr, names))
    return jtr, ptr, names


def _replayed(jtr, jbatch):
    """The JAX step's draws: t [accum, B], x_end [accum, B, ...] or None and
    fade offsets [accum, B, 2] or None."""
    jop = jtr.diffusion.op
    _, *rngs = jax.random.split(jtr.state.rng, ACCUM + 1)
    ts, ends, offs = [], [], []
    for r, x in zip(rngs, jbatch):
        loss_rng, _, end_rng = jax.random.split(r, 3)
        t_rng, op_rng = jax.random.split(loss_rng)
        ts.append(np.asarray(jax.random.randint(t_rng, (B,), 0, jop.timesteps)))
        x_end = jop.sample_x_end(end_rng, x)
        ends.append(None if x_end is None else np.asarray(x_end))
        offs.append(np.asarray(jop._draw_offsets(op_rng, B)) if hasattr(jop, "_draw_offsets")
                    else None)
    stack = (lambda a: None if a[0] is None else torch.from_numpy(np.stack(a)))
    return torch.from_numpy(np.stack(ts)).long(), stack(ends), stack(offs)


@pytest.mark.parametrize("name", ["fade_generation", "fade"])
def test_one_step_matches_jax_trainer(tmp_path, name):
    """One optimizer step with the JAX draws replayed: fade generation's
    endpoints, Random_Incremental fade's per-loss crops.  Neither Trainer
    resets a fade operator: its baked offsets stay unset."""
    jtr, ptr, names = _trainers(tmp_path, name)
    jbatch, _ = jtr._next_superbatch()
    pbatch = ptr._next_superbatch()
    np.testing.assert_array_equal(np.asarray(jbatch), pbatch.numpy())
    t, x_end, offsets = _replayed(jtr, jbatch)
    assert (x_end is None) == (name == "fade") and (offsets is None) == (name != "fade")
    jtr._maybe_reset_op()
    jtr.state, jloss = jtr._train_step(jtr.state, jtr.diffusion, jbatch, None)
    ploss = ptr.train_step(pbatch, t=t, x_end=x_end, rng=offsets)
    want = _jax_blob(jtr, names)
    assert ptr.step == want["step"] == 1
    np.testing.assert_allclose(ploss.item(), float(jloss), rtol=1e-5)
    for part in ("model", "ema"):
        _assert_fp32_params(ptr.state()[part], want[part], part)
    if name == "fade":
        assert jtr.diffusion.op.offsets is None and ptr.diffusion.op.offsets is None


def test_family_b_trainer_draws_endpoints_and_snapshots(tmp_path):
    """train(): each microbatch draws its endpoint from the Trainer's
    generator, and the snapshot draws one for prepare_start and sample."""
    d = ColdDiffusion(op=get_operator("fade_generation", **OPS["fade_generation"],
                                      device="cpu"), image_size=S)
    kw = {**KW, "save_and_sample_every": 2}
    tr = Trainer(d, UnetConvNext(dim=DIM, dim_mults=MULTS),
                 datasets.SyntheticDataset(S, 3, length=16), results_folder=str(tmp_path),
                 device="cpu", train_num_steps=2, **kw)
    seen = []
    draw = tr.diffusion.op.sample_x_end
    tr.diffusion.op.sample_x_end = lambda gen, x: (seen.append(gen), draw(gen, x))[1]
    assert tr.train(log_every=1) == "done"
    # 2 steps x 2 microbatches from the Trainer's generator, then the snapshot's
    assert seen[:4] == [tr.generator] * 4 and len(seen) == 5 and seen[4] is not tr.generator
    for part in ("og", "xt", "direct_recons", "sample"):
        assert (tmp_path / f"{part}-1.png").exists()


class _SnowLike(Degradation):
    """A deterministic operator with ``random_snow``: it records the first
    draw of each generator its reset is given."""

    random_snow = True

    def __init__(self):
        super().__init__(4)
        self.draws = []

    def degrade(self, x, n, *, x_end=None, rng=None):
        return x

    def reset(self, generator, batch_size):
        self.draws.append(torch.randint(0, 2**31 - 1, (), generator=generator).item())
        return self


def test_reset_rule_matches_jax_trainer(tmp_path):
    """Both Trainers reset only ``random_snow`` operators, once per step,
    from a stream of their own seeded by the step alone: the same step
    gives the same draw whatever the Trainer's seed, the training
    generator is untouched, and fade (``random_snow`` unset) is never reset."""
    jd = JColdDiffusion(op=JSnow.create(image_size=S, timesteps=4, random_snow=True,
                                        batch_size=B), image_size=S)
    fields = {}
    for seed in (0, 1):
        jtr = JTrainer(jd, JUnetConvNext(dim=DIM, dim_mults=MULTS),
                       jdatasets.SyntheticDataset(S, 3, length=16),
                       results_folder=str(tmp_path / f"j{seed}"),
                       mesh=make_mesh(jax.devices()[:1]), **{**KW, "seed": seed})
        for step in (0, 1):
            jtr.step = step
            jtr._maybe_reset_op()
            fields[seed, step] = np.asarray(jtr.diffusion.op.snow)
    assert np.array_equal(fields[0, 0], fields[1, 0])
    assert np.array_equal(fields[0, 1], fields[1, 1])
    assert not np.array_equal(fields[0, 0], fields[0, 1])

    draws = {}
    for seed in (0, 1):
        op = _SnowLike()
        tr = Trainer(ColdDiffusion(op=op, image_size=S), UnetConvNext(dim=DIM, dim_mults=MULTS),
                     datasets.SyntheticDataset(S, 3, length=16),
                     results_folder=str(tmp_path / f"p{seed}"), device="cpu",
                     **{**KW, "seed": seed})
        ref = torch.Generator().manual_seed(seed)
        for _ in range(2):
            tr.train_step(tr._next_superbatch())
            torch.randint(0, op.timesteps, (B,), generator=ref)  # the t draws alone
            torch.randint(0, op.timesteps, (B,), generator=ref)
        assert torch.equal(tr.generator.get_state(), ref.get_state())
        draws[seed] = op.draws
    assert len(draws[0]) == 2 and draws[0] == draws[1] and draws[0][0] != draws[0][1]

    fade = get_operator("fade", **OPS["fade"], device="cpu")
    tr = Trainer(ColdDiffusion(op=fade, image_size=S), UnetConvNext(dim=DIM, dim_mults=MULTS),
                 datasets.SyntheticDataset(S, 3, length=16),
                 results_folder=str(tmp_path / "fade"), device="cpu", **KW)
    op = tr.diffusion.op  # the Trainer's copy on its device
    tr.train_step(tr._next_superbatch())
    assert tr.diffusion.op is op and op.offsets is None
