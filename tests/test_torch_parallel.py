"""The port's data parallelism (``colddiff_torch.parallel``) against one
process and against the JAX package's mesh.

One group of two CPU processes over gloo (one torch thread each) serves
the checks below that need one; each rank runs the same calls and rank 0
saves what they gave, and this process computes the 1-process references.
The configuration is the suite's tiny one: UnetConvNext dim 8 (1, 2) or a
one-block ResNet at 16 px, B=4 global (2 a process), accum 2.

Tolerances, stated per check:
  - the 2-process step and sample against one process: the JAX dry run's
    (loss rtol 1e-5 / atol 1e-6, params rtol 1e-4 / atol 1e-5, samples
    2e-5), through ``dryrun_multichip``'s own check; the dropout, snow and
    fade steps at the same loss and params tolerances;
  - the 2-process step against JAX's on a 2-device mesh: the fp32 bound of
    tests/test_torch_train.py (params within 1e-7 + 1e-5 |p| for all but 1
    in 10^4 entries, lr for all; loss rtol 1e-5);
  - FSDP against replicated over 2 steps: params and EMA rtol 1e-5 / atol
    1e-6, as tests/test_parallel.py:103-134 holds JAX;
  - the mesh harness against one device: rtol 1e-4 / atol 1e-5, as
    tests/test_parallel.py:174-212;
  - checkpoints: bitwise.
"""

import os
import socket
from pathlib import Path

import numpy as np
import pytest
import torch

from colddiff_torch import parallel
from colddiff_torch.data import datasets
from colddiff_torch.diffusion import ColdDiffusion
from colddiff_torch.eval import EvalHarness
from colddiff_torch.models import UnetConvNext, UnetResNet
from colddiff_torch.operators import get_operator
from colddiff_torch.scripts import dryrun_multichip
from colddiff_torch.train import Trainer

S, DIM, MULTS = 16, 8, (1, 2)
N, B, ACCUM = 2, 4, 2  # processes, global batch, microbatches
BLUR = dict(image_size=S, timesteps=8, blur_routine="Exponential_reflect",
            kernel_size=15, kernel_std=0.01)
OPS = {
    "blur": BLUR,
    "snow": dict(image_size=S, timesteps=6, snow_level=4, random_snow=True, single_snow=True,
                 batch_size=B),
    "fade": dict(image_size=S, timesteps=6, fade_routine="Random_Incremental",
                 kernel_std=0.1, initial_mask=1),
}
RESNET = dict(ch=32, ch_mult=(1,), num_res_blocks=1, attn_resolutions=(S,), resolution=S)
KW = dict(train_batch_size=B, gradient_accumulate_every=ACCUM, step_start_ema=2,
          update_ema_every=1, save_and_sample_every=10**9, num_workers=1, seed=0)
JAX_STEPS, JAX_MULTS = 2, (1,)  # one level halves the JAX Trainer's set-up


class _Mesh:
    """What ``shard_batch`` reads of a DeviceMesh."""

    def __init__(self, rank, size):
        self.rank, self.n = rank, size

    def get_local_rank(self):
        return self.rank

    def size(self):
        return self.n


def _trainer(folder, op="blur", model="convnext", dropout=0.0, mults=MULTS, **kw):
    d = ColdDiffusion(op=get_operator(op, **OPS[op], device="cpu"), image_size=S,
                      sampling_routine="x0_step_down")
    torch.manual_seed(0)
    net = (UnetConvNext(dim=DIM, dim_mults=mults) if model == "convnext"
           else UnetResNet(**RESNET, dropout=dropout))
    return Trainer(d, net, datasets.SyntheticDataset(S, 3, length=16),
                   results_folder=str(folder), device="cpu", **{**KW, **kw})


def _harness(folder, mesh=None):
    d = ColdDiffusion(op=get_operator("blur", **BLUR, device="cpu"), image_size=S,
                      sampling_routine="x0_step_down")
    torch.manual_seed(0)
    return EvalHarness(d, UnetConvNext(dim=DIM, dim_mults=MULTS), results_folder=str(folder),
                       mesh=mesh, device="cpu")


def _state(tr):
    s = tr.state()
    return {k: s[k] for k in ("step", "model", "ema", "opt")}


def _rank(rank, port, root, inputs):
    """One process of the group: every check's 2-process side; ``inputs``
    gives the path of the JAX mesh's inputs when they are ready."""
    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(N))
    torch.set_num_threads(1)
    root = Path(root)
    parallel.init_multihost(f"localhost:{port}", N, rank, device="cpu")
    mesh = parallel.make_mesh("cpu")
    got = {}

    # replicated and FSDP, 2 steps of train() each; their checkpoints
    rep = _trainer(root / "rep", mesh=mesh, train_num_steps=2, save_and_sample_every=2)
    rep.train(log_every=10)
    fsdp = _trainer(root / "fsdp", mesh=mesh, train_num_steps=2, save_and_sample_every=2,
                    param_sharding="fsdp", fsdp_min_size=1)
    got["fsdp_dtensors"] = sum(isinstance(p, torch.distributed.tensor.DTensor)
                               for p in fsdp.model.parameters())
    fsdp.train(log_every=10)
    got["rep"], got["fsdp"] = _state(rep), _state(fsdp)
    # a 1-process-layout checkpoint (the replicated run's) into an FSDP Trainer
    back = _trainer(root / "back", mesh=mesh, param_sharding="fsdp", fsdp_min_size=1,
                    load_path=str(root / "rep" / "model.pt"))
    got["back"] = _state(back)

    # dropout, random snow and Random_Incremental fade: one step from the loaders
    for name, kw in (("dropout", dict(model="resnet", dropout=0.3)), ("snow", dict(op="snow")),
                     ("fade", dict(op="fade"))):
        tr = _trainer(root / f"{name}{rank}", mesh=mesh, **kw)
        local = tr._next_superbatch()
        loss = tr.train_step(local).item()
        got[name] = dict(loss=loss, batch=parallel.gather_rows(local, mesh, dim=1),
                         model=tr.state()["model"])

    # the mesh harness: the manifold table (batches of 5 and 1 pad to 6 and 2)
    # and a reconstruction grid, written by rank 0 alone
    h = _harness(root / f"harness{rank}", mesh)
    got["manifold"] = h.fid_distance_decrease_from_manifold(
        datasets.SyntheticDataset(S, 3, length=6, seed=3), end=6, batch_size=5)
    h.controlled_direct_reconstruct(np.stack([datasets.SyntheticDataset(S, 3)[i]
                                              for i in range(4)]))
    got["files"] = sorted(p.name for p in (root / f"harness{rank}").iterdir())
    got["files"] = parallel.gather_rows(torch.tensor([len(got["files"])]), mesh).tolist()

    # dryrun_multichip's own steps 1-4 on this group
    got["dryrun"] = dryrun_multichip.process_checks(dryrun_multichip.TINY, mesh, None,
                                                    str(root / f"dry{rank}"))
    # the JAX mesh's step, from its state and with its t draws, on this
    # rank's rows (the JAX Trainer runs meanwhile in the parent)
    inp = torch.load(inputs.get(timeout=600))
    tr = _trainer(root / f"jax{rank}", mesh=mesh, mults=JAX_MULTS)
    tr.load_state(inp["init"])
    losses = [tr.train_step(parallel.shard_batch(b, mesh, 1),
                            t=parallel.shard_batch(t, mesh, 1)).item()
              for b, t in zip(inp["batches"], inp["ts"])]
    got["jax"] = dict(losses=losses, **_state(tr))
    if rank == 0:
        torch.save(got, root / "got.pt")
    torch.distributed.destroy_process_group()


def _replayed_t(state_rng, timesteps):
    """The [accum, B] levels the JAX train step draws from ``state_rng``
    (colddiff/train.py:277-286, colddiff/diffusion.py:152-153)."""
    import jax

    _, *rngs = jax.random.split(state_rng, ACCUM + 1)
    ts = []
    for r in rngs:
        loss_rng, _, _ = jax.random.split(r, 3)
        t_rng, _ = jax.random.split(loss_rng)
        ts.append(np.asarray(jax.random.randint(t_rng, (B,), 0, timesteps)))
    return torch.from_numpy(np.stack(ts)).long()


def _jax_mesh_steps(folder):
    """JAX's Trainer on a 2-device mesh: its first state (in the port's
    layout), JAX_STEPS superbatches with their t draws, and its state after."""
    import jax

    from colddiff.data import datasets as jdatasets
    from colddiff.diffusion import ColdDiffusion as JColdDiffusion
    from colddiff.models import UnetConvNext as JUnetConvNext
    from colddiff.operators.blur import GaussianBlur as JGaussianBlur
    from colddiff.parallel import make_mesh
    from colddiff.train import Trainer as JTrainer
    from tests.test_torch_train import _jax_blob

    d = JColdDiffusion(op=JGaussianBlur.create(**BLUR), image_size=S,
                       sampling_routine="x0_step_down")
    jtr = JTrainer(d, JUnetConvNext(dim=DIM, dim_mults=JAX_MULTS),
                   jdatasets.SyntheticDataset(S, 3, length=16), results_folder=str(folder),
                   mesh=make_mesh(jax.devices()[:N]), **KW)
    names = [n for n, _ in UnetConvNext(dim=DIM, dim_mults=JAX_MULTS).named_parameters()]
    init = _jax_blob(jtr, names)
    batches, ts, losses = [], [], []
    for _ in range(JAX_STEPS):
        jbatch, _ = jtr._next_superbatch()
        batches.append(torch.from_numpy(np.asarray(jbatch)))
        ts.append(_replayed_t(jtr.state.rng, BLUR["timesteps"]))
        jtr.state, loss = jtr._train_step(jtr.state, jtr.diffusion, jbatch, None)
        losses.append(float(loss))
    return dict(init=init, batches=batches, ts=ts), dict(losses=losses, **_jax_blob(jtr, names))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The two-process group's results, and the JAX mesh's."""
    import torch.multiprocessing as mp

    root = tmp_path_factory.mktemp("parallel")
    port = _free_port()
    ctx = mp.get_context("spawn")
    queues = [ctx.Queue() for _ in range(N)]
    procs = [ctx.Process(target=_rank, args=(r, port, str(root), q))
             for r, q in enumerate(queues)]
    for p in procs:
        p.start()
    inputs, jax_out = _jax_mesh_steps(root / "jaxtr")
    torch.save(inputs, root / "jax_inputs.pt")
    for q in queues:
        q.put(str(root / "jax_inputs.pt"))
    for p in procs:
        p.join(300)
    for p in procs:
        if p.is_alive():
            p.kill()
    assert [p.exitcode for p in procs] == [0] * N
    return root, torch.load(root / "got.pt"), jax_out


def _assert_params(got: dict, want: dict, rtol, atol, what):
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=rtol, atol=atol,
                                   msg=lambda m: f"{what} {k}: {m}")


# ---------------------------------------------------------------------- #
# the placement rules, without a group


def test_fsdp_sharding_leaf_rule_on_the_flagship():
    """JAX's rule on the flagship's torch shapes: < min_size stays
    replicated, else the largest dimension the mesh divides, the later on a
    tie; a size no dimension divides stays replicated."""
    from torch.distributed.tensor import Replicate, Shard

    model = UnetConvNext(dim=64, dim_mults=(1, 2, 4, 8))
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    rule = parallel.fsdp_sharding(model, 2)
    assert set(rule) == set(shapes)
    for name, shape in shapes.items():
        (place,) = rule[name]
        if np.prod(shape) < 2 ** 14:
            assert place == Replicate(), name
        else:
            best = max((d for d in range(len(shape)) if shape[d] % 2 == 0),
                       key=lambda d: (shape[d], d))
            assert place == Shard(best), (name, shape)
    # min_size, ties and a size no dimension divides
    t = {"small": torch.zeros(127, 128), "tie": torch.zeros(256, 256, 1, 1),
         "wide": torch.zeros(3, 2 ** 15), "odd": torch.zeros(3, 5 ** 7)}
    assert parallel.fsdp_sharding(t, 2) == {"small": (Replicate(),), "tie": (Shard(1),),
                                            "wide": (Shard(1),), "odd": (Replicate(),)}
    assert parallel.fsdp_sharding(t, 3, min_size=1)["wide"] == (Shard(0),)
    assert rule["downs.0.0.ds_conv.weight"] == (Replicate(),)  # [3, 1, 7, 7]: 147 < 2^14
    assert rule["mid_block1.net.1.weight"] == (Shard(0),)  # [1024, 512, 3, 3]
    assert rule["mid_attn.fn.fn.to_qkv.weight"] == (Shard(1),)  # [384, 512, 1, 1]
    with pytest.raises(ValueError, match="unknown param_sharding"):
        parallel.shard_state(model, _Mesh(0, 1), "zero3")


def test_shard_batch_and_batch_rows():
    x = torch.arange(2 * 6 * 3).reshape(2, 6, 3)
    for r in range(3):
        np.testing.assert_array_equal(parallel.shard_batch(x, _Mesh(r, 3), 1),
                                      x[:, 2 * r:2 * r + 2])
    np.testing.assert_array_equal(parallel.shard_batch(x.numpy(), _Mesh(1, 2)), x[1:])
    with pytest.raises(ValueError, match="does not divide"):
        parallel.shard_batch(x, _Mesh(0, 4), 1)
    # draws inside batch_rows are the global batch's rows, the generator's
    # stream moved as by the global draw
    def draw(gen):
        return lambda n: torch.rand(n, 5, generator=gen)

    ref = torch.Generator().manual_seed(3)
    full = draw(ref)(6)
    gen = torch.Generator().manual_seed(3)
    with parallel.batch_rows(2, 3):
        assert parallel.local_rows(2) == slice(4, 6)
        assert torch.equal(parallel.draw_rows(draw(gen), 2), full[4:])
    assert torch.equal(gen.get_state(), ref.get_state())
    assert parallel.local_rows(2) == slice(0, 2)
    assert torch.equal(parallel.draw_rows(draw(gen), 2), draw(ref)(2))


class _Mesh2D:
    """What ``shard_images`` and ``image_rows`` read of a 2-D DeviceMesh."""

    mesh_dim_names = ("data", "space")

    def __init__(self, place, shape):
        self.axes = {name: _Mesh(r, n) for name, r, n in zip(self.mesh_dim_names, place, shape)}

    def __getitem__(self, name):
        return self.axes[name]


def test_spatial_sharding_functions_and_their_wrong_arguments():
    """make_mesh_2d needs the group; image_sharding places batch and rows;
    shard_images cuts a process's block and refuses sizes its mesh does not
    divide; image_rows on a space axis of one sets the batch rows alone.
    (Row-sharded runs on a group: tests/test_torch_spatial.py.)"""
    from torch.distributed.tensor import Shard

    from colddiff_torch.parallel import spatial

    with pytest.raises(RuntimeError, match="init_multihost"):
        parallel.make_mesh_2d(1, 2, "cpu")
    with pytest.raises(RuntimeError, match="init_multihost"):
        parallel.make_mesh("cpu")
    assert parallel.image_sharding(None) == (Shard(0), Shard(1))
    x = torch.arange(4 * 6 * 2 * 3).reshape(4, 6, 2, 3)
    for d in range(2):
        for r in range(3):
            block = parallel.shard_images(x, _Mesh2D((d, r), (2, 3)))
            assert torch.equal(block, x[2 * d:2 * d + 2, 2 * r:2 * r + 2])
    np.testing.assert_array_equal(parallel.shard_images(x.numpy(), _Mesh2D((1, 0), (4, 2))),
                                  x[1:2, :3])
    with pytest.raises(ValueError, match="batch of 4 images does not divide over the 3"):
        parallel.shard_images(x, _Mesh2D((0, 0), (3, 1)))
    with pytest.raises(ValueError, match="6 rows do not divide over the 4 processes"):
        parallel.shard_images(x, _Mesh2D((0, 0), (1, 4)))
    with parallel.image_rows(_Mesh2D((1, 0), (2, 1))):
        assert spatial.current() is None and parallel.local_rows(3) == slice(3, 6)
    assert parallel.local_rows(3) == slice(0, 3)


# ---------------------------------------------------------------------- #
# two processes


def test_two_process_step_and_sample_equal_one_process(group):
    """dryrun_multichip's steps on the group, held by its own check."""
    root, got, _ = group
    res = dryrun_multichip.check(got["dryrun"], dryrun_multichip.TINY, torch.device("cpu"),
                                 None, str(root / "dry"))
    assert res["backend"] == "gloo" and res["samples_max_err"] <= 2e-5


def test_two_process_step_matches_jax_two_device_mesh(group):
    """The port over 2 processes == JAX's Trainer on a 2-device mesh, from
    one state, on JAX's batches, with JAX's t draws."""
    from tests.test_torch_train import _assert_fp32_params

    _, got, want = group
    np.testing.assert_allclose(got["jax"]["losses"], want["losses"], rtol=1e-5)
    assert got["jax"]["step"] == want["step"] == JAX_STEPS
    for part in ("model", "ema"):
        _assert_fp32_params(got["jax"][part], want[part], part)


def test_fsdp_equals_replicated_over_two_steps(group):
    root, got, _ = group
    assert got["fsdp_dtensors"] > 0, "fsdp sharded nothing"
    assert got["fsdp"]["step"] == got["rep"]["step"] == 2
    # the snapshot at step 2: rank 0 sampled the gathered EMA
    for part in ("og", "xt", "direct_recons", "sample"):
        assert (root / "fsdp" / f"{part}-1.png").exists()
    for part in ("model", "ema"):
        _assert_params(got["fsdp"][part], got["rep"][part], 1e-5, 1e-6, part)
    for i, st in got["rep"]["opt"]["state"].items():
        for k in ("exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(got["fsdp"]["opt"]["state"][i][k], st[k],
                                       rtol=1e-5, atol=1e-9)


def test_checkpoints_cross_between_fsdp_and_one_process(group, tmp_path):
    """An FSDP run's model.pt loads into a 1-process Trainer, and a
    1-process-layout model.pt into an FSDP Trainer, bitwise."""
    root, got, _ = group
    one = _trainer(tmp_path, load_path=str(root / "fsdp" / "model.pt"))
    for part, want in (("model", got["fsdp"]["model"]), ("ema", got["fsdp"]["ema"])):
        for k, v in want.items():
            assert torch.equal(one.state()[part][k], v), (part, k)
    blob = torch.load(root / "fsdp" / "model.pt")
    assert blob["opt"]["param_groups"][0]["params"] == list(range(len(got["fsdp"]["model"])))
    for i, st in blob["opt"]["state"].items():
        for k, v in st.items():
            assert torch.equal(one.opt.state_dict()["state"][i][k], v)
    assert one.step == 2
    for part in ("model", "ema"):
        for k, v in got["rep"][part].items():
            assert torch.equal(got["back"][part][k], v), (part, k)
    assert got["back"]["step"] == 2


@pytest.mark.parametrize("name", ["dropout", "snow", "fade"])
def test_random_steps_equal_at_one_and_two_processes(group, tmp_path, name):
    """Dropout masks, random snow's per-sample fields and Random_Incremental
    fade's per-loss crops are drawn for the global batch on every process;
    each keeps its rows, so the 2-process step equals the 1-process step on
    the joined batch (the dryrun's loss and params tolerances)."""
    _, got, _ = group
    kw = {"dropout": dict(model="resnet", dropout=0.3), "snow": dict(op="snow"),
          "fade": dict(op="fade")}[name]
    tr = _trainer(tmp_path, **kw)
    loss = tr.train_step(got[name]["batch"]).item()
    np.testing.assert_allclose(got[name]["loss"], loss, rtol=1e-5, atol=1e-6)
    _assert_params(got[name]["model"], tr.state()["model"], 1e-4, 1e-5, name)


def test_mesh_harness_matches_single_device(group, tmp_path):
    _, got, _ = group
    want = _harness(tmp_path).fid_distance_decrease_from_manifold(
        datasets.SyntheticDataset(S, 3, length=6, seed=3), end=6, batch_size=5)
    for k in ("rmse_degraded", "rmse_sampled", "rmse_direct", "ssim_degraded",
              "ssim_sampled", "ssim_direct", "proxy_fid_degraded", "proxy_fid_sampled",
              "proxy_fid_direct"):
        np.testing.assert_allclose(got["manifold"][k], want[k], rtol=1e-4, atol=1e-5,
                                   err_msg=k)
    # only rank 0 wrote the four grids
    assert got["files"] == [4, 0]
