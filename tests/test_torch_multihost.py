"""Multi-process training through the port's command line: two processes ==
one process.  The twin of tests/test_multihost.py.

Two interpreters run ``python -m colddiff_torch.cli.main train ... --device
cpu --coordinator_address localhost:<port> --num_processes 2 --process_id
i`` (gloo, one torch thread each; each reads its stripe of the synthetic
set), first 2 replicated steps, then, resuming from the ``model.pt`` that
both wrote together, a third step with ``--param_sharding fsdp``.  Each
interpreter runs the CLI module under ``runpy`` with ``Trainer.train_step``
wrapped, so it reports the losses it saw and a checksum of its whole
parameters, as tests/_multihost_child.py reports JAX's.  Both processes
must see the same losses and checksums, and equal one process's Trainer
on the same global batches (the two stripes joined) from the same
``--seed`` at rtol 1e-5; the FSDP step's ``model.pt`` at rtol 1e-5 / atol
1e-6, as tests/test_parallel.py holds FSDP against replicated.
"""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from colddiff_torch.cli import main as pcli
from colddiff_torch.data.datasets import DataLoader
from colddiff_torch.train import Trainer

REPO = Path(__file__).resolve().parents[1]
N, B = 2, 8  # processes, global batch
ARGS = ["train", "--dataset", "synthetic", "--image_size", "16", "--time_steps", "3",
        "--blur_size", "3", "--blur_std", "1.0", "--blur_routine", "Constant",
        "--dim", "8", "--batch_size", str(B), "--grad_accum", "1",
        "--save_and_sample_every", "1000", "--device", "cpu"]


def _child(argv):
    """One process: the CLI under runpy, with the Trainer's steps recorded."""
    import runpy

    torch.set_num_threads(1)
    seen = []
    step = Trainer.train_step

    def recorded(self, batch, **kw):
        loss = step(self, batch, **kw)
        seen.append((loss.item(), sum(p.detach().abs().sum().item()
                                      for p in self.model.parameters())))
        return loss

    Trainer.train_step = recorded
    sys.argv = ["colddiff_torch.cli.main", *argv]
    runpy.run_module("colddiff_torch.cli.main", run_name="__main__", alter_sys=True)
    print("RESULT " + json.dumps(seen), flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_pair(extra):
    """Both processes of ``ARGS + extra``; each one's [(loss, checksum)]."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen(
        [sys.executable, "-c", "import sys; from tests.test_torch_multihost import _child; "
         "_child(sys.argv[1:])", *ARGS, *extra, "--coordinator_address", f"localhost:{port}",
         "--num_processes", str(N), "--process_id", str(i)],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(N)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return [json.loads([ln for ln in out.splitlines() if ln.startswith("RESULT ")][-1][7:])
            for out in outs]


def _global_batches(ds, steps):
    """The global batches of ``steps`` steps: the processes' stripes joined."""
    stripes = [iter(DataLoader(ds, B // N, num_workers=1, seed=0, process_index=r,
                               process_count=N)) for r in range(N)]
    return [torch.from_numpy(np.concatenate([next(s) for s in stripes]))[None]
            for _ in range(steps)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two CLI runs of two processes, and one process's three steps."""
    root = tmp_path_factory.mktemp("multihost")
    folder = root / "shared"
    first = _run_pair(["--train_steps", "2", "--save_folder", str(folder)])
    # a collective load of that model.pt on both, one FSDP step, a collective save
    resumed = _run_pair(["--train_steps", "3", "--save_folder", str(folder),
                         "--resume_training", "--param_sharding", "fsdp"])
    args = pcli.build_parser().parse_args(ARGS + ["--save_folder", str(root / "one")])
    diffusion, model, size, channels = pcli.build(args)
    ds = pcli.make_dataset(args, size, train=True, channels=channels)
    tr = Trainer(diffusion, model, ds, train_batch_size=B, gradient_accumulate_every=1,
                 results_folder=str(root / "one"), device="cpu")
    one = []
    for batch in _global_batches(ds, 3):
        loss = tr.train_step(batch).item()
        one.append((loss, sum(p.abs().sum().item() for p in tr.model.parameters())))
    return first, resumed, one, tr.state()["model"], torch.load(folder / "model.pt")


def test_both_processes_see_the_same_steps(runs):
    first, resumed, _, _, _ = runs
    assert first[0] == first[1] and len(first[0]) == 2
    assert resumed[0][0][0] == resumed[1][0][0] and len(resumed[0]) == 1


def test_two_processes_equal_one_on_the_same_global_batches(runs):
    first, _, one, _, _ = runs
    np.testing.assert_allclose([x[0] for x in first[0]], [x[0] for x in one[:2]], rtol=1e-5)
    np.testing.assert_allclose([x[1] for x in first[0]], [x[1] for x in one[:2]], rtol=1e-5)


def test_fsdp_resume_from_the_collective_checkpoint(runs):
    _, resumed, one, want, blob = runs
    np.testing.assert_allclose(resumed[0][0][0], one[2][0], rtol=1e-5)
    assert blob["step"] == 3
    for k, v in want.items():
        torch.testing.assert_close(blob["model"][k], v, rtol=1e-5, atol=1e-6)
