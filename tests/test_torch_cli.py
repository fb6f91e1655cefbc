"""The port's command line == colddiff's, and the port's CLI end to end.

- The parsers: the same option strings, dests, defaults, types, choices
  and actions for ``train`` and ``test``, plus ``--device`` alone and the
  ``UnetADM`` choice of ``--model``.
- The ``--test_type`` table: read from ``colddiff/cli/main.py`` with ``ast``
  (no JAX Trainer is built), every name the JAX ``run_test`` accepts and the
  harness method it calls; the port's ``dispatch`` calls that method.
- ``make_operator``/``build``: the operator tables of every degradation
  equal the JAX ones at fp32 1e-6.
- One ``train`` step through the port's CLI for each degradation (16 px,
  dim 8, T=3, ``--device cpu``), as ``tests/test_cli_matrix.py`` does, a
  ``train`` -> ``test --load_path`` round trip with the ``refresh_every``
  stamp, and one subprocess canary of ``python -m colddiff_torch.cli.main``
  through the restart supervisor.
"""

import argparse
import ast
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from colddiff_torch.cli import dispatch as pdispatch

jcli = importlib.import_module("colddiff.cli.main")
pcli = importlib.import_module("colddiff_torch.cli.main")
REPO = Path(__file__).resolve().parents[1]

# tests/test_cli_matrix.py:13-24
CASES = {
    "blur": ["--blur_size", "3", "--blur_std", "1.0", "--blur_routine", "Constant"],
    "noise": [],
    "decolor": ["--decolor_routine", "Linear", "--decolor_total_remove"],
    "fade": ["--fade_routine", "Random_Incremental", "--kernel_std", "0.2",
             "--initial_mask", "2"],
    "fade_naive": ["--fade_routine", "Spiral"],
    "fade_generation": ["--kernel_std", "0.2", "--initial_mask", "2"],
    "resolution": ["--resolution_routine", "Incremental_factor_2"],
    "snow": ["--snow_level", "2", "--random_snow"],
    "mix": [],
}
TOY = ["--dataset", "synthetic", "--image_size", "16", "--time_steps", "3",
       "--model", "UnetConvNext", "--dim", "8", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def second_folder(tmp_path):
    folder = tmp_path / "second"
    folder.mkdir()
    rng = np.random.default_rng(0)
    for i in range(10):
        Image.fromarray((rng.random((18, 18, 3)) * 255).astype(np.uint8)).save(
            folder / f"{i}.png")
    return folder


# ---------------------------------------------------------------------- #
# the parser and the dispatch table


def _options(parser, command):
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices, a.nargs,
                     a.const, a.required, type(a).__name__)
            for a in sub.choices[command]._actions}


@pytest.mark.parametrize("command", ["train", "test"])
def test_parser_equals_jax_plus_device(command):
    want = _options(jcli.build_parser(), command)
    got = _options(pcli.build_parser(), command)
    assert set(got) - set(want) == {"device"} and set(want) <= set(got)
    for dest, spec in want.items():
        if dest == "model":  # the port adds guided-diffusion's ADM, which JAX lacks
            assert got[dest][3] == [*spec[3], "UnetADM"]
            spec = (*spec[:3], got[dest][3], *spec[4:])
        assert got[dest] == spec, dest
    assert got["device"][:2] == (("--device",), "cuda")
    args = pcli.build_parser().parse_args([command, "--bs", "3", "--resolution", "8",
                                           "--order_seed", "5",
                                           "--forward_process_type", "snow"])
    assert (args.batch_size, args.image_size, args.seed, args.degradation) == (3, 8, 5, "snow")


def _jax_test_types():
    """{--test_type name: harness method} and the dead names, read from the
    source of the JAX ``run_test``."""
    tree = ast.parse((REPO / "colddiff" / "cli" / "main.py").read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "run_test")
    table, dead = {}, None
    for node in ast.walk(fn):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "_DEAD_UPSTREAM"):
            dead = tuple(ast.literal_eval(node.value))
        if not (isinstance(node, ast.If) and isinstance(node.test, ast.Compare)
                and isinstance(node.test.left, ast.Name) and node.test.left.id == "tt"):
            continue
        op, rhs = node.test.ops[0], node.test.comparators[0]
        if isinstance(rhs, ast.Name):  # tt in _DEAD_UPSTREAM
            continue
        names = ((ast.literal_eval(rhs),) if isinstance(op, ast.Eq)
                 else tuple(ast.literal_eval(rhs)))
        calls = [c.func.attr for stmt in node.body for c in ast.walk(stmt)
                 if isinstance(c, ast.Call) and isinstance(c.func, ast.Attribute)
                 and isinstance(c.func.value, ast.Name) and c.func.value.id == "harness"]
        if calls:
            table.update(dict.fromkeys(names, calls[0]))
    return table, dead


def test_test_type_table_equals_jax():
    table, dead = _jax_test_types()
    assert len(table) == 43 and len(dead) == 4
    assert pcli.TEST_TYPES == table
    assert pcli.DEAD_UPSTREAM == dead


class _Recorder:
    """A harness that records the methods called on it."""

    def __init__(self, folder):
        self.results_folder = Path(folder)
        self.calls = []

    def __getattr__(self, name):
        def call(*args, **kw):
            self.calls.append(name)
            return argparse.Namespace(img=np.zeros((2, 4, 4, 3), np.float32))
        return call


def test_every_test_type_dispatches_to_its_jax_method(tmp_path):
    table, dead = _jax_test_types()
    ds = [np.zeros((4, 4, 3), np.float32)] * 5
    for tt, method in table.items():
        args = pcli.build_parser().parse_args(["test", "--test_type", tt, "--batch_size", "2",
                                               "--save_folder", str(tmp_path)])
        h = _Recorder(tmp_path)
        if method == "fid_distance_decrease_from_manifold":
            h.fid_distance_decrease_from_manifold = (
                lambda *a, **k: h.calls.append("fid_distance_decrease_from_manifold")
                or {"refresh_every": 1})
        pcli.dispatch(h, args, ds)
        assert h.calls == [method], tt
    assert json.loads((tmp_path / "manifold_metrics.json").read_text()) == {"refresh_every": 1}
    for tt in (*dead, "no_such_test"):
        args = pcli.build_parser().parse_args(["test", "--test_type", tt])
        with pytest.raises(SystemExit, match="dead in the reference" if tt in dead
                           else "unknown --test_type"):
            pcli.dispatch(_Recorder(tmp_path), args, ds)


@pytest.mark.parametrize("degradation", sorted(CASES))
def test_make_operator_and_build_equal_jax(degradation):
    argv = ["train", "--degradation", degradation, *TOY, "--batch_size", "4",
            *CASES[degradation]]
    jargs = jcli.build_parser().parse_args([a for a in argv if a not in ("--device", "cpu")])
    pargs = pcli.build_parser().parse_args(argv)
    jd, jmodel, jsize, jch = jcli.build(jargs)
    pd, pmodel, psize, pch = pcli.build(pargs)
    assert (psize, pch) == (jsize, jch) == (16, 3)
    for field in ("image_size", "channels", "loss_type", "train_routine",
                  "sampling_routine", "discrete", "recon_noise_std"):
        assert getattr(pd, field) == getattr(jd, field), field
    assert type(pd.op).__name__ == type(jd.op).__name__
    assert pd.op.timesteps == jd.op.timesteps == 3
    pop, jop = pd.op, jd.op
    if getattr(pop, "random_snow", False):
        # an unseeded draw on each side: compare the fields of one seed
        pop, jop = pop.reseed(7, 4), jop._generate(batch_size=4, seed=7)
    for name, value in pop.state().items():
        want = np.asarray(getattr(jop, name))
        np.testing.assert_allclose(value.double().numpy(), want.astype(np.float64),
                                   rtol=0, atol=1e-6, err_msg=name)
    assert type(pmodel).__name__ == type(jmodel).__name__
    shapes = jax.eval_shape(jmodel.init, jax.random.key(0), jnp.zeros((1, 16, 16, 3)),
                            jnp.zeros((1,), jnp.int32))
    assert (sum(p.numel() for p in pmodel.parameters())
            == sum(np.prod(x.shape) for x in jax.tree_util.tree_leaves(shapes)))


# ---------------------------------------------------------------------- #
# the CLI end to end on the CPU


@pytest.mark.parametrize("degradation", sorted(CASES))
def test_cli_one_step_train(tmp_path, second_folder, degradation):
    extra = ["--data_path_2", str(second_folder)] if degradation == "mix" else []
    pcli.main(["train", "--degradation", degradation, *TOY, "--batch_size", "8",
               "--train_steps", "1", "--grad_accum", "1", "--save_and_sample_every", "100",
               "--save_folder", str(tmp_path / "out"), *CASES[degradation], *extra])
    blob = torch.load(tmp_path / "out" / "model.pt", map_location="cpu")
    assert blob["step"] == 1
    assert all(torch.isfinite(v).all() for v in blob["model"].values())


def test_cli_train_then_test_and_refresh_every_stamp(tmp_path):
    common = ["--degradation", "blur", *TOY, *CASES["blur"], "--batch_size", "8",
              "--save_folder", str(tmp_path / "out")]
    pcli.main(["train", *common, "--train_steps", "2", "--grad_accum", "1",
               "--save_and_sample_every", "2"])
    ckpt = tmp_path / "out" / "model.pt"
    assert ckpt.exists() and (tmp_path / "out" / "sample-1.png").exists()
    pcli.main(["test", *common, "--test_type", "test_data", "--load_path", str(ckpt),
               "--save_folder", str(tmp_path / "eval")])
    assert list((tmp_path / "eval").glob("*.png")), "test_from_data wrote no grids"
    for k in (4, 1):
        extra = ["--refresh_every", str(k)] if k != 1 else []
        pcli.main(["test", *common, "--test_type", "test_fid_distance_decrease_from_manifold",
                   "--test_end", "8", "--load_path", str(ckpt), *extra])
        metrics = json.loads((tmp_path / "out" / "manifold_metrics.json").read_text())
        assert metrics["refresh_every"] == k
        assert all(np.isfinite(v) for v in metrics.values() if isinstance(v, float))


def test_cli_test_loads_the_ema_model(tmp_path, monkeypatch):
    """``test`` hands the checkpoint's EMA weights to the harness."""
    common = ["--degradation", "blur", *TOY, *CASES["blur"], "--batch_size", "4",
              "--save_folder", str(tmp_path)]
    pcli.main(["train", *common, "--train_steps", "1", "--grad_accum", "1",
               "--save_and_sample_every", "100"])
    blob = torch.load(tmp_path / "model.pt", map_location="cpu")
    seen = {}
    monkeypatch.setattr(pcli, "dispatch",
                        lambda h, args, ds, ds2=None: seen.update(h=h, ds=ds, ds2=ds2))
    pcli.main(["test", *common, "--load_path", str(tmp_path / "model.pt")])
    model = seen["h"].model.state_dict()
    assert all(torch.equal(model[k], v) for k, v in blob["ema"].items())
    assert seen["ds2"] is None and seen["h"].device.type == "cpu"


def test_cli_to_lab_decolor_train(tmp_path):
    pcli.main(["train", "--degradation", "decolor", "--decolor_routine", "Linear",
               "--to_lab", *TOY, "--batch_size", "8", "--train_steps", "1",
               "--grad_accum", "1", "--save_and_sample_every", "1",
               "--save_folder", str(tmp_path / "out")])
    for name in ("og", "xt", "direct_recons", "sample"):
        assert (tmp_path / "out" / f"{name}-1.png").exists()


def test_cli_refuses_what_it_cannot_do(tmp_path):
    base = ["train", *TOY, "--save_folder", str(tmp_path)]
    # the three values of a group without a launcher come together
    for extra in (["--coordinator_address", "localhost:1234"],
                  ["--multihost", "--num_processes", "2"]):
        with pytest.raises(ValueError, match="together"):
            pcli.main(base + extra)
    with pytest.raises(SystemExit, match="data_path_2"):
        pcli.main(base + ["--degradation", "mix", "--train_steps", "0"])
    if not torch.cuda.is_available():
        # cuda by default, never a silent move to the CPU
        with pytest.raises(RuntimeError, match="--device cpu"):
            pcli.main([a for a in base if a not in ("--device", "cpu")])
    assert not list(tmp_path.iterdir())


def test_supervisor_respawns_once_through_the_entry_point(tmp_path):
    """The one subprocess canary: ``--restart_every_steps 1 --train_steps 2``
    runs a supervisor and two workers; the first stops at the step-1
    boundary, the second resumes and finishes."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    env.pop("COLDDIFF_RESTART_WORKER", None)
    r = subprocess.run(
        [sys.executable, "-m", "colddiff_torch.cli.main", "train", *TOY, *CASES["blur"],
         "--batch_size", "8", "--train_steps", "2", "--grad_accum", "1",
         "--save_and_sample_every", "100", "--restart_every_steps", "1",
         "--save_folder", str(tmp_path)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.count("hit restart boundary; respawning") == 1, r.stdout
    assert "step 1: restart boundary" in r.stdout
    assert torch.load(tmp_path / "model.pt", map_location="cpu")["step"] == 2


def test_supervisor_is_skipped_in_a_worker(monkeypatch):
    args = pcli.build_parser().parse_args(["train", "--restart_every_steps", "3"])
    assert pcli._is_restart_supervisor(args)
    monkeypatch.setenv("COLDDIFF_RESTART_WORKER", "1")
    assert not pcli._is_restart_supervisor(args)
    assert pcli._RESTART_EXIT_CODE == jcli._RESTART_EXIT_CODE == 75


def test_slurm_dispatch_equals_jax_but_the_partition(tmp_path):
    jdispatch = importlib.import_module("colddiff.cli.dispatch")
    jobs = tmp_path / "jobs.txt"
    jobs.write_text("# a comment\npython -m colddiff_torch.cli.main train --bs 8\n\n"
                    "python -m colddiff_torch.cli.main test --test_type test_data\n")
    for mod, name in ((jdispatch, "jax"), (pdispatch, "port")):
        mod.main([str(jobs), "--out", str(tmp_path / name), "--partition", "gpu",
                  "--workdir", str(tmp_path)])
    for i in range(2):
        want = (tmp_path / "jax" / f"colddiff-{i}.sh").read_text()
        got = (tmp_path / "port" / f"colddiff-{i}.sh").read_text()
        assert got == want.replace(str(tmp_path / "jax"), str(tmp_path / "port"))
    pdispatch.main([str(jobs), "--out", str(tmp_path / "default")])
    assert "#SBATCH --partition=gpu" in (tmp_path / "default" / "colddiff-0.sh").read_text()
