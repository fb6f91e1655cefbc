"""The harness as data, the shape of `BENCHMARK.json` and of a result, and tiny CPU
rehearsals of both drivers through their comparisons: sound runs are
correct, every fault and the control are not."""

import importlib
import json
import re
import shutil
import subprocess
import sys

import pytest

from benchmark import common
from benchmark.run import run
from conftest import CELLS, SAMPLE, TRAIN, tiny

BENCH = common.load_json(common.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_benchmark_json_keeps_its_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"] and 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in BENCH[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert any(m["name"] == "setup_s" and m["bound"] == 0.25 for m in BENCH["end_to_end"])
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}


@pytest.mark.parametrize("name", CELLS)
def test_every_file_of_a_cell_is_found_by_name(name):
    c = common.cell(name)
    importlib.import_module(f"benchmark.drivers.{c['traffic']['kind']}")
    assert c["limits"] and {"setup_s"} < {m["name"] for m in c["end_to_end"]}
    assert c["per_layer"]
    for m in c["per_layer"]:
        params = common.load_json(common.BENCH / "metrics" / f"{m['name']}.json")
        assert hasattr(importlib.import_module(f"benchmark.metrics.{params['reader']}"), "read")
    for cfg in BENCH["configs"]:
        assert common.load_json(common.ROOT / cfg["file"])["name"] == cfg["name"]


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_tiny_rehearsal_is_correct_and_writes_no_device_metric(name, trace):
    result = run(tiny(name), 2 ** 31 + 12345, 0.5, trace, "cpu", 0.0)
    assert list(result) == RESULT_KEYS
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert result["metrics"] == {} and result["device"]["platform"] == "cpu"
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())


@pytest.mark.parametrize("name,fault", [(TRAIN, "state_unchanged"), (TRAIN, "half_batch"),
                                        (SAMPLE, "state_unchanged"), (SAMPLE, "answer_altered")])
def test_a_planted_fault_is_not_correct(name, fault):
    cell = tiny(name)
    driver = importlib.import_module(f"benchmark.drivers.{cell['traffic']['kind']}")
    with driver.plant(fault):
        result = run(cell, 77, 0.5, False, "cpu", 0.0)
    assert result["correct"] is False


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The reference one precision step down in the program's place."""
    cell = tiny(name)
    driver = importlib.import_module(f"benchmark.drivers.{cell['traffic']['kind']}")
    numbers = driver.compare(cell, 5, driver.control(cell, 5, "cpu"), "cpu")
    ok, checks = common.judge(numbers, cell["limits"])
    assert ok is False, checks


def _script(args, cwd=common.ROOT):
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def test_run_exits_without_a_card_and_prints_nothing():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = _script(["benchmark/run.py", "--workload", TRAIN, "--seed", "1", "--seconds", "1"])
    assert out.returncode != 0 and out.stdout == ""


def test_run_fails_with_the_benchmark_alone(tmp_path):
    shutil.copy(common.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(common.BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _script(["benchmark/run.py", "--workload", SAMPLE, "--seed", "1", "--seconds", "1"],
                  cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_a_drivers_run_loads_no_jax_module():
    code = ("import sys, json; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/benchmark/tests']; "
            "from conftest import tiny, TRAIN, SAMPLE; from benchmark.run import run; "
            "from benchmark import common; "
            "[run(tiny(n), 3, 0.2, False, 'cpu', 0.0) for n in (TRAIN, SAMPLE)]; "
            "print(json.dumps(common.forbidden_modules()))")
    out = _script(["-c", code, str(common.ROOT)])
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
    assert common.FORBIDDEN == ("jax", "jaxlib", "flax", "optax", "orbax", "colddiff")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct_on_the_card(card, name):
    """The control at the cell's own size on the card, one seed."""
    cell = common.cell(name)
    driver = importlib.import_module(f"benchmark.drivers.{cell['traffic']['kind']}")
    numbers = driver.compare(cell, 20261018, driver.control(cell, 20261018, card), card)
    ok, checks = common.judge(numbers, cell["limits"])
    assert ok is False, checks
