"""colddiff_torch stands alone: no JAX, no colddiff, nothing built at import.

The import rule is checked on the source (an ``ast`` scan), not through
``sys.modules``: JAX may be preloaded into every interpreter of a host.
"""

import ast
import importlib
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import colddiff_torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "colddiff")


def _sources():
    return sorted((ROOT / "colddiff_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_colddiff_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_every_submodule_imports_without_building():
    from colddiff_torch.ops import _build

    names = [m.name for m in pkgutil.walk_packages(colddiff_torch.__path__, "colddiff_torch.")]
    assert {"colddiff_torch.ops.convnext_front", "colddiff_torch.sampling",
            "colddiff_torch.models.unet_convnext", "colddiff_torch.train",
            "colddiff_torch.ops.bisect_mosaic", "colddiff_torch.scripts.bisect_mosaic",
            "colddiff_torch.data.datasets", "colddiff_torch.utils",
            "colddiff_torch.operators.decolor", "colddiff_torch.operators.fade",
            "colddiff_torch.operators.fade_generation",
            "colddiff_torch.operators.resolution", "colddiff_torch.ops.image"} <= set(names)
    for name in names:
        importlib.import_module(name)
    assert _build.load_library.cache_info().currsize == 0  # no nvcc, no dlopen
    assert "triton" not in sys.modules


def _run_smoke(cwd: Path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_gpu():
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_ab_script_needs_a_mode_and_a_gpu():
    from colddiff_torch.scripts import ab

    assert ab.main([]) == 2  # no mode: prints its usage
    assert ab.main(["fronts", str(ROOT)]) == 2  # no CUDA device here: no child runs
