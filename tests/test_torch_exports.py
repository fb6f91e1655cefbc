"""The port exports what colddiff exports.

``operators.register`` puts a user's operator where ``get_operator`` and the
CLI's ``make_operator`` find it; the reference attention forms
``linear_attention`` and ``linear_attention_blockdiag`` equal their JAX
twins at fp32; and every public name of every ``colddiff`` module has its
twin in ``colddiff_torch``, read from the sources with ``ast`` (a module's
``__all__``, or its top-level functions and classes where it has none), but
for the gaps named in ``GAPS`` and ``NO_TWIN``, each with its reason.
"""

import argparse
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import colddiff_torch.operators as pops
from colddiff.models import layers as jlayers
from colddiff_torch.cli import main as pcli
from colddiff_torch.models import layers

ROOT = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = ROOT / "colddiff", ROOT / "colddiff_torch"

# JAX modules whose twin sits at another path
MOVED = {"ops/pallas/convnext_front.py": "ops/convnext_front.py"}
# JAX modules with no twin, by design
NO_TWIN = {
    "models/import_torch.py": "maps torch state dicts onto Flax trees; the port loads "
                              "reference .pt files as they are (models/convert.py)",
    "eval/torch_inception_ref.py": "a torch transcription that checks the JAX Inception "
                                   "graph; the port's eval/fid.py is that graph in torch",
    "ops/pallas/__init__.py": "the Pallas package's roster; the port's kernels are "
                              "ops/convnext_front.py, ops/bisect_mosaic.py and "
                              "ops/group_norm.py",
}
# public JAX names a twin lacks, by design
GAPS = {
    "train.py": {"TrainState": "a Flax pytree; the port's Trainer holds its own state"},
    "utils.py": {
        "enable_compilation_cache": "JAX's persistent compilation cache; no torch meaning",
        "retry_compile": "retries a remote TPU compile; no torch meaning",
    },
    "ops/pallas/convnext_front.py": {
        "convnext_front_reference": "the port's plain version is convnext_front_plain",
        "pallas_supported": "the port's kernels take every C on CUDA; CPU tensors run "
                            "the plain version",
    },
}


def _public_names(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return set(ast.literal_eval(node.value))
    return {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and not n.name.startswith("_")}


def _jax_modules():
    return sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("rel", _jax_modules())
def test_every_public_name_has_its_twin(rel):
    if rel in NO_TWIN:
        assert not (PORT_PKG / rel).exists(), f"{rel} has a twin now: drop it from NO_TWIN"
        return
    twin = PORT_PKG / MOVED.get(rel, rel)
    assert twin.is_file(), f"colddiff/{rel} has no twin in colddiff_torch/"
    missing = _public_names(JAX_PKG / rel) - _public_names(twin)
    assert missing == set(GAPS.get(rel, {})), (
        f"colddiff/{rel}: the port lacks {sorted(missing)}, by design "
        f"{sorted(GAPS.get(rel, {}))}")


class StandIn(pops.Degradation):
    """A user's operator: no tables, the identity degrade."""

    @classmethod
    def create(cls, timesteps, device="cuda"):
        op = cls(timesteps)
        op.device = device
        return op


def test_register_reaches_get_operator_and_the_cli(monkeypatch):
    monkeypatch.setattr(pops, "_REGISTRY", dict(pops._REGISTRY))
    with pytest.raises(ValueError, match="unknown degradation 'stand_in'"):
        pops.get_operator("stand_in", timesteps=3, device="cpu")
    pops.register("stand_in", StandIn)
    op = pops.get_operator("stand_in", timesteps=3, device="cpu")
    assert isinstance(op, StandIn) and (op.timesteps, op.device) == (3, "cpu")
    args = argparse.Namespace(degradation="stand_in", time_steps=5, device="cpu")
    op = pcli.make_operator(args, 16, 3)
    assert isinstance(op, StandIn) and op.timesteps == 5
    pops.register("blur", StandIn)  # a name is replaced, as in the JAX registry
    assert isinstance(pops.get_operator("blur", timesteps=2, device="cpu"), StandIn)


def _qkv(rng, shape):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def test_linear_attention_equals_jax(rng):
    q, k, v = _qkv(rng, (3, 64, 32))  # tests/test_pallas.py's shapes
    want = np.asarray(jlayers.linear_attention(*map(jnp.asarray, (q, k, v)), 0.17))
    got = layers.linear_attention(*map(torch.from_numpy, (q, k, v)), 0.17)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_linear_attention_blockdiag_equals_jax_and_per_head(rng):
    b, n, heads, d = 2, 48, 4, 8
    q, k, v = _qkv(rng, (b, n, heads * d))
    want = np.asarray(jlayers.linear_attention_blockdiag(
        *map(jnp.asarray, (q, k, v)), heads, 0.31))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = layers.linear_attention_blockdiag(tq, tk, tv, heads, 0.31)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)

    def split(a):
        return a.reshape(b, n, heads, d).transpose(1, 2).reshape(b * heads, n, d)

    per_head = layers.linear_attention(split(tq), split(tk), split(tv), 0.31)
    per_head = per_head.reshape(b, heads, n, d).transpose(1, 2).reshape(b, n, heads * d)
    np.testing.assert_allclose(got.numpy(), per_head.numpy(), rtol=0, atol=1e-6)
