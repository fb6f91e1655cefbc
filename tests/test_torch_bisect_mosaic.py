"""The probe kernels' plain versions == the TPU probes of scripts/bisect_mosaic.py.

Each JAX kernel body (``k_roll``, ``k_roll_slice``, ``k_masked_norm``,
``k_dyn_sublane``, imported from the script by path) runs through
``pl.pallas_call(..., interpret=True)`` with default memory spaces, at the
script's shapes and on its inputs, and is held against the port's plain
PyTorch version: exactly for the rolls (copies), at 1e-6 for the two sums
(fp32 summation order).  On CPU tensors the port's wrappers run those plain
versions; the CUDA kernels themselves are tested in test_torch_cuda.py.
"""

import functools
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from colddiff_torch.ops import bisect_mosaic as ops
from colddiff_torch.scripts import bisect_mosaic as script

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def tpu_probes():
    spec = importlib.util.spec_from_file_location(
        "_tpu_bisect_mosaic", ROOT / "scripts" / "bisect_mosaic.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def inputs():
    return {k: v.numpy() for k, v in script.inputs("cpu").items()}


def _interpret(kernel, x, out_shape=None, grid=(1,), in_spec=None, out_spec=None):
    full = pl.BlockSpec((1,) + x.shape[1:], lambda i: (i, 0, 0))
    return np.asarray(pl.pallas_call(
        kernel, out_shape=out_shape or jax.ShapeDtypeStruct(x.shape, x.dtype),
        grid=grid, in_specs=[in_spec or full], out_specs=out_spec or full,
        interpret=True)(x))


def test_inputs_are_the_jax_scripts():
    rng = np.random.default_rng(0)
    a = script.inputs("cpu")
    for key, shape in (("x", (1, 64, 8576)), ("xn", (1, 64, 8192)), ("xd", (1, 70, 8576))):
        np.testing.assert_array_equal(a[key].numpy(),
                                      np.asarray(rng.standard_normal(shape), np.float32))


def test_roll_matches_tpu_probe(tpu_probes, inputs):
    x = inputs["x"]
    want = _interpret(tpu_probes.k_roll, x)
    got = ops.roll_plain(torch.from_numpy(x), x.shape[-1] - script.ROLL).numpy()
    np.testing.assert_array_equal(got, want)


def test_roll_slice_matches_tpu_probe(tpu_probes, inputs):
    x = inputs["x"]
    want = _interpret(tpu_probes.k_roll_slice, x)
    got = ops.roll_slice_plain(torch.from_numpy(x), x.shape[-1] - script.ROLL,
                               script.SPLIT).numpy()
    np.testing.assert_array_equal(got, want)


def test_masked_norm_matches_tpu_probe(tpu_probes, inputs):
    x = inputs["xn"]
    want = _interpret(tpu_probes.k_masked_norm, x)
    got = ops.masked_norm_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_dyn_sublane_matches_tpu_probe(tpu_probes, inputs):
    x = inputs["xd"]
    want = _interpret(
        functools.partial(tpu_probes.k_dyn_sublane, hgt_t=32), x,
        out_shape=jax.ShapeDtypeStruct((1, 64, 8576), np.float32), grid=(2,),
        in_spec=pl.BlockSpec((1, 70, 8576), lambda i: (0, 0, 0)),
        out_spec=pl.BlockSpec((1, 32, 8576), lambda i: (0, i, 0)))
    got = ops.dyn_sublane_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_cpu_wrappers_run_the_plain_versions_and_launch_nothing(inputs):
    wrappers = (ops.probe_roll, ops.probe_roll_slice, ops.probe_masked_norm,
                ops.probe_dyn_sublane)
    before = [w.launches for w in wrappers]
    x = torch.from_numpy(inputs["x"])
    shift = x.shape[-1] - script.ROLL
    outs = dict(script.probes("cpu"))
    assert torch.equal(outs["roll_whole_row"], ops.roll_plain(x, shift))
    assert torch.equal(outs["roll_then_slice"], ops.roll_slice_plain(x, shift, script.SPLIT))
    assert torch.equal(outs["masked_norm"],
                       ops.masked_norm_plain(torch.from_numpy(inputs["xn"])))
    assert torch.equal(outs["dyn_sublane"],
                       ops.dyn_sublane_plain(torch.from_numpy(inputs["xd"])))
    assert [w.launches for w in wrappers] == before


@pytest.mark.parametrize("shape", [(3, 4, 192), (2, 64)])
def test_plain_versions_on_other_shapes(shape):
    """The plain versions against numpy at shapes the script does not use."""
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(ops.roll_plain(t, 5).numpy(), np.roll(x, 5, axis=-1))
    h = x.reshape(*shape[:-1], -1, ops.GROUP)
    np.testing.assert_allclose(ops.masked_norm_plain(t).numpy(),
                               (h - h.mean(-1, keepdims=True)).reshape(shape), atol=1e-6)


def _at_offset(n: int, offset: int) -> torch.Tensor:
    """A contiguous CPU tensor of ``n`` floats at storage offset ``offset``."""
    return torch.empty(n + offset)[offset:]


# (width, shift, split, x offset, out offset in floats, float4 path?)
QUAD_CASES = [
    (8576, 8512, 8576, 0, 0, True),    # the probe's roll
    (8576, 8512, 8192, 0, 0, True),    # the probe's roll_slice
    (8576, 0, 0, 0, 0, True),          # dyn_sublane
    (8576, 8512, 8192, 4, 4, True),    # offsets of a whole quad
    (8576, 8512, 8192, 1, 0, False),   # input pointer off 16 bytes
    (8576, 8512, 8192, 0, 2, False),   # output pointer off 16 bytes
    (8577, 8513, 8577, 0, 0, False),   # odd width
    (130, 66, 130, 0, 0, False),       # width not a whole number of quads
    (8576, 63, 8576, 0, 0, False),     # odd shift
    (8576, 8511, 8576, 0, 0, False),   # shift not a whole number of quads
    (8576, 8512, 8190, 0, 0, False),   # split not a whole number of quads
]


@pytest.mark.parametrize("width,shift,split,x_off,out_off,want", QUAD_CASES)
def test_quad_path_follows_alignment_and_quads(width, shift, split, x_off, out_off, want):
    x, out = _at_offset(2 * width, x_off), _at_offset(2 * width, out_off)
    assert (x.data_ptr() % 16 == 0) == (x_off % 4 == 0)  # storage starts 16-byte aligned
    assert ops.quad_path(x.data_ptr(), out.data_ptr(), width, shift, split) is want


def test_wrappers_reject_bad_shapes():
    with pytest.raises(ValueError):
        ops.probe_masked_norm(torch.zeros(2, 100))
    with pytest.raises(ValueError):
        ops.probe_dyn_sublane(torch.zeros(1, 6, 8))


def test_entry_point_refuses_without_a_gpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "-m", "colddiff_torch.scripts.bisect_mosaic"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "OK" not in proc.stdout
