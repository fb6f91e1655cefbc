"""The ADM configuration and the flagship's sampling cell: the family file
and its plain reference (``families/UnetADM.py``, ``reference/adm.py``), the
work counts, the ``norm_roofline`` reader on stretches made by hand, and tiny
CPU rehearsals of both new cells through their comparisons (sound runs are
correct; the faults and the control are not)."""

import copy
import importlib
import subprocess
import sys
from unittest import mock

import pytest
import torch

from benchmark import common, families, flops
from benchmark.metrics import norm_roofline
from benchmark.reference import models as ref_models
from benchmark.run import run
from benchmark.trace import Stretch

ADM = "imagenet256_deblur_adm.train_b8x4"
FLAGSHIP_SAMPLE = "celeba128_deblur_convnext.sample_b64"
CONFIG = common.load_json(common.BENCH / "configs" / "imagenet256_deblur_adm.json")
RESNET = common.load_json(common.BENCH / "configs" / "cifar10_deblur_resnet.json")
# FlopCounterMode on the reference at 256 px: convolutions, linear layers and
# the attention's two einsums of one image's forward
ADM_FORWARD_FLOPS = 2_238_759_567_360


def tiny(name: str) -> dict:
    """A new cell cut to a size the CPU runs in seconds."""
    c = copy.deepcopy(common.cell(name))
    config, traffic = c["config"], c["traffic"]
    config["image_size"] = 16
    if name == ADM:
        # bf16's rounding of a GroupNorm over groups of 1 to 2 channels of a
        # 16 px image reads grad_diff ~0.06; at 64 channels of 32 px, ~0.01
        config["image_size"] = 32
        config["model"].update(num_channels=64, channel_mult=[1, 2], num_res_blocks=1,
                               attention_resolutions=[16], num_head_channels=32)
        config["degradation"]["time_steps"] = 5
        traffic.update(batch=2, accum=2, loader_workers=2, pool_images=32, trace_steps=2)
    else:
        config["model"].update(dim=8, dim_mults=[1, 2])
        config["degradation"]["time_steps"] = 20
        traffic.update(batch=6, model_chunk=4, pool_images=40)
    return c


def test_family_resolves_and_builds_without_the_program():
    code = ("import json, sys, torch; sys.path.insert(0, sys.argv[1])\n"
            "from benchmark import families, flops\n"
            "config = json.load(open(sys.argv[2]))\n"
            "family = families.find(config)\n"
            "with torch.device('meta'): family.reference(config)\n"
            "family.norms(config)\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, str(common.ROOT),
                          str(common.BENCH / "configs" / "imagenet256_deblur_adm.json")],
                         capture_output=True, text=True, check=True).stdout
    assert not set(eval(out)) & {"colddiff_torch", "colddiff", "jax", "jaxlib", "flax"}


def test_port_and_reference_share_names_and_shapes():
    with torch.device("meta"):
        ref = ref_models.build(CONFIG)
    port = families.find(CONFIG).port(CONFIG)
    assert ({n: p.shape for n, p in port.named_parameters()}
            == {n: p.shape for n, p in ref.named_parameters()})
    assert sum(p.numel() for p in ref.parameters()) == CONFIG["model"]["parameters"]


def test_forward_flops_of_an_image():
    assert flops.forward_flops(CONFIG) == ADM_FORWARD_FLOPS


def test_a_program_without_adm_fails_in_port(monkeypatch):
    """The parent of the ADM port: the family file is there, the model is not."""
    import colddiff_torch.models

    monkeypatch.delattr(colddiff_torch.models, "UnetADM")
    with pytest.raises(ImportError, match="UnetADM"):
        families.find(CONFIG).port(CONFIG)


@pytest.mark.parametrize("size", ["published", "tiny"])
def test_norms_are_the_ports_group_norm_calls(size):
    """``norms(config)`` against the GroupNorm calls the port makes in one
    forward, counted on the meta device."""
    from colddiff_torch.ops import group_norm as gn

    config = CONFIG if size == "published" else tiny(ADM)["config"]
    port = families.find(config).port(config)
    calls = []

    def record(x, gamma, beta, num_groups, eps=1e-6, swish=True):
        calls.append({"hw": x.shape[2] * x.shape[3], "c": x.shape[1],
                      "per_image_affine": gamma.dim() == 2, "swish": swish})
        return torch.empty_like(x)

    s = config["image_size"]
    with mock.patch.object(gn, "group_norm_swish", record), torch.device("meta"):
        port(torch.zeros(2, s, s, 3), torch.tensor([1, 2]))
    assert calls == families.find(config).norms(config)
    if size == "published":
        assert (len(calls), sum(n["per_image_affine"] for n in calls)) == (101, 42)


def _read(stretch, config):
    params = common.load_json(common.BENCH / "metrics" / "group_norm_roofline.train.json")
    return norm_roofline.read(stretch, params, {"config": config})


def test_norm_roofline_on_a_stretch():
    ms = 1_000_000
    ops = [("void (anonymous namespace)::group_norm_swish_kernel<__nv_bfloat16, 16>(Args)",
            0, 30 * ms, ("train_step",)),
           ("sm90_xmma_gemm", 30 * ms, 40 * ms, ("train_step",)),
           ("void (anonymous namespace)::group_norm_swish_kernel<float, 1>(Args)",
            40 * ms, 50 * ms, ("train_step",))]
    stretch = Stretch(1.0, 0, 50 * ms, ops, [], {"forward_calls": 4, "forward_batch": 8})
    norms = families.find(CONFIG).norms(CONFIG)
    per_forward = sum(2 * (2 * 8 * n["hw"] * n["c"] + 2 * (8 if n["per_image_affine"] else 1)
                           * n["c"]) for n in norms)
    want = 100 * 4 * per_forward / flops.PEAK_BYTES_PER_S / 0.040
    assert _read(stretch, CONFIG) == pytest.approx(want)
    # the bytes of the x reads and writes: 400,228,352 elements an image
    assert norm_roofline.least_ms(CONFIG, 1, 1) == pytest.approx(
        1e3 * (2 * 400_228_352 + sum(2 * n["c"] for n in norms)) / flops.PEAK_BYTES_PER_S)


def test_norm_roofline_reads_nothing_without_norms_or_kernels():
    ms = 1_000_000
    kernel = [("group_norm_swish_kernel", 0, ms, ())]
    work = {"forward_calls": 2, "forward_batch": 4}
    assert _read(Stretch(1.0, 0, ms, kernel, [], work), RESNET) is None
    assert _read(Stretch(1.0, 0, ms, [("gemm", 0, ms, ())], [], work), CONFIG) is None


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", [ADM, FLAGSHIP_SAMPLE])
def test_tiny_rehearsal_of_a_new_cell_is_correct(name, trace):
    result = run(tiny(name), 2 ** 31 + 2424, 0.5, trace, "cpu", 0.0)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] >= 1
    assert result["metrics"] == {} and result["device"]["platform"] == "cpu"


@pytest.mark.parametrize("name,fault", [(ADM, "state_unchanged"), (ADM, "half_batch"),
                                        (FLAGSHIP_SAMPLE, "state_unchanged"),
                                        (FLAGSHIP_SAMPLE, "answer_altered")])
def test_a_planted_fault_in_a_new_cell_is_not_correct(name, fault):
    cell = tiny(name)
    driver = importlib.import_module(f"benchmark.drivers.{cell['traffic']['kind']}")
    with driver.plant(fault):
        result = run(cell, 78, 0.5, False, "cpu", 0.0)
    assert result["correct"] is False


@pytest.mark.parametrize("name", [ADM, FLAGSHIP_SAMPLE])
def test_control_of_a_new_cell_is_not_correct(name):
    cell = tiny(name)
    driver = importlib.import_module(f"benchmark.drivers.{cell['traffic']['kind']}")
    numbers = driver.compare(cell, 6, driver.control(cell, 6, "cpu"), "cpu")
    ok, checks = common.judge(numbers, cell["limits"])
    assert ok is False, checks
