"""Settings of the benchmark's own tests: the repository root on the path
and the ``cuda`` marker.  A card test decides in its ``card`` fixture
whether a card is present, never while a module is imported."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: runs on the chip")
    from benchmark import common

    common.program_env()
    return torch.device("cuda")


TRAIN = "celeba128_deblur_convnext.train_b128x2"
SAMPLE = "cifar10_deblur_resnet.sample_b512"
CELLS = (TRAIN, SAMPLE)


def tiny(name: str) -> dict:
    """A cell of ``BENCHMARK.json`` cut to a size the CPU runs in seconds:
    its configuration's widths and depth, T and the traffic's batch."""
    import copy

    from benchmark import common

    c = copy.deepcopy(common.cell(name))
    config, traffic = c["config"], c["traffic"]
    config["image_size"] = 16
    if traffic["kind"] == "train":
        config["model"].update(dim=8, dim_mults=[1, 2])
        config["degradation"]["time_steps"] = 5
        traffic.update(batch=4, accum=2, loader_workers=2, pool_images=32, trace_steps=2)
    else:
        config["model"].update(ch=32, ch_mult=[1, 2], num_res_blocks=1, attn_resolutions=[8])
        config["degradation"]["time_steps"] = 20
        traffic.update(batch=6, model_chunk=4, pool_images=40)
    return c


@pytest.fixture
def tiny_cell():
    return tiny
