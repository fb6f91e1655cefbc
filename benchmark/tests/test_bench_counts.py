"""The work counts behind ``mfu.*`` and ``front_roofline.train``, and the
readers on a stretch made by hand."""

import pytest

from benchmark import common, flops
from benchmark.trace import Stretch

CONFIGS = common.ROOT / "benchmark" / "configs"
FLAGSHIP = common.load_json(CONFIGS / "celeba128_deblur_convnext.json")
RESNET = common.load_json(CONFIGS / "cifar10_deblur_resnet.json")
# (side, channels, time conditioning, LayerNorm) of the flagship's 17 fronts
FLAGSHIP_FRONTS = [(128, 3, True, False), (128, 64, True, True), (64, 64, True, True),
                   (64, 128, True, True), (32, 128, True, True), (32, 256, True, True),
                   (16, 256, True, True), (16, 512, True, True), (16, 512, True, True),
                   (16, 512, True, True), (16, 1024, True, True), (16, 256, True, True),
                   (32, 512, True, True), (32, 128, True, True), (64, 256, True, True),
                   (64, 64, True, True), (128, 64, False, True)]


@pytest.mark.parametrize("config,want", [(FLAGSHIP, 67_258_524_032), (RESNET, 12_443_713_536)])
def test_forward_flops_per_image(config, want):
    assert flops.forward_flops(config) == want


def test_flagship_fronts():
    got = [(f["h"], f["c"], f["cond"], f["norm"]) for f in flops.fronts(FLAGSHIP)]
    assert got == FLAGSHIP_FRONTS
    assert flops.fronts(RESNET) == []


@pytest.mark.parametrize("batch", [16, 32])
def test_front_bound_is_chip_smokes(batch):
    import chip_smoke

    for h, c, cond, norm in FLAGSHIP_FRONTS:
        assert flops.front_bound(batch, h, h, c, cond, norm, 2) == chip_smoke.front_bound(
            batch, h, h, c, cond, norm, 2)
    # PERF.md's bound of one B=16 forward's fronts: 141.104 + 1.15 us
    assert flops.fronts_bound_ms(FLAGSHIP, 16, 2) == pytest.approx(0.142254, abs=1e-6)


def _stretch(ops, spans=(), wall_s=1.0, **work):
    return Stretch(wall_s, 0, int(wall_s * 1e9), list(ops), list(spans), work)


def _read(metric, stretch, config=FLAGSHIP):
    import importlib

    params = common.load_json(common.BENCH / "metrics" / f"{metric}.json")
    reader = importlib.import_module(f"benchmark.metrics.{params['reader']}")
    return reader.read(stretch, params, {"config": config})


def test_readers_on_a_stretch():
    ms = 1_000_000
    ops = [("void (anonymous namespace)::convnext_front_tile_kernel<64>(float*)", 0, 2 * ms,
            ("train_step",)),
           ("sm90_xmma_gemm", 1 * ms, 5 * ms, ("sampler", "unet.forward")),
           ("void (anonymous namespace)::convnext_front_small_c_kernel(float*)", 100 * ms,
            101 * ms, ("loader",))]
    spans = [("loader", 0, 4 * ms), ("loader", 10 * ms, 12 * ms), ("unet.forward", 2 * ms, 95 * ms)]
    s = _stretch(ops, spans, wall_s=0.2, forward_calls=2, forward_batch=32)
    assert s.busy_ns() == 6 * ms
    assert _read("device_idle.train", s) == pytest.approx(100 * (1 - 6 / 200))
    assert _read("loader_wait_ms.train", s) == pytest.approx(3.0)
    assert _read("unet_device_ms.sample", s) == pytest.approx(4.0)
    roof = _read("front_roofline.train", s)
    assert roof == pytest.approx(100 * 2 * flops.fronts_bound_ms(FLAGSHIP, 32, 2) / 3.0)
    mfu = _read("mfu.train", s)
    assert mfu == pytest.approx(100 * 3 * 67_258_524_032 * 64 / (0.2 * 989e12))
    gaps = s.breakdown()["idle_gaps"]
    assert gaps[:2] == [["outside_spans", pytest.approx(0.099)], ["loader", pytest.approx(0.095)]]


def test_markers_place_each_device_op_in_its_spans():
    import torch

    from benchmark.trace import MARKER, Incomplete, Recorder, reduce_ops

    rec = Recorder(torch.device("cpu"), on=True)
    for kind, name in [("enter", "stretch"), ("enter", "sampler"), ("enter", "unet.forward"),
                       ("exit", "unet.forward"), ("exit", "sampler"), ("exit", "stretch")]:
        rec.marks.append((kind, name, len(rec.marks)))
    m = f"void at::cuda::{MARKER}(long)"
    ops = [(m, 10, 11), (m, 12, 13), ("degrade", 14, 20), (m, 21, 22), ("conv", 23, 40),
           (m, 41, 42), ("degrade", 43, 50), (m, 51, 52), (m, 60, 61), ("late", 70, 80)]
    s = reduce_ops(ops, rec, 1.0, {})
    assert (s.start, s.end) == (10, 61)
    assert [(o[0], o[3]) for o in s.ops] == [("degrade", ("sampler",)),
                                            ("conv", ("sampler", "unet.forward")),
                                            ("degrade", ("sampler",))]
    assert [g[2] for g in s.gaps()][:2] == ["sampler", "unet.forward"]
    assert s.busy_ns() == 6 + 17 + 7
    assert [x[0] for x in s.spans] == ["unet.forward", "sampler"]
    with pytest.raises(Incomplete):  # a marker lost
        reduce_ops(ops[1:], rec, 1.0, {})


def test_a_segment_short_of_its_peers_is_incomplete():
    import torch

    from benchmark.trace import MARKER, Incomplete, Recorder, reduce_ops

    rec = Recorder(torch.device("cpu"), on=True)
    rec.marks = ([("enter", "stretch", 0)]
                 + [(k, "unet.forward", 0) for _ in range(3) for k in ("enter", "exit")]
                 + [("exit", "stretch", 0)])

    def trace(per_call):
        names = [MARKER]
        for n in per_call:
            names += [MARKER] + ["conv"] * n + [MARKER]
        return [(name, 10 * i, 10 * i + 5) for i, name in enumerate(names + [MARKER])]

    assert len(reduce_ops(trace((3, 3, 3)), rec, 1.0, {}).ops) == 9
    with pytest.raises(Incomplete):  # the third call lost a record
        reduce_ops(trace((3, 3, 2)), rec, 1.0, {})


def test_readers_find_nothing_to_read():
    empty = _stretch([], forward_calls=0, forward_batch=0)
    for metric in ("device_idle.train", "loader_wait_ms.train", "unet_device_ms.sample",
                   "front_roofline.train", "mfu.train"):
        assert _read(metric, empty) is None
