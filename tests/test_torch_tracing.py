"""The port's spans (``colddiff_torch.tracing``) on the CPU: off without a
profiler, on under one, on the profiler's clock, and opened where the
Trainer, the loader, the sampler, GroupNorm and the front's backward do
their work.  Tiny shapes; no JAX."""

import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from colddiff_torch import tracing
from colddiff_torch.data import datasets
from colddiff_torch.diffusion import ColdDiffusion
from colddiff_torch.models import UnetConvNext, UnetResNet
from colddiff_torch.models.layers import FusedGroupNormSwish
from colddiff_torch.operators import get_operator
from colddiff_torch.ops.convnext_front import convnext_front
from colddiff_torch.sampling import prepare_start, sample
from colddiff_torch.train import Trainer

S, T = 16, 4
BLUR = dict(image_size=S, timesteps=T, blur_routine="Exponential_reflect", kernel_size=15,
            kernel_std=0.01)
RESNET = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, attn_resolutions=(8,), resolution=S)
CPU = [ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def empty_buffer():
    tracing.clear()
    yield
    tracing.clear()


def _diffusion():
    return ColdDiffusion(op=get_operator("blur", **BLUR, device="cpu"), image_size=S,
                         sampling_routine="x0_step_down")


def _names(keep=None):
    return [(kind, name) for kind, name, _, _ in tracing.boundaries()
            if keep is None or name in keep]


def test_off_records_nothing():
    assert not torch.autograd._profiler_enabled()
    with tracing.span("outer"):
        inner = tracing.span("inner")
        with inner:
            torch.ones(2).add_(1)
    assert inner is tracing.span("other")  # the one shared no-op
    assert tracing.boundaries() == []


def test_spans_nest_and_carry_the_thread():
    with profile(activities=CPU):
        with tracing.span("outer"):
            with tracing.span("inner"):
                pass
        seen = []
        # a thread the profiler does not follow records nothing
        t = threading.Thread(target=lambda: seen.append(tracing.span("elsewhere")))
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and seen == [tracing._OFF]
    bounds = tracing.boundaries()
    assert [(k, n) for k, n, _, _ in bounds] == [("enter", "outer"), ("enter", "inner"),
                                                 ("exit", "inner"), ("exit", "outer")]
    assert {tid for _, _, tid, _ in bounds} == {threading.get_ident()}
    times = [ns for _, _, _, ns in bounds]
    assert times == sorted(times)


def test_boundaries_lie_on_the_profilers_clock():
    a = torch.randn(64, 64)
    with profile(activities=CPU) as prof:
        with tracing.span("mm"):
            torch.mm(a, a)
    (_, _, _, enter), (_, _, _, exit_) = tracing.boundaries()
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(mm) == 1
    assert enter <= mm[0].start_ns() <= mm[0].start_ns() + mm[0].duration_ns() <= exit_


def test_a_trainer_step_opens_its_spans_in_order(tmp_path):
    torch.manual_seed(0)
    tr = Trainer(_diffusion(), UnetConvNext(dim=8, dim_mults=(1, 2)),
                 datasets.SyntheticDataset(S, 3, length=8), train_batch_size=2,
                 gradient_accumulate_every=2, save_and_sample_every=10 ** 9, num_workers=1,
                 results_folder=str(tmp_path), device="cpu")
    with profile(activities=CPU):
        tr.train_step(tr._next_superbatch())
    step = ["train.loader", "loader.queue", "train.forward", "train.backward",
            "train.optimizer"]
    pair = [("enter", "loader.queue"), ("exit", "loader.queue")]
    micro = [("enter", "train.forward"), ("exit", "train.forward"),
             ("enter", "train.backward"), ("exit", "train.backward")]
    assert _names(step) == ([("enter", "train.loader"), *pair, *pair, ("exit", "train.loader")]
                            + micro * 2 + [("enter", "train.optimizer"),
                                           ("exit", "train.optimizer")])
    # every front's backward inside a train.backward
    depth, inside = 0, []
    for kind, name in _names(("train.backward", "convnext_front.backward")):
        if name == "train.backward":
            depth += 1 if kind == "enter" else -1
        else:
            inside.append(depth)
    assert inside and set(inside) == {1}


def test_a_sample_opens_one_degrade_span_a_step():
    d = _diffusion()
    x = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (2, S, S, 3)).astype(np.float32))
    start = prepare_start(d, x)
    with profile(activities=CPU):
        sample(d, lambda xt, t: xt * 0.5, start)
    assert _names() == [("enter", "sample.degrade"), ("exit", "sample.degrade")] * T


def test_a_resnet_forward_opens_one_group_norm_span_a_norm():
    torch.manual_seed(0)
    model = UnetResNet(**RESNET).eval()
    norms = sum(isinstance(m, FusedGroupNormSwish) for m in model.modules())
    x, t = torch.randn(1, S, S, 3), torch.tensor([1])
    with profile(activities=CPU), torch.no_grad():
        model(x, t)
    assert norms > 0
    assert _names() == [("enter", "unet.group_norm"), ("exit", "unet.group_norm")] * norms


def test_a_front_backward_opens_its_span():
    gen = torch.Generator().manual_seed(0)
    c = 4
    x = torch.randn(2, c, 8, 8, generator=gen, requires_grad=True)
    w = torch.randn(c, 1, 7, 7, generator=gen, requires_grad=True)
    b, cond = torch.zeros(c), torch.randn(2, c, generator=gen)
    gamma, beta = torch.ones(c), torch.zeros(c)
    with profile(activities=CPU):
        out = convnext_front(x, w, b, cond, gamma, beta)
        assert _names() == []  # the forward opens none
        out.sum().backward()
    assert _names() == [("enter", "convnext_front.backward"),
                        ("exit", "convnext_front.backward")]
    assert x.grad is not None and w.grad is not None


def test_boundaries_of_many_threads_are_all_kept_in_one_order():
    """The buffer under more threads than cores, switching often: no
    boundary lost, each thread's in its own order, times in buffer order."""
    import sys

    threads, each = 16, 300
    ready = threading.Barrier(threads)  # all alive at once: no thread id reused

    def work():
        ready.wait(timeout=60)
        for k in range(each):
            tracing._mark("enter", str(k))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=work) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    bounds = tracing.boundaries()
    assert len(bounds) == threads * each
    by_thread = {}
    for _, name, tid, _ in bounds:
        by_thread.setdefault(tid, []).append(int(name))
    assert sorted(by_thread.values()) == [list(range(each))] * threads
    times = [ns for _, _, _, ns in bounds]
    assert times == sorted(times)
