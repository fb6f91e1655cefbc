"""The traced stretch of a window: ``torch.profiler`` over a few steps or one
request, with CUDA activity only (recording every host op would slow the
host and so the stretch), reduced in memory to device operations and spans.
Nothing is written to disk.

A span is one of the benchmark's own ranges around a call into the program
(``loader``, ``train_step``, ``prepare_start``, ``sampler``,
``unet.forward``).  Its host length is read by the host clock; on the card,
each span boundary launches an empty marker kernel on the stream, so the
device operations between a span's two markers are the ones launched
inside it.  Device times are the profiler's, in ns.
"""

from __future__ import annotations

import contextlib
import sys
import time
from dataclasses import dataclass, field
from typing import Callable

import torch
from torch.profiler import ProfilerActivity, profile

STRETCH = "stretch"
MARKER = "spin_kernel"  # the kernel torch.cuda._sleep launches
MARKER_CYCLES = 2000  # ~1 us: a marker the profiler cannot see as empty
ATTEMPTS = 4  # stretches traced before a run gives up on a complete one


class Incomplete(RuntimeError):
    """The profiler lost device records of a stretch."""


@dataclass
class Stretch:
    """One traced stretch: its host-clock seconds (between two
    synchronisations), its bounds on the device's clock, device operations
    ``(name, start, end, spans)`` (``spans``: the names of the spans it was
    launched in, outermost first), host spans ``(name, start, end)``, and
    the work the driver did in it (``steps``, ``images``,
    ``forward_calls``, ``forward_batch``)."""

    wall_s: float
    start: int
    end: int
    ops: list = field(default_factory=list)
    spans: list = field(default_factory=list)
    work: dict = field(default_factory=dict)

    def busy_ns(self) -> int:
        """The union of the device operations' intervals inside the stretch."""
        return (self.end - self.start) - sum(hi - lo for lo, hi, _ in self.gaps())

    def gaps(self) -> list[tuple[int, int, str]]:
        """The device's idle intervals inside the stretch, each with the
        innermost span of the operation that ends it (the span the host
        was in when it launched the work the device waited for)."""
        out, t = [], self.start
        for _, lo, hi, spans in sorted(self.ops, key=lambda o: o[1]):
            if lo > t:
                out.append((t, min(lo, self.end), spans[-1] if spans else "outside_spans"))
            t = max(t, hi)
        if t < self.end:
            out.append((t, self.end, "outside_spans"))
        return [g for g in out if g[1] > g[0]]

    def ops_in(self, span: str) -> list:
        """Device operations launched inside a span named ``span``."""
        return [o for o in self.ops if span in o[3]]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, by name, and the
        longest idle gaps, each named by its span (``gaps``)."""
        by_name: dict[str, int] = {}
        for name, lo, hi, _ in self.ops:
            by_name[name] = by_name.get(name, 0) + (hi - lo)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:160], ns / 1e9] for n, ns in ops],
                "idle_gaps": [[name, (hi - lo) / 1e9] for lo, hi, name in gaps]}


class Recorder:
    """The benchmark's spans in one run: nothing unless ``on``; in a traced
    stretch, each boundary's host time and a marker kernel on the card."""

    def __init__(self, device: torch.device, on: bool = False):
        self.device, self.on = device, on
        self.marks: list[tuple[str, str, int]] = []  # (enter or exit, name, host ns)

    def _mark(self, kind: str, name: str) -> None:
        self.marks.append((kind, name, time.perf_counter_ns()))
        if self.device.type == "cuda":
            torch.cuda._sleep(MARKER_CYCLES)

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        self._mark("enter", name)
        try:
            yield
        finally:
            self._mark("exit", name)

    def host_spans(self) -> list[tuple[str, int, int]]:
        out, open_ = [], []
        for kind, name, t in self.marks:
            if kind == "enter":
                open_.append((name, t))
            else:
                name, t0 = open_.pop()
                out.append((name, t0, t))
        return out


def reduce_ops(ops: list[tuple[str, int, int]], rec: Recorder, wall_s: float,
               work: dict) -> Stretch:
    """A ``Stretch`` from the device operations ``(name, start, end)`` of a
    stretch that ``rec`` recorded: their markers, in time order, are the
    boundaries in ``rec.marks``.  Raises ``Incomplete`` where records are
    missing: a marker, or operations between two markers where the same
    two boundaries elsewhere in the stretch hold more (the same calls
    launch the same kernels)."""
    ops = sorted(ops, key=lambda o: o[1])
    markers = sum(MARKER in o[0] for o in ops)
    spans = [s for s in rec.host_spans() if s[0] != STRETCH]
    if not ops:  # a CPU run: nothing on a device
        return Stretch(wall_s, 0, 0, [], spans, work)
    if markers != len(rec.marks):
        raise Incomplete(f"the trace holds {markers} span markers, the run made "
                         f"{len(rec.marks)}")
    out, stack, marks, bounds = [], [], iter(rec.marks), {}
    segments, last, count = {}, None, 0
    for name, lo, hi in ops:
        if MARKER not in name:
            if "enter" in bounds and "exit" not in bounds:
                out.append((name, lo, hi, tuple(stack)))
                count += 1
            continue
        kind, span, _ = next(marks)
        if last is not None:
            segments.setdefault((last, kind, span), []).append(count)
        last, count = (kind, span, tuple(stack)), 0
        if span == STRETCH:
            bounds[kind] = lo if kind == "enter" else hi
        elif kind == "enter":
            stack.append(span)
        else:
            stack.pop()
    for key, counts in segments.items():
        mode = max(set(counts), key=counts.count)
        if min(counts) < mode:
            raise Incomplete(f"{counts.count(min(counts))} segment(s) {key} hold "
                             f"{min(counts)} device operations, the others {mode}")
    return Stretch(wall_s, bounds["enter"], bounds["exit"], out, spans, work)


def traced(run: Callable[[], dict], rec: Recorder) -> Stretch:
    """Run ``run`` (which returns the work it did, its calls wrapped in
    ``rec.span``) under the profiler, from one synchronisation to the next,
    and reduce what the card ran; again, up to ``ATTEMPTS`` times, while
    the profiler lost records."""
    for attempt in range(1, ATTEMPTS + 1):
        try:
            return _traced_once(run, rec)
        except Incomplete as e:
            print(f"trace attempt {attempt}: {e}", file=sys.stderr, flush=True)
    raise Incomplete(f"no complete stretch in {ATTEMPTS} attempts")


def _traced_once(run: Callable[[], dict], rec: Recorder) -> Stretch:
    device = rec.device
    acts = [ProfilerActivity.CUDA] if device.type == "cuda" else [ProfilerActivity.CPU]
    rec.on, rec.marks = True, []
    with profile(activities=acts) as prof:
        if device.type == "cuda":  # the profiler records from its first kernel on
            torch.zeros(1, device=device).add_(1)
            torch.cuda.synchronize(device)
            time.sleep(0.05)
        t0 = time.perf_counter()
        with rec.span(STRETCH):
            work = run()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    rec.on = False
    cpu = torch.autograd.DeviceType.CPU
    ops = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.device_type() != cpu]
    return reduce_ops(ops, rec, wall, work)
