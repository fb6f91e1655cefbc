"""The reader of the program's own spans (``metrics/program_span.py``) on
synthetic stretches: device time of nested spans, idle time inside host
intervals, the time window that drops a failed attempt's boundaries, and
None where boundaries and markers differ in number or the program has no
spans."""

import sys

import pytest

from benchmark.metrics import program_span
from benchmark.trace import Stretch

MARK = "colddiff_trace_mark"
MS = 1_000_000


def _params(span, read="device_ms", per="spans"):
    return {"reader": "program_span", "span": span, "read": read, "per": per}


def _stretch(ops, start=10 * MS, end=20 * MS, work=None):
    return Stretch(1.0, start, end, [(n, lo, hi, ()) for n, lo, hi in ops], [], work or {})


@pytest.fixture
def boundaries(monkeypatch):
    """Set the program's boundaries: ``(kind, name, host ns)`` on one thread
    unless a fourth item names another."""
    from colddiff_torch import tracing

    def put(bounds):
        rows = [(b[0], b[1], b[3] if len(b) > 3 else 1, b[2]) for b in bounds]
        monkeypatch.setattr(tracing, "boundaries", lambda: rows)

    return put


def _nested():
    """Span a holds span b; a marker (1 us) at each boundary, launched
    5 us after its host time."""
    host = [("enter", "a", 10 * MS), ("enter", "b", 11 * MS), ("exit", "b", 12 * MS),
            ("exit", "a", 13 * MS)]
    ops = [(MARK, 10 * MS + 5000, 10 * MS + 6000), ("k1", 10 * MS + 7000, 10 * MS + 9000),
           (MARK, 11 * MS + 5000, 11 * MS + 6000), ("k2", 11 * MS + 7000, 11 * MS + 10000),
           ("k3", 11 * MS + 10000, 11 * MS + 14000), (MARK, 12 * MS + 5000, 12 * MS + 6000),
           ("k4", 12 * MS + 8000, 12 * MS + 9000), (MARK, 13 * MS + 5000, 13 * MS + 6000)]
    return host, ops


@pytest.mark.parametrize("span,want_ns", [("a", 2000 + 3000 + 4000 + 1000), ("b", 3000 + 4000)])
def test_device_time_of_nested_spans(boundaries, span, want_ns):
    host, ops = _nested()
    boundaries(host)
    got = program_span.read(_stretch(ops, work={"steps": 2}), _params(span, per="steps"), {})
    assert got == pytest.approx(want_ns / 2 / MS)


def test_host_time_per_span(boundaries):
    host, ops = _nested()
    boundaries(host)
    got = program_span.read(_stretch(ops), _params("b", read="host_ms"), {})
    assert got == pytest.approx(1.0)


def test_idle_time_inside_host_intervals(boundaries):
    # the device runs [10, 11] and [14, 15] ms of [10, 16], then two markers
    # of 1 us at 15.5: idle (11, 14), (15, 15.5) and (15.502, 16); the host
    # is in "loader" over [12.5, 14.5] and [15.5, 15.9]
    host = [("enter", "loader", 12 * MS + MS // 2), ("exit", "loader", 14 * MS + MS // 2),
            ("enter", "loader", 15 * MS + MS // 2), ("exit", "loader", 15 * MS + 9 * MS // 10)]
    ops = [("k", 10 * MS, 11 * MS), (MARK, 14 * MS, 14 * MS + 100),
           ("k", 14 * MS + 100, 14 * MS + 900), (MARK, 14 * MS + 900, 15 * MS),
           (MARK, 15 * MS + MS // 2, 15 * MS + MS // 2 + 1000),
           (MARK, 15 * MS + MS // 2 + 1000, 15 * MS + MS // 2 + 2000)]
    boundaries(host)
    stretch = _stretch(ops, end=16 * MS, work={"steps": 2})
    got = program_span.read(stretch, _params("loader", read="idle_ms", per="steps"), {})
    assert got == pytest.approx((1.5 + 0.398) / 2)


def test_a_failed_attempts_boundaries_are_dropped(boundaries):
    host, ops = _nested()
    # an attempt traced before this stretch left two spans' boundaries
    earlier = [("enter", "a", 2 * MS), ("exit", "a", 3 * MS), ("enter", "b", 5 * MS)]
    boundaries(earlier + host)
    got = program_span.read(_stretch(ops), _params("a"), {})
    assert got == pytest.approx(10000 / MS)


def test_boundaries_and_markers_that_differ_in_number_read_none(boundaries, capsys):
    host, ops = _nested()
    boundaries(host)
    got = program_span.read(_stretch(ops[:-1]), _params("a"), {})
    assert got is None
    assert "4 boundaries in the stretch, 3 colddiff_trace_mark operations" in capsys.readouterr().err


def test_spans_per_thread_pair_apart(boundaries):
    # the autograd thread (2) opens a span while the main thread's is open
    host = [("enter", "a", 10 * MS, 1), ("enter", "f", 11 * MS, 2), ("exit", "f", 12 * MS, 2),
            ("exit", "a", 13 * MS, 1)]
    _, ops = _nested()
    boundaries(host)
    got = program_span.read(_stretch(ops), _params("f"), {})
    assert got == pytest.approx(7000 / MS)


def test_a_program_without_spans_reads_none(monkeypatch, capsys):
    import colddiff_torch

    # a checkout before the spans: the module cannot be imported
    monkeypatch.delattr(colddiff_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "colddiff_torch.tracing", None)
    _, ops = _nested()
    assert program_span.read(_stretch(ops), _params("a"), {}) is None
    assert "no colddiff_torch.tracing" in capsys.readouterr().err
