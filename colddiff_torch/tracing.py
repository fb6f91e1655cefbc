"""Spans of the port's own work, on the clock of ``torch.profiler``.

``with span("train.forward"): ...`` marks where one layer's work is
launched.  A span is off unless a ``torch.profiler`` session is active in
the calling thread (the session reaches the autograd engine's threads, so
a backward is covered): the benchmark's traced stretch, the Trainer's
``profile_dir`` window, an operator's own profiler.  Off, it costs one
check of the profiler's enabled flag and a shared no-op context manager:
it records, allocates and launches nothing.

On, each boundary does, under one lock (so the boundaries of all threads
keep one order, which is also the order of their launches):

- append ``(kind, name, thread id, time.time_ns())`` to a bounded buffer
  (:func:`boundaries`; ``kind`` is "enter" or "exit", spans nest per
  thread).  ``time.time_ns`` is the clock of the profiler's events on the
  host and the device (torch converts CUPTI's timestamps to it), so a
  boundary can be laid against the trace;
- once :func:`prepare` has named a CUDA device (a Trainer or EvalHarness
  on CUDA does), launch one ``colddiff_trace_mark`` kernel on the current
  stream: a spin of ~1.9 us in an H100's trace (``csrc/trace_mark.cu``), so
  that the device operations between a span's two markers are the ones
  launched inside it;
- inside the Trainer's own window (:func:`label`), open
  ``torch.profiler.record_function(name)`` too, so that the exported trace
  shows the span.

The spans (PERF.md section 3 names the metric that reads each):
``train.loader``, ``loader.queue``, ``train.forward``, ``train.backward``,
``train.optimizer``, ``convnext_front.backward``, ``sample.degrade``,
``unet.group_norm``, ``unet.ada_group_norm``, ``unet.attention``,
``unet.group_norm.backward``.
"""

from __future__ import annotations

import collections
import ctypes
import threading
import time

import torch

from .ops import _build

__all__ = ["MARKER", "span", "prepare", "label", "boundaries", "clear"]

MARKER = "colddiff_trace_mark"  # the marker kernel's name in a trace
MARK_CYCLES = 2000  # long enough that the profiler records every marker
CAPACITY = 1 << 17  # boundaries kept; the oldest go first

_lock = threading.Lock()
_buffer: collections.deque = collections.deque(maxlen=CAPACITY)
_launch = None  # the marker's ctypes entry point, once prepare() named a card
_device = None
_label = False


class _Off:
    """The span when nothing profiles: one object, shared, doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "named")

    def __init__(self, name: str):
        self.name, self.named = name, None

    def __enter__(self):
        if _label:
            self.named = torch.profiler.record_function(self.name)
            self.named.__enter__()
        _mark("enter", self.name)

    def __exit__(self, *exc):
        _mark("exit", self.name)
        if self.named is not None:
            self.named.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that marks ``name`` while a profiler is active."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return _Span(name)


def _mark(kind: str, name: str) -> None:
    with _lock:
        _buffer.append((kind, name, threading.get_ident(), time.time_ns()))
        if _launch is not None:
            err = _launch(MARK_CYCLES, torch.cuda.current_stream(_device).cuda_stream)
            if err != 0:
                raise RuntimeError(f"{MARKER} launch failed: cudaError {err}")


def prepare(device) -> None:
    """Launch a marker at every boundary on ``device`` from now on, loading
    (and building, on a checkout's first run) the port's kernel library
    now, so that it never loads inside a span.  Nothing on a CPU device."""
    global _launch, _device
    device = torch.device(device)
    if device.type != "cuda":
        return
    fn = _build.load_library().colddiff_trace_mark_launch
    fn.argtypes = [ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with _lock:
        _launch, _device = fn, device


def label(on: bool) -> None:
    """Name each span in the profiler's own trace too (``record_function``)
    while ``on``: the Trainer's ``profile_dir`` window sets and clears it."""
    global _label
    _label = bool(on)


def boundaries() -> list[tuple[str, str, int, int]]:
    """The boundaries recorded so far, oldest first: ``(kind, name, thread
    id, ns)``, ``ns`` on the profiler's clock."""
    with _lock:
        return list(_buffer)


def clear() -> None:
    """Forget every boundary recorded so far."""
    with _lock:
        _buffer.clear()
