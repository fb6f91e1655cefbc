"""A span of the program's own (``colddiff_torch.tracing``), read against
the traced stretch on the clock the two share (the profiler's:
``time.time_ns`` on the host, CUPTI's timestamps converted to it).

The program's boundaries whose host time lies in ``[stretch.start - 1 ms,
stretch.end]`` are the stretch's (a failed attempt's lie before it).  On
the card each launched one ``colddiff_trace_mark`` kernel, so they pair,
in order, with those operations of ``stretch.ops``, and the device
operations between a span's two markers are that span's (the markers of
spans nested in it left out).  ``params``:

- ``span``: the span's name;
- ``read``: ``device_ms`` (the summed time of the span's device
  operations), ``host_ms`` (the span's host length), or ``idle_ms`` (the
  device-idle time of ``stretch.gaps()`` that falls inside the span's host
  intervals);
- ``per``: a key of ``stretch.work`` (``steps``, ``forward_calls``) to
  divide by, or ``spans`` (their count).

None, with the reason on standard error, where the program has no such
spans (a checkout before them) or the boundaries and markers differ in
number."""

import sys

SLACK_NS = 1_000_000  # a boundary's host time precedes its marker's device start


def _say(params, why: str) -> None:
    print(f"program span {params['span']}: {why}", file=sys.stderr, flush=True)


def spans(stretch, device: bool) -> list:
    """The stretch's program spans, ``(name, host enter ns, host exit ns,
    device operations)`` (operations None unless ``device``); ValueError,
    with the reason, where they cannot be read."""
    try:
        from colddiff_torch import tracing
    except ImportError:
        raise ValueError("this checkout's program has no colddiff_torch.tracing") from None
    lo, hi = stretch.start - SLACK_NS, stretch.end
    bounds = [b for b in tracing.boundaries() if lo <= b[3] <= hi]
    ops = sorted(stretch.ops, key=lambda o: o[1])
    marks = [i for i, o in enumerate(ops) if o[0].startswith(tracing.MARKER)]
    if device and len(marks) != len(bounds):
        raise ValueError(f"{len(bounds)} boundaries in the stretch, {len(marks)} "
                         f"{tracing.MARKER} operations")
    out, open_ = [], {}
    for k, (kind, name, thread, ns) in enumerate(bounds):
        stack = open_.setdefault(thread, [])
        if kind == "enter":
            stack.append((name, k, ns))
            continue
        if not stack or stack[-1][0] != name:
            raise ValueError(f"an exit of {name} without its enter in the stretch")
        _, k0, ns0 = stack.pop()
        inside = None
        if device:
            inside = [o for o in ops[marks[k0] + 1:marks[k]]
                      if not o[0].startswith(tracing.MARKER)]
        out.append((name, ns0, ns, inside))
    return out


def _overlap(gaps, intervals) -> int:
    """ns of the ``(lo, hi, ...)`` gaps that fall inside the intervals."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return sum(max(0, min(g[1], b) - max(g[0], a)) for g in gaps for a, b in merged)


def read(stretch, params, cell):
    try:
        found = spans(stretch, device=params["read"] != "host_ms")
    except ValueError as e:
        _say(params, str(e))
        return None
    mine = [s for s in found if s[0] == params["span"]]
    if not mine:
        _say(params, "none in the stretch")
        return None
    if params["read"] == "device_ms":
        ns = sum(hi - lo for _, _, _, ops in mine for _, lo, hi, _ in ops)
    elif params["read"] == "host_ms":
        ns = sum(exit_ - enter for _, enter, exit_, _ in mine)
    else:
        ns = _overlap(stretch.gaps(), [(enter, exit_) for _, enter, exit_, _ in mine])
    per = len(mine) if params["per"] == "spans" else stretch.work.get(params["per"], 0)
    return ns / per / 1e6 if per else None
