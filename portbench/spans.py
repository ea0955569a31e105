"""The program's spans laid on the window and on the device's busy time,
for the metric readers that read them.

In a traced run the job server keeps its spans while the harness's
profiler runs (``sequitr_tpu_torch.tracing``; the server turns its tracer
on at the first claim that sees the session), and bridges every span but
``server.job`` into the profiler's trace as a ``user_annotation``. Two
views of them, each None where there is nothing to read (a program
without a tracer):

``host(run)``: the spans and counter additions the tracer kept
(``tracing.latest()``), as ``(name, start, end, tid)`` and ``(name, t,
n)`` in seconds from the window's start on the host clock; the window
starts at ``run.process_start + run.setup_s`` on ``time.perf_counter``.

``device(run)``: the traced window's length, the union of the device's
intervals and the bridged spans, in seconds from the window's start on
the trace's clock, read from the trace the harness exported
(``trace.json`` in the run's directory, beside ``out/`` where the jobs
write) and clipped to the window as ``traceio.reduce_trace`` clips it.

A job's frame steps are the job thread's ``PhaseTimer`` phases; the window
outside them is the turnover between jobs (poll, claim, status, set-up,
close, ledger).
"""

from __future__ import annotations

import json
import math
import os
import re
import sys
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

from portbench import traceio

__all__ = [
    "FRAME_STEPS", "Host", "Device", "host", "device", "read_trace",
    "union", "length", "overlap", "named", "ms_per_mvox", "idle_share",
]

FRAME_STEPS = ("job.infer", "job.fetch", "job.write", "job.localize")

Intervals = List[Tuple[float, float]]


class Host(NamedTuple):
    spans: List[Tuple[str, float, float, int]]
    counts: List[Tuple[str, float, int]]
    dropped: int


class Device(NamedTuple):
    window_s: float
    busy: Intervals
    spans: List[Tuple[str, float, float, int]]


# the last run each view was taken of, and the view: every reader of a run
# shares one reading of the tracer and one parse of the trace
_CACHE: Dict[str, Tuple[object, object]] = {}


def _cached(kind: str, run, make):
    hit = _CACHE.get(kind)
    if hit is not None and hit[0] is run:
        return hit[1]
    value = make(run)
    _CACHE[kind] = (run, value)
    return value


def host(run) -> Optional[Host]:
    """What the program's tracer kept, on the window's clock; None without
    a tracer or without a span inside the window (a tracer left from before
    the run)."""
    return _cached("host", run, _host)


def _host(run) -> Optional[Host]:
    try:
        from sequitr_tpu_torch import tracing
    except ImportError:
        return None
    latest = getattr(tracing, "latest", None)
    tracer = latest() if latest is not None else None
    if tracer is None:
        return None
    t0 = run.process_start + run.setup_s
    spans = [(r.name, r.start_ns * 1e-9 - t0, r.end_ns * 1e-9 - t0, r.tid)
             for r in tracer.spans()]
    counts = [(c.name, c.t_ns * 1e-9 - t0, c.n) for c in tracer.counts()]
    in_window: Dict[str, float] = {}
    for name, a, b in named_all(spans, run.window_s):
        in_window[name] = in_window.get(name, 0.0) + b - a
    if not in_window:
        return None
    phases: Dict[str, float] = {}
    for job in run.done:
        for k, v in job.phases.items():
            phases[k] = phases.get(k, 0.0) + v
    print(f"portbench: program spans: {len(spans)} kept, {tracer.dropped} dropped; seconds in "
          f"the window by name {in_window}; the done jobs' phases {phases}", file=sys.stderr)
    return Host(spans, counts, tracer.dropped)


def device(run) -> Optional[Device]:
    """The device's busy intervals and the bridged spans of the run's
    exported trace; None without the trace, its window span, a device event
    or a bridged span."""
    return _cached("device", run, _device)


def _device(run) -> Optional[Device]:
    # the spans are bridged only while the program's tracer keeps them
    if run.trace is None or not run.ended or host(run) is None:
        return None
    path = os.path.join(os.path.dirname(os.path.dirname(run.ended[0].output)), "trace.json")
    if not os.path.exists(path):
        return None
    view = read_trace(path, clip_s=run.window_s, expect=run.trace)
    return view if view is not None and view.spans else None


# a complete event as the profiler's exporter writes it, its keys in this
# order, each on a line of its own or on one line: the pattern starts at the
# category, which rules out most events at once, and the "ph" before it is
# checked after
_EVENT = re.compile(
    rb'"cat":\s*"(kernel|gpu_memcpy|gpu_memset|user_annotation)",\s*'
    rb'"name":\s*"([^"\\]*(?:\\.[^"\\]*)*)",\s*"pid":\s*[^,]*,\s*"tid":\s*([^,]*?),\s*'
    rb'"ts":\s*([-+0-9.eE]+),\s*"dur":\s*([-+0-9.eE]+)'
)
_COMPLETE = re.compile(rb'"ph":\s*"X",\s*$')


def _scan(path: str) -> List[Tuple[str, str, float, float, object]]:
    """The device's and the annotations' complete events, ``(cat, name,
    start, end, tid)`` in microseconds (a name for annotations only), picked
    out of the file's text."""
    with open(path, "rb") as f:
        text = f.read()
    out = []
    for m in _EVENT.finditer(text):
        if not _COMPLETE.search(text, max(0, m.start() - 32), m.start()):
            continue
        cat, name, tid, ts, dur = m.groups()
        cat = cat.decode()
        name = json.loads(b'"' + name + b'"') if cat == "user_annotation" else ""
        tid = tid.strip().strip(b'"').decode()
        a = float(ts)
        out.append((cat, name, a, a + float(dur), int(tid) if tid.isdigit() else tid))
    return out


def _parse(path: str) -> List[Tuple[str, str, float, float, object]]:
    """The same events from the whole file parsed as JSON."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    out = []
    for ev in events:
        cat = ev.get("cat", "")
        if ev.get("ph") != "X" or (cat not in traceio._DEVICE_CATS and cat != "user_annotation"):
            continue
        name = ev.get("name", "") if cat == "user_annotation" else ""
        a = float(ev["ts"])
        out.append((cat, name, a, a + float(ev.get("dur", 0.0)), ev.get("tid")))
    return out


def read_trace(path: str, clip_s: Optional[float] = None, expect=None) -> Optional[Device]:
    """The window, busy intervals and ``user_annotation`` spans of an
    exported trace, cut as ``traceio.reduce_trace`` cuts it (the window span
    clipped to its first ``clip_s`` seconds); None without the window span
    or a device event in it.

    A traced run's trace is about 1 GB, and parsing it whole again would add
    some 40 s to the run, so the events are first picked out of its text
    (``_scan``); the file is parsed whole only where that finds no window,
    or disagrees with ``expect`` (``traceio.reduce_trace``'s summary of the
    same trace) on the window's length or the busy time."""
    t = time.perf_counter()
    view, how = _view(_scan(path), clip_s), "scanned"
    if view is None or (expect is not None and not _agrees(view, expect)):
        view, how = _view(_parse(path), clip_s), "parsed whole"
    print(f"portbench: trace {how} for the bridged spans in {time.perf_counter() - t:.3f} s",
          file=sys.stderr)
    return view


def _agrees(view: Device, summary) -> bool:
    return (math.isclose(view.window_s, summary.window_s, rel_tol=1e-9, abs_tol=1e-12)
            and math.isclose(length(view.busy), summary.busy_s, rel_tol=1e-9, abs_tol=1e-12))


def _view(events, clip_s: Optional[float]) -> Optional[Device]:
    window = None
    busy, annotations = [], []
    for cat, name, a, b, tid in events:
        if cat != "user_annotation":
            busy.append((a, b))
        elif name == traceio.WINDOW_SPAN:
            window = (a, b)
        elif not name.startswith("portbench."):
            annotations.append((name, a, b, tid))
    if window is None:
        return None
    w0, w1 = window
    if clip_s is not None:
        w1 = min(w1, w0 + clip_s * 1e6)
    busy = union((max(a, w0), min(b, w1)) for a, b in busy if min(b, w1) > max(a, w0))
    if not busy:
        return None
    return Device(
        (w1 - w0) * 1e-6,
        [((a - w0) * 1e-6, (b - w0) * 1e-6) for a, b in busy],
        [(name, (max(a, w0) - w0) * 1e-6, (min(b, w1) - w0) * 1e-6, tid)
         for name, a, b, tid in annotations if b > w0 and a < w1],
    )


def union(intervals: Iterable[Tuple[float, float]]) -> Intervals:
    out: Intervals = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def length(intervals: Intervals) -> float:
    return sum(b - a for a, b in intervals)


def overlap(x: Intervals, y: Intervals) -> float:
    """The length of the intersection of two unions (sorted, disjoint)."""
    total, i, j = 0.0, 0, 0
    while i < len(x) and j < len(y):
        a, b = max(x[i][0], y[j][0]), min(x[i][1], y[j][1])
        if b > a:
            total += b - a
        if x[i][1] < y[j][1]:
            i += 1
        else:
            j += 1
    return total


def named_all(spans: Sequence, window_s: float) -> List[Tuple[str, float, float]]:
    """Every span, clipped to ``[0, window_s]``, as ``(name, start, end)``."""
    out = []
    for name, a, b, _ in spans:
        a, b = max(a, 0.0), min(b, window_s)
        if b > a:
            out.append((name, a, b))
    return out


def named(spans: Sequence, names: Sequence[str], window_s: float) -> Intervals:
    """The spans called one of ``names``, clipped to ``[0, window_s]``."""
    return [(a, b) for name, a, b in named_all(spans, window_s) if name in names]


def ms_per_mvox(run, names: Sequence[str]) -> Optional[float]:
    """Host milliseconds of the window's spans called one of ``names``,
    summed, per million voxels served; None without such a span."""
    kept = host(run)
    if kept is None or not run.done:
        return None
    found = named(kept.spans, names, run.window_s)
    if not found:
        return None
    return 1e3 * length(found) / (run.served_voxels / 1e6)


def idle_share(run, names: Sequence[str], outside: bool = False) -> Optional[float]:
    """The share of the traced window, in %, in which the device is idle and
    a bridged span called one of ``names`` is open (``outside``: none is);
    None without bridged spans."""
    view = device(run)
    if view is None or view.window_s <= 0:
        return None
    w = view.window_s
    idle = w - length(view.busy)
    inside = union(named(view.spans, names, w))
    idle_inside = length(inside) - overlap(inside, view.busy)
    return 100.0 * ((idle - idle_inside) if outside else idle_inside) / w
