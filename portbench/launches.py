"""Device time of the kernels launched inside the program's bridged spans.

In a traced run the program's spans are bridged into the profiler's trace
as ``user_annotation`` events on the host's timeline (``spans.py``). A
kernel belongs to the span in which its launch lies: the launch is the
host's CUDA call (a ``cuda_*`` event) that carries the kernel's
``correlation`` id, and its start is looked up among the spans of each
name, whatever the thread (the job thread alone launches while a frame's
spans are open). Each kernel's device time is clipped to the traced
window, as ``traceio.reduce_trace`` clips it.

The trace the harness exported (``trace.json`` beside ``out/``) is read
once a run, and not parsed as JSON: the few events wanted are picked out
of its text, as ``spans.py`` picks out its own, and only their numbers
are kept. The file is parsed whole only where that finds no window, or
where the kernels' time in the window disagrees with
``traceio.reduce_trace``'s summary of the same trace.
"""

from __future__ import annotations

import bisect
import json
import math
import os
import re
import sys
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from portbench import spans, traceio

__all__ = ["SPANS", "kernel_seconds", "read_trace"]

# the spans whose kernels are summed
SPANS = ("flows.forward", "flows.integrate")

# (cat, name, start, end, correlation) in microseconds: kernels and launches
# with their correlation, the window and SPANS without
Event = Tuple[str, str, float, float, Optional[int]]

# a complete event as the profiler's exporter writes it (``spans._EVENT``'s
# keys and order), with its ``args`` object, which holds no object itself
_EVENT = re.compile(
    rb'"cat":\s*"(kernel|cuda_runtime|cuda_driver|user_annotation)",\s*'
    rb'"name":\s*"([^"\\]*(?:\\.[^"\\]*)*)",\s*"pid":\s*[^,]*,\s*"tid":\s*[^,]*?,\s*'
    rb'"ts":\s*([-+0-9.eE]+),\s*"dur":\s*([-+0-9.eE]+)(?:,\s*"args":\s*\{([^{}]*)\})?'
)
_CORRELATION = re.compile(rb'"correlation":\s*(\d+)')
_COMPLETE = re.compile(rb'"ph":\s*"X",\s*$')
_WANTED = (traceio.WINDOW_SPAN,) + SPANS


def kernel_seconds(run, name: str) -> Optional[float]:
    """Device seconds in the window of the kernels launched inside the
    bridged spans called ``name`` (one of ``SPANS``); None without a trace
    or without such a span."""
    view = spans._cached("launches", run, _view)
    return None if view is None or name not in view else view[name]


def _scan(path: str) -> List[Event]:
    with open(path, "rb") as f:
        text = f.read()
    out = []
    for m in _EVENT.finditer(text):
        if not _COMPLETE.search(text, max(0, m.start() - 32), m.start()):
            continue
        cat, name, ts, dur, args = m.groups()
        cat = cat.decode()
        a = float(ts)
        if cat == "user_annotation":
            name = json.loads(b'"' + name + b'"')
            if name in _WANTED:
                out.append((cat, name, a, a + float(dur), None))
            continue
        corr = _CORRELATION.search(args) if args else None
        if corr is not None:
            out.append((cat, "", a, a + float(dur), int(corr.group(1))))
    return out


def _parse(path: str) -> List[Event]:
    """The same events from the whole file parsed as JSON."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    out = []
    for ev in events:
        cat, name = ev.get("cat", ""), ev.get("name", "")
        if ev.get("ph") != "X":
            continue
        a = float(ev["ts"])
        b = a + float(ev.get("dur", 0.0))
        if cat == "user_annotation":
            if name in _WANTED:
                out.append((cat, name, a, b, None))
        elif cat == "kernel" or cat.startswith("cuda_"):
            corr = ev.get("args", {}).get("correlation")
            if corr is not None:
                out.append((cat, "", a, b, int(corr)))
    return out


def _within(starts: List[float], ends: List[float], t: float) -> bool:
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= ends[i]


def _union(intervals: Sequence[Tuple[float, float]]) -> Tuple[List[float], List[float]]:
    starts: List[float] = []
    ends: List[float] = []
    for a, b in sorted(intervals):
        if starts and a <= ends[-1]:
            ends[-1] = max(ends[-1], b)
        else:
            starts.append(a)
            ends.append(b)
    return starts, ends


def _by_span(events: Iterable[Event], window_s: float) -> Optional[Tuple[Dict[str, float], float, int]]:
    """The kernels' seconds in the window by span, all of them, and how
    many lacked their launch; None without the window span."""
    window = None
    found: Dict[str, List[Tuple[float, float]]] = {n: [] for n in SPANS}
    launches: Dict[int, float] = {}
    kernels = []
    for cat, name, a, b, corr in events:
        if cat == "user_annotation":
            if name == traceio.WINDOW_SPAN:
                window = (a, b)
            else:
                found[name].append((a, b))
        elif cat == "kernel":
            kernels.append((a, b, corr))
        else:
            launches[corr] = a
    if window is None:
        return None
    w0, w1 = window[0], min(window[1], window[0] + window_s * 1e6)
    unions = {n: _union(v) for n, v in found.items() if v}
    out = {n: 0.0 for n in unions}
    total, unmatched = 0.0, 0
    for a, b, corr in kernels:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        total += (b - a) * 1e-6
        t = launches.get(corr)
        if t is None:
            unmatched += 1
            continue
        for n in out:
            if _within(*unions[n], t):
                out[n] += (b - a) * 1e-6
                break
    return out, total, unmatched


def read_trace(path: str, window_s: float, expect=None) -> Optional[Dict[str, float]]:
    """The kernels' seconds in the window by span of an exported trace;
    None without the window span or without a span of ``SPANS``.
    ``expect``: ``traceio.reduce_trace``'s summary of the same trace, whose
    kernels' time the scan must give, or the file is parsed whole."""
    t = time.perf_counter()
    got, how = _by_span(_scan(path), window_s), "scanned"
    if got is None or (expect is not None and not math.isclose(
            got[1], sum(expect.kernels.values()), rel_tol=1e-9, abs_tol=1e-12)):
        got, how = _by_span(_parse(path), window_s), "parsed whole"
    if got is None:
        return None
    out, _, unmatched = got
    print(f"portbench: trace {how} for the kernels by span in {time.perf_counter() - t:.3f} s: "
          f"{out}; {unmatched} kernels in the window without their launch", file=sys.stderr)
    return out or None


def _view(run) -> Optional[Dict[str, float]]:
    if run.trace is None or not run.ended:
        return None
    path = os.path.join(os.path.dirname(os.path.dirname(run.ended[0].output)), "trace.json")
    if not os.path.exists(path):
        return None
    return read_trace(path, run.window_s, expect=run.trace)
