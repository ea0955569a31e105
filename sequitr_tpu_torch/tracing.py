"""In-process spans and counters of the port; off unless turned on.

``span(name, **attrs)`` times a block and ``count(name, n)`` adds to a
counter. With tracing off (the default) ``span`` checks one module-level
slot and returns the shared ``NOOP``: no clock is read and no profiler is
touched. ``enable()`` turns tracing on for the process and returns the
``Tracer`` that keeps what follows: each span's name, start and end from
``time.perf_counter_ns()``, its thread, its parent span (a per-thread
stack) and the job id of its thread, in a bounded buffer that counts what
it drops. Nothing is written until asked (``Tracer.write_chrome``);
``latest()`` keeps the tracer turned on last after ``disable()``.

The job id is set for a block by ``job(job_id)`` (the server, around each
job on its own thread and on the job's thread) and carried into the
threads a job starts by ``bind(fn)`` (the frame reader, the localize pool).

While a ``torch.profiler`` session runs, each span also enters
``torch.profiler.record_function(name)``, so its interval lands in the
profiler's Chrome trace as a ``user_annotation`` on its thread, on the
device trace's clock. Spans that enclose a whole job (``MEMORY_ONLY``) stay
out of the profiler's trace: they would cover every idle gap of the device
whole. ``profiling()`` tells whether such a session runs (the job server
keeps spans while one does, ``ImageServer._follow_profiler``).
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, NamedTuple, Optional

__all__ = [
    "NOOP", "MEMORY_ONLY", "SpanRecord", "CountRecord", "Tracer",
    "span", "count", "job", "bind", "enable", "disable", "active", "latest", "profiling",
]

# spans kept in memory only, never bridged into a profiler's trace
MEMORY_ONLY = frozenset({"server.job"})


class SpanRecord(NamedTuple):
    id: int
    parent: Optional[int]
    name: str
    start_ns: int
    end_ns: int
    tid: int  # the thread's native id, as the profiler's trace gives it
    thread: str
    job: Optional[str]
    attrs: Dict[str, Any]


class CountRecord(NamedTuple):
    name: str
    t_ns: int
    n: int
    total: int  # the counter's value after this addition
    tid: int
    job: Optional[str]


class _Off:
    """The span and job scope of a process with tracing off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


NOOP = _Off()

# the tracer of the process; None = tracing off
_ACTIVE: Optional["Tracer"] = None
# the tracer turned on last, on or off now
_LATEST: Optional["Tracer"] = None


class Tracer:
    """What one stretch of tracing kept: spans and counter additions, the
    oldest dropped beyond ``capacity`` records (``dropped`` counts them)."""

    def __init__(self, capacity: int = 200_000):
        self.capacity = int(capacity)
        self.dropped = 0
        self._buf: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._totals: Dict[str, int] = {}
        self._local = threading.local()
        try:
            import torch.autograd.profiler as autograd_profiler
            from torch.profiler import record_function
        except ImportError:  # a process without torch has no profiler to bridge to
            autograd_profiler = record_function = None
        self._autograd_profiler, self._record_function = autograd_profiler, record_function

    def _profiling(self) -> bool:
        """True while a ``torch.profiler`` session runs (torch's own flag)."""
        return getattr(self._autograd_profiler, "_is_profiler_enabled", False)

    def _thread(self):
        st = self._local
        if not hasattr(st, "stack"):
            st.stack = []
            st.job = None
            st.tid = threading.get_native_id()
            st.name = threading.current_thread().name
        return st

    def _keep(self, record) -> None:
        with self._lock:
            if len(self._buf) == self.capacity:
                self.dropped += 1
            self._buf.append(record)

    def _count(self, name: str, n: int) -> None:
        st = self._thread()
        t = time.perf_counter_ns()
        with self._lock:
            total = self._totals[name] = self._totals.get(name, 0) + n
        self._keep(CountRecord(name, t, n, total, st.tid, st.job))

    def spans(self) -> List[SpanRecord]:
        with self._lock:
            return [r for r in self._buf if isinstance(r, SpanRecord)]

    def counts(self) -> List[CountRecord]:
        with self._lock:
            return [r for r in self._buf if isinstance(r, CountRecord)]

    def write_chrome(self, path: str) -> None:
        """Write the records to ``path`` as a Chrome trace (Perfetto and
        ``chrome://tracing`` open it): spans as complete events (``ph:
        "X"``, microseconds of ``perf_counter_ns``) with the job id, span id
        and parent in ``args``; counters as ``ph: "C"`` events of their
        running value; ``dropped`` under ``otherData``."""
        pid = os.getpid()
        events, threads = [], {}
        for r in self.spans():
            threads[r.tid] = r.thread
            events.append({
                "ph": "X", "name": r.name, "cat": "span", "pid": pid, "tid": r.tid,
                "ts": r.start_ns / 1e3, "dur": (r.end_ns - r.start_ns) / 1e3,
                "args": {"job": r.job, "id": r.id, "parent": r.parent, **r.attrs},
            })
        for r in self.counts():
            events.append({
                "ph": "C", "name": r.name, "pid": pid, "tid": r.tid, "ts": r.t_ns / 1e3,
                "args": {r.name: r.total},
            })
        for tid, name in threads.items():
            events.append({"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                           "args": {"name": name}})
        trace = {"traceEvents": events, "displayTimeUnit": "ms",
                 "otherData": {"clock": "perf_counter_ns", "dropped": self.dropped}}
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(trace, f)
        os.replace(tmp, path)


class _Span:
    __slots__ = ("_tracer", "name", "attrs", "_id", "_parent", "_t0", "_annotation")

    def __init__(self, tracer: Tracer, name: str, attrs: Dict[str, Any]):
        self._tracer, self.name, self.attrs = tracer, name, attrs

    def set(self, **attrs) -> None:
        """Attach attributes known only inside the block."""
        self.attrs.update(attrs)

    def __enter__(self):
        st = self._tracer._thread()
        self._parent = st.stack[-1] if st.stack else None
        self._id = next(self._tracer._ids)
        st.stack.append(self._id)
        self._annotation = None
        if self.name not in MEMORY_ONLY and self._tracer._profiling():
            self._annotation = self._tracer._record_function(self.name)
            self._annotation.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter_ns()
        if self._annotation is not None:
            self._annotation.__exit__(None, None, None)
        st = self._tracer._thread()
        if st.stack and st.stack[-1] == self._id:
            st.stack.pop()
        self._tracer._keep(SpanRecord(
            self._id, self._parent, self.name, self._t0, t1, st.tid, st.name, st.job, self.attrs,
        ))
        return False


class _JobScope:
    __slots__ = ("_tracer", "_job", "_prev")

    def __init__(self, tracer: Tracer, job_id: Optional[str]):
        self._tracer, self._job = tracer, job_id

    def __enter__(self):
        st = self._tracer._thread()
        self._prev, st.job = st.job, self._job
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer._thread().job = self._prev
        return False


def span(name: str, **attrs):
    """A context manager timing its block as span ``name``; ``NOOP`` with
    tracing off. ``attrs`` (and ``.set(...)`` inside the block) are kept
    with the span."""
    tracer = _ACTIVE
    if tracer is None:
        return NOOP
    return _Span(tracer, name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (nothing with tracing off)."""
    tracer = _ACTIVE
    if tracer is not None:
        tracer._count(name, n)


def job(job_id: Optional[str]):
    """A context manager under which the calling thread's spans carry
    ``job_id``; ``NOOP`` with tracing off."""
    tracer = _ACTIVE
    if tracer is None:
        return NOOP
    return _JobScope(tracer, job_id)


def bind(fn: Callable) -> Callable:
    """``fn`` set to run under the calling thread's job id in whatever
    thread calls it (a thread or pool the job starts); ``fn`` itself with
    tracing off."""
    tracer = _ACTIVE
    if tracer is None:
        return fn
    job_id = tracer._thread().job

    def run(*args, **kwargs):
        with job(job_id):
            return fn(*args, **kwargs)

    return run


def active() -> Optional[Tracer]:
    """The tracer keeping spans now, or None with tracing off."""
    return _ACTIVE


def latest() -> Optional[Tracer]:
    """The tracer turned on last, whether on or off now (its records stay),
    or None before any."""
    return _LATEST


def profiling() -> bool:
    """True while a ``torch.profiler`` session runs in the process (torch's
    own flag; no session runs where torch's profiler was never imported)."""
    mod = sys.modules.get("torch.autograd.profiler")
    return bool(getattr(mod, "_is_profiler_enabled", False))


def enable(capacity: int = 200_000) -> Tracer:
    """Turn tracing on with a fresh ``Tracer``; returns it."""
    global _ACTIVE, _LATEST
    _ACTIVE = _LATEST = Tracer(capacity)
    return _ACTIVE


def disable() -> Optional[Tracer]:
    """Turn tracing off; returns the tracer that was on (its records stay)."""
    global _ACTIVE
    tracer, _ACTIVE = _ACTIVE, None
    return tracer
