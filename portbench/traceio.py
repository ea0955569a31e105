"""Device trace of the measured window, reduced to what the metrics read.

``torch.profiler`` (CPU and CUDA activities) runs from the window's first
submission to its close; the harness marks the window with a
``portbench.window`` span. The Chrome trace it exports is read back as
JSON: the device's kernels, copies and sets, clipped to the window, give
each kernel's total time and the union of busy intervals; the gaps in that
union are labelled by the host op that overlaps them most.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

__all__ = ["TraceSummary", "reduce_trace", "WINDOW_SPAN"]

WINDOW_SPAN = "portbench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")


class TraceSummary:
    """``kernels``: device seconds by kernel name (copies and sets under
    their own names), ``busy_s`` / ``window_s``: the union of device
    intervals and the window's length, ``gaps``: the longest idle gaps as
    ``(label, seconds)``."""

    def __init__(self, kernels: Dict[str, float], copies: Dict[str, float], busy_s: float,
                 window_s: float, gaps: List[Tuple[str, float]]):
        self.kernels, self.copies = kernels, copies
        self.busy_s, self.window_s, self.gaps = busy_s, window_s, gaps

    def device_ops(self, n: int = 10) -> List[List]:
        ops = {**self.kernels, **self.copies}
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], s] for name, s in top]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _label(gap: Tuple[float, float], host: List[Tuple[float, float, str]]) -> str:
    best, best_overlap = "no host op recorded", 0.0
    for a, b, name in host:
        ov = min(b, gap[1]) - max(a, gap[0])
        if ov > best_overlap:
            best, best_overlap = name, ov
    return best


def reduce_trace(path: str, clip_s: Optional[float] = None, n_gaps: int = 10) -> Optional[TraceSummary]:
    """The summary of an exported trace over the window span, cut to its
    first ``clip_s`` seconds (the measured window, which ends at a job's
    completion); None without the span or without a device event in it."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    window = None
    device, host = [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, name = ev.get("cat", ""), ev.get("name", "")
        a = float(ev["ts"])
        b = a + float(ev.get("dur", 0.0))
        if name == WINDOW_SPAN:
            window = (a, b)
        elif cat in _DEVICE_CATS:
            device.append((a, b, name, cat))
        elif cat in _HOST_CATS and not name.startswith("portbench."):
            host.append((a, b, name))
    if window is None:
        return None
    w0, w1 = window
    if clip_s is not None:
        w1 = min(w1, w0 + clip_s * 1e6)
    kernels: Dict[str, float] = {}
    copies: Dict[str, float] = {}
    clipped = []
    for a, b, name, cat in device:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        clipped.append((a, b))
        bucket = kernels if cat == "kernel" else copies
        bucket[name] = bucket.get(name, 0.0) + (b - a) * 1e-6
    if not clipped:
        return None
    busy = _union(clipped)
    gaps, prev = [], w0
    for a, b in busy + [(w1, w1)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps.sort(key=lambda g: g[0] - g[1])
    host = [h for h in host if h[1] > w0 and h[0] < w1]
    labelled = [(_label(g, host), (g[1] - g[0]) * 1e-6) for g in gaps[:n_gaps]]
    return TraceSummary(
        kernels, copies, sum(b - a for a, b in busy) * 1e-6, (w1 - w0) * 1e-6, labelled,
    )
