"""Runtime utilities: device resolution and phase timing.

``resolve_device`` is the one place that turns a ``device`` argument into a
``torch.device``: the default is the CUDA card, and asking for it without
one raises — the port never falls back to the CPU on its own.
``PhaseTimer`` is the JAX package's structured phase timer, copied.
``device_median_ms`` times calls on the card.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Iterator, Union

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device", "PhaseTimer", "device_median_ms"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``.

    Raises RuntimeError for a CUDA device when no card is visible: callers
    that want the CPU pass ``device="cpu"``.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")
    return dev


class PhaseTimer:
    """Accumulate wall-clock per named phase; render a compact dict.

    >>> t = PhaseTimer()
    >>> with t.phase("normalize"): ...
    >>> t.summary()  # {"normalize_s": 0.12, ...}
    """

    def __init__(self) -> None:
        self._acc: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._acc[name] = self._acc.get(name, 0.0) + dt

    def summary(self) -> Dict[str, float]:
        return {f"{k}_s": round(v, 4) for k, v in self._acc.items()}


def device_median_ms(fn: Callable[[], object], n: int = 100) -> float:
    """Median device time of ``fn()`` in ms over ``n`` calls, from CUDA events.

    A sleep kernel first holds the stream for twice the time the host takes
    to queue all ``n`` calls, so the events see back-to-back device time,
    not launch overhead.
    """
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    events = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(n)
    ]
    # cycles at up to 2 GHz: a slower clock only sleeps longer
    torch.cuda._sleep(int(2e9 * (2 * n * enqueue_s + 0.01)))
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return times[n // 2]
