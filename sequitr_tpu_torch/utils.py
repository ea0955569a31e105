"""Runtime utilities: device resolution and phase timing.

``resolve_device`` is the one place that turns a ``device`` argument into a
``torch.device``: the default is the CUDA card, and asking for it without
one raises — the port never falls back to the CPU on its own.
``PhaseTimer`` is the JAX package's structured phase timer, copied.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Union

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device", "PhaseTimer"]

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
