"""Plain percentile normalization of one frame or volume (numpy, float32).

The served jobs' default (``normalize: auto`` on the card) estimates the
5th and 99.5th percentiles from a 1024-bin histogram: ``lo``/``hi`` the
minimum and maximum, ``scale = 1023 / max(hi - lo, 1e-20)``, bucket
``int(clip((x - lo) * scale, 0, 1023))``, and for each q the first bin
whose cumulative share reaches q, at ``lo + (k + 1) / scale - 0.5 /
scale``. The map is then ``clip((x - p_lo) / (p_hi - p_lo + 1e-8), 0, 1)``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["histogram_percentiles", "normalize"]


def histogram_percentiles(x: np.ndarray, qs=(0.05, 0.995), bins: int = 1024) -> np.ndarray:
    """Percentiles (as fractions ``qs``) of all of ``x``'s values."""
    v = np.asarray(x, np.float32).ravel()
    lo, hi = np.float32(v.min()), np.float32(v.max())
    scale = np.float32(bins - 1) / np.float32(max(hi - lo, np.float32(1e-20)))
    idx = np.clip((v - lo) * scale, 0, bins - 1).astype(np.int64)
    cdf = np.cumsum(np.bincount(idx, minlength=bins)).astype(np.float32) / np.float32(v.size)
    out = []
    for q in qs:
        k = int(np.argmax(cdf >= np.float32(q)))
        out.append(lo + np.float32(k + 1) / scale - np.float32(0.5) / scale)
    return np.asarray(out, np.float32)


def normalize(x: np.ndarray) -> np.ndarray:
    """The float32 map the network sees."""
    lo, hi = histogram_percentiles(x)
    v = np.asarray(x, np.float32)
    return np.clip((v - lo) / (hi - lo + np.float32(1e-8)), 0.0, 1.0).astype(np.float32)
