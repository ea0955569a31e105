"""Per-object colocalization statistics (host-side quantification).

A copy of ``sequitr_tpu.ops.colocalize`` (host numpy; the port imports
nothing of the JAX package).

The classic multi-fluorophore question — "does marker A sit where marker
B sits, per cell?" — answered per segmented object: Pearson correlation
of the two channels over each object's pixels, and the Manders split
coefficients M1/M2 (the fraction of one channel's intensity residing in
the other channel's above-threshold pixels; Manders 1993). Channel
thresholds default to per-frame Otsu (the 256-bin Otsu is implemented
here, with no image-library dependency).

Host-side by design: per-object reductions over an irregular instance
map are data-dependent gather/scatter work (SURVEY.md §3.5 keeps
localization-style post-processing off the chip); every reduction is one
``np.bincount`` over the flattened instance map, so a K-channel frame
costs 2K + 3·C(K,2) bincounts — milliseconds at 1024².

Exposed through the ``measure_objects`` pipeline (``colocalize: true``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = ["otsu_threshold", "validate_threshold_spec",
           "resolve_thresholds", "object_coloc_pairs"]


def otsu_threshold(arr: np.ndarray, bins: int = 256) -> float:
    """Otsu's between-class-variance-maximizing intensity threshold.

    Operates on the flattened array (any shape/dtype); returns the bin
    EDGE intensity: pixels strictly above it are "positive". A constant
    image returns its single value (nothing is positive).
    """
    a = np.asarray(arr, np.float64).ravel()
    lo, hi = float(a.min()), float(a.max())
    if hi <= lo:
        return hi
    hist, edges = np.histogram(a, bins=bins, range=(lo, hi))
    p = hist.astype(np.float64) / a.size
    centers = (edges[:-1] + edges[1:]) / 2.0
    w0 = np.cumsum(p)
    w1 = 1.0 - w0
    mu_cum = np.cumsum(p * centers)
    mu_tot = mu_cum[-1]
    with np.errstate(divide="ignore", invalid="ignore"):
        mu0 = mu_cum / w0
        mu1 = (mu_tot - mu_cum) / w1
        between = w0 * w1 * (mu0 - mu1) ** 2
    between[~np.isfinite(between)] = -1.0
    k = int(np.argmax(between))
    return float(edges[k + 1])


def validate_threshold_spec(
    spec: Union[str, float, Sequence[float], None], k: int,
) -> None:
    """Reject a malformed ``coloc_threshold`` spec WITHOUT computing it.

    Callers with a frame loop validate once up front (a bad spec must be
    a deterministic fail-fast error, not something an all-empty stack
    silently never evaluates); the per-frame Otsu values still resolve
    frame by frame in ``resolve_thresholds``.
    """
    if spec is None or spec == "otsu":
        return
    if isinstance(spec, (int, float)) and not isinstance(spec, bool):
        return
    if isinstance(spec, (list, tuple)):
        if len(spec) != k or not all(
            isinstance(v, (int, float)) and not isinstance(v, bool)
            for v in spec
        ):
            raise ValueError(
                f"coloc_threshold list must hold {k} numbers, got {spec!r}"
            )
        return
    raise ValueError(
        f"coloc_threshold must be 'otsu', a number or a per-channel list, "
        f"got {spec!r}"
    )


def resolve_thresholds(
    chans: Sequence[np.ndarray],
    spec: Union[str, float, Sequence[float], None],
) -> List[float]:
    """Per-channel positivity thresholds for the Manders coefficients.

    ``spec``: ``"otsu"``/None = per-channel (per-frame) Otsu; a number =
    the same absolute threshold for every channel; a list = one absolute
    threshold per channel.
    """
    validate_threshold_spec(spec, len(chans))
    if spec is None or spec == "otsu":
        return [otsu_threshold(c) for c in chans]
    if isinstance(spec, (int, float)):
        return [float(spec)] * len(chans)
    return [float(v) for v in spec]


def object_coloc_pairs(
    inst: np.ndarray,
    n: int,
    chans: Sequence[np.ndarray],
    thresholds: Sequence[float],
) -> Dict[Tuple[int, int], Dict[str, np.ndarray]]:
    """Per-object Pearson + Manders M1/M2 for every channel pair.

    ``inst``: int instance map (0 = background, 1..n objects);
    ``chans``: K same-shape float intensity channels; ``thresholds``:
    K positivity thresholds (pixels strictly above are "positive").

    Returns ``{(i, j): {"pearson": (n,), "m1": (n,), "m2": (n,)}}`` for
    every i < j, arrays indexed by instance-1. Conventions: an object
    with zero intensity variance in either channel has Pearson ``nan``
    (correlation undefined — e.g. a saturated or empty cell); an object
    with zero total intensity in a channel has that Manders coefficient
    ``nan``. M1 is the fraction of channel i's intensity inside channel
    j's positive pixels; M2 the converse.
    """
    flat = np.ascontiguousarray(inst).ravel()
    minlength = n + 1
    counts = np.bincount(flat, minlength=minlength)[1:].astype(np.float64)
    k = len(chans)
    flats = [np.asarray(c, np.float64).ravel() for c in chans]
    pos = [f > t for f, t in zip(flats, thresholds)]
    # raw sums feed the Manders denominators (intensity FRACTIONS are
    # offset-dependent by definition); the Pearson moments use frame-mean-
    # centered values — Pearson is shift-invariant, and raw moments
    # (sq - s^2/n) cancel catastrophically on the high DC offsets of
    # 16-bit camera data (measured: pearson 0.99984 where 1.0 is exact)
    sums = [np.bincount(flat, f, minlength)[1:] for f in flats]
    cents = [f - f.mean() for f in flats]
    csums = [np.bincount(flat, c, minlength)[1:] for c in cents]
    csqs = [np.bincount(flat, c * c, minlength)[1:] for c in cents]
    out: Dict[Tuple[int, int], Dict[str, np.ndarray]] = {}
    with np.errstate(divide="ignore", invalid="ignore"):
        var = [
            sq - s * s / np.maximum(counts, 1)
            for sq, s in zip(csqs, csums)
        ]
        for i in range(k):
            for j in range(i + 1, k):
                s_ab = np.bincount(flat, cents[i] * cents[j], minlength)[1:]
                cov = s_ab - csums[i] * csums[j] / np.maximum(counts, 1)
                denom = np.sqrt(var[i] * var[j])
                pearson = np.where(denom > 0, cov / denom, np.nan)
                a_in_b = np.bincount(flat, flats[i] * pos[j], minlength)[1:]
                b_in_a = np.bincount(flat, flats[j] * pos[i], minlength)[1:]
                m1 = np.where(sums[i] > 0, a_in_b / sums[i], np.nan)
                m2 = np.where(sums[j] > 0, b_in_a / sums[j], np.nan)
                out[(i, j)] = {"pearson": pearson, "m1": m1, "m2": m2}
    return out
