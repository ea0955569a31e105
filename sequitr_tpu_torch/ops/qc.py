"""Per-frame acquisition QC: focus, exposure and saturation metrics.

Port of ``sequitr_tpu.ops.qc``. The triage step before any model runs:
timelapses carry out-of-focus frames (autofocus hunting), saturated
frames (laser spikes) and dark frames (shutter glitches, stage moves).
``frame_qc`` scores frames on their device in one batched pass — a frame,
or every plane of a volume at once — and ``flag_frames`` flags outliers
on the host with robust statistics over the whole run.

Metrics (``METRICS``, the ``qc.csv`` column order):

* ``focus_vol`` — variance of the 3x3 Laplacian response over the
  interior (a 1-px rim is excluded so border padding can't fake
  sharpness);
* ``tenengrad`` — mean squared Sobel gradient magnitude, interior;
* ``mean`` / ``std`` / ``p01`` / ``p99`` — exposure statistics;
* ``sat_frac`` — fraction of pixels at or above the saturation level.

Numerics against the jitted JAX graph: ``p01``/``p99`` are
``ops.normalize.percentile_linear`` (bit-equal to the jitted
``jnp.percentile``); ``std`` takes its square root in float64 and rounds
once (XLA's f32 square root is correctly rounded, PyTorch's CPU one is
not). The whole-frame sums are reductions in each backend's own order,
so ``focus_vol``, ``tenengrad``, ``mean`` and ``std`` agree to a few f32
ulps, not bit for bit (``tests/test_torch_qc.py`` holds the bar).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from sequitr_tpu_torch.ops.normalize import percentile_linear

__all__ = ["METRICS", "frame_qc", "plane_var", "flag_frames", "default_saturation_level"]

# metric column order (the qc.csv contract; flag_frames indexes by name)
METRICS = ("focus_vol", "tenengrad", "mean", "std", "p01", "p99",
           "sat_frac")


def _mean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the two trailing axes: the sum times f32(1/n), XLA's
    rewrite of ``jnp.mean``'s division by a constant."""
    n = x.shape[-2] * x.shape[-1]
    return x.sum(dim=(-2, -1)) * (np.float32(1.0) / np.float32(n))


def plane_var(x: torch.Tensor) -> torch.Tensor:
    """Population variance over the two trailing axes, as ``jnp.var``
    computes it: the mean of the squared deviations from the mean."""
    d = x - _mean(x)[..., None, None]
    return _mean(d * d)


def frame_qc(frame: torch.Tensor, sat_level: float) -> torch.Tensor:
    """QC metrics of ``frame`` (..., H, W), any dtype, on its device:
    returns (..., 7) float32 in ``METRICS`` order.

    A (Z, H, W) volume scores every plane in the same pass (the JAX
    package's vmapped ``cached_volume_qc``). ``sat_level`` is the
    saturation threshold; ``inf`` disables it (``sat_frac`` reads 0).
    Nothing syncs with the host.
    """
    x = frame.to(torch.float32)
    # interior views: the 3x3 stencils as shifted adds
    c = x[..., 1:-1, 1:-1]
    up, dn = x[..., :-2, 1:-1], x[..., 2:, 1:-1]
    lf, rt = x[..., 1:-1, :-2], x[..., 1:-1, 2:]
    ul, ur = x[..., :-2, :-2], x[..., :-2, 2:]
    dl, dr = x[..., 2:, :-2], x[..., 2:, 2:]
    lap = up + dn + lf + rt - 4.0 * c
    gx = (ur + 2.0 * rt + dr) - (ul + 2.0 * lf + dl)
    gy = (dl + 2.0 * dn + dr) - (ul + 2.0 * up + ur)
    pct = percentile_linear(x.flatten(-2), (1.0, 99.0), dim=-1)
    sat = _mean((x >= sat_level).to(torch.float32))
    std = plane_var(x).double().sqrt().float()
    return torch.stack([
        plane_var(lap), _mean(gx * gx + gy * gy), _mean(x), std, pct[0], pct[1], sat,
    ], dim=-1)


def flag_frames(
    table: np.ndarray,
    mad_k: float = 3.5,
    dark_fraction: float = 0.5,
    sat_max: float = 0.01,
    focus_drop: float = 0.5,
) -> List[List[str]]:
    """Robust per-frame flags from a (T, 7) metric table.

    ``focus``: focus_vol more than ``mad_k`` robust sigmas (1.4826·MAD)
    below the run median AND below ``focus_drop`` x the median — the MAD
    term adapts to any scene/optics, the drop floor keeps tight
    low-variance runs from flagging 3%-dips (true defocus collapses the
    Laplacian variance by far more than half). ``dark``: mean below
    ``dark_fraction`` x the run's median mean. ``saturated``: sat_frac
    above ``sat_max`` (absolute — saturation is absolute). Single-frame
    runs never flag ``focus`` (no distribution).
    """
    t = np.asarray(table, np.float64)
    if t.ndim != 2 or t.shape[1] != len(METRICS):
        raise ValueError(
            f"table must be (T, {len(METRICS)}), got {t.shape}"
        )
    col = {m: t[:, i] for i, m in enumerate(METRICS)}
    flags: List[List[str]] = [[] for _ in range(len(t))]
    if len(t) > 1:
        med = float(np.median(col["focus_vol"]))
        mad = float(np.median(np.abs(col["focus_vol"] - med)))
        # MAD floor: >=50% identical focus scores (frozen stage,
        # duplicated frames) collapse the MAD to 0 — the degenerate run
        # must still flag a grossly defocused frame (the drop floor
        # prevents false positives)
        sigma = max(1.4826 * mad, 1e-12)
        for i in np.flatnonzero(
            (col["focus_vol"] < med - mad_k * sigma)
            & (col["focus_vol"] < focus_drop * med)
        ):
            flags[i].append("focus")
    med_mean = float(np.median(col["mean"]))
    for i in np.flatnonzero(col["mean"] < dark_fraction * med_mean):
        flags[i].append("dark")
    for i in np.flatnonzero(col["sat_frac"] > sat_max):
        flags[i].append("saturated")
    return flags


def default_saturation_level(dtype: np.dtype) -> Optional[float]:
    """Full-scale value for integer camera data; None for float inputs
    (already-normalized floats have no natural ceiling — callers pass an
    explicit ``saturation_level`` instead)."""
    dtype = np.dtype(dtype)
    if dtype.kind in "ui":
        return float(np.iinfo(dtype).max)
    return None
