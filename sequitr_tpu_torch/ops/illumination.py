"""Retrospective illumination correction for timelapse stacks.

Port of ``sequitr_tpu.ops.illumination``. Two multiplicative nuisances
corrupt long fluorescence acquisitions:

- SHADING: a per-pixel profile (vignetting, dust, sensor gain) shared by
  every frame of a fixed-FoV sequence. The per-pixel MEDIAN across (a
  sample of) frames isolates the profile up to content leakage, and a
  low-order 2D polynomial fit removes that leakage. Correct by DIVIDING.
  ``mosaic.estimate_flatfield`` uses the same estimator.
- PHOTOBLEACHING: a smooth per-frame global decay. A least-squares line
  through log(median intensity) vs t gives a decay rate whose inverse ramp
  re-normalizes every frame to the first frame's level
  (``estimate_bleach_exp``); ``ratio`` rescales each frame by its OWN
  median against the first frame's.

Estimation is host numpy over a sampled frame subset (``fit_shading`` and
``estimate_bleach_exp`` are the JAX package's, copied). Application
(``make_corrector``) runs on the frame's device: cast, divide by the
shading, per-channel median, gain.

The median is ``jnp.percentile(x, 50)``'s, linear method: sort, then the
two order statistics at ``floor`` / ``ceil`` of ``0.5 * (n - 1)`` (in f32)
summed with JAX's two weights (``_median_linear``, a call of
``ops.normalize.percentile_linear``). ``torch.median`` returns the lower
middle and ``torch.quantile`` interpolates by ``lerp`` (and refuses more
than 2^24 values), so neither is bit-equal to it.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from sequitr_tpu_torch.ops.normalize import percentile_linear

__all__ = [
    "fit_shading",
    "estimate_bleach_exp",
    "make_corrector",
]

# division guards: a fitted profile is clipped away from 0, and a
# per-frame ratio gain is bounded so one blank frame cannot blow up
_MIN_PROFILE = 0.05
_GAIN_BOUNDS = (0.05, 20.0)


def fit_shading(frames: np.ndarray, order: int = 2) -> np.ndarray:
    """Polynomial shading profile from the per-pixel median of frames.

    ``frames``: (N, H, W) views through one optical path (timelapse
    frames or mosaic tiles). ``order``: total 2D polynomial degree
    (default 2; raise it only with many frames — a high-order fit on
    few frames chases content). Returns an (H, W) float32 profile,
    mean 1, clipped to >= 0.05 so division can never explode. A
    degenerate fit (all-zero/non-finite input) returns all-ones, i.e.
    "no correction".
    """
    if frames.ndim != 3:
        raise ValueError(f"frames must be (N, H, W), got {frames.shape}")
    if not 1 <= order <= 6:
        raise ValueError(f"order={order} must be in [1, 6]")
    med = np.median(frames, axis=0).astype(np.float64)
    h, w = med.shape
    y = np.linspace(-1.0, 1.0, h)
    x = np.linspace(-1.0, 1.0, w)
    yy, xx = np.meshgrid(y, x, indexing="ij")
    terms = [
        (yy**i * xx**j).reshape(-1)
        for i in range(order + 1)
        for j in range(order + 1 - i)
    ]
    a = np.stack(terms, axis=1)
    coef, *_ = np.linalg.lstsq(a, med.reshape(-1), rcond=None)
    prof = (a @ coef).reshape(h, w)
    mean = prof.mean()
    if not np.isfinite(mean) or mean <= 0:
        return np.ones((h, w), np.float32)
    prof /= mean
    return np.maximum(prof, _MIN_PROFILE).astype(np.float32)


def estimate_bleach_exp(
    times: np.ndarray, medians: np.ndarray, n_total: int
) -> Tuple[np.ndarray, float]:
    """Exponential photobleach gains from sampled per-frame medians.

    Fits log(median) = a + b*t over the sampled ``times`` (absolute
    frame indices in the serving order) and returns
    ``(gains, rate)`` where ``gains[t] = exp(-b*t)`` for every frame
    ``t`` in [0, n_total) — multiplying frame t by ``gains[t]``
    restores it to the fitted t=0 level — and ``rate = -b`` (positive
    = decaying, per-frame log units; half-life = ln(2)/rate frames).

    Degenerate inputs (fewer than 2 usable samples, non-positive
    medians throughout, non-finite fit) return all-ones gains and rate
    0: "no correction" is always the safe fallback. Gains are clipped
    to [0.05, 20] so an extreme extrapolation cannot blow up late
    frames.
    """
    times = np.asarray(times, np.float64)
    medians = np.asarray(medians, np.float64)
    if times.shape != medians.shape or times.ndim != 1:
        raise ValueError(
            f"times/medians must be matching 1-D, got {times.shape} "
            f"vs {medians.shape}"
        )
    ok = np.isfinite(medians) & (medians > 1e-12) & np.isfinite(times)
    if int(ok.sum()) < 2:
        return np.ones(n_total, np.float32), 0.0
    t, m = times[ok], np.log(medians[ok])
    a = np.stack([np.ones_like(t), t], axis=1)
    coef, *_ = np.linalg.lstsq(a, m, rcond=None)
    b = float(coef[1])
    if not np.isfinite(b):
        return np.ones(n_total, np.float32), 0.0
    gains = np.exp(-b * np.arange(n_total, dtype=np.float64))
    gains = np.clip(gains, *_GAIN_BOUNDS)
    return gains.astype(np.float32), -b


def _median_linear(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """``jnp.percentile(x, 50.0, axis=dim)`` of f32 ``x``, bit for bit
    (``percentile_linear`` at q = 50: odd counts take the middle value
    times 1 plus the same value times 0; even counts 0.5 * each middle,
    summed)."""
    return percentile_linear(x, (50.0,), dim=dim)[0]


def make_corrector(mode: str) -> Callable:
    """Per-frame correction on the frame's device: (frame, shading, gain,
    ref_med) -> (corrected, median, applied_gain).

    ``frame``: (H, W, C) any dtype (cast on the device: native-dtype H2D,
    as the serving jobs do). ``shading``: (H, W, C) float32 profile
    (all-ones = no flat-field). ``gain``/``ref_med``: (C,) float32 — the
    precomputed exponential gain for this frame, and the reference
    (first-frame) median for ``ratio`` mode. ``mode``:

    - ``"exp"``: applied gain = ``gain`` (host-precomputed ramp).
    - ``"ratio"``: applied gain = ref_med / this frame's own
      shading-corrected median, clipped — exact per-frame stationarity.
      A degenerate reference (ref_med ~ 0) falls back to gain 1 per
      channel.
    - ``"none"``: gain 1 (flat-field only).

    The median is computed in every mode (it feeds gains.csv).
    """
    if mode not in ("exp", "ratio", "none"):
        raise ValueError(f"mode must be exp|ratio|none, got {mode!r}")

    def run(frame, shading, gain, ref_med):
        f = frame.to(torch.float32) / shading
        med = _median_linear(f.reshape(-1, f.shape[-1]), dim=0)
        if mode == "ratio":
            g = torch.where(
                ref_med > 1e-6,
                torch.clamp(ref_med / torch.clamp(med, min=1e-6), *_GAIN_BOUNDS),
                torch.ones_like(ref_med),
            )
        elif mode == "exp":
            g = gain
        else:
            g = torch.ones_like(gain)
        return f * g[None, None, :], med, g

    return run
