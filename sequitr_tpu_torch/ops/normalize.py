"""Percentile intensity normalization (port of ``sequitr_tpu.ops.normalize``).

    lo, hi = percentile(frame, p_lo), percentile(frame, p_hi)
    out    = clip((frame - lo) / (hi - lo + eps), 0, 1)

Three ways to find ``lo``/``hi``, as in the JAX package:

* ``percentile_normalize``: exact, one sort per slice and JAX's linear
  interpolation (``percentile_linear``: ``jnp.percentile`` as it runs
  under ``jax.jit``, bit for bit, at any slice size);
* ``percentile_normalize_fast``: a 4096-bin histogram in plain PyTorch
  (min/max pass, integer bucketing, one scatter-add of counts);
* ``percentile_normalize_pallas``: a 1024-bin histogram on the CUDA
  kernels (``ops.kernels.histogram``: min/max, counts and quantiles in one
  pass on the device), the name kept so job JSON's ``"normalize":
  "pallas"`` means the same thing on both packages.

All run per channel on the trailing axis when ``channel_axis`` is set, on
whatever device the input lies on, and never sync with the host.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from sequitr_tpu_torch.ops.kernels.histogram import invert_cdf, kernel_quantiles, scale_of

__all__ = [
    "percentile_linear",
    "percentile_normalize",
    "percentile_normalize_fast",
    "percentile_normalize_pallas",
    "histogram_quantiles",
]


def _flatten_spatial(x: torch.Tensor, channel_axis: bool) -> torch.Tensor:
    """(..., C) -> (S, C) float32, or (...,) -> (S, 1)."""
    x = x.to(torch.float32)
    if channel_axis:
        return x.reshape(-1, x.shape[-1])
    return x.reshape(-1, 1)


def percentile_linear(x: torch.Tensor, qs: Sequence[float], dim: int = 0) -> torch.Tensor:
    """``jnp.percentile(x, qs, axis=dim)`` of f32 ``x`` as it runs under
    ``jax.jit`` with constant ``qs`` (percents), bit for bit.

    Returns (len(qs), *x's shape without ``dim``). JAX's linear method in
    f32: q = p / 100 (folded exactly: eager JAX multiplies by 0.01 and
    lands an ulp off), the position q * (f32(n) - 1), the sorted values at
    its floor and ceil, then ``low * (1 - w) + high * w`` with w the
    position's fraction, the sum fused with the first product as XLA's CPU
    backend emits it (``fma_f32``). A slice holding a NaN gives NaN,
    as in JAX. One sort serves every q; the positions are host numbers
    (``n`` is static), so nothing syncs.
    """
    n = x.shape[dim]
    n_f = np.float32(n)
    ordered = torch.sort(x, dim=dim).values
    out = []
    for p in qs:
        pos = np.float32(np.float32(p) / np.float32(100.0)) * (n_f - np.float32(1.0))
        low = min(max(np.floor(pos), np.float32(0.0)), n_f - np.float32(1.0))
        high = min(max(np.ceil(pos), np.float32(0.0)), n_f - np.float32(1.0))
        high_w = np.float32(pos - np.floor(pos))
        low_w = np.float32(1.0) - high_w
        lo = ordered.narrow(dim, int(low), 1).squeeze(dim)
        hi = ordered.narrow(dim, int(high), 1).squeeze(dim)
        out.append(fma_f32(lo, float(low_w), hi * float(high_w)))
    res = torch.stack(out)
    # NaN sorts last: the slice's largest value is NaN iff it holds one
    has_nan = torch.isnan(ordered.narrow(dim, n - 1, 1).squeeze(dim))
    return torch.where(has_nan, torch.full_like(res, float("nan")), res)


def fma_f32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once, as one fused multiply-add (``b`` a
    tensor or an f32-exact number).

    ``a * b`` of two f32 values is exact in f64 (48 bits); the f64 sum and
    its error (TwoSum) give the sum rounded to odd, and rounding that to
    f32 is the correctly rounded sum (53 >= 24 + 2 bits). Elementwise f64
    ops, the same on the CPU and the card.
    """
    p = a.double() * (b.double() if isinstance(b, torch.Tensor) else b)
    c = c.double()
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    odd = (s.view(torch.int64) & 1) == 1
    away = torch.nextafter(s, torch.where(err > 0, float("inf"), float("-inf")))
    return torch.where((err == 0) | odd, s, away).float()


def percentile_normalize(
    x: torch.Tensor,
    p_lo: float = 5.0,
    p_hi: float = 99.5,
    channel_axis: bool = False,
    clip: bool = True,
    eps: float = 1e-8,
) -> torch.Tensor:
    """Exact per-frame percentile normalization (one sort per slice,
    ``percentile_linear``)."""
    flat = _flatten_spatial(x, channel_axis)
    lohi = percentile_linear(flat, (p_lo, p_hi), dim=0)
    return _apply(x, lohi[0], lohi[1], channel_axis, clip, eps)


def histogram_quantiles(
    flat: torch.Tensor, qs: Sequence[float], bins: int
) -> torch.Tensor:
    """Approximate quantiles of ``flat`` (S, C) via a fixed-bin histogram.

    Returns (len(qs), C): per q, the first bin whose CDF reaches q, at its
    midpoint-corrected upper edge — ``sequitr_tpu``'s XLA path, bucket for
    bucket.
    """
    s, c = flat.shape
    lo = flat.amin(dim=0)
    hi = flat.amax(dim=0)
    scale = scale_of(lo, hi, bins)
    idx = ((flat - lo) * scale).to(torch.int32).clamp(0, bins - 1)
    # per-channel histogram: channel c's bins start at c*bins
    offsets = torch.arange(c, dtype=torch.int32, device=flat.device) * bins
    keys = (idx + offsets).reshape(-1).to(torch.int64)
    hist = torch.zeros(c * bins, dtype=torch.int64, device=flat.device)
    hist.scatter_add_(0, keys, torch.ones_like(keys))
    return invert_cdf(hist.reshape(c, bins), s, lo, scale, qs).T


def percentile_normalize_fast(
    x: torch.Tensor,
    p_lo: float = 5.0,
    p_hi: float = 99.5,
    channel_axis: bool = False,
    clip: bool = True,
    eps: float = 1e-8,
    bins: int = 4096,
) -> torch.Tensor:
    """Histogram-based percentile normalization (plain PyTorch, sort-free)."""
    flat = _flatten_spatial(x, channel_axis)
    lohi = histogram_quantiles(flat, [p_lo / 100.0, p_hi / 100.0], bins)
    return _apply(x, lohi[0], lohi[1], channel_axis, clip, eps)


def percentile_normalize_pallas(
    x: torch.Tensor,
    p_lo: float = 5.0,
    p_hi: float = 99.5,
    clip: bool = True,
    eps: float = 1e-8,
    bins: int = 1024,
    channel_axis: bool = False,
) -> torch.Tensor:
    """Percentile normalization on the histogram kernel (1024 bins).

    Single-channel spatial arrays — (H, W) frames or (Z, H, W) volumes —
    histogram all their pixels as one slice (percentiles are over the pixel
    multiset, so the row layout is immaterial). ``channel_axis=True``: x is
    (*spatial, C) and each channel is its own slice, all in one launch.
    """
    qs = [p_lo / 100.0, p_hi / 100.0]
    if channel_axis:
        if x.ndim < 3:
            raise ValueError(
                f"pallas normalize with channels expects >=3D, got {tuple(x.shape)}"
            )
        slices = torch.movedim(x, -1, 0).reshape(x.shape[-1], -1)
        lohi = kernel_quantiles(slices, qs, bins=bins)  # (C, 2)
        return _apply(x, lohi[:, 0], lohi[:, 1], True, clip, eps)
    if x.ndim < 2:
        raise ValueError(f"pallas normalize expects >=2D spatial, got {tuple(x.shape)}")
    lohi = kernel_quantiles(x.reshape(1, -1), qs, bins=bins)[0]
    return _apply(x, lohi[0], lohi[1], False, clip, eps)


def _apply(x, lo, hi, channel_axis, clip, eps):
    x = x.to(torch.float32)
    if not channel_axis:
        lo = lo.reshape(())
        hi = hi.reshape(())
    out = (x - lo) / (hi - lo + eps)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    return out
