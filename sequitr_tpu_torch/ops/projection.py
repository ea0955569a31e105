"""Z-projection: collapse z-stacks into 2D frames on their device.

Port of ``sequitr_tpu.ops.projection``: the bridge from volumetric
acquisitions to the 2D pipeline family (``project_stack``, chained into
the 2D jobs by ``depends_on``).

Methods:

* ``max`` / ``min`` / ``sum`` / ``mean`` / ``std`` / ``median`` — plain
  reductions over z;
* ``best_focus`` — the single plane with the largest variance of its 3x3
  Laplacian (edge-replicated; ``ops.qc.plane_var``, the QC's focus
  measure), pixels unchanged;
* ``edof`` — extended depth of field: per-pixel focus selection from the
  local Laplacian energy (box-summed over ``radius``), ``mode="blend"``
  power-weighting across z by ``gamma`` or ``mode="select"`` taking the
  sharpest plane; the per-pixel argmax-z height map comes with it.

Dtype contract: selection methods (``max``/``min``/``best_focus``) return
the input dtype bit-exactly (uint16 reduces through int32: PyTorch has no
uint16 max on the CPU); arithmetic methods return float32.

Numerics against the jitted JAX projector: sums over z run plane by plane
in z order (XLA's CPU reduction order; ``torch.sum`` orders otherwise),
the mean multiplies that sum by f32(1/Z) (XLA's rewrite of the division
by a constant); the variance sums squared deviations
with each product fused into the running sum (``fma_f32``: XLA's CPU
backend contracts the multiply into the reduction) and its square root is
taken in float64 and rounded once; the median is ``percentile_linear`` at
50 (the mean of the two middles); the box sum adds the window in raster
order onto a zero pad (``lax.reduce_window``'s order), so the height map
is the JAX package's. The blend's ``** gamma`` is XLA's ``pow`` in the JAX
package and a float64 power rounded once here (closer to XLA's than
``torch.pow`` in f32, and the same on the CPU and the card): the blend
agrees to a bar (``tests/test_torch_projection.py``).
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sequitr_tpu_torch.ops.normalize import fma_f32, percentile_linear
from sequitr_tpu_torch.ops.qc import plane_var

__all__ = ["METHODS", "make_projector"]

# methods -> True when the output preserves the input dtype bit-exactly
METHODS = {
    "max": True,
    "min": True,
    "sum": False,
    "mean": False,
    "std": False,
    "median": False,
    "best_focus": True,
    "edof": False,
}

# dtypes without a max/min (or gather) kernel on every device, and the
# type each reduces through exactly
_WIDEN = {torch.uint16: torch.int32, torch.uint32: torch.int64}
_SAME_BITS = {torch.uint16: torch.int16, torch.uint32: torch.int32}


def _plane_laplacian(x: torch.Tensor) -> torch.Tensor:
    """3x3 Laplacian over each plane of a (Z, Y, X) f32 volume, same
    shape (edge-replicated pad, so border pixels score from real
    neighbors instead of a zero rim that would fake an edge)."""
    xp = F.pad(x[None], (1, 1, 1, 1), mode="replicate")[0]
    return (
        xp[:, :-2, 1:-1] + xp[:, 2:, 1:-1]
        + xp[:, 1:-1, :-2] + xp[:, 1:-1, 2:]
        - 4.0 * x
    )


def _sum_z(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 0, plane by plane in order, onto zero."""
    acc = torch.zeros_like(x[0])
    for z in range(x.shape[0]):
        acc = acc + x[z]
    return acc


def _sum_products_z(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of ``a * b`` over axis 0, each product fused into the running
    sum, plane by plane in order."""
    acc = torch.zeros_like(a[0])
    for z in range(a.shape[0]):
        acc = fma_f32(a[z], b[z], acc)
    return acc


def _recip(n: int) -> np.float32:
    """f32(1/n): XLA turns a division by a constant into this product."""
    return np.float32(1.0) / np.float32(n)


def _mean_z(x: torch.Tensor) -> torch.Tensor:
    return _sum_z(x) * _recip(x.shape[0])


def _std_z(x: torch.Tensor) -> torch.Tensor:
    d = x - _mean_z(x)
    var = _sum_products_z(d, d) * _recip(x.shape[0])
    return var.double().sqrt().float()


def _box_sum(x: torch.Tensor, radius: int) -> torch.Tensor:
    """Windowed sum of each plane over (2r+1)^2, SAME, zero outside: the
    window added in raster order (dy, then dx) onto zero."""
    h, w = x.shape[-2:]
    xp = F.pad(x, (radius, radius, radius, radius))
    acc = torch.zeros_like(x)
    for dy in range(2 * radius + 1):
        for dx in range(2 * radius + 1):
            acc = acc + xp[..., dy:dy + h, dx:dx + w]
    return acc


def _select_plane(vol: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """``vol[z]`` for a 0-d index tensor on ``vol``'s device, no sync."""
    bits = _SAME_BITS.get(vol.dtype)
    src = vol if bits is None else vol.view(bits)
    out = torch.index_select(src, 0, z.reshape(1))[0]
    return out if bits is None else out.view(vol.dtype)


def _reduce_z(vol: torch.Tensor, op: Callable) -> torch.Tensor:
    wide = _WIDEN.get(vol.dtype)
    if wide is None:
        return op(vol, dim=0)
    return op(vol.to(wide), dim=0).to(vol.dtype)


def make_projector(
    method: str,
    radius: int = 4,
    gamma: float = 4.0,
    mode: str = "blend",
) -> Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Build ``project(vol) -> (proj, aux)`` for (Z, Y, X) volumes on
    their device.

    ``aux`` is method-specific: ``best_focus`` returns the chosen plane
    index (int32 scalar), ``edof`` the per-pixel argmax-z height map
    (int32, (Y, X)); every other method returns an int32 ``-1`` sentinel
    (one streaming loop in the server for every method).

    ``radius``/``gamma``/``mode`` apply to ``edof`` only: the box
    half-width of the local sharpness window, the weighting exponent
    (higher = closer to hard selection) and ``"blend"``/``"select"``.
    """
    if method not in METHODS:
        raise ValueError(
            f"method={method!r} must be one of {sorted(METHODS)}"
        )
    radius = int(radius)
    if radius < 0:
        raise ValueError(f"radius={radius} must be >= 0")
    gamma = float(gamma)
    if not gamma > 0:
        raise ValueError(f"gamma={gamma} must be > 0")
    if mode not in ("blend", "select"):
        raise ValueError(f"mode={mode!r} must be 'blend' or 'select'")

    def project(vol: torch.Tensor):
        if vol.ndim != 3:
            raise ValueError(f"volume must be (Z, Y, X), got {tuple(vol.shape)}")
        aux = torch.full((), -1, dtype=torch.int32, device=vol.device)
        if method == "max":
            return _reduce_z(vol, torch.amax), aux
        if method == "min":
            return _reduce_z(vol, torch.amin), aux
        x = vol.to(torch.float32)
        if method == "sum":
            return _sum_z(x), aux
        if method == "mean":
            return _mean_z(x), aux
        if method == "std":
            return _std_z(x), aux
        if method == "median":
            return percentile_linear(x, (50.0,), dim=0)[0], aux
        lap = _plane_laplacian(x)
        if method == "best_focus":
            z = torch.argmax(plane_var(lap))
            return _select_plane(vol, z), z.to(torch.int32)
        # edof: local Laplacian energy -> per-pixel cross-z weighting
        sharp = lap * lap
        if radius > 0:
            # truncated border windows shrink identically across z at
            # the same pixel, so the cross-z ranking is unaffected
            sharp = _box_sum(sharp, radius)
        height = torch.argmax(sharp, dim=0)
        if mode == "select":
            proj = torch.take_along_dim(x, height[None], dim=0)[0]
            return proj, height.to(torch.int32)
        # blend: scale-invariant power weights (normalize by the
        # per-pixel max first so gamma powers stay in f32 range)
        peak = torch.amax(sharp, dim=0, keepdim=True)
        wgt = ((sharp / torch.clamp(peak, min=1e-30)).double() ** gamma).float()
        denom = _sum_z(wgt)
        # a pixel flat in EVERY plane has zero sharpness everywhere ->
        # uniform weights (plain mean), not 0/0
        safe = denom > 0
        proj = torch.where(
            safe,
            _sum_products_z(wgt, x) / torch.where(safe, denom, 1.0),
            _mean_z(x),
        )
        return proj, height.to(torch.int32)

    return project

