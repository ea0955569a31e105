"""Ronneberger-style U-Net per-pixel loss weight maps (host-side precompute;
a copy of ``sequitr_tpu.ops.weightmaps``).

sequitr feeds weighted cross-entropy with per-pixel weight maps combining
class-balance weights and a border-emphasis term computed from distance
transforms at record-creation time (SURVEY.md §2 'U-Net weight maps';
reference source unavailable — the formulation below is the original U-Net
paper's, documented as spec):

    w(x) = w_class(x) + w0 * exp(-(d1(x) + d2(x))^2 / (2 sigma^2))

where d1/d2 are distances to the nearest and second-nearest object border.
This is irregular, instance-dependent host work done ONCE when building
training records, so it stays numpy/scipy on the host (SURVEY.md §2).
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage

__all__ = ["class_balance_weights", "border_weights", "unet_weight_map"]


def class_balance_weights(
    labels: np.ndarray,
    num_classes: int,
    valid: np.ndarray | None = None,
) -> np.ndarray:
    """Per-pixel inverse-frequency class weights, mean-normalized to ~1.

    ``valid``: optional bool mask of ANNOTATED pixels (sparse/partial
    annotations) — frequencies count only valid pixels, so the phantom
    class-0 of masked-out regions cannot skew the balance; invalid
    pixels read weight 0.
    """
    labels = np.asarray(labels)
    flat = labels.reshape(-1)
    if valid is not None:
        flat = flat[np.asarray(valid).reshape(-1)]
    freq = np.bincount(flat, minlength=num_classes).astype(np.float64)
    total = flat.size
    # inverse frequency; absent classes contribute nothing
    inv = np.where(freq > 0, total / (num_classes * np.maximum(freq, 1)), 0.0)
    w = inv[labels]
    if valid is not None:
        w = w * np.asarray(valid)
        # normalize over ANNOTATED pixels only: a whole-map mean would
        # inflate valid weights by 1/annotated-fraction, drowning the
        # fixed w0 border term at sparse coverage (review finding)
        mean = w[np.asarray(valid)].mean() if np.asarray(valid).any() else 0.0
        if mean > 0:
            return (w / mean).astype(np.float32)
        return np.zeros_like(w, dtype=np.float32)  # nothing annotated
    mean = w.mean()
    return (w / mean if mean > 0 else np.ones_like(w)).astype(np.float32)


def border_weights(
    instance_labels: np.ndarray,
    w0: float = 10.0,
    sigma: float = 5.0,
    max_instances: int = 512,
) -> np.ndarray:
    """Border-emphasis term from per-instance distance transforms.

    ``instance_labels``: (H, W) — or (Z, H, W) for volumetric training —
    int map with 0 = background and each object a distinct positive id
    (e.g. from connected components). For every pixel, d1/d2 are the
    distances to the two nearest distinct instances; the weight peaks in
    the thin gaps between touching cells — exactly the pixels a
    segmentation net must get right for downstream tracking. Distance
    transforms are N-D (scipy EDT), so the 3D variant is exact, just
    proportionally more host precompute at record-build time.
    """
    instance_labels = np.asarray(instance_labels)
    ids = np.unique(instance_labels)
    ids = ids[ids != 0][:max_instances]
    if len(ids) < 2:
        return np.zeros(instance_labels.shape, dtype=np.float32)
    dists = np.empty((len(ids),) + instance_labels.shape, dtype=np.float32)
    for i, obj in enumerate(ids):
        dists[i] = ndimage.distance_transform_edt(instance_labels != obj)
    dists.partition(1, axis=0)  # two smallest along instance axis
    d1, d2 = dists[0], dists[1]
    return (w0 * np.exp(-((d1 + d2) ** 2) / (2.0 * sigma**2))).astype(np.float32)


def unet_weight_map(
    class_labels: np.ndarray,
    instance_labels: np.ndarray | None = None,
    num_classes: int | None = None,
    w0: float = 10.0,
    sigma: float = 5.0,
    valid: np.ndarray | None = None,
) -> np.ndarray:
    """Full U-Net weight map: class balance + border emphasis.

    If ``instance_labels`` is None, instances are derived from connected
    components of the foreground (``class_labels > 0``). ``valid``:
    optional bool mask of annotated pixels (sparse annotations) —
    class balance counts only valid pixels and the whole map zeros where
    invalid, so unannotated regions contribute NOTHING to the weighted
    cross-entropy (its sum(w)-normalization makes zero weight a true
    ignore; ops/losses.py).
    """
    class_labels = np.asarray(class_labels)
    if num_classes is None:
        num_classes = int(class_labels.max()) + 1
    if instance_labels is None:
        instance_labels, _ = ndimage.label(class_labels > 0)
    wc = class_balance_weights(class_labels, num_classes, valid=valid)
    wb = border_weights(instance_labels, w0=w0, sigma=sigma)
    w = wc + wb
    if valid is not None:
        w = w * np.asarray(valid)
    return w.astype(np.float32)
