"""The benchmark's cell scenes with each cell's instance id.

``cells_scene`` draws exactly what ``inputs.cells_frame`` draws, from the
same generator calls in the same order, so its image equals
``cells_frame``'s bit for bit; beside it, the instance map: each cell's
pixels (``q < 0.525``, the pixels ``cells_frame``'s class map gives the
cell) take the cell's id 1, 2, ... in drawing order, a later cell
overwriting an earlier one where they overlap. This is the truth the
``cpnet`` weights were trained on and are scored against
(``tools/train_cpnet.py``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["cells_scene"]


def _add_cell(img, inst, rng, cls: int, cell_id: int) -> None:
    h, w = inst.shape
    cy = float(rng.uniform(8, h - 8))
    cx = float(rng.uniform(8, w - 8))
    if cls == 1:
        r_a = r_b = float(rng.uniform(5.0, 11.0))
        amp = float(rng.uniform(350.0, 700.0))
    else:
        r_a = float(rng.uniform(7.0, 12.0))
        r_b = r_a * float(rng.uniform(0.35, 0.55))
        amp = float(rng.uniform(900.0, 1600.0))
    theta = float(rng.uniform(0.0, np.pi))
    ct, st = np.cos(theta), np.sin(theta)
    ext = int(np.ceil(3.0 * max(r_a, r_b)))
    y0, y1 = max(0, int(cy) - ext), min(h, int(cy) + ext + 1)
    x0, x1 = max(0, int(cx) - ext), min(w, int(cx) + ext + 1)
    yy, xx = np.mgrid[y0:y1, x0:x1]
    dy, dx = yy - cy, xx - cx
    u = ct * dx + st * dy
    v = -st * dx + ct * dy
    q = (u / r_a) ** 2 + (v / r_b) ** 2
    profile = amp * np.exp(-0.5 * q * 4.0)
    img[y0:y1, x0:x1] += profile.astype(np.float32)
    inst[y0:y1, x0:x1] = np.where(q < 0.525, cell_id, inst[y0:y1, x0:x1])


def cells_scene(seed, shape: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """``(image, instances)``: ``inputs.cells_frame(seed, shape)`` and its
    (H, W) int32 instance map."""
    rng = np.random.default_rng(seed)
    h, w = shape
    img = rng.gamma(2.0, 60.0, shape).astype(np.float32)
    inst = np.zeros(shape, np.int32)
    for k in range(max(3, int(h * w / 4096.0))):
        _add_cell(img, inst, rng, 1 if rng.random() < 0.7 else 2, k + 1)
    img += rng.normal(0.0, 1.0, shape).astype(np.float32) * np.sqrt(np.maximum(img, 0.0)) * 0.5
    return np.maximum(img, 0.0), inst
