"""The benchmark's input generator: synthetic fluorescence frames.

``cells_frame`` is a frozen copy of the scenes the committed
``unet2d_cells`` fixture was trained on
(``sequitr_tpu_torch/data/synthetic.py``): a gamma background, round dim
"interphase" cells (class 1) and bright elongated "mitotic" cells (class
2), shot noise on top. The copy keeps the benchmark's inputs fixed when the
program's generator changes.

``build_inputs`` turns a traffic file's ``input`` block into TIFF files under
a run directory: ``distinct`` items drawn from the run's seed, and
``job_inputs`` job inputs, each ``items_per_job`` of those items in an order
drawn from the seed (every item the same number of times, give or take
one), as one multi-page TIFF.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from portbench import tiffio

__all__ = ["cells_frame", "seed_words", "build_inputs", "JobInput"]


def seed_words(seed: int, *salt: int) -> List[int]:
    """Non-negative 32-bit words of ``seed`` (any whole number) and
    ``salt``, for ``np.random.default_rng``: the same seed, the same draws."""
    s = int(seed) % (1 << 64)
    return [s & 0xFFFFFFFF, s >> 32, *(int(x) for x in salt)]


def _add_cell(img, lab, rng, cls: int) -> None:
    h, w = lab.shape
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
    lab[y0:y1, x0:x1] = np.where(q < 0.525, cls, lab[y0:y1, x0:x1])


def cells_frame(seed, shape: Tuple[int, int]) -> np.ndarray:
    """One (H, W) float32 fluorescence frame, one cell per 64x64 pixels."""
    rng = np.random.default_rng(seed)
    h, w = shape
    img = rng.gamma(2.0, 60.0, shape).astype(np.float32)
    lab = np.zeros(shape, np.int32)
    for _ in range(max(3, int(h * w / 4096.0))):
        _add_cell(img, lab, rng, 1 if rng.random() < 0.7 else 2)
    img += rng.normal(0.0, 1.0, shape).astype(np.float32) * np.sqrt(np.maximum(img, 0.0)) * 0.5
    return np.maximum(img, 0.0)


class JobInput:
    """One job's input: ``path`` (a TIFF or a directory of TIFFs) and the
    index into the distinct items of each item it holds, in order."""

    def __init__(self, path: str, items: Sequence[int]):
        self.path = path
        self.items = list(items)


def make_items(spec: Dict, seed: int) -> np.ndarray:
    """The ``distinct`` uint16 frames of an ``input`` block, from the seed."""
    shape = tuple(spec["shape"])
    if len(shape) != 2:
        raise ValueError(f"input shape {shape}: the generator makes 2D frames")
    return np.stack(
        [cells_frame(seed_words(seed, 1, i), shape) for i in range(spec["distinct"])]
    ).clip(0, 65535).astype(np.uint16)


def _orders(spec: Dict, seed: int, n: int, per_job: int) -> List[List[int]]:
    """``n`` orders of ``per_job`` items: one run of permutations, cut."""
    rng = np.random.default_rng(seed_words(seed, 2))
    d = int(spec["distinct"])
    flat = np.concatenate([rng.permutation(d) for _ in range(-(-n * per_job // d))])
    return [[int(i) for i in flat[k * per_job:(k + 1) * per_job]] for k in range(n)]


def build_inputs(spec: Dict, seed: int, root: str) -> Tuple[np.ndarray, List[JobInput], JobInput]:
    """Write a traffic file's inputs under ``root``: ``(items, inputs,
    warmup)``. ``warmup`` holds the first ``warmup_items`` items, in the
    cell's own shape."""
    items = make_items(spec, seed)
    per_job = int(spec["items_per_job"])

    def write(name: str, order: List[int]) -> JobInput:
        path = os.path.join(root, f"{name}.tif")
        tiffio.write_stack(path, items[order])
        return JobInput(path, order)

    inputs = [
        write(f"input{k:03d}", order)
        for k, order in enumerate(_orders(spec, seed, int(spec["job_inputs"]), per_job))
    ]
    warmup = write("warmup", list(range(int(spec["warmup_items"]))))
    return items, inputs, warmup
