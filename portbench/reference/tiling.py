"""Plain sliding-window tiling and Hann stitch.

Tiles start every ``patch - overlap`` along an axis, the last one clamped
to end at the edge. Each tile's class probabilities are weighted by a
separable window whose ramps over the first and last ``overlap`` samples
are ``0.5 - 0.5 cos(pi t)``, ``t = 1 .. overlap`` over ``overlap + 1``, and
1 inside; the stitched map is the weighted sum over the sum of weights.
"""

from __future__ import annotations

import itertools
from typing import List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["offsets", "grid", "window", "stitch"]


def offsets(size: int, patch: int, overlap: int) -> List[int]:
    out = list(range(0, size - patch + 1, patch - overlap))
    if out[-1] != size - patch:
        out.append(size - patch)
    return out


def grid(shape: Sequence[int], patch: Sequence[int], overlap: Sequence[int]) -> List[Tuple[int, ...]]:
    return list(itertools.product(*[offsets(s, p, o) for s, p, o in zip(shape, patch, overlap)]))


def window(patch: Sequence[int], overlap: Sequence[int]) -> np.ndarray:
    w = np.ones((), np.float64)
    for n, o in zip(patch, overlap):
        a = np.ones(n)
        if o:
            ramp = 0.5 - 0.5 * np.cos(np.pi * np.arange(1, o + 1) / (o + 1))
            a[:o], a[-o:] = ramp, ramp[::-1]
        w = np.multiply.outer(w, a)
    return w.astype(np.float32)


def stitch(tiles: torch.Tensor, origins, shape, overlap) -> torch.Tensor:
    """(T, K, *patch) probabilities at ``origins`` -> (K, *shape)."""
    patch = tuple(tiles.shape[2:])
    w = torch.from_numpy(window(patch, overlap)).to(tiles.device)
    acc = torch.zeros((tiles.shape[1],) + tuple(shape), dtype=torch.float32, device=tiles.device)
    wsum = torch.zeros(tuple(shape), dtype=torch.float32, device=tiles.device)
    for t, o in zip(tiles, origins):
        sl = tuple(slice(a, a + p) for a, p in zip(o, patch))
        acc[(slice(None),) + sl] += t * w
        wsum[sl] += w
    return acc / wsum
