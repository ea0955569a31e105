"""Overlapping-patch tiling and weighted stitch-blend (port of ``sequitr_tpu.ops.tiling``).

The tile grid and blend windows are the JAX package's numpy code, copied:
offsets advance by ``patch - overlap`` with the last tile clamped to the
edge, and windows are separable 1-D profiles (computed in f64, cast to
f32) whose interior is exactly 1. Extract and stitch are PyTorch on the
input's device: slices out, and an f32 accumulate with the exact masked
divide back in. The JAX package's rolled ``scan`` forms exist for its
compiler only; the plain loop here gives the same numbers.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "tile_offsets",
    "tile_grid",
    "blend_window",
    "extract_patches",
    "stitch_patches",
]


def tile_offsets(size: int, patch: int, overlap: int) -> Tuple[int, ...]:
    """1-D tile start offsets covering ``[0, size)`` with >= ``overlap`` overlap.

    Offsets advance by ``patch - overlap`` and the final offset is clamped to
    ``size - patch`` so the last tile ends exactly at the image edge (tiles
    near the edge may therefore overlap more than ``overlap``).
    """
    if patch > size:
        raise ValueError(f"patch ({patch}) larger than size ({size})")
    if not 0 <= overlap < patch:
        raise ValueError(f"overlap ({overlap}) must be in [0, patch)")
    step = patch - overlap
    offsets = list(range(0, max(size - patch, 0) + 1, step))
    if offsets[-1] != size - patch:
        offsets.append(size - patch)
    return tuple(offsets)


def tile_grid(
    shape: Sequence[int], patch: Sequence[int], overlap: Sequence[int]
) -> Tuple[Tuple[int, ...], ...]:
    """N-D tile grid: cartesian product of per-axis offsets, row-major."""
    per_axis = [tile_offsets(s, p, o) for s, p, o in zip(shape, patch, overlap)]
    grid = np.stack(
        np.meshgrid(*per_axis, indexing="ij"), axis=-1
    ).reshape(-1, len(per_axis))
    return tuple(tuple(int(v) for v in row) for row in grid)


@functools.lru_cache(maxsize=64)
def _window_1d(n: int, overlap: int, kind: str) -> np.ndarray:
    """1-D blend profile of length ``n`` ramping over ``overlap`` samples.

    ``flat``: all-ones (simple averaging in overlaps).
    ``tri``:  linear ramp 1/(o+1)..1 over the first/last ``overlap`` samples.
    ``hann``: raised-cosine ramp over the first/last ``overlap`` samples.

    The interior of the window is exactly 1 so non-overlapping regions are an
    identity pass-through; this makes tile->stitch of a constant field exact.
    """
    w = np.ones(n, dtype=np.float64)
    if overlap > 0 and kind != "flat":
        ramp_len = overlap
        t = np.arange(1, ramp_len + 1, dtype=np.float64) / (ramp_len + 1)
        if kind == "tri":
            ramp = t
        elif kind == "hann":
            ramp = 0.5 - 0.5 * np.cos(np.pi * t)
        else:
            raise ValueError(f"unknown window kind: {kind!r}")
        w[:ramp_len] = ramp
        w[-ramp_len:] = ramp[::-1]
    return w


def blend_window(
    patch: Sequence[int],
    overlap: Sequence[int],
    kind: str = "hann",
    device: torch.device | str = "cpu",
) -> torch.Tensor:
    """Separable N-D blend window, shape ``patch``, float32 on ``device``.

    Cached per device and shared between callers (read it, never write
    it): a fresh host-to-card copy per frame would stall the stream.
    """
    return _blend_window(
        tuple(int(p) for p in patch), tuple(int(o) for o in overlap), kind,
        str(torch.device(device)),
    )


@functools.lru_cache(maxsize=64)
def _blend_window(patch, overlap, kind: str, device: str) -> torch.Tensor:
    axes = [_window_1d(p, o, kind) for p, o in zip(patch, overlap)]
    w = functools.reduce(np.multiply.outer, axes).astype(np.float32)
    return torch.from_numpy(w).to(device)


def extract_patches(
    image: torch.Tensor,
    offsets: Sequence[Sequence[int]],
    patch: Sequence[int],
) -> torch.Tensor:
    """Extract tiles at ``offsets`` from the leading spatial axes.

    ``image``: (S0, S1, ..., trailing...) with ``len(patch)`` spatial axes.
    Returns (T, *patch, *trailing).
    """
    tiles = [
        image[tuple(slice(o, o + p) for o, p in zip(off, patch))]
        for off in offsets
    ]
    return torch.stack(tiles, dim=0)


def stitch_patches(
    patches: torch.Tensor,
    offsets: Sequence[Sequence[int]],
    out_spatial: Sequence[int],
    overlap: Sequence[int],
    window: str = "hann",
) -> torch.Tensor:
    """Weighted stitch-blend: recompose per-patch maps into a full frame.

    ``patches``: (T, *patch, *trailing). Each tile times the blend window is
    accumulated into an f32 canvas beside a canvas of window weights; the
    result is their quotient, with an exact masked divide (an additive eps
    would bias the ~1e-5 Hann corner weights).
    """
    nd = len(out_spatial)
    patch = tuple(patches.shape[1 : 1 + nd])
    trailing = tuple(patches.shape[1 + nd :])
    w = blend_window(patch, overlap, window, device=patches.device)
    w_b = w.reshape(w.shape + (1,) * len(trailing))

    acc = torch.zeros(
        tuple(out_spatial) + trailing, dtype=torch.float32, device=patches.device
    )
    wacc = torch.zeros(tuple(out_spatial), dtype=torch.float32, device=patches.device)
    for t, off in enumerate(offsets):
        sl = tuple(slice(o, o + p) for o, p in zip(off, patch))
        acc[sl] += patches[t].to(torch.float32) * w_b
        wacc[sl] += w
    wacc = wacc.reshape(wacc.shape + (1,) * len(trailing))
    return torch.where(wacc > 0, acc / torch.clamp_min(wacc, 1e-30), 0.0)
