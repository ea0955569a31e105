"""Multi-position mosaic stitching: grid-of-tiles -> one composite image.

Port of ``sequitr_tpu.mosaic``: pairwise phase correlation of
adjacent-tile overlap strips, a weighted least-squares position solve and
a feathered blend (the global-optimization stitcher, Preibisch 2009
style).

* Pairwise offsets are measured on the OVERLAP STRIPS only, cropped so the
  expected displacement is ~0 (far from phase correlation's mod-N wrap
  boundary). The strips of every horizontal pair share one shape, so ALL
  horizontal pairs are correlated in one batched call of
  ``ops.registration``'s correlator on the device (``_correlate_strips``),
  and all vertical pairs in a second.
* The global solve is a tiny least-squares over tile positions, host
  numpy (copied, as are the flat-field, gain, overlap-parsing, snake and
  feather helpers).
* Sub-pixel placement shifts ALL tiles by their fractional remainders in
  one batched Fourier shift on the device (``_shift_tiles``); the
  integer-origin feathered accumulate is host numpy (the canvas can
  exceed the card's memory).

The device functions take ``device`` (default the CUDA card;
``stitch_mosaic``'s ``backend: "cpu"`` passes ``"cpu"``). Conventions,
confidence gating and the fallback weight are the JAX package's: tiles
row-major on an (R, C) grid, positions are tile-origin offsets in canvas
pixels (min -> 0 per axis), seams below ``min_response`` fall back to the
nominal offset at weight 0.05.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sequitr_tpu_torch.ops import illumination as illum_lib
from sequitr_tpu_torch.ops import registration as reg_lib
from sequitr_tpu_torch.utils import resolve_device

__all__ = [
    "MosaicResult",
    "estimate_flatfield",
    "estimate_overlap",
    "solve_tile_gains",
    "normalize_overlap",
    "snake_indices",
    "snake_to_row_major",
    "pair_offsets",
    "solve_positions",
    "blend_mosaic",
    "stitch_grid",
]

# weight (relative to a confident measurement's 1.0) of a nominal-offset
# fallback edge: enough to keep the position graph connected, small
# enough that confident neighbours dominate the solve
_FALLBACK_WEIGHT = 0.05


@dataclass
class MosaicResult:
    """Everything a stitch produces.

    ``positions``: (R*C, 2) float64 tile origins (y, x), canvas coords,
    row-major grid order. ``edges``: (E, 2) int tile-index pairs (i, j);
    ``offsets``: (E, 2) measured (or fallen-back) j-minus-i offsets;
    ``responses``: (E,) PSR confidences; ``used``: (E,) bool, False where
    the nominal fallback replaced a low-confidence measurement.
    ``mosaic``: (Hc, Wc) float32 composite (None for estimate-only).
    """

    positions: np.ndarray
    edges: np.ndarray
    offsets: np.ndarray
    responses: np.ndarray
    used: np.ndarray
    rms_residual: float
    mosaic: np.ndarray | None


def normalize_overlap(
    overlap, tile_shape: Tuple[int, int]
) -> Tuple[int, int]:
    """Overlap parameter → (ov_y, ov_x) pixels.

    Accepts an int (px, both axes), a float in (0, 1) (fraction of the
    tile size per axis), or a 2-sequence of either. Validates the result
    is at least 4 px (phase correlation needs a few cycles of shared
    content) and at most half the tile (beyond that the "grid" premise
    is broken).
    """
    h, w = tile_shape
    if isinstance(overlap, (list, tuple)):
        if len(overlap) != 2:
            raise ValueError(f"overlap={overlap!r} must be scalar or 2-seq")
        oy, ox = overlap
    else:
        oy = ox = overlap
    out = []
    for v, n in ((oy, h), (ox, w)):
        if isinstance(v, float) and not float(v).is_integer():
            if not 0.0 < v < 1.0:
                raise ValueError(
                    f"fractional overlap {v!r} must be in (0, 1)"
                )
            v = int(round(v * n))
        v = int(v)
        if not 4 <= v <= n // 2:
            raise ValueError(
                f"overlap {v} px out of range [4, {n // 2}] for tile "
                f"size {n}"
            )
        out.append(v)
    return out[0], out[1]


def snake_indices(grid: Tuple[int, int]) -> np.ndarray:
    """Acquisition-order index for each row-major grid slot of a
    serpentine scan (odd rows acquired right→left)."""
    r, c = grid
    idx = np.arange(r * c).reshape(r, c)
    idx[1::2] = idx[1::2, ::-1]
    return idx.reshape(-1)


def snake_to_row_major(tiles: np.ndarray, grid: Tuple[int, int]) -> np.ndarray:
    """Reorder serpentine-acquired tiles (odd rows scanned right→left)
    into row-major grid order. ``tiles`` is (R*C, ...) in ACQUISITION
    order."""
    return tiles[snake_indices(grid)]


def estimate_flatfield(tiles: np.ndarray, order: int = 2) -> np.ndarray:
    """Retrospective flat-field (vignetting) profile shared by a grid's
    tiles.

    Every tile of a scan sees the SAME optical path — illumination
    falloff, dust, sensor shading — while the sample content varies, so
    the per-pixel MEDIAN across tiles isolates the multiplicative
    shading field up to content leakage; a low-order 2D polynomial fit
    (vignetting is smooth, classically radial-quadratic) removes that
    leakage and the result is normalized to mean 1. Correct by
    DIVIDING tiles by the profile before stitching: uncorrected
    vignetting shows up as a dark grid of seams in the composite and
    biases the seam correlator's intensity statistics.

    ``order``: total polynomial degree (default 2; 4 captures
    higher-order falloff when many tiles are available). Returns an
    (H, W) float32 profile with mean 1, clipped to >= 0.05 so division
    can never explode.
    """
    if tiles.ndim != 3:
        raise ValueError(f"tiles must be (N, H, W), got {tiles.shape}")
    # shared with timelapse correction (ops.illumination): a mosaic's
    # tiles and a timelapse's frames are both "many views through one
    # optical path", so the estimator is the same
    return illum_lib.fit_shading(tiles, order=order)


def estimate_overlap(
    tiles: np.ndarray,
    grid: Tuple[int, int],
    *,
    max_pairs: int = 8,
    min_response: float = 3.0,
    device=None,
) -> Tuple[int, int]:
    """Estimate the nominal overlap from the tiles themselves.

    Whole-tile phase correlation of an adjacent pair measures displacement
    ``W - ov``, which exceeds W/2 for any overlap under half a tile, so
    the mod-N wrap reports it as ``-ov`` DIRECTLY. Estimates aggregate as
    the median over up to ``max_pairs`` pairs per direction; pairs below
    ``min_response`` PSR are dropped. Raises ValueError when no direction
    yields a usable estimate. Returns integer (ov_y, ov_x); the sub-pixel
    remainder is the strip correlator's job.
    """
    n, h, w = tiles.shape
    hor, ver = _grid_edges(grid)
    out = []
    for pairs, axis, size in ((hor, 1, w), (ver, 0, h)):
        if not pairs:
            out.append(0)
            continue
        step = max(1, len(pairs) // max_pairs)
        sel = pairs[::step][:max_pairs]
        refs = np.stack([tiles[i] for i, _ in sel])
        movs = np.stack([tiles[j] for _, j in sel])
        # NO Hann window: the shared content sits at the tile EDGES,
        # exactly where a window crushes the signal to zero
        shifts, resp = _correlate_strips(refs, movs, True, False, 1, device)
        good = resp >= min_response
        ovs = -shifts[good, axis]
        ovs = ovs[(ovs >= 4) & (ovs <= size // 2)]
        out.append(int(round(float(np.median(ovs)))) if len(ovs) else 0)
    # first pass = horizontal seams (x overlap), second = vertical (y)
    ov_x, ov_y = out
    if grid[0] > 1 and not ov_y or grid[1] > 1 and not ov_x:
        raise ValueError(
            "could not estimate the tile overlap (weak whole-tile "
            "correlation — featureless seams?); pass overlap explicitly"
        )
    # single-row/column grids have no seams in one direction: mirror
    # the measured axis so the strip/feather geometry stays valid
    if grid[0] == 1:
        ov_y = ov_x
    if grid[1] == 1:
        ov_x = ov_y
    return ov_y, ov_x


def solve_tile_gains(
    tiles: np.ndarray,
    grid: Tuple[int, int],
    overlap: Tuple[int, int],
) -> np.ndarray:
    """Per-tile multiplicative gains from overlap intensity ratios.

    A long scan photobleaches: later tiles are dimmer by a smooth
    per-tile factor that flat-field (a per-PIXEL profile shared by all
    tiles) cannot express, and the blend then shows intensity steps at
    seams. Adjacent tiles image the SAME content in their overlap, so
    the ratio of robust strip medians measures the gain difference per
    seam; per-tile log-gains come from the same anchored least-squares
    shape as the position solve (log turns the multiplicative chain
    into a sum), normalized to mean-0 log (product of gains = 1, so the
    mosaic's global scale is untouched). Correct by MULTIPLYING tile k
    by ``gains[k]``. Seams with a non-positive or tiny strip median
    (blank overlap) are skipped; a tile with no usable seam keeps gain
    1 via the anchor rows.
    """
    n, h, w = tiles.shape
    ov_y, ov_x = overlap
    hor, ver = _grid_edges(grid)
    rows: List[np.ndarray] = []
    rhs: List[float] = []
    for pairs, axis in ((hor, 1), (ver, 0)):
        for i, j in pairs:
            if axis == 1:
                a = tiles[i][:, w - ov_x:]
                b = tiles[j][:, :ov_x]
            else:
                a = tiles[i][h - ov_y:, :]
                b = tiles[j][:ov_y, :]
            med_a = float(np.median(a))
            med_b = float(np.median(b))
            if med_a <= 1e-6 or med_b <= 1e-6:
                continue  # blank/negative overlap: no gain information
            row = np.zeros(n)
            # corrected equality: g_i * med_a == g_j * med_b
            row[i], row[j] = 1.0, -1.0
            rows.append(row)
            rhs.append(np.log(med_b) - np.log(med_a))
    # anchor every tile weakly at log-gain 0: keeps seam-less tiles at
    # 1 and pins the global scale without fighting the seam equations
    anchor_w = 1e-3
    for k in range(n):
        row = np.zeros(n)
        row[k] = anchor_w
        rows.append(row)
        rhs.append(0.0)
    a_mat = np.stack(rows)
    lg, *_ = np.linalg.lstsq(a_mat, np.asarray(rhs), rcond=None)
    lg -= lg.mean()  # product of gains = 1
    return np.exp(lg).astype(np.float32)


def _grid_edges(
    grid: Tuple[int, int]
) -> Tuple[List[Tuple[int, int]], List[Tuple[int, int]]]:
    """Adjacent-pair index lists: (horizontal, vertical), each (i, j)
    with j the right/below neighbour of i, row-major indices."""
    r, c = grid
    hor = [(y * c + x, y * c + x + 1) for y in range(r) for x in range(c - 1)]
    ver = [(y * c + x, (y + 1) * c + x) for y in range(r - 1) for x in range(c)]
    return hor, ver


def _correlate_strips(refs, movs, subpixel, window, refine, device=None):
    """All of a direction's pairs in one batched correlation on ``device``:
    (P, h, w) strip stacks -> (P, 2) float64 shifts + (P,) PSR responses,
    on the host."""
    device = resolve_device(device)
    shifts, resp = reg_lib._correlate(
        torch.as_tensor(np.asarray(refs, np.float32)).to(device),
        torch.as_tensor(np.asarray(movs, np.float32)).to(device),
        2, subpixel, window, refine,
    )
    return (
        shifts.cpu().numpy().astype(np.float64),
        resp.cpu().numpy().astype(np.float64),
    )


def pair_offsets(
    tiles: np.ndarray,
    grid: Tuple[int, int],
    overlap: Tuple[int, int],
    *,
    subpixel: bool = True,
    window: bool = True,
    refine: int = 2,
    device=None,
    correlate: Optional[Callable] = None,
):
    """Measured offsets of every adjacent tile pair.

    ``tiles``: (R*C, H, W) row-major. Returns ``(edges, offsets,
    responses, nominals)``: edges (E, 2) int; offsets (E, 2) float64 —
    the measured origin offset of tile j relative to tile i; responses
    (E,) PSR; nominals (E, 2) the grid-spacing prediction. The strips are
    cropped at nominal spacing, so the measured strip shift IS the
    deviation from nominal (expected ~0). ``correlate``: an optional
    ``(refs, movs) -> (shifts, responses)`` in place of the one-device
    batched correlator, e.g. ``parallel.make_dp_seam_correlator(mesh)``
    (the pair axis sharded over the mesh).
    """
    n, h, w = tiles.shape
    ov_y, ov_x = overlap
    hor, ver = _grid_edges(grid)
    edges: List[Tuple[int, int]] = []
    offsets: List[np.ndarray] = []
    responses: List[float] = []
    nominals: List[Tuple[float, float]] = []
    for pairs, axis in ((hor, 1), (ver, 0)):
        if not pairs:
            continue
        if axis == 1:
            refs = np.stack([tiles[i][:, w - ov_x:] for i, _ in pairs])
            movs = np.stack([tiles[j][:, :ov_x] for _, j in pairs])
            nominal = (0.0, float(w - ov_x))
        else:
            refs = np.stack([tiles[i][h - ov_y:, :] for i, _ in pairs])
            movs = np.stack([tiles[j][:ov_y, :] for _, j in pairs])
            nominal = (float(h - ov_y), 0.0)
        if correlate is None:
            shifts, resp = _correlate_strips(refs, movs, subpixel, window, refine, device)
        else:
            shifts, resp = correlate(refs, movs)
        for k, (i, j) in enumerate(pairs):
            edges.append((i, j))
            offsets.append(np.asarray(nominal) + shifts[k])
            responses.append(float(resp[k]))
            nominals.append(nominal)
    return (
        np.asarray(edges, np.int64),
        np.asarray(offsets, np.float64),
        np.asarray(responses, np.float64),
        np.asarray(nominals, np.float64),
    )


def solve_positions(
    n_tiles: int,
    edges: np.ndarray,
    offsets: np.ndarray,
    responses: np.ndarray,
    nominals: np.ndarray,
    *,
    min_response: float = 0.0,
):
    """Globally consistent tile positions from pairwise offsets.

    Weighted least squares over p ∈ R^(N×2): minimize
    Σ_e w_e ‖p_j − p_i − d_e‖² with tile 0 anchored at the origin; the
    two axes decouple, so it is two identical small dense solves.
    Low-confidence edges (PSR < ``min_response``) fall back to their
    NOMINAL offset at weight 0.05 — they keep the graph connected (a
    grid interior tile ringed by blank seams still lands at grid
    spacing) without letting a blank seam fight confident neighbours.

    Returns ``(positions, used, rms_residual)``: positions (N, 2)
    float64 shifted so min → 0 per axis; used (E,) bool (False =
    fallback); rms_residual the post-solve RMS of w-weighted edge
    disagreements in px — the stitch-consistency QC number.
    """
    e = len(edges)
    used = (
        responses >= min_response
        if min_response > 0.0
        else np.ones(e, bool)
    )
    d = np.where(used[:, None], offsets, nominals)
    wts = np.where(used, 1.0, _FALLBACK_WEIGHT)
    # rows: one per edge (+1 anchor); cols: one per tile
    a = np.zeros((e + 1, n_tiles), np.float64)
    rows = np.arange(e)
    a[rows, edges[:, 0]] = -1.0
    a[rows, edges[:, 1]] = 1.0
    a[e, 0] = 1.0  # anchor
    sw = np.sqrt(np.concatenate([wts, [1.0]]))
    aw = a * sw[:, None]
    positions = np.zeros((n_tiles, 2), np.float64)
    for ax in range(2):
        b = np.concatenate([d[:, ax], [0.0]]) * sw
        positions[:, ax] = np.linalg.lstsq(aw, b, rcond=None)[0]
    resid = positions[edges[:, 1]] - positions[edges[:, 0]] - d
    rms = float(
        np.sqrt((wts[:, None] * resid**2).sum() / max(wts.sum() * 2, 1e-12))
    )
    positions -= positions.min(axis=0, keepdims=True)
    return positions, used, rms


def _shift_tiles(tiles: np.ndarray, shifts: np.ndarray, device=None) -> np.ndarray:
    """Fractional Fourier shifts of ALL tiles in one batched call on
    ``device``; float32 on the host."""
    device = resolve_device(device)
    out = reg_lib.apply_shift(
        torch.as_tensor(np.asarray(tiles, np.float32)).to(device),
        torch.as_tensor(np.asarray(shifts, np.float32)).to(device),
    )
    return out.cpu().numpy()


def _feather(shape: Tuple[int, int], overlap: Tuple[int, int]) -> np.ndarray:
    """Per-tile blend weights: linear ramps over the overlap width from
    every edge (separable product). Strictly positive everywhere, so a
    region covered by exactly one tile reproduces it EXACTLY after the
    w·t / Σw division."""
    h, w = shape
    fy, fx = max(overlap[0], 1), max(overlap[1], 1)
    y = np.minimum(np.arange(h) + 0.5, h - 0.5 - np.arange(h))
    x = np.minimum(np.arange(w) + 0.5, w - 0.5 - np.arange(w))
    wy = np.minimum(y / fy, 1.0)
    wx = np.minimum(x / fx, 1.0)
    return (wy[:, None] * wx[None, :]).astype(np.float32)


def blend_mosaic(
    tiles: np.ndarray,
    positions: np.ndarray,
    overlap: Tuple[int, int],
    *,
    subpixel: bool = True,
    device=None,
) -> np.ndarray:
    """Feather-blended composite of ``tiles`` at ``positions``.

    Each tile is placed at the integer part of its position; the
    fractional remainder is applied as a batched sub-pixel Fourier
    shift (exact for band-limited content). The Fourier shift WRAPS, so
    the single leading row/column that received wrapped content gets
    its blend weight zeroed — in overlaps a neighbour fills it; on the
    outer rim it stays empty (≤1 px, the price of sub-pixel placement).
    ``subpixel=False`` rounds positions to whole pixels and skips the
    resample entirely (lossless; use for label tiles). The shifts run on
    ``device``, the accumulate on the host.
    """
    n, h, w = tiles.shape
    positions = np.asarray(positions, np.float64)
    if subpixel:
        # sub-resolution fractions are estimator float noise, not signal
        # (the correlator's precision is ~2e-3 px): snap them to the
        # integer, else a position of 224±1e-5 triggers the Fourier shift
        # AND the wrap-zeroed leading row/col, a 1-px rim that would then
        # differ between two backends on the same data
        nearest = np.round(positions)
        positions = np.where(
            np.abs(positions - nearest) < 1e-3, nearest, positions
        )
        origins = np.floor(positions).astype(np.int64)
        frac = positions - origins
        shifted = _shift_tiles(tiles, frac, device)
    else:
        origins = np.round(positions).astype(np.int64)
        frac = np.zeros((n, 2))
        shifted = np.asarray(tiles, np.float32)
    base = _feather((h, w), overlap)
    hc = int(origins[:, 0].max()) + h
    wc = int(origins[:, 1].max()) + w
    acc = np.zeros((hc, wc), np.float32)
    wsum = np.zeros((hc, wc), np.float32)
    for k in range(n):
        wk = base
        if frac[k, 0] > 0 or frac[k, 1] > 0:
            wk = base.copy()
            if frac[k, 0] > 0:
                wk[0, :] = 0.0  # wrapped row
            if frac[k, 1] > 0:
                wk[:, 0] = 0.0  # wrapped column
        y0, x0 = origins[k]
        acc[y0 : y0 + h, x0 : x0 + w] += wk * shifted[k]
        wsum[y0 : y0 + h, x0 : x0 + w] += wk
    return acc / np.maximum(wsum, 1e-12)


def stitch_grid(
    tiles: np.ndarray | Sequence[np.ndarray],
    grid: Tuple[int, int],
    *,
    overlap=0.1,
    order: str = "row",
    subpixel: bool = True,
    window: bool = True,
    refine: int = 2,
    min_response: float = 0.0,
    blend: bool = True,
    device=None,
    correlate: Optional[Callable] = None,
) -> MosaicResult:
    """Stitch an (R, C) grid of overlapping tiles into one composite.

    ``tiles``: (R*C, H, W) in acquisition order (``order="snake"`` for
    serpentine stage scans). ``overlap``: nominal overlap — px int,
    fraction of the tile, or per-axis pair. ``min_response``: PSR gate;
    seams below it fall back to nominal spacing (see solve_positions).
    ``blend=False`` skips compositing (estimate-only). The correlations
    and shifts run on ``device`` (default the card); ``correlate``
    replaces the seam correlator (``pair_offsets``). See MosaicResult.
    """
    tiles = np.asarray(tiles, np.float32)
    r, c = grid
    if tiles.ndim != 3:
        raise ValueError(
            f"tiles must be (N, H, W) single-channel, got {tiles.shape}"
        )
    if len(tiles) != r * c:
        raise ValueError(f"{len(tiles)} tiles for a {r}x{c} grid")
    if order == "snake":
        tiles = snake_to_row_major(tiles, grid)
    elif order != "row":
        raise ValueError(f"order={order!r} must be 'row' or 'snake'")
    if isinstance(overlap, str):
        if overlap != "auto":
            raise ValueError(
                f"overlap={overlap!r} must be px / fraction / pair / "
                f"'auto'"
            )
        ov = estimate_overlap(tiles, grid, device=device) if r * c > 1 else (4, 4)
    else:
        ov = normalize_overlap(overlap, tiles.shape[1:])
    if r * c == 1:
        return MosaicResult(
            positions=np.zeros((1, 2)),
            edges=np.zeros((0, 2), np.int64),
            offsets=np.zeros((0, 2)),
            responses=np.zeros(0),
            used=np.zeros(0, bool),
            rms_residual=0.0,
            mosaic=tiles[0] if blend else None,
        )
    edges, offsets, responses, nominals = pair_offsets(
        tiles, grid, ov, subpixel=subpixel, window=window,
        refine=refine, device=device, correlate=correlate,
    )
    positions, used, rms = solve_positions(
        r * c, edges, offsets, responses, nominals,
        min_response=min_response,
    )
    mosaic = (
        blend_mosaic(tiles, positions, ov, subpixel=subpixel, device=device)
        if blend
        else None
    )
    return MosaicResult(
        positions=positions,
        edges=edges,
        offsets=np.where(used[:, None], offsets, nominals),
        responses=responses,
        used=used,
        rms_residual=rms,
        mosaic=mosaic,
    )
