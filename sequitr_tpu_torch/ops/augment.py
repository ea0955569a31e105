"""Training augmentation: flips, rotations, elastic warp, photometric jitter
(port of ``sequitr_tpu.ops.augment``).

PyTorch generators cannot replay ``jax.random``, so every op is split in
two: a *draw* takes an explicit ``torch.Generator`` and returns the random
quantities (flip bits, the rotation count, the displacement field, the
photometric gain, offset and noise), and an *apply* is a deterministic
function of the example and its draws. The applies are the JAX package's
arithmetic op for op, so on the reference's own draws they give its output
(the tests hold them to ``augment_elastic.npz``); the draws follow the same
distributions from another stream.

The elastic field is the JAX package's: a ``grid`` x ``grid`` lattice of
``N(0, 1) * alpha`` pixel displacements upsampled by ``jax.image.resize``'s
bicubic (Keys' cubic with a = -0.5, half-pixel centres, weights renormalised
over the taps inside the lattice) — not ``F.interpolate``'s bicubic (a =
-0.75, clamped edges). ``elastic_fields`` computes those weights itself and
applies them as two small products. The warp is one gather of packed
quad-corner rows (``_quad_warp``): image channels, the weight map and the
label plane share it; labels pick one corner with round-half-to-even on the
absolute coordinate. 3D volumes flip on all three axes, rotate in-plane and
take the same field on every z-plane.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = [
    "AugmentDraws",
    "draw_flip",
    "draw_rot90",
    "draw_elastic",
    "draw_photometric",
    "draw_example",
    "elastic_fields",
    "resize_weights",
    "apply_flip",
    "apply_rot90",
    "apply_photometric",
    "elastic_warp",
    "warp_example",
    "apply_example",
    "augment_example",
    "augment_batch",
]


# ---------------------------------------------------------------------------
# draws
# ---------------------------------------------------------------------------


def draw_flip(generator: Optional[torch.Generator], n_axes: int) -> List[bool]:
    """One fair coin per flip axis."""
    return [bool(b) for b in torch.rand(n_axes, generator=generator) < 0.5]


def draw_rot90(generator: Optional[torch.Generator]) -> int:
    """The number of quarter turns, uniform in 0..3."""
    return int(torch.randint(0, 4, (), generator=generator))


def draw_elastic(
    generator: Optional[torch.Generator], grid: int, alpha: float, p: float
) -> Tuple[torch.Tensor, bool]:
    """The (2, grid, grid) control lattice of ``N(0, 1) * alpha`` pixel
    displacements (dy, dx) and whether the warp applies (probability ``p``)."""
    lattice = torch.randn((2, grid, grid), generator=generator, dtype=torch.float32) * alpha
    return lattice, bool(torch.rand((), generator=generator) < p)


def draw_photometric(
    generator: Optional[torch.Generator],
    shape: Sequence[int],
    gain_jitter: float = 0.0,
    offset_jitter: float = 0.0,
    noise_std: float = 0.0,
):
    """Per-channel gain (log-uniform in ``[1/(1+g), 1+g]``), per-channel
    offset ``N(0, offset_jitter)`` and per-pixel noise ``N(0, noise_std)``
    for an image of ``shape`` (channels last); each None when its knob is 0."""
    c = shape[-1]
    gain = offset = noise = None
    if gain_jitter > 0:
        hi = float(np.log1p(gain_jitter))
        gain = torch.exp((torch.rand(c, generator=generator) * 2 - 1) * hi)
    if offset_jitter > 0:
        offset = torch.randn(c, generator=generator) * offset_jitter
    if noise_std > 0:
        noise = torch.randn(tuple(shape), generator=generator) * noise_std
    return gain, offset, noise


@dataclasses.dataclass
class AugmentDraws:
    """The random part of one example's augmentation.

    ``flip``: one bit per flip axis; ``rot``: quarter turns; ``dy``/``dx``:
    the (H, W) displacement field (zeros when the warp does not apply);
    ``gain``/``offset``/``noise``: the photometric draws or None.
    """

    flip: List[bool]
    rot: int
    dy: torch.Tensor
    dx: torch.Tensor
    gain: Optional[torch.Tensor] = None
    offset: Optional[torch.Tensor] = None
    noise: Optional[torch.Tensor] = None


def _draw_host(generator, image_shape, dims, elastic_alpha, elastic_grid, p_elastic,
               gain_jitter, offset_jitter, noise_std):
    """One example's draws in ``draw_example``'s order, the lattice not yet
    resized: (flip, rot, lattice, do_elastic, (gain, offset, noise))."""
    flip = draw_flip(generator, 2 if dims == 2 else 3)
    rot = draw_rot90(generator)
    lattice, do_elastic = draw_elastic(generator, elastic_grid, elastic_alpha, p_elastic)
    phot = draw_photometric(generator, image_shape, gain_jitter, offset_jitter, noise_std)
    return flip, rot, lattice, do_elastic, phot


def draw_example(
    generator: Optional[torch.Generator],
    image_shape: Sequence[int],
    dims: int = 2,
    elastic_alpha: float = 20.0,
    elastic_grid: int = 4,
    p_elastic: float = 0.5,
    gain_jitter: float = 0.0,
    offset_jitter: float = 0.0,
    noise_std: float = 0.0,
    device=None,
) -> AugmentDraws:
    """Draw one example's augmentation: flips, rotation, the elastic field
    (computed on ``device``), then the photometric draws (moved there)."""
    flip, rot, lattice, do_elastic, phot = _draw_host(
        generator, image_shape, dims, elastic_alpha, elastic_grid, p_elastic,
        gain_jitter, offset_jitter, noise_std,
    )
    plane = tuple(image_shape[:2] if dims == 2 else image_shape[1:3])
    dy, dx = elastic_fields(lattice.to(device), plane)
    if not do_elastic:
        dy, dx = torch.zeros_like(dy), torch.zeros_like(dx)
    gain, offset, noise = (None if t is None else t.to(device) for t in phot)
    return AugmentDraws(flip, rot, dy, dx, gain, offset, noise)


# ---------------------------------------------------------------------------
# the elastic field: jax.image.resize's bicubic
# ---------------------------------------------------------------------------


def _fma32(a, b, c):
    """float32 ``a * b + c`` rounded once (a fused multiply-add): the f32
    product is exact in float64."""
    if isinstance(a, torch.Tensor):
        return (a.double() * b.double() + c.double()).float()
    out = np.asarray(a, np.float64) * np.asarray(b, np.float64) + np.asarray(c, np.float64)
    return out.astype(np.float32)


@functools.lru_cache(maxsize=16)
def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) f32 weights of ``jax.image.resize(..., "bicubic")``
    along one axis of upsampling ``n_in -> n_out``
    (``jax._src.image.scale.compute_weight_mat`` with Keys' cubic, a = -0.5):
    sample position ``(i + 0.5) * n_in / n_out - 0.5``, the kernel at each
    tap's distance, columns renormalised to sum 1, zero outside the input.
    Evaluated in f32 as XLA's CPU backend evaluates it (its multiply-adds
    fused), which makes these weights bit-equal to the reference's at the
    lattice and patch sizes the tests measure. Cached by size: the array is
    shared, and read only."""
    if n_out < n_in:
        raise ValueError(f"elastic lattice {n_in} larger than the plane {n_out}")
    f32 = np.float32
    inv = f32(1.0 / (n_out / n_in))
    sample = _fma32(np.arange(n_out, dtype=f32) + f32(0.5), inv, f32(-0.5))
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=f32)[:, None]).astype(f32)
    near = _fma32((_fma32(f32(1.5), x, f32(-2.5)) * x).astype(f32), x, f32(1.0))
    far = _fma32(_fma32(_fma32(f32(-0.5), x, f32(2.5)), x, f32(-4.0)), x, f32(2.0))
    w = np.where(x >= 2, f32(0), np.where(x >= 1, far, near)).astype(f32)
    total = np.zeros((1, n_out), f32)
    for row in w:
        total = (total + row).astype(f32)
    keep = np.abs(total) > 1000.0 * np.finfo(np.float32).eps
    w = np.where(keep, (w / np.where(total != 0, total, f32(1))).astype(f32), f32(0))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0)).astype(f32)


def elastic_fields(lattice: torch.Tensor, shape: Tuple[int, int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dense (dy, dx) field of a (..., 2, g, g) control lattice over the
    plane ``shape`` (H, W): ``jax.image.resize(lattice, (2, H, W),
    "bicubic")``. The rows are contracted first, then the columns, each a
    sum over the lattice taps in order with one rounding a tap, as XLA's CPU
    dot sums it at power-of-two widths (bit-equal there; elsewhere within
    1e-6 of the field's largest value). Runs on ``lattice``'s device.
    Returns two (..., H, W) f32 tensors."""
    h, w = shape
    g_y, g_x = lattice.shape[-2:]
    dev = lattice.device
    wy = torch.from_numpy(resize_weights(g_y, h)).to(dev)  # (g_y, H)
    wx = torch.from_numpy(resize_weights(g_x, w)).to(dev)  # (g_x, W)
    lat = lattice.to(torch.float32)
    rows = torch.zeros(lat.shape[:-2] + (h, g_x), dtype=torch.float32, device=dev)
    for a in range(g_y):
        rows = _fma32(lat[..., a, None, :], wy[a][:, None], rows)
    field = torch.zeros(lat.shape[:-2] + (h, w), dtype=torch.float32, device=dev)
    for b in range(g_x):
        field = _fma32(rows[..., :, b, None], wx[b][None, :], field)
    return field[..., 0, :, :], field[..., 1, :, :]


# ---------------------------------------------------------------------------
# applies
# ---------------------------------------------------------------------------


def apply_flip(arrays: Sequence[torch.Tensor], bits: Sequence[bool], axes: Sequence[int]):
    """Flip every array along each axis whose bit is set."""
    out = []
    for a in arrays:
        for bit, ax in zip(bits, axes):
            if bit:
                a = torch.flip(a, [ax])
        out.append(a)
    return out


def apply_rot90(arrays: Sequence[torch.Tensor], k: int, axes: Tuple[int, int]):
    """Rotate every array by ``k`` quarter turns in the plane ``axes``
    (``jnp.rot90``'s direction)."""
    return [torch.rot90(a, k, list(axes)) if k % 4 else a for a in arrays]


def apply_photometric(image, gain=None, offset=None, noise=None):
    """``image * gain + offset + noise`` (each term where drawn)."""
    out = image
    if gain is not None:
        out = out * gain
    if offset is not None:
        out = out + offset
    if noise is not None:
        out = out + noise
    return out


def _shift_cols(a: torch.Tensor) -> torch.Tensor:
    """``a`` at column min(x+1, W-1) (axis -2 of (..., H, W, C))."""
    return torch.cat([a[..., 1:, :], a[..., -1:, :]], dim=-2)


def _shift_rows(a: torch.Tensor) -> torch.Tensor:
    """``a`` at row min(y+1, H-1) (axis -3 of (..., H, W, C))."""
    return torch.cat([a[..., 1:, :, :], a[..., -1:, :, :]], dim=-3)


def _quad_warp(bilinear: torch.Tensor, nearest: Optional[torch.Tensor], yy, xx):
    """Warp ``bilinear`` (..., H, W, C) and optionally ``nearest`` (..., H, W)
    at the (..., H, W) coordinates ``yy``/``xx`` with ONE gather.

    The four bilinear corners of every pixel are packed into rows of
    4*C' values by edge-clamped shifts, and one gather of those rows
    serves every channel; the nearest-neighbour plane rides along as an
    extra channel and takes the corner that ``round`` (half to even on the
    absolute coordinate) would pick. Coordinates clamp to the plane.
    """
    h, w = bilinear.shape[-3:-1]
    yy = torch.clamp(yy, 0.0, h - 1.0)
    xx = torch.clamp(xx, 0.0, w - 1.0)
    y0 = torch.floor(yy).to(torch.int64)
    x0 = torch.floor(xx).to(torch.int64)
    fy = (yy - y0)[..., None]
    fx = (xx - x0)[..., None]

    stacked = bilinear
    if nearest is not None:
        stacked = torch.cat([stacked, nearest.to(torch.float32)[..., None]], -1)
    s01 = _shift_cols(stacked)
    s10 = _shift_rows(stacked)
    s11 = _shift_rows(s01)
    quad = torch.cat([stacked, s01, s10, s11], -1)
    c = stacked.shape[-1]
    lead = quad.shape[:-3]
    flat = quad.reshape(lead + (h * w, 4 * c))
    idx = (y0 * w + x0).reshape(lead + (h * w, 1)).expand(lead + (h * w, 4 * c))
    g = torch.gather(flat, -2, idx).reshape(lead + (h, w, 4, c))
    c00, c01, c10, c11 = g[..., 0, :], g[..., 1, :], g[..., 2, :], g[..., 3, :]
    top = c00 * (1 - fx) + c01 * fx
    bot = c10 * (1 - fx) + c11 * fx
    out = top * (1 - fy) + bot * fy

    out_nn = None
    if nearest is not None:
        fy2, fx2 = fy[..., 0], fx[..., 0]
        sel_y = torch.where(fy2 == 0.5, (y0 % 2) == 1, fy2 > 0.5)
        sel_x = torch.where(fx2 == 0.5, (x0 % 2) == 1, fx2 > 0.5)
        nn_top = torch.where(sel_x, c01[..., -1], c00[..., -1])
        nn_bot = torch.where(sel_x, c11[..., -1], c10[..., -1])
        out_nn = torch.where(sel_y, nn_bot, nn_top).to(nearest.dtype)
        out = out[..., :-1]
    return out, out_nn


def _warp_coords(dy: torch.Tensor, dx: torch.Tensor):
    h, w = dy.shape[-2:]
    yy = torch.arange(h, dtype=torch.float32, device=dy.device)[:, None] + dy
    xx = torch.arange(w, dtype=torch.float32, device=dx.device)[None, :] + dx
    return yy, xx


def _flat_nearest(arr: torch.Tensor, yy, xx) -> torch.Tensor:
    """Nearest-neighbour resample of ``arr`` (H, W, C) at the rounded
    (half to even, as ``jnp.round``) and clamped coordinates."""
    h, w = arr.shape[:2]
    yi = torch.clamp(torch.round(yy).to(torch.int64), 0, h - 1)
    xi = torch.clamp(torch.round(xx).to(torch.int64), 0, w - 1)
    return arr.reshape(h * w, -1)[(yi * w + xi).reshape(-1)].reshape(h, w, -1)


def elastic_warp(img: torch.Tensor, dy: torch.Tensor, dx: torch.Tensor, order: int = 1) -> torch.Tensor:
    """Warp ``img`` (H, W[, C]) by the displacement field: bilinear
    (``order=1``) or nearest-neighbour (``order=0``)."""
    yy, xx = _warp_coords(dy, dx)
    squeeze = img.ndim == 2
    arr = img[..., None] if squeeze else img
    out = _quad_warp(arr, None, yy, xx)[0] if order else _flat_nearest(arr, yy, xx)
    return out[..., 0] if squeeze else out


def warp_example(image, labels, weights, dy, dx, dims: int = 2):
    """Warp (image, labels, weights) by one field with one gather.

    ``image`` (..., H, W[, C]) for ``dims=2`` or (..., Z, H, W[, C]) for 3,
    labels and weights its spatial shape; ``dy``/``dx`` (..., H, W) with the
    leading axes of the example batch (the same field on every z-plane).
    Labels or weights may be None.
    """
    squeeze = image.ndim == labels.ndim if labels is not None else (
        weights is not None and image.ndim == weights.ndim
    )
    img = image[..., None] if squeeze else image
    spatial = img.shape[:-1]
    w_in = weights if weights is not None else torch.ones(spatial, dtype=torch.float32, device=img.device)
    stacked = torch.cat([img.to(torch.float32), w_in.to(torch.float32)[..., None]], -1)
    yy, xx = _warp_coords(dy, dx)
    if dims == 3:  # the same field on every z-plane
        yy, xx = yy.unsqueeze(-3), xx.unsqueeze(-3)
        yy = yy.expand(spatial)
        xx = xx.expand(spatial)
    warped, out_lab = _quad_warp(stacked, labels, yy, xx)
    out_img = warped[..., :-1]
    if squeeze:
        out_img = out_img[..., 0]
    return out_img, out_lab, (warped[..., -1] if weights is not None else None)


def apply_example(image, labels, weights, draws: AugmentDraws, dims: int = 2):
    """One example's augmentation from its draws: flips, rotation, the
    elastic warp, then the photometric jitter (image only, after the
    geometry). ``image`` (H, W, C) or (Z, H, W, C); labels/weights its
    spatial shape or None. Returns (image, labels, weights)."""
    arrays = [a for a in (image, labels, weights) if a is not None]
    flip_axes = (0, 1) if dims == 2 else (0, 1, 2)
    rot_axes = (0, 1) if dims == 2 else (1, 2)
    arrays = apply_rot90(apply_flip(arrays, draws.flip, flip_axes), draws.rot, rot_axes)
    it = iter(arrays)
    img = next(it)
    lab = next(it) if labels is not None else None
    w = next(it) if weights is not None else None
    out_img, out_lab, out_w = warp_example(img, lab, w, draws.dy, draws.dx, dims)
    out_img = apply_photometric(out_img, draws.gain, draws.offset, draws.noise)
    return out_img, out_lab, out_w


def augment_example(
    generator: Optional[torch.Generator],
    image: torch.Tensor,
    labels: Optional[torch.Tensor] = None,
    weights: Optional[torch.Tensor] = None,
    dims: int = 2,
    **knobs,
):
    """``apply_example`` on fresh draws (``draw_example``'s knobs)."""
    draws = draw_example(generator, tuple(image.shape), dims=dims, device=image.device, **knobs)
    return apply_example(image, labels, weights, draws, dims)


def augment_batch(
    generator: Optional[torch.Generator],
    images: torch.Tensor,
    labels: torch.Tensor,
    weights: torch.Tensor,
    dims: int = 2,
    elastic_alpha: float = 20.0,
    elastic_grid: int = 4,
    p_elastic: float = 0.5,
    gain_jitter: float = 0.0,
    offset_jitter: float = 0.0,
    noise_std: float = 0.0,
):
    """Augment a batch with one set of draws an example from ``generator``
    (``draw_example``'s, in order), applied on the batch's device: the
    fields of the whole batch in one ``elastic_fields``, flips and
    rotations per example, then one warp of the whole batch. Equal to
    ``apply_example`` on each example's ``draw_example``. Returns (images,
    labels, weights)."""
    dev = images.device
    draws = [
        _draw_host(
            generator, tuple(images.shape[1:]), dims, elastic_alpha, elastic_grid, p_elastic,
            gain_jitter, offset_jitter, noise_std,
        )
        for _ in range(images.shape[0])
    ]
    flips, rots, lattices, on, phots = zip(*draws)
    plane = tuple(images.shape[1:3] if dims == 2 else images.shape[2:4])
    dy, dx = elastic_fields(torch.stack(lattices).to(dev), plane)
    keep = torch.tensor(on, device=dev)[:, None, None]
    dy, dx = torch.where(keep, dy, 0.0), torch.where(keep, dx, 0.0)
    flip_axes = (0, 1) if dims == 2 else (0, 1, 2)
    rot_axes = (0, 1) if dims == 2 else (1, 2)
    geo = [
        apply_rot90(apply_flip(ex, f, flip_axes), r, rot_axes)
        for ex, f, r in zip(zip(images, labels, weights), flips, rots)
    ]
    img, lab, w = (torch.stack(t) for t in zip(*geo))
    out_img, out_lab, out_w = warp_example(img, lab, w, dy, dx, dims)
    if any(t is not None for phot in phots for t in phot):
        out_img = torch.stack([
            apply_photometric(x, *(None if t is None else t.to(dev) for t in phot))
            for x, phot in zip(out_img, phots)
        ])
    return out_img, out_lab, out_w
