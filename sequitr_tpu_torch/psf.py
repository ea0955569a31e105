"""Point-spread-function utilities for fluorescence microscopy.

Port of ``sequitr_tpu.psf`` on PyTorch: every device function runs on its
inputs' device (cuFFT, pools, gathers and sorts on the card) and holds no
Python control flow that depends on the data, so nothing waits for the
card until a host-facing function fetches its result (one copy a frame).

* ``gaussian_psf_2d`` / ``gaussian_psf_3d``: Gaussian approximations to
  the widefield PSF (Zhang et al. 2007: sigma from NA and wavelength);
* ``psf_convolve``: circular FFT convolution with a centred PSF over the
  trailing axes (leading axes are a batch: one FFT call serves them all);
* ``richardson_lucy`` / ``richardson_lucy_frame``: deconvolution with a
  fixed iteration count; the PSF's two transfer functions are taken once;
  leading axes are a batch, channels run one at a time;
* ``detect_peaks`` / ``fit_peaks_gaussian`` / ``localize_emitters`` and
  their 3D and astigmatic forms: max-pool NMS, a tie-break on flat
  indices, candidate selection brightest-first, then Gaussian-mask fits of
  every candidate's crop in one batched gather (Thompson et al. 2002).

Where JAX's semantics need care:

* ``lax.top_k`` puts the lower index first among equal values; the port
  takes ``torch.topk`` of unique int64 keys (the value's order bits above
  the complemented flat index), so the order is JAX's on every device;
* ``_suppress_tied_maxima``'s min pool over int32 flat indices is a
  separable ``torch.minimum`` of shifted slices (pools take no integers
  on the card; a float pool is exact only below 2^24 indices);
* the 3D fit's background is ``jnp.median`` of the crop's lateral faces
  (``ops.normalize.percentile_linear`` at 50: an even count averages the
  two middles, ``torch.median`` would take the lower);
* ``dynamic_slice`` clamps each crop's origin into the image, as here;
* ``z_from_widths``' grid is ``jnp.linspace``'s arithmetic in f32
  (``_linspace``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from sequitr_tpu_torch.ops.normalize import fma_f32, percentile_linear
from sequitr_tpu_torch.utils import resolve_device

__all__ = [
    "gaussian_sigma_from_na",
    "gaussian_psf_2d",
    "gaussian_psf_3d",
    "psf_convolve",
    "richardson_lucy",
    "richardson_lucy_frame",
    "detect_peaks",
    "fit_peaks_gaussian",
    "localize_emitters",
    "detect_peaks_3d",
    "fit_peaks_gaussian_3d",
    "localize_emitters_3d",
    "fit_peaks_elliptical",
    "AstigCalibration",
    "calibrate_astigmatism",
    "z_from_widths",
    "localize_emitters_astig",
]


def gaussian_sigma_from_na(wavelength_nm: float, na: float, pixel_size_nm: float) -> float:
    """Lateral Gaussian sigma (pixels) approximating a widefield PSF.

    Zhang, Zerubia & Olivo-Marin (2007): sigma ~ 0.21 * lambda / NA for a
    paraxial widefield PSF, converted to pixel units.
    """
    return 0.21 * wavelength_nm / na / pixel_size_nm


def _gauss_1d(size: int, sigma: float, device) -> torch.Tensor:
    r = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    return torch.exp(-(r * r) / (2.0 * sigma**2))


def gaussian_psf_2d(size: int, sigma: float, device=None) -> torch.Tensor:
    """(size, size) normalized Gaussian kernel on ``device``."""
    g = _gauss_1d(size, sigma, resolve_device(device))
    k = torch.outer(g, g)
    return k / k.sum()


def gaussian_psf_3d(size_xy: int, size_z: int, sigma_xy: float, sigma_z: float, device=None) -> torch.Tensor:
    """(size_z, size_xy, size_xy) normalized anisotropic Gaussian kernel."""
    device = resolve_device(device)
    gz = _gauss_1d(size_z, sigma_z, device)
    k = gz[:, None, None] * gaussian_psf_2d(size_xy, sigma_xy, device)[None]
    return k / k.sum()


def _otf(psf: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    """The PSF zero-padded to ``shape``, rolled so its centre sits at the
    origin, and transformed (``rfftn`` over its axes)."""
    dims = tuple(range(-psf.ndim, 0))
    pad = []
    for s, k in reversed(list(zip(shape, psf.shape))):
        pad += [0, s - k]
    padded = F.pad(psf.to(torch.float32), pad)
    padded = torch.roll(padded, [-(k // 2) for k in psf.shape], dims)
    return torch.fft.rfftn(padded, dim=dims)


def _apply_otf(x: torch.Tensor, otf: torch.Tensor, shape: Tuple[int, ...]) -> torch.Tensor:
    dims = tuple(range(-len(shape), 0))
    return torch.fft.irfftn(torch.fft.rfftn(x, dim=dims) * otf, s=shape, dim=dims)


def psf_convolve(image: torch.Tensor, psf: torch.Tensor) -> torch.Tensor:
    """Circular FFT convolution of ``image`` with a centred ``psf``.

    The PSF's axes are ``image``'s trailing axes (kernel <= spatial); any
    leading axes of ``image`` are a batch, transformed in the same FFT
    calls. The PSF is zero-padded and rolled by ``-(k // 2)`` so its centre
    sits at the origin.
    """
    shape = tuple(image.shape[-psf.ndim:])
    return _apply_otf(image.to(torch.float32), _otf(psf, shape), shape)


def richardson_lucy(image: torch.Tensor, psf: torch.Tensor, iterations: int = 20, eps: float = 1e-6) -> torch.Tensor:
    """Richardson-Lucy deconvolution with a static iteration count.

    ``image`` is (*batch, *spatial) with the PSF's rank in ``spatial``; each
    batch item starts from its own mean. The transfer functions of the PSF
    and of its mirror are taken once; the work runs on a contiguous
    (B, *spatial) view.
    """
    shape = tuple(image.shape[-psf.ndim:])
    dims = tuple(range(-psf.ndim, 0))
    x = torch.clamp(image.to(torch.float32), min=0.0).reshape((-1,) + shape).contiguous()
    otf = _otf(psf, shape)
    otf_mirror = _otf(torch.flip(psf, dims=tuple(range(psf.ndim))), shape)
    mean = x.reshape(x.shape[0], -1).mean(dim=1)
    est = (mean + eps).reshape((-1,) + (1,) * len(shape)).expand_as(x).contiguous()
    for _ in range(iterations):
        conv = _apply_otf(est, otf, shape)
        ratio = x / torch.clamp(conv, min=eps)
        est = est * _apply_otf(ratio, otf_mirror, shape)
    return est.reshape(image.shape)


def richardson_lucy_frame(frame: torch.Tensor, psf: torch.Tensor, iterations: int = 20) -> torch.Tensor:
    """Channel-aware Richardson-Lucy: (H, W) deconvolves directly, (H, W, C)
    deconvolves each channel against the shared PSF.

    The channels run one after another, not as one batch: an inverse FFT
    over a batch of two sums in another order than over one (measured on
    the CPU: 723 of 1,152 values of a 2x24x24 ``irfftn`` differ), and each
    channel must equal the same channel deconvolved alone, as in the JAX
    package (``deconvolve``'s ``deconvolved_c{k}.tif``).
    """
    f32 = frame.to(torch.float32)
    if f32.ndim == psf.ndim + 1:
        return torch.stack([richardson_lucy(f32[..., c], psf, iterations) for c in range(f32.shape[-1])], dim=-1)
    return richardson_lucy(f32, psf, iterations)


# ---------------------------------------------------------------------------
# single-molecule sub-pixel localization
# ---------------------------------------------------------------------------


def _threshold(thr, device) -> Union[float, torch.Tensor]:
    """A threshold as JAX compares it: f32. A Python number stays a kernel
    argument (no copy); a per-item sequence or tensor becomes an f32
    tensor on ``device``."""
    if isinstance(thr, torch.Tensor):
        return thr.to(device=device, dtype=torch.float32)
    if isinstance(thr, (list, tuple, np.ndarray)):
        return torch.as_tensor(np.asarray(thr, np.float32), device=device)
    return float(np.float32(thr))


def _suppress_tied_maxima(is_peak: torch.Tensor, window_dims: Sequence[int]) -> torch.Tensor:
    """Keep one detection per plateau of exactly tied local maxima.

    ``is_peak`` is (*batch, *spatial) with ``window_dims`` over the trailing
    axes; flat indices count within one batch item. Equality NMS keeps
    every member of an exact tie, and any two surviving maxima inside each
    other's (symmetric, odd) windows hold equal values, so keeping the
    minimum flat index per window is purely a tie-break. The min pool
    (fill n, SAME) is separable: ``torch.minimum`` of shifted slices per
    axis, exact int32 at any size.
    """
    nd = len(window_dims)
    spatial = is_peak.shape[-nd:]
    n = int(np.prod(spatial))
    flat_idx = torch.arange(n, dtype=torch.int32, device=is_peak.device).reshape(spatial)
    masked = torch.where(is_peak, flat_idx, torch.full_like(flat_idx, n))
    pooled = masked
    for ax, w in zip(range(-nd, 0), window_dims):
        half = w // 2
        if half == 0:
            continue
        pad = [0, 0] * (-ax - 1) + [half, half]
        padded = F.pad(pooled, pad, value=n)
        size = pooled.shape[ax]
        out = padded.narrow(ax, 0, size)
        for j in range(1, w):
            out = torch.minimum(out, padded.narrow(ax, j, size))
        pooled = out
    return is_peak & (flat_idx == pooled)


def _top_k_stable(score: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last axis: the k largest values, descending,
    the lower index first among equal values.

    Each value becomes a unique int64 key: its f32 bits mapped to an order
    that compares as the floats do (``-0.0`` taken as ``0.0``), above the
    complement of its index; the keys' top k is the order JAX returns, on
    any device and whatever ``torch.topk``'s tie order.
    """
    n = score.shape[-1]
    bits = (score + 0.0).view(torch.int32)  # + 0.0: -0.0 becomes +0.0
    ordered = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    idx = torch.arange(n, dtype=torch.int64, device=score.device)
    keys = ordered * (1 << 32) + ((1 << 32) - 1 - idx)
    _, pos = torch.topk(keys, k, dim=-1, largest=True, sorted=True)
    return torch.gather(score, -1, pos), pos


def _detect(img: torch.Tensor, threshold, max_peaks: int, window_dims: Sequence[int]):
    """Local maxima above ``threshold`` of each batch item of ``img``
    (*batch, *spatial): (flat index, valid) of the ``max_peaks``
    brightest, (*batch, K) each."""
    nd = len(window_dims)
    spatial = img.shape[-nd:]
    batch = img.shape[:-nd]
    x = img.reshape((-1, 1) + tuple(spatial))
    pool = F.max_pool2d if nd == 2 else F.max_pool3d
    pooled = pool(x, tuple(window_dims), stride=1, padding=tuple(w // 2 for w in window_dims))
    pooled = pooled.reshape(img.shape)
    thr = _threshold(threshold, img.device)
    if isinstance(thr, torch.Tensor) and thr.ndim:
        thr = thr.reshape(thr.shape + (1,) * nd)
    is_peak = (img == pooled) & (img > thr)
    is_peak = _suppress_tied_maxima(is_peak, window_dims)
    score = torch.where(is_peak, img, torch.full_like(img, float("-inf"))).reshape(batch + (-1,))
    k = min(max_peaks, score.shape[-1])  # top_k requires k <= size
    vals, idx = _top_k_stable(score, k)
    return idx, torch.isfinite(vals)


def detect_peaks(image: torch.Tensor, threshold, max_peaks: int = 256, min_distance: int = 2):
    """Candidate emitter pixels: local maxima above ``threshold``.

    ``image`` is (H, W), or (B, H, W) with one threshold per frame (a
    sequence or a (B,) tensor). Non-maximum suppression is a max-pool
    compare (SAME, ``-inf`` padding), exact ties collapse to one detection
    (:func:`_suppress_tied_maxima`) and candidates are the ``max_peaks``
    brightest, brightest first (fixed output shape).

    Returns ``(yx, valid)``: (..., max_peaks, 2) int32 pixel coordinates
    and a boolean mask (False rows are padding below threshold).
    """
    img = image.to(torch.float32)
    k = 2 * min_distance + 1
    idx, valid = _detect(img, threshold, max_peaks, (k, k))
    w = img.shape[-1]
    yx = torch.stack([idx // w, idx % w], dim=-1)
    return yx.to(torch.int32), valid


def _crops(img: torch.Tensor, coords: torch.Tensor, window: Sequence[int]):
    """Crops of ``window`` around each candidate: (*batch, K, *window) and
    the origins (*batch, K, nd), each clamped into the image as
    ``dynamic_slice`` clamps it. ``img`` is (*batch, *spatial), ``coords``
    (*batch, K, nd)."""
    nd = len(window)
    spatial = img.shape[-nd:]
    for s, w in zip(spatial, window):
        if w > s:
            raise ValueError(f"fit window {tuple(window)} exceeds the image {tuple(spatial)}")
    # Python bounds: no host-to-device copy (nothing syncs until the fetch)
    origin = torch.stack(
        [torch.clamp(coords[..., i] - w // 2, 0, s - w) for i, (s, w) in enumerate(zip(spatial, window))], dim=-1
    )
    batch = img.shape[:-nd]
    flat = img.reshape(batch + (-1,))
    # flat offset of each crop voxel: origin + the window's own grid
    strides = [int(np.prod(spatial[i + 1:])) for i in range(nd)]
    offs = 0
    for i, w in enumerate(window):
        shape = [1] * nd
        shape[i] = w
        offs = offs + (torch.arange(w, device=img.device) * strides[i]).reshape(shape)
    base = sum(origin[..., i].to(torch.int64) * strides[i] for i in range(nd))
    index = base.reshape(base.shape + (1,) * nd) + offs  # (*batch, K, *window)
    k = coords.shape[-2]
    crop = torch.gather(flat, -1, index.reshape(batch + (k * int(np.prod(window)),)))
    return crop.reshape(batch + (k,) + tuple(window)), origin


def _sum2(x: torch.Tensor) -> torch.Tensor:
    return x.sum(dim=(-2, -1))


def fit_peaks_gaussian(image: torch.Tensor, yx: torch.Tensor, window: int = 7, sigma: float = 1.5, iterations: int = 8):
    """Sub-pixel emitter positions via iterative Gaussian-mask centroids.

    Thompson, Larson & Webb (Biophys J 2002): iterate a Gaussian-weighted,
    background-subtracted centroid inside a ``window`` x ``window`` crop;
    background = mean of the crop border. Every candidate's crop is one
    batched gather and each iteration one set of batched ops. ``image``
    (H, W) with ``yx`` (K, 2), or (B, H, W) with (B, K, 2).

    Returns dict with ``y``/``x`` (float sub-pixel, image coordinates),
    ``amplitude`` (background-subtracted peak mass under the mask) and
    ``background``.
    """
    img = image.to(torch.float32)
    crop, origin = _crops(img, yx, (window, window))
    half = window // 2
    rel = torch.arange(window, dtype=torch.float32, device=img.device)
    border = torch.cat([crop[..., 0, :], crop[..., -1, :], crop[..., 1:-1, 0], crop[..., 1:-1, -1]], dim=-1)
    bg = border.mean(dim=-1)
    signal = torch.clamp(crop - bg[..., None, None], min=0.0)
    yy = rel[:, None]
    xx = rel[None, :]
    two_s2 = 2.0 * sigma**2
    cy = torch.full(bg.shape, float(half), dtype=torch.float32, device=img.device)
    cx = cy.clone()
    for _ in range(iterations):
        dy = yy - cy[..., None, None]
        dx = xx - cx[..., None, None]
        m = torch.exp(-(dy * dy + dx * dx) / two_s2) * signal
        tot = torch.clamp(_sum2(m), min=1e-12)
        cy, cx = _sum2(m * yy) / tot, _sum2(m * xx) / tot
    dy = yy - cy[..., None, None]
    dx = xx - cx[..., None, None]
    wgt = torch.exp(-(dy * dy + dx * dx) / two_s2)
    amp = _sum2(wgt * signal) / torch.clamp(_sum2(wgt * wgt), min=1e-12)
    return {"y": cy + origin[..., 0], "x": cx + origin[..., 1], "amplitude": amp, "background": bg}


def _device_of(image, device) -> torch.device:
    """A tensor's own device unless ``device`` is given; host arrays go to
    ``device`` (default the card)."""
    if device is None and isinstance(image, torch.Tensor):
        return image.device
    return resolve_device(device)


def _as_tensor(image, device: torch.device) -> torch.Tensor:
    if isinstance(image, torch.Tensor):
        return image.to(device)
    return torch.from_numpy(np.ascontiguousarray(image)).to(device)


def pack_valid(valid: torch.Tensor, fits: dict, keys) -> torch.Tensor:
    """The mask and the fields ``keys`` of ``fits`` as one (1 + len(keys),
    K) f32 tensor, so a frame comes back in ONE copy (one sync), as the JAX
    package's one ``np.asarray(valid)``; K rows are few."""
    return torch.stack([valid.to(torch.float32)] + [fits[k].to(torch.float32) for k in keys])


def unpack_valid(packed: np.ndarray, keys) -> dict:
    """Host side of :func:`pack_valid`: the valid rows of each field."""
    m = packed[0] > 0.5
    return {k: packed[1 + i][m] for i, k in enumerate(keys)}


def fetch_valid(valid: torch.Tensor, fits: dict) -> dict:
    """The valid rows of ``fits`` as host numpy arrays, in one copy."""
    keys = list(fits)
    return unpack_valid(pack_valid(valid, fits, keys).cpu().numpy(), keys)


def localize_emitters(
    image,
    threshold: float,
    max_peaks: int = 256,
    min_distance: int = 2,
    window: int = 7,
    sigma: float = 1.5,
    device=None,
):
    """Detect + sub-pixel-fit emitters in one frame; host-facing.

    Returns a dict of numpy arrays (y, x, amplitude, background) holding
    only the valid detections, brightest first. ``image`` is a host frame
    (sent to ``device``, default the card) or a tensor (used where it
    lies). One copy back a frame.
    """
    img = _as_tensor(image, _device_of(image, device))
    _, valid, fits = _detect_and_fit(
        img, threshold, max_peaks=max_peaks, min_distance=min_distance, window=window, sigma=sigma,
    )
    return fetch_valid(valid, fits)


def _detect_and_fit(img, threshold, *, max_peaks, min_distance, window, sigma):
    yx, valid = detect_peaks(img, threshold, max_peaks, min_distance)
    fits = fit_peaks_gaussian(img, yx, window=window, sigma=sigma)
    return yx, valid, fits


# ---------------------------------------------------------------------------
# volumetric (3D) sub-voxel localization
# ---------------------------------------------------------------------------


def detect_peaks_3d(
    volume: torch.Tensor,
    threshold,
    max_peaks: int = 256,
    min_distance: int = 2,
    min_distance_z: int = 1,
):
    """Candidate emitter voxels in a (Z, H, W) volume: one 3D max-pool
    compare over a ``(2*min_distance_z+1, 2*min_distance+1,
    2*min_distance+1)`` window, the tie-break, the ``max_peaks``
    brightest.

    Returns ``(zyx, valid)``: (max_peaks, 3) int32 voxel coordinates and a
    boolean mask (False rows are padding below threshold).
    """
    vol = volume.to(torch.float32)
    kz = 2 * min_distance_z + 1
    k = 2 * min_distance + 1
    idx, valid = _detect(vol, threshold, max_peaks, (kz, k, k))
    _, h, w = vol.shape[-3:]
    rem = idx % (h * w)
    zyx = torch.stack([idx // (h * w), rem // w, rem % w], dim=-1)
    return zyx.to(torch.int32), valid


def fit_peaks_gaussian_3d(
    volume: torch.Tensor,
    zyx: torch.Tensor,
    window: int = 7,
    window_z: int = 5,
    sigma: float = 1.5,
    sigma_z: float = 1.5,
    iterations: int = 8,
):
    """Sub-voxel emitter positions via 3D Gaussian-mask centroids.

    The volumetric :func:`fit_peaks_gaussian`: an anisotropic-Gaussian
    weighted, background-subtracted centroid inside a ``window_z x window
    x window`` crop. Background = MEDIAN over the crop's four lateral
    faces (``jnp.median``'s linear method: ``percentile_linear`` at 50).

    Returns dict with ``z``/``y``/``x`` (float sub-voxel, volume
    coordinates), ``amplitude`` and ``background``.
    """
    vol = volume.to(torch.float32)
    crop, origin = _crops(vol, zyx, (window_z, window, window))
    hz, hxy = window_z // 2, window // 2
    kk = crop.shape[:-3]
    lateral = torch.cat(
        [
            crop[..., :, 0, :].reshape(kk + (-1,)),
            crop[..., :, -1, :].reshape(kk + (-1,)),
            crop[..., :, 1:-1, 0].reshape(kk + (-1,)),
            crop[..., :, 1:-1, -1].reshape(kk + (-1,)),
        ],
        dim=-1,
    )
    bg = percentile_linear(lateral, (50.0,), dim=-1)[0]
    signal = torch.clamp(crop - bg[..., None, None, None], min=0.0)
    dev = vol.device
    zz = torch.arange(window_z, dtype=torch.float32, device=dev)[:, None, None]
    yy = torch.arange(window, dtype=torch.float32, device=dev)[None, :, None]
    xx = torch.arange(window, dtype=torch.float32, device=dev)[None, None, :]
    two_sz2, two_s2 = 2.0 * sigma_z**2, 2.0 * sigma**2

    def weight(cz, cy, cx):
        dz = zz - cz[..., None, None, None]
        dy = yy - cy[..., None, None, None]
        dx = xx - cx[..., None, None, None]
        return torch.exp(-(dz * dz) / two_sz2 - (dy * dy + dx * dx) / two_s2)

    def sum3(x):
        return x.sum(dim=(-3, -2, -1))

    cz = torch.full(bg.shape, float(hz), dtype=torch.float32, device=dev)
    cy = torch.full(bg.shape, float(hxy), dtype=torch.float32, device=dev)
    cx = cy.clone()
    for _ in range(iterations):
        m = weight(cz, cy, cx) * signal
        tot = torch.clamp(sum3(m), min=1e-12)
        cz, cy, cx = sum3(m * zz) / tot, sum3(m * yy) / tot, sum3(m * xx) / tot
    wgt = weight(cz, cy, cx)
    amp = sum3(wgt * signal) / torch.clamp(sum3(wgt * wgt), min=1e-12)
    return {
        "z": cz + origin[..., 0], "y": cy + origin[..., 1], "x": cx + origin[..., 2],
        "amplitude": amp, "background": bg,
    }


def localize_emitters_3d(
    volume,
    threshold: float,
    max_peaks: int = 256,
    min_distance: int = 2,
    min_distance_z: int = 1,
    window: int = 7,
    window_z: int = 5,
    sigma: float = 1.5,
    sigma_z: float = 1.5,
    device=None,
):
    """Detect + sub-voxel-fit emitters in a (Z, H, W) volume; host-facing.

    Returns a dict of numpy arrays (z, y, x, amplitude, background) of the
    valid detections, brightest first; one copy back a volume.
    """
    vol = _as_tensor(volume, _device_of(volume, device))
    _, valid, fits = _detect_and_fit_3d(
        vol, threshold, max_peaks=max_peaks, min_distance=min_distance,
        min_distance_z=min_distance_z, window=window, window_z=window_z,
        sigma=sigma, sigma_z=sigma_z,
    )
    return fetch_valid(valid, fits)


def _detect_and_fit_3d(vol, threshold, *, max_peaks, min_distance, min_distance_z, window, window_z, sigma, sigma_z):
    zyx, valid = detect_peaks_3d(vol, threshold, max_peaks, min_distance, min_distance_z)
    fits = fit_peaks_gaussian_3d(vol, zyx, window=window, window_z=window_z, sigma=sigma, sigma_z=sigma_z)
    return zyx, valid, fits


# ---------------------------------------------------------------------------
# astigmatic 3D localization from 2D frames (cylindrical-lens z encoding)
# ---------------------------------------------------------------------------


def fit_peaks_elliptical(
    image: torch.Tensor,
    yx: torch.Tensor,
    window: int = 15,
    iterations: int = 12,
    min_sigma: float = 0.5,
    max_sigma: float = 6.0,
):
    """Sub-pixel positions AND per-axis Gaussian widths (elliptical fit).

    Adaptive Gaussian-mask moments: each iteration re-centres the mask on
    the weighted centroid and re-sizes it from the masked second moments
    (masked variance v = s²w²/(s²+w²), so s² = v·w²/(w² − v)). ``image``
    (H, W) with ``yx`` (K, 2), or (B, H, W) with (B, K, 2).

    Returns dict with ``y``/``x``, ``sigma_y``/``sigma_x`` (pixels),
    ``amplitude`` and ``background``.
    """
    img = image.to(torch.float32)
    crop, origin = _crops(img, yx, (window, window))
    half = window // 2
    rel = torch.arange(window, dtype=torch.float32, device=img.device)
    lo2, hi2 = min_sigma**2, max_sigma**2
    border = torch.cat([crop[..., 0, :], crop[..., -1, :], crop[..., 1:-1, 0], crop[..., 1:-1, -1]], dim=-1)
    bg = border.mean(dim=-1)
    signal = torch.clamp(crop - bg[..., None, None], min=0.0)
    yy = rel[:, None]
    xx = rel[None, :]

    def weight(cy, cx, wy2, wx2):
        dy = yy - cy[..., None, None]
        dx = xx - cx[..., None, None]
        return torch.exp(-(dy * dy) / (2.0 * wy2[..., None, None]) - (dx * dx) / (2.0 * wx2[..., None, None]))

    cy = torch.full(bg.shape, float(half), dtype=torch.float32, device=img.device)
    cx = cy.clone()
    wy2 = torch.full(bg.shape, 1.5**2, dtype=torch.float32, device=img.device)
    wx2 = wy2.clone()
    for _ in range(iterations):
        m = weight(cy, cx, wy2, wx2) * signal
        tot = torch.clamp(_sum2(m), min=1e-12)
        cy = _sum2(m * yy) / tot
        cx = _sum2(m * xx) / tot
        dy = yy - cy[..., None, None]
        dx = xx - cx[..., None, None]
        vy = _sum2(m * (dy * dy)) / tot
        vx = _sum2(m * (dx * dx)) / tot
        # masked variance v = s²w²/(s²+w²)  =>  s² = v·w²/(w²−v)
        sy2 = vy * wy2 / torch.clamp(wy2 - vy, min=1e-6)
        sx2 = vx * wx2 / torch.clamp(wx2 - vx, min=1e-6)
        wy2 = torch.clamp(sy2, lo2, hi2)
        wx2 = torch.clamp(sx2, lo2, hi2)
    wgt = weight(cy, cx, wy2, wx2)
    amp = _sum2(wgt * signal) / torch.clamp(_sum2(wgt * wgt), min=1e-12)
    return {
        "y": cy + origin[..., 0], "x": cx + origin[..., 1],
        "sigma_y": torch.sqrt(wy2), "sigma_x": torch.sqrt(wx2),
        "amplitude": amp, "background": bg,
    }


def _quadratic_width(coef, z):
    a, b, e = coef
    return torch.sqrt(torch.clamp(a * z**2 + b * z + e, min=1e-6))


@dataclasses.dataclass(frozen=True)
class AstigCalibration:
    """Astigmatic defocus calibration: per-axis width-vs-z curves.

    sigma²(z) = a·z² + b·z + e per axis (``qx``/``qy`` hold (a, b, e) for
    the x/y widths; exact for the cylindrical-lens defocus model),
    ``z_range`` bounds the invertible region, ``window`` is the crop size
    the widths were measured with (localization defaults to it, so the
    width estimator's truncation bias cancels). The JSON file is the JAX
    package's (``to_json`` / ``from_json`` read and write the same keys).
    """

    qx: Tuple[float, float, float]
    qy: Tuple[float, float, float]
    z_range: Tuple[float, float]
    window: int = 15

    def sigma_x(self, z: torch.Tensor) -> torch.Tensor:
        return _quadratic_width(self.qx, z)

    def sigma_y(self, z: torch.Tensor) -> torch.Tensor:
        return _quadratic_width(self.qy, z)

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(
                {"qx": list(self.qx), "qy": list(self.qy), "z_range": list(self.z_range), "window": self.window},
                f,
                indent=2,
            )

    @staticmethod
    def from_dict(d: dict) -> "AstigCalibration":
        for key in ("qx", "qy", "z_range"):
            if key not in d:
                raise ValueError(f"calibration missing {key!r}")
        if len(d["qx"]) != 3 or len(d["qy"]) != 3 or len(d["z_range"]) != 2:
            raise ValueError("malformed astigmatism calibration")
        return AstigCalibration(
            qx=tuple(float(v) for v in d["qx"]),
            qy=tuple(float(v) for v in d["qy"]),
            z_range=tuple(float(v) for v in d["z_range"]),
            window=int(d.get("window", 15)),
        )

    @staticmethod
    def from_json(path: str) -> "AstigCalibration":
        with open(path) as f:
            d = json.load(f)
        if not isinstance(d, dict):
            raise ValueError("malformed astigmatism calibration")
        return AstigCalibration.from_dict(d)


def calibrate_astigmatism(
    bead_stack,
    z_positions,
    window: int = 15,
    min_distance: int = 3,
    iterations: int = 12,
    diagnostics: bool = False,
    device=None,
):
    """Fit astigmatic defocus curves from a bead z-scan.

    ``bead_stack`` is (Z, H, W): one frame per stage position
    ``z_positions[i]`` of an isolated bead. Every plane's brightest local
    maximum (above the plane's median) is fit with
    :func:`fit_peaks_elliptical`, all planes in one batched pass on
    ``device``; sigma²(z) is then fit per axis by host least squares.

    Returns the :class:`AstigCalibration`; with ``diagnostics=True``
    returns ``(calib, diag)`` where ``diag`` carries the per-plane
    measured widths (``sigma_x``/``sigma_y``) and ``z``, numpy.
    """
    stack = np.asarray(bead_stack, dtype=np.float32)
    zs = np.asarray(z_positions, dtype=np.float64)
    if stack.ndim != 3:
        raise ValueError(f"bead_stack must be (Z, H, W), got {stack.shape}")
    if len(zs) != stack.shape[0]:
        raise ValueError(f"{len(zs)} z positions for {stack.shape[0]} planes")
    if len(zs) < 5:
        raise ValueError("need >= 5 calibration planes for a stable fit")

    meds = np.median(stack, axis=(1, 2)).astype(np.float32)
    dev = resolve_device(device)
    valid, fits = _calibration_fits(
        torch.from_numpy(stack).to(dev), meds, min_distance=min_distance, window=window, iterations=iterations,
    )
    # every plane's mask and widths in one copy
    found, sy, sx = torch.stack([valid[:, 0].to(torch.float32), fits["sigma_y"][:, 0], fits["sigma_x"][:, 0]]).cpu().numpy()
    bad = np.flatnonzero(found < 0.5)
    if bad.size:
        raise ValueError(f"no bead found in calibration plane {bad[0]}")
    sy = sy.astype(np.float64)
    sx = sx.astype(np.float64)

    A = np.stack([zs**2, zs, np.ones_like(zs)], axis=-1)
    qx, *_ = np.linalg.lstsq(A, sx**2, rcond=None)
    qy, *_ = np.linalg.lstsq(A, sy**2, rcond=None)
    calib = AstigCalibration(
        qx=tuple(float(v) for v in qx),
        qy=tuple(float(v) for v in qy),
        z_range=(float(zs.min()), float(zs.max())),
        window=int(window),
    )
    if diagnostics:
        return calib, {"sigma_x": sx, "sigma_y": sy, "z": zs}
    return calib


def _calibration_fits(stack: torch.Tensor, thresholds, *, min_distance, window, iterations):
    """Brightest-peak detection + elliptical width fit for every
    calibration plane in one batched pass (per-plane thresholds)."""
    yx, valid = detect_peaks(stack, thresholds, max_peaks=1, min_distance=min_distance)
    return valid, fit_peaks_elliptical(stack, yx, window=window, iterations=iterations)


def _linspace(start: float, stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace(start, stop, num)`` in f32 (``start``/``stop`` f32
    values), as XLA's CPU backend runs it: the division by ``num - 1``
    becomes a product with its f32 reciprocal r, ``stop * step`` is
    reassociated to ``iota * (stop * r)``, and that product is fused into
    the sum ``start * (1 - iota * r) + iota * (stop * r)``; ``stop`` is
    appended."""
    div = num - 1
    r = np.float32(1.0) / np.float32(div)
    it = torch.arange(div, dtype=torch.float32, device=device)
    first = start * (1.0 - it * float(r))
    out = fma_f32(it, float(np.float32(stop) * r), first)
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32, device=device)])


def z_from_widths(sigma_x, sigma_y, calib: AstigCalibration, n_grid: int = 241, device=None) -> torch.Tensor:
    """Axial position from measured per-axis widths.

    Huang et al. (Science 2008) inversion: minimize the sqrt-width
    distance D(z) = (√sx−√sx_cal(z))² + (√sy−√sy_cal(z))² over a static z
    grid spanning the calibrated range (the first minimum), refined with
    one parabolic step. The calibration's numbers enter as f32, as in the
    JAX package's jitted localizer. Returns z in calibration units.
    """
    dev = sigma_x.device if isinstance(sigma_x, torch.Tensor) and device is None else resolve_device(device)
    sx = torch.as_tensor(sigma_x, dtype=torch.float32).to(dev)
    sy = torch.as_tensor(sigma_y, dtype=torch.float32).to(dev)
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    zmin, zmax = (f32(v) for v in calib.z_range)
    zg = _linspace(zmin, zmax, n_grid, dev)
    dz = float(np.float32(np.float32(zmax) - np.float32(zmin)) / np.float32(n_grid - 1))
    cx = torch.sqrt(_quadratic_width(tuple(f32(v) for v in calib.qx), zg))
    cy = torch.sqrt(_quadratic_width(tuple(f32(v) for v in calib.qy), zg))
    mx = torch.sqrt(sx)[:, None]
    my = torch.sqrt(sy)[:, None]
    d = (mx - cx[None]) ** 2 + (my - cy[None]) ** 2  # (n, n_grid)
    i = torch.clamp(torch.argmin(d, dim=1), 1, n_grid - 2)
    three = torch.gather(d, 1, i[:, None] + torch.arange(-1, 2, device=dev)[None])
    d0, d1, d2 = three.unbind(1)
    denom = d0 - 2.0 * d1 + d2
    off = torch.where(denom.abs() > 1e-18, 0.5 * (d0 - d2) / denom, torch.zeros_like(denom))
    off = torch.clamp(off, -1.0, 1.0)
    return zg[i] + off * dz


def localize_emitters_astig(
    image,
    threshold: float,
    calib: AstigCalibration,
    max_peaks: int = 256,
    min_distance: int = 2,
    window: Optional[int] = None,
    n_grid: int = 241,
    device=None,
):
    """3D localization from a single 2D astigmatic frame; host-facing.

    Detection + elliptical width fit + calibration-curve z inversion.
    ``window`` defaults to the calibration's own window so the width
    estimator's truncation bias cancels. Returns numpy arrays (z, y, x,
    sigma_y, sigma_x, amplitude, background) of the valid detections,
    brightest first; z in calibration units, y/x in pixels. One copy back
    a frame.
    """
    if window is None:
        window = calib.window
    img = _as_tensor(image, _device_of(image, device))
    _, valid, fits = _detect_and_fit_astig(
        img, threshold, calib, max_peaks=max_peaks, min_distance=min_distance, window=window, n_grid=n_grid,
    )
    return fetch_valid(valid, fits)


def _detect_and_fit_astig(img, threshold, calib, *, max_peaks, min_distance, window, n_grid):
    yx, valid = detect_peaks(img, threshold, max_peaks, min_distance)
    fits = fit_peaks_elliptical(img, yx, window=window)
    fits["z"] = z_from_widths(fits["sigma_x"], fits["sigma_y"], calib, n_grid=n_grid)
    return yx, valid, fits
