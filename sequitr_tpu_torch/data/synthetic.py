"""Deterministic synthetic microscopy scenes.

The reference validated against real fluorescence data that cannot ship in
this repo; the rebuild needs *reproducible* scenes for three jobs:

* training the committed fixture checkpoints (``tools/make_fixtures.py``),
* the per-config fidelity measurements in the fidelity checks (mIoU / PSNR of the
  production device path vs the CPU-f32 exact reference on identical weights),
* end-to-end tests that want non-degenerate masks.

Scenes model the classic sequitr 3-class task (SURVEY.md §2 UNet2D row:
background / interphase / mitotic): a noisy gamma-distributed background,
round dim "interphase" cells (class 1) and brighter, elongated "mitotic"
cells (class 2), with intensities in the uint16-ish range real stacks use,
so the percentile-normalize path sees realistic dynamics. Everything is a
pure function of the seed (numpy ``default_rng``) — the same seed yields
byte-identical scenes on every platform, which is what lets the fidelity checks
compare device and CPU paths on the *same* pixels.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["cells_frame", "cells_stack", "cells_volume", "denoise_pair", "emitter_frame", "emitter_volume", "astig_emitter_frame", "astig_widths", "bandlimited_scene"]


def bandlimited_scene(
    shape: Tuple[int, ...],
    rng: np.random.Generator,
    sigma: float = 0.08,
    amp: float = 50.0,
    offset: float = 120.0,
) -> np.ndarray:
    """Band-limited PERIODIC scene: gaussian low-pass of white noise.

    The registration/mosaic fixture: periodicity + band limitation make
    `registration.apply_shift`'s Fourier resample EXACT, so sub-pixel
    estimators can be tested against analytic ground truth instead of
    another interpolator's error. Consumes exactly one ``rng.normal``
    field (callers interleaving more draws stay reproducible). N-D.
    """
    f = np.fft.fftn(rng.normal(0, 1, shape))
    grids = np.meshgrid(
        *[np.fft.fftfreq(n) for n in shape], indexing="ij"
    )
    r2 = sum(g**2 for g in grids)
    img = np.fft.ifftn(f * np.exp(-r2 / (2 * sigma**2))).real
    return (img * amp + offset).astype(np.float32)


def _add_cell(img, lab, rng, cls: int) -> None:
    """Stamp one cell into (img, lab) in place, in a local window."""
    h, w = lab.shape
    cy = float(rng.uniform(8, h - 8))
    cx = float(rng.uniform(8, w - 8))
    if cls == 1:  # interphase: round, dim
        r_a = r_b = float(rng.uniform(5.0, 11.0))
        amp = float(rng.uniform(350.0, 700.0))
    else:  # mitotic: elongated, bright (condensed chromatin)
        r_a = float(rng.uniform(7.0, 12.0))
        r_b = r_a * float(rng.uniform(0.35, 0.55))
        amp = float(rng.uniform(900.0, 1600.0))
    theta = float(rng.uniform(0.0, np.pi))
    ct, st = np.cos(theta), np.sin(theta)

    # local window: 3 sigma of the larger axis
    ext = int(np.ceil(3.0 * max(r_a, r_b)))
    y0, y1 = max(0, int(cy) - ext), min(h, int(cy) + ext + 1)
    x0, x1 = max(0, int(cx) - ext), min(w, int(cx) + ext + 1)
    yy, xx = np.mgrid[y0:y1, x0:x1]
    dy, dx = yy - cy, xx - cx
    u = ct * dx + st * dy
    v = -st * dx + ct * dy
    q = (u / r_a) ** 2 + (v / r_b) ** 2
    profile = amp * np.exp(-0.5 * q * 4.0)  # steep falloff: crisp boundary
    img[y0:y1, x0:x1] += profile.astype(np.float32)
    # label where the profile dominates the background (~35% of peak)
    lab[y0:y1, x0:x1] = np.where(q < 0.525, cls, lab[y0:y1, x0:x1])


def cells_frame(
    seed: int, shape: Tuple[int, int] = (256, 256), density: float = 1 / 4096.0
) -> Tuple[np.ndarray, np.ndarray]:
    """One synthetic fluorescence frame.

    Returns ``(image float32, labels int32)`` with labels in {0, 1, 2}:
    background / interphase / mitotic. ``density`` is cells per pixel
    (default: one cell per 64x64 area).
    """
    rng = np.random.default_rng(seed)
    h, w = shape
    img = rng.gamma(2.0, 60.0, shape).astype(np.float32)  # autofluorescence
    lab = np.zeros(shape, np.int32)
    n = max(3, int(h * w * density))
    for _ in range(n):
        cls = 1 if rng.random() < 0.7 else 2
        _add_cell(img, lab, rng, cls)
    # shot-noise-like perturbation on top of the rendered scene
    img += rng.normal(0.0, 1.0, shape).astype(np.float32) * np.sqrt(
        np.maximum(img, 0.0)
    ) * 0.5
    return np.maximum(img, 0.0), lab


def instances_frame(
    seed: int,
    shape: Tuple[int, int] = (256, 256),
    density: float = 1 / 2048.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """One synthetic frame with INSTANCE labels (flow-segmentation task).

    Returns ``(image float32, instances int32)`` — each cell a distinct
    positive id. Cells are round Gaussian-profile blobs; center sampling
    allows TOUCHING pairs (accepts any center whose distance to every
    placed cell exceeds ~0.85x the radius sum, so boundaries overlap)
    but rejects heavy overlap. Touching same-intensity cells are exactly
    the case per-pixel class maps + CCL cannot separate — the scene the
    flows family exists for. Background/noise statistics match
    ``cells_frame`` (gamma autofluorescence + shot noise) so percentile
    normalization is exercised identically.
    """
    rng = np.random.default_rng(seed)
    h, w = shape
    img = rng.gamma(2.0, 60.0, shape).astype(np.float32)
    lab = np.zeros(shape, np.int32)
    n = max(3, int(h * w * density))
    placed = []  # (cy, cx, r)
    next_id = 1
    for _ in range(n):
        for _try in range(40):
            r = float(rng.uniform(6.0, 12.0))
            cy = float(rng.uniform(r, h - r))
            cx = float(rng.uniform(r, w - r))
            if all(
                (cy - py) ** 2 + (cx - px) ** 2 >= (0.85 * (r + pr)) ** 2
                for py, px, pr in placed
            ):
                break
        else:
            continue
        placed.append((cy, cx, r))
        amp = float(rng.uniform(400.0, 800.0))
        ext = int(np.ceil(1.5 * r))
        y0, y1 = max(0, int(cy) - ext), min(h, int(cy) + ext + 1)
        x0, x1 = max(0, int(cx) - ext), min(w, int(cx) + ext + 1)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        q = ((yy - cy) ** 2 + (xx - cx) ** 2) / r**2
        img[y0:y1, x0:x1] += (amp * np.exp(-0.5 * q * 4.0)).astype(
            np.float32
        )
        win = lab[y0:y1, x0:x1]
        lab[y0:y1, x0:x1] = np.where((q < 1.0) & (win == 0), next_id, win)
        next_id += 1
    img += rng.normal(0.0, 1.0, shape).astype(np.float32) * np.sqrt(
        np.maximum(img, 0.0)
    ) * 0.5
    return np.maximum(img, 0.0), lab


def denoise_pair(
    seed: int, shape: Tuple[int, int] = (256, 256), sigma: float = 0.1
) -> Tuple[np.ndarray, np.ndarray]:
    """(clean, noisy) pair for the Noise2Void task, in [0, 1]-ish scale.

    ``clean`` is the NOISELESS cell render (flat background + smooth cell
    profiles, normalized by a fixed scale so seeds share one intensity
    space); ``noisy`` adds iid zero-mean Gaussian noise — exactly the
    pixelwise-independent noise model N2V's blind-spot loss assumes.
    Unlike ``cells_frame`` there is no gamma autofluorescence or shot
    noise in ``clean``: the pair needs a truth the denoiser can be scored
    against, and both paths (training records, serving fidelity) feed the
    net the noisy member only.
    """
    rng = np.random.default_rng(seed)
    h, w = shape
    img = np.full(shape, 120.0, np.float32)  # flat background pedestal
    lab = np.zeros(shape, np.int32)
    n = max(3, int(h * w / 4096.0))
    for _ in range(n):
        cls = 1 if rng.random() < 0.7 else 2
        _add_cell(img, lab, rng, cls)
    clean = (img / 1800.0).astype(np.float32)  # fixed scale: peaks < ~1
    noisy = clean + rng.normal(0.0, sigma, shape).astype(np.float32)
    return clean, noisy


def cells_stack(
    seed: int, n: int, shape: Tuple[int, int] = (256, 256)
) -> Tuple[np.ndarray, np.ndarray]:
    """``n`` independent frames: (n, H, W) images + labels."""
    imgs = np.empty((n,) + tuple(shape), np.float32)
    labs = np.empty((n,) + tuple(shape), np.int32)
    for i in range(n):
        imgs[i], labs[i] = cells_frame(seed * 10_000 + i, shape)
    return imgs, labs


def cells_volume(
    seed: int, shape: Tuple[int, int, int] = (16, 128, 128)
) -> Tuple[np.ndarray, np.ndarray]:
    """A z-stack with z-extended cells (the UNet3D task).

    Cells live on a central plane and decay over ±2 neighbouring planes
    (defocus blur); labels extend one plane either side — enough z
    structure that a 3D net beats plane-wise 2D.
    """
    rng = np.random.default_rng(seed)
    nz, h, w = shape
    vol = rng.gamma(2.0, 60.0, shape).astype(np.float32)
    lab = np.zeros(shape, np.int32)
    n = max(3, int(h * w / 4096))
    for _ in range(n):
        cz = int(rng.integers(2, nz - 2))
        img2, lab2 = np.zeros((h, w), np.float32), np.zeros((h, w), np.int32)
        cls = 1 if rng.random() < 0.7 else 2
        _add_cell(img2, lab2, rng, cls)
        for dz, gain in ((-2, 0.2), (-1, 0.55), (0, 1.0), (1, 0.55), (2, 0.2)):
            z = cz + dz
            if 0 <= z < nz:
                vol[z] += img2 * gain
        for dz in (-1, 0, 1):
            z = cz + dz
            if 0 <= z < nz:
                lab[z] = np.where(lab2 > 0, lab2, lab[z])
    return vol, lab


def emitter_frame(
    seed: int,
    shape: Tuple[int, int] = (256, 256),
    n: int = 40,
    sigma: float = 1.5,
    amp: float = 400.0,
    background: float = 20.0,
    min_sep: float = 8.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sparse sub-pixel point emitters (the single-molecule task).

    Returns ``(image float32, positions (n, 2) float64)`` with positions in
    (y, x) pixel coordinates. Emitters are rejected-sampled to keep
    ``min_sep`` pixels apart so detection/fitting is unambiguous and the
    centroid-RMSE fidelity metric measures the fitter, not collisions.
    """
    rng = np.random.default_rng(seed)
    h, w = shape
    pos = []
    for _ in range(10_000):
        if len(pos) == n:
            break
        p = rng.uniform([6.0, 6.0], [h - 6.0, w - 6.0])
        if all((p[0] - q[0]) ** 2 + (p[1] - q[1]) ** 2 >= min_sep**2 for q in pos):
            pos.append(p)
    pos_arr = np.asarray(pos, np.float64)
    img = np.full(shape, background, np.float32)
    ext = int(np.ceil(4 * sigma))
    for cy, cx in pos_arr:
        y0, y1 = max(0, int(cy) - ext), min(h, int(cy) + ext + 1)
        x0, x1 = max(0, int(cx) - ext), min(w, int(cx) + ext + 1)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        img[y0:y1, x0:x1] += amp * np.exp(
            -((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma**2)
        ).astype(np.float32)
    img += rng.normal(0.0, 3.0, shape).astype(np.float32)
    return np.maximum(img, 0.0), pos_arr


def emitter_volume(
    seed: int,
    shape: Tuple[int, int, int] = (16, 128, 128),
    n: int = 20,
    sigma: float = 1.4,
    sigma_z: float = 1.6,
    amp: float = 400.0,
    background: float = 20.0,
    min_sep: float = 8.0,
    min_sep_z: float = 4.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sparse sub-voxel point emitters in a (Z, H, W) volume.

    The volumetric counterpart of :func:`emitter_frame`: returns
    ``(volume float32, positions (n, 3) float64)`` with positions in
    (z, y, x) voxel coordinates. Rejection sampling keeps emitters
    ``min_sep`` voxels apart laterally OR ``min_sep_z`` axially (an
    anisotropic exclusion ellipsoid), so the 3D centroid-RMSE fidelity
    metric measures the fitter, not collisions.
    """
    rng = np.random.default_rng(seed)
    d, h, w = shape
    pos = []
    for _ in range(10_000):
        if len(pos) == n:
            break
        p = rng.uniform(
            [3.0, 6.0, 6.0], [d - 3.0, h - 6.0, w - 6.0]
        )
        if all(
            ((p[0] - q[0]) / min_sep_z) ** 2
            + ((p[1] - q[1]) ** 2 + (p[2] - q[2]) ** 2) / min_sep**2
            >= 1.0
            for q in pos
        ):
            pos.append(p)
    pos_arr = np.asarray(pos, np.float64)
    vol = np.full(shape, background, np.float32)
    ext = int(np.ceil(4 * sigma))
    ext_z = int(np.ceil(3 * sigma_z))
    for cz, cy, cx in pos_arr:
        z0, z1 = max(0, int(cz) - ext_z), min(d, int(cz) + ext_z + 1)
        y0, y1 = max(0, int(cy) - ext), min(h, int(cy) + ext + 1)
        x0, x1 = max(0, int(cx) - ext), min(w, int(cx) + ext + 1)
        zz, yy, xx = np.mgrid[z0:z1, y0:y1, x0:x1]
        vol[z0:z1, y0:y1, x0:x1] += amp * np.exp(
            -((zz - cz) ** 2) / (2 * sigma_z**2)
            - ((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma**2)
        ).astype(np.float32)
    vol += rng.normal(0.0, 3.0, shape).astype(np.float32)
    return np.maximum(vol, 0.0), pos_arr


# analytic cylindrical-lens defocus curves used by the astigmatic
# synthetic scenes: sigma(z) = 1.3*sqrt(1 + ((z -/+ 300)/400)^2), foci
# split +/-300 units. sigma^2 is exactly quadratic in z, so the matching
# AstigCalibration coefficients below are closed-form (see psf.py).
ASTIG_QX = (1.05625e-05, -0.0063375, 2.640625)
ASTIG_QY = (1.05625e-05, 0.0063375, 2.640625)
ASTIG_Z_RANGE = (-600.0, 600.0)


def astig_widths(z: float) -> Tuple[float, float]:
    """(sigma_y, sigma_x) of the analytic defocus model at z."""
    sx = 1.3 * np.sqrt(1.0 + ((z - 300.0) / 400.0) ** 2)
    sy = 1.3 * np.sqrt(1.0 + ((z + 300.0) / 400.0) ** 2)
    return sy, sx


def astig_emitter_frame(
    seed: int,
    shape: Tuple[int, int] = (256, 256),
    n: int = 40,
    photons: float = 3000.0,
    background: float = 20.0,
    min_sep: float = 12.0,
    z_span: float = 450.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sparse astigmatic emitters: widths encode known z.

    Returns ``(image float32, positions (n, 3) float64)`` with positions
    in (z, y, x) — z in calibration units over ``[-z_span, z_span]``,
    y/x in pixels. Amplitude scales as 1/(2*pi*sx*sy) (constant photon
    count), so defocused emitters are genuinely dimmer, like real SMLM
    frames. ``min_sep`` is generous because defocused spots are wide.
    """
    rng = np.random.default_rng(seed)
    h, w = shape
    pos = []
    for _ in range(10_000):
        if len(pos) == n:
            break
        p = np.asarray([
            rng.uniform(-z_span, z_span),
            rng.uniform(10.0, h - 10.0),
            rng.uniform(10.0, w - 10.0),
        ])
        if all(
            (p[1] - q[1]) ** 2 + (p[2] - q[2]) ** 2 >= min_sep**2
            for q in pos
        ):
            pos.append(p)
    pos_arr = np.asarray(pos, np.float64)
    img = np.full(shape, background, np.float32)
    for cz, cy, cx in pos_arr:
        sy, sx = astig_widths(cz)
        ext = int(np.ceil(4 * max(sy, sx)))
        y0, y1 = max(0, int(cy) - ext), min(h, int(cy) + ext + 1)
        x0, x1 = max(0, int(cx) - ext), min(w, int(cx) + ext + 1)
        yy, xx = np.mgrid[y0:y1, x0:x1]
        img[y0:y1, x0:x1] += (
            photons / (2 * np.pi * sx * sy) * np.exp(
                -((yy - cy) ** 2) / (2 * sy**2)
                - ((xx - cx) ** 2) / (2 * sx**2)
            )
        ).astype(np.float32)
    img += rng.normal(0.0, 0.3, shape).astype(np.float32)
    return np.maximum(img, 0.0), pos_arr
