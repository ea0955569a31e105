"""The port's emitter detection and fits (2D, 3D, elliptical), the
astigmatic calibration and z inversion, against ``sequitr_tpu.psf`` on
the same numpy inputs; mirrors ``tests/test_misc.py::TestEmitterLocalization``
and ``tests/test_psf3d.py``, and holds the ``localize3d_step`` golden.

Detections (pixel coordinates and the valid mask) are ``assert_array_equal``
to JAX's, padding rows included (``lax.top_k``'s order: brightest first,
the lower index first among equal values). Fits within the golden's bars
(atol 1e-4, rtol 1e-5: two ``exp`` implementations and two summation
orders); the 3D background (a median of exact values) bit-equal;
``z_from_widths``' grid bit-equal to ``jnp.linspace``; z within 1e-3 of
the calibrated range.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequitr_tpu import psf as jax_psf
from sequitr_tpu.data import synthetic as jax_synthetic
from sequitr_tpu_torch import psf
from sequitr_tpu_torch.data import synthetic

ATOL, RTOL = 1e-4, 1e-5
GOLDEN = "tests/goldens/localize3d_step.npz"
SX_PARAMS = (1.3, +300.0, 400.0)
SY_PARAMS = (1.3, -300.0, 400.0)
CALIB = dict(qx=(1.05625e-05, -0.0063375, 2.640625), qy=(1.05625e-05, 0.0063375, 2.640625), z_range=(-600.0, 600.0))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _same_fits(got, want, keys=None, atol=ATOL):
    keys = keys or sorted(want)
    assert set(got) == set(want)
    for k in keys:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, atol=atol, rtol=RTOL, err_msg=k)


def _sigma_curve(z, s0, c, d):
    return s0 * np.sqrt(1.0 + ((z - c) / d) ** 2)


def _make_volume(truth, shape=(21, 64, 64), sigma=1.4, sigma_z=1.6, amp=800.0, bg=50.0, noise=2.0, seed=0):
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.mgrid[: shape[0], : shape[1], : shape[2]].astype(np.float64)
    vol = np.full(shape, bg)
    for cz, cy, cx in truth:
        vol += amp * np.exp(-((zz - cz) ** 2) / (2 * sigma_z**2) - ((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sigma**2))
    return vol + rng.normal(0, noise, shape)


def _make_astig_frame(truth, shape=(96, 96), photons=3000.0, bg=20.0, noise=0.3, seed=1):
    rng = np.random.default_rng(seed)
    fy, fx = np.mgrid[: shape[0], : shape[1]].astype(np.float64)
    frame = np.full(shape, bg)
    for cz, cy, cx in truth:
        sx, sy = _sigma_curve(cz, *SX_PARAMS), _sigma_curve(cz, *SY_PARAMS)
        frame += photons / (2 * np.pi * sx * sy) * np.exp(-((fy - cy) ** 2) / (2 * sy**2) - ((fx - cx) ** 2) / (2 * sx**2))
    return frame + rng.normal(0, noise, shape)


def _make_bead_scan(zs, shape=(32, 32), by=15.7, bx=16.2, photons=2000.0, bg=20.0, noise=0.3, seed=2):
    rng = np.random.default_rng(seed)
    gy, gx = np.mgrid[: shape[0], : shape[1]].astype(np.float64)
    stack = np.empty((len(zs),) + shape)
    for i, z in enumerate(zs):
        sx, sy = _sigma_curve(z, *SX_PARAMS), _sigma_curve(z, *SY_PARAMS)
        stack[i] = bg + photons / (2 * np.pi * sx * sy) * np.exp(
            -((gy - by) ** 2) / (2 * sy**2) - ((gx - bx) ** 2) / (2 * sx**2)
        )
    return stack + rng.normal(0, noise, stack.shape)


# -- 2D -----------------------------------------------------------------------


def test_subpixel_accuracy_matches_jax():
    rng = np.random.default_rng(0)
    H = W = 64
    truth = np.array([[12.3, 20.7], [40.25, 10.5], [50.8, 50.1], [25.0, 45.6]])
    yy, xx = np.mgrid[0:H, 0:W]
    img = np.zeros((H, W), np.float32)
    for cy, cx in truth:
        img += 100.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 1.5**2))
    img += 10.0 + rng.normal(0, 0.5, (H, W)).astype(np.float32)
    out = psf.localize_emitters(img, threshold=30.0, sigma=1.5, device="cpu")
    _same_fits(out, jax_psf.localize_emitters(img, threshold=30.0, sigma=1.5))
    pts = np.stack([out["y"], out["x"]], -1)
    assert len(pts) == 4
    for t in truth:
        assert float(np.min(np.linalg.norm(pts - t, axis=1))) < 0.05
    assert (out["amplitude"] > 0).all()


def test_detect_peaks_static_shapes_and_mask():
    img = np.zeros((32, 32), np.float32)
    img[8, 8], img[20, 24] = 5.0, 3.0
    yx, valid = psf.detect_peaks(torch.from_numpy(img), threshold=1.0, max_peaks=16)
    assert tuple(yx.shape) == (16, 2) and tuple(valid.shape) == (16,) and yx.dtype == torch.int32
    assert int(valid.sum()) == 2
    assert {tuple(map(int, p)) for p in yx[valid].numpy()} == {(8, 8), (20, 24)}
    wyx, wvalid = jax_psf.detect_peaks(jnp.asarray(img), 1.0, 16)
    np.testing.assert_array_equal(yx.numpy(), np.asarray(wyx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(wvalid))


@pytest.mark.parametrize("seed,max_peaks,min_distance", [(0, 64, 2), (1, 8, 1), (2, 300, 3), (3, 1024, 2)])
def test_detect_peaks_equal_to_jax(seed, max_peaks, min_distance):
    """Coordinates and mask bit-equal, padding rows included."""
    rng = np.random.default_rng(seed)
    img = rng.normal(10.0, 3.0, (48, 40)).astype(np.float32)
    yx, valid = psf.detect_peaks(torch.from_numpy(img), 12.0, max_peaks, min_distance)
    wyx, wvalid = jax.jit(lambda x: jax_psf.detect_peaks(x, 12.0, max_peaks, min_distance))(jnp.asarray(img))
    np.testing.assert_array_equal(yx.numpy(), np.asarray(wyx))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(wvalid))


def test_tied_values_keep_jax_order():
    """Equal-valued separate peaks (more than max_peaks of them, so the
    cut falls inside a tie) and 2x2 plateaus: the same candidates in the
    same order as lax.top_k (lower index first)."""
    img = np.zeros((40, 40), np.float32)
    for k, (y, x) in enumerate([(y, x) for y in range(3, 38, 6) for x in range(3, 38, 6)]):
        img[y, x] = 5.0 if k % 3 else 7.0
        if k % 4 == 0:
            img[y : y + 2, x : x + 2] = img[y, x]  # a plateau
    for max_peaks in (5, 10, 20, 40):
        yx, valid = psf.detect_peaks(torch.from_numpy(img), 1.0, max_peaks)
        wyx, wvalid = jax_psf.detect_peaks(jnp.asarray(img), 1.0, max_peaks)
        np.testing.assert_array_equal(yx.numpy(), np.asarray(wyx))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(wvalid))
    out = psf.localize_emitters(img, 1.0, max_peaks=64, window=5, device="cpu")
    _same_fits(out, jax_psf.localize_emitters(img, 1.0, max_peaks=64, window=5))


def test_batched_detect_and_fit_match_frames():
    """(B, H, W) with one threshold a frame: each frame's rows are those of
    the frame alone (the calibration's batched pass)."""
    rng = np.random.default_rng(5)
    frames = rng.normal(10.0, 3.0, (3, 32, 36)).astype(np.float32)
    thr = [12.0, 13.0, 14.5]
    yx, valid = psf.detect_peaks(torch.from_numpy(frames), thr, 20)
    fits = psf.fit_peaks_gaussian(torch.from_numpy(frames), yx, window=5)
    for b in range(3):
        yb, vb = psf.detect_peaks(torch.from_numpy(frames[b]), thr[b], 20)
        np.testing.assert_array_equal(yx[b].numpy(), yb.numpy())
        np.testing.assert_array_equal(valid[b].numpy(), vb.numpy())
        fb = psf.fit_peaks_gaussian(torch.from_numpy(frames[b]), yb, window=5)
        for k in fb:
            np.testing.assert_allclose(fits[k][b].numpy(), fb[k].numpy(), atol=1e-5, rtol=1e-6)


def test_suppress_tied_maxima_past_2_24_voxels():
    """The integer min pool is exact past 2^24 flat indices, where an f32
    pool can no longer tell neighbours apart."""
    from scipy import ndimage

    shape = (16, 1025, 1025)  # 16,810,000 voxels > 2^24
    n = int(np.prod(shape))
    assert n > 2**24
    is_peak = np.zeros(shape, bool)
    flat = is_peak.reshape(-1)
    for i in (2**24 + 1, 2**24 + 2, 2**24 + 1025, n - 1, n - 2, 5, 6, 2**23 + 7):
        flat[i] = True
    got = psf._suppress_tied_maxima(torch.from_numpy(is_peak), (3, 5, 5)).numpy()
    idx = np.arange(n, dtype=np.int64).reshape(shape)
    masked = np.where(is_peak, idx, n)
    want = is_peak & (idx == ndimage.minimum_filter(masked, size=(3, 5, 5), mode="constant", cval=n))
    np.testing.assert_array_equal(got, want)
    kept = set(np.flatnonzero(got.reshape(-1)).tolist())
    assert kept == {5, 2**23 + 7, 2**24 + 1, n - 2}


def test_no_peaks_below_threshold():
    out = psf.localize_emitters(np.ones((16, 16), np.float32), threshold=5.0, device="cpu")
    assert all(len(v) == 0 for v in out.values())
    assert set(out) == {"y", "x", "amplitude", "background"}


def test_image_smaller_than_max_peaks():
    img = np.zeros((10, 10), np.float32)
    img[4, 5] = 9.0
    out = psf.localize_emitters(img, threshold=1.0, max_peaks=256, device="cpu")
    assert len(out["y"]) == 1
    assert abs(float(out["y"][0]) - 4) < 0.5 and abs(float(out["x"][0]) - 5) < 0.5
    _same_fits(out, jax_psf.localize_emitters(img, threshold=1.0, max_peaks=256))


@pytest.mark.parametrize("shape", [(7, 7), (7, 12), (10, 10), (30, 9)])
def test_border_crops_clamp_like_dynamic_slice(shape):
    """Candidates at every border and corner, on images no larger than
    the window in one axis: the crops clamp into the image as
    ``dynamic_slice`` does."""
    rng = np.random.default_rng(sum(shape))
    img = rng.gamma(2.0, 30.0, shape).astype(np.float32)
    h, w = shape
    yx = np.array([[0, 0], [0, w - 1], [h - 1, 0], [h - 1, w - 1], [h // 2, w // 2], [1, w - 2], [h - 3, 2]], np.int32)
    got = psf.fit_peaks_gaussian(torch.from_numpy(img), torch.from_numpy(yx), window=7)
    want = jax_psf.fit_peaks_gaussian(jnp.asarray(img), jnp.asarray(yx), window=7)
    _same_fits({k: v.numpy() for k, v in got.items()}, want)
    if min(shape) >= 7:
        ell = psf.fit_peaks_elliptical(torch.from_numpy(img), torch.from_numpy(yx), window=7)
        _same_fits({k: v.numpy() for k, v in ell.items()}, jax_psf.fit_peaks_elliptical(jnp.asarray(img), jnp.asarray(yx), window=7))


def test_window_larger_than_image_raises():
    with pytest.raises(ValueError, match="window"):
        psf.fit_peaks_gaussian(torch.zeros(5, 5), torch.zeros(1, 2, dtype=torch.int32), window=7)


def test_flip_equivariance_makes_tta_a_noop():
    rng = np.random.default_rng(7)
    H = W = 33
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    img = (10.0 + 500.0 * np.exp(-((yy - 15.73) ** 2 + (xx - 16.31) ** 2) / 2) + rng.normal(0, 0.3, (H, W))).astype(np.float32)
    t = torch.from_numpy
    fits = psf.fit_peaks_gaussian(t(img), torch.tensor([[16, 16]], dtype=torch.int32), window=5, sigma=1.0)
    fits_f = psf.fit_peaks_gaussian(t(img[::-1].copy()), torch.tensor([[H - 1 - 16, 16]], dtype=torch.int32),
                                    window=5, sigma=1.0)
    assert abs(float(fits_f["y"][0]) - (H - 1 - float(fits["y"][0]))) < 1e-4
    assert abs(float(fits_f["x"][0]) - float(fits["x"][0])) < 1e-4
    ell = psf.fit_peaks_elliptical(t(img), torch.tensor([[16, 16]], dtype=torch.int32), window=7)
    ell_f = psf.fit_peaks_elliptical(t(img[:, ::-1].copy()), torch.tensor([[16, W - 1 - 16]], dtype=torch.int32), window=7)
    assert abs(float(ell_f["x"][0]) - (W - 1 - float(ell["x"][0]))) < 1e-4
    assert abs(float(ell_f["sigma_y"][0]) - float(ell["sigma_y"][0])) < 1e-5


def test_synthetic_emitter_frame_matches_jax():
    img, pos = synthetic.emitter_frame(444_000, (256, 256), n=40)
    out = psf.localize_emitters(img, 120.0, device="cpu")
    want = jax_psf.localize_emitters(img, 120.0)
    assert len(out["y"]) == len(want["y"]) == 40
    _same_fits(out, want)


# -- 3D -----------------------------------------------------------------------


def test_subvoxel_accuracy_3d():
    rng = np.random.default_rng(3)
    truth = []
    while len(truth) < 6:
        cand = (rng.uniform(5, 15), rng.uniform(10, 53), rng.uniform(10, 53))
        if all(np.linalg.norm(np.subtract(cand, t)[1:]) > 12 for t in truth):
            truth.append(cand)
    vol = _make_volume(truth)
    out = psf.localize_emitters_3d(vol, 200.0, sigma=1.4, sigma_z=1.6, window=9, window_z=7, device="cpu")
    want = jax_psf.localize_emitters_3d(vol, 200.0, sigma=1.4, sigma_z=1.6, window=9, window_z=7)
    _same_fits(out, want)
    assert len(out["z"]) == 6
    pts = np.stack([out["z"], out["y"], out["x"]], -1)
    for t in truth:
        err = pts - np.asarray(t)
        i = np.argmin((err**2).sum(1))
        assert abs(err[i, 0]) < 0.08 and abs(err[i, 1]) < 0.05 and abs(err[i, 2]) < 0.05
    assert np.allclose(out["background"], 50.0, atol=3.0)


def test_detect_peaks_3d_static_shapes():
    vol = np.zeros((8, 16, 16), np.float32)
    vol[3, 5, 7], vol[6, 10, 2] = 5.0, 3.0
    zyx, valid = psf.detect_peaks_3d(torch.from_numpy(vol), threshold=1.0, max_peaks=12)
    assert tuple(zyx.shape) == (12, 3) and int(valid.sum()) == 2
    wz, wv = jax_psf.detect_peaks_3d(jnp.asarray(vol), 1.0, 12)
    np.testing.assert_array_equal(zyx.numpy(), np.asarray(wz))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(wv))


def test_no_peaks_3d():
    out = psf.localize_emitters_3d(np.ones((6, 12, 12), np.float32), threshold=5.0, device="cpu")
    assert len(out["z"]) == 0


def test_halfpixel_tie_single_detection():
    vol = _make_volume([(6.0, 20.0, 25.5)], noise=0.0)
    out = psf.localize_emitters_3d(vol, 200.0, device="cpu")
    assert len(out["z"]) == 1 and abs(out["x"][0] - 25.5) < 0.05
    _same_fits(out, jax_psf.localize_emitters_3d(vol, 200.0))
    out2d = psf.localize_emitters(np.asarray(vol[6], np.float32), 200.0, device="cpu")
    assert len(out2d["y"]) == 1 and abs(out2d["x"][0] - 25.5) < 0.05


def test_min_distance_z_suppresses_axial_neighbors():
    vol = np.zeros((11, 16, 16), np.float32)
    vol[4, 8, 8], vol[6, 8, 8] = 10.0, 8.0
    tight = psf.localize_emitters_3d(vol, 1.0, min_distance_z=1, window=5, window_z=3, device="cpu")
    wide = psf.localize_emitters_3d(vol, 1.0, min_distance_z=2, window=5, window_z=3, device="cpu")
    assert len(tight["z"]) == 2 and len(wide["z"]) == 1


def test_fit_3d_background_is_jax_median():
    """The lateral faces of a 5x7x7 crop are 120 values: an even count,
    JAX averages the two middles. Background bit-equal, positions at the
    bars, on random candidates (borders included)."""
    rng = np.random.default_rng(11)
    vol = rng.gamma(2.0, 40.0, (12, 30, 34)).astype(np.float32)
    zyx = np.stack([rng.integers(0, s, 24) for s in vol.shape], -1).astype(np.int32)
    got = psf.fit_peaks_gaussian_3d(torch.from_numpy(vol), torch.from_numpy(zyx), sigma=1.4, sigma_z=1.6)
    want = jax_psf.fit_peaks_gaussian_3d(jnp.asarray(vol), jnp.asarray(zyx), sigma=1.4, sigma_z=1.6)
    np.testing.assert_array_equal(got["background"].numpy(), np.asarray(want["background"]))
    _same_fits({k: v.numpy() for k, v in got.items()}, want)


def test_golden_localize3d_step():
    g = np.load(GOLDEN)
    vol, _ = synthetic.emitter_volume(90_001, (12, 64, 64), n=8)
    out = psf.localize_emitters_3d(vol, 120.0, max_peaks=16, sigma=1.4, sigma_z=1.6, device="cpu")
    for k in ("z", "y", "x", "amplitude", "background"):
        np.testing.assert_allclose(np.asarray(out[k], np.float32), g[f"vol_{k}"], atol=1e-4, rtol=1e-5, err_msg=k)
    rng = np.random.default_rng(90_002)
    yy, xx = np.mgrid[:64, :64].astype(np.float64)
    frame = np.full((64, 64), 20.0)
    for cz, cy, cx in [(250.0, 20.5, 40.2), (-380.0, 45.1, 18.7)]:
        sx, sy = _sigma_curve(cz, *SX_PARAMS), _sigma_curve(cz, *SY_PARAMS)
        frame += 3000.0 / (2 * np.pi * sx * sy) * np.exp(-((yy - cy) ** 2) / (2 * sy**2) - ((xx - cx) ** 2) / (2 * sx**2))
    frame = (frame + rng.normal(0, 0.2, frame.shape)).astype(np.float32)
    astig = psf.localize_emitters_astig(frame, 40.0, psf.AstigCalibration(**CALIB), device="cpu")
    for k in ("z", "y", "x", "sigma_y", "sigma_x", "amplitude", "background"):
        np.testing.assert_allclose(np.asarray(astig[k], np.float32), g[f"astig_{k}"], atol=1e-3, rtol=1e-5, err_msg=k)


def test_synthetic_volume_matches_jax_synthetic():
    """The port's data generator is the JAX package's, value for value."""
    a, pa = synthetic.emitter_volume(446_000, (16, 64, 64), n=10)
    b, pb = jax_synthetic.emitter_volume(446_000, (16, 64, 64), n=10)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.asarray(pa), np.asarray(pb))


# -- elliptical fit and astigmatism --------------------------------------------


def test_widths_recovered():
    rng = np.random.default_rng(4)
    fy, fx = np.mgrid[0:31, 0:31].astype(np.float64)
    for sy_t, sx_t in [(1.2, 2.2), (2.0, 1.1), (1.6, 1.6)]:
        cy_t, cx_t = 15 + rng.uniform(-0.5, 0.5), 15 + rng.uniform(-0.5, 0.5)
        img = 100 + 900 * np.exp(-((fy - cy_t) ** 2) / (2 * sy_t**2) - ((fx - cx_t) ** 2) / (2 * sx_t**2))
        img = (img + rng.normal(0, 1.0, img.shape)).astype(np.float32)
        yx = np.array([[15, 15]], np.int32)
        fits = psf.fit_peaks_elliptical(torch.from_numpy(img), torch.from_numpy(yx), window=15)
        _same_fits({k: v.numpy() for k, v in fits.items()},
                   jax_psf.fit_peaks_elliptical(jnp.asarray(img), jnp.asarray(yx), window=15))
        assert abs(float(fits["y"][0]) - cy_t) < 0.02 and abs(float(fits["x"][0]) - cx_t) < 0.02
        assert abs(float(fits["sigma_y"][0]) - sy_t) < 0.06 and abs(float(fits["sigma_x"][0]) - sx_t) < 0.06


def test_width_clamped_to_bounds():
    rng = np.random.default_rng(5)
    img = rng.normal(100, 1.0, (21, 21)).astype(np.float32)
    fits = psf.fit_peaks_elliptical(torch.from_numpy(img), torch.tensor([[10, 10]], dtype=torch.int32), window=11)
    assert 0.5 <= float(fits["sigma_y"][0]) <= 6.0 and 0.5 <= float(fits["sigma_x"][0]) <= 6.0


@pytest.mark.parametrize("z_range,n_grid", [((-600.0, 600.0), 241), ((-437.3, 512.9), 241), ((0.1, 0.9), 101),
                                            ((1234.5, 1999.9), 57), ((-1.0, 1.0), 3)])
def test_z_grid_is_jnp_linspace(z_range, n_grid):
    f32 = [float(np.float32(v)) for v in z_range]
    got = psf._linspace(f32[0], f32[1], n_grid, "cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.linspace(*z_range, n_grid)))
    traced = jax.jit(lambda c: jnp.linspace(c[0], c[1], n_grid))(jnp.asarray(z_range, jnp.float32))
    np.testing.assert_array_equal(got, np.asarray(traced))


def test_z_from_widths_matches_jax():
    rng = np.random.default_rng(12)
    calib_t, calib_j = psf.AstigCalibration(**CALIB), jax_psf.AstigCalibration(**CALIB)
    zq = np.concatenate([np.linspace(-700, 700, 57), rng.uniform(-600, 600, 40)])
    sx = np.asarray(calib_j.sigma_x(jnp.asarray(zq, jnp.float32))) * (1 + rng.normal(0, 0.01, zq.shape))
    sy = np.asarray(calib_j.sigma_y(jnp.asarray(zq, jnp.float32))) * (1 + rng.normal(0, 0.01, zq.shape))
    sx, sy = sx.astype(np.float32), sy.astype(np.float32)
    got = psf.z_from_widths(torch.from_numpy(sx), torch.from_numpy(sy), calib_t).numpy()
    coef = jnp.asarray(calib_j.qx + calib_j.qy + calib_j.z_range, jnp.float32)
    want = np.asarray(jax.jit(lambda a, b, c: jax_psf.z_from_widths(
        a, b, jax_psf.AstigCalibration(qx=(c[0], c[1], c[2]), qy=(c[3], c[4], c[5]), z_range=(c[6], c[7]))
    ))(jnp.asarray(sx), jnp.asarray(sy), coef))
    np.testing.assert_allclose(got, want, atol=1e-3 * 1200.0, rtol=0)
    zhat = psf.z_from_widths(calib_t.sigma_x(torch.tensor(zq[:57], dtype=torch.float32)),
                             calib_t.sigma_y(torch.tensor(zq[:57], dtype=torch.float32)), calib_t).numpy()
    inside = np.abs(zq[:57]) <= 500
    assert np.abs(zhat[inside] - zq[:57][inside]).max() < 2.0


def test_calibration_and_z_recovery():
    zs = np.linspace(-600, 600, 21)
    scan = _make_bead_scan(zs)
    calib = psf.calibrate_astigmatism(scan, zs, device="cpu")
    want = jax_psf.calibrate_astigmatism(scan, zs)
    assert calib.z_range == want.z_range == (-600.0, 600.0) and calib.window == want.window == 15
    np.testing.assert_allclose(calib.qx, want.qx, rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(calib.qy, want.qy, rtol=1e-5, atol=1e-12)
    zg = torch.linspace(-500, 500, 101)
    assert float(zg[calib.sigma_x(zg).argmin()]) > 100 and float(zg[calib.sigma_y(zg).argmin()]) < -100
    rng = np.random.default_rng(6)
    truth = [(rng.uniform(-450, 450), *rng.uniform(12, 84, 2)) for _ in range(5)]
    frame = _make_astig_frame(truth)
    out = psf.localize_emitters_astig(frame, 25.0, calib, device="cpu")
    _same_fits(out, jax_psf.localize_emitters_astig(frame, 25.0, want), atol=1e-3)
    assert len(out["z"]) == 5
    z_errs = []
    for cz, cy, cx in truth:
        i = np.argmin((out["y"] - cy) ** 2 + (out["x"] - cx) ** 2)
        assert abs(out["y"][i] - cy) < 0.05 and abs(out["x"][i] - cx) < 0.05
        z_errs.append(out["z"][i] - cz)
    assert float(np.sqrt(np.mean(np.square(z_errs)))) < 0.06 * 1200


def test_calibration_diagnostics_match_jax():
    zs = np.linspace(-600, 600, 17)
    scan = _make_bead_scan(zs, seed=3)
    calib, diag = psf.calibrate_astigmatism(scan, zs, window=13, diagnostics=True, device="cpu")
    _, want = jax_psf.calibrate_astigmatism(scan, zs, window=13, diagnostics=True)
    for k in ("sigma_x", "sigma_y"):
        np.testing.assert_allclose(diag[k], want[k], atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(diag["z"], want["z"])


def test_json_roundtrip(tmp_path):
    calib = psf.AstigCalibration(qx=(1e-6, -0.005, 2.7), qy=(1e-6, 0.005, 2.7), z_range=(-600.0, 600.0), window=13)
    p = str(tmp_path / "astig.json")
    calib.to_json(p)
    assert psf.AstigCalibration.from_json(p) == calib
    jax_psf.AstigCalibration(qx=calib.qx, qy=calib.qy, z_range=calib.z_range, window=13).to_json(str(tmp_path / "j.json"))
    assert open(p).read() == open(str(tmp_path / "j.json")).read()


@pytest.mark.parametrize("content", [{"qx": [1, 2, 3], "qy": [1, 2]}, {"qx": [1, 2, 3], "qy": [1, 2, 3]}, [1, 2, 3],
                                     {"qx": [1, 2], "qy": [1, 2, 3], "z_range": [0, 1]}])
def test_from_json_validation(tmp_path, content):
    p = str(tmp_path / "bad.json")
    with open(p, "w") as f:
        json.dump(content, f)
    with pytest.raises(ValueError) as got:
        psf.AstigCalibration.from_json(p)
    with pytest.raises(ValueError) as want:
        jax_psf.AstigCalibration.from_json(p)
    assert str(got.value) == str(want.value)


def test_calibrate_validation():
    zs = np.linspace(-600, 600, 21)
    stack = _make_bead_scan(zs)
    with pytest.raises(ValueError, match="z positions"):
        psf.calibrate_astigmatism(stack, zs[:-1], device="cpu")
    with pytest.raises(ValueError, match="Z, H, W"):
        psf.calibrate_astigmatism(stack[0], zs[:1], device="cpu")
    with pytest.raises(ValueError, match=">= 5"):
        psf.calibrate_astigmatism(stack[:3], zs[:3], device="cpu")


def test_matching_window_default():
    zs = np.linspace(-600, 600, 15)
    calib = psf.calibrate_astigmatism(_make_bead_scan(zs), zs, window=13, device="cpu")
    assert calib.window == 13
    out = psf.localize_emitters_astig(_make_astig_frame([(100.0, 40.0, 40.0)]), 25.0, calib, device="cpu")
    assert len(out["z"]) == 1


def test_synthetic_astig_frame_matches_jax():
    img, pos = synthetic.astig_emitter_frame(447_000, (256, 256), n=25)
    calib_t, calib_j = psf.AstigCalibration(**CALIB), jax_psf.AstigCalibration(**CALIB)
    out = psf.localize_emitters_astig(img, 25.0, calib_t, device="cpu")
    want = jax_psf.localize_emitters_astig(img, 25.0, calib_j)
    assert len(out["z"]) == len(want["z"])
    _same_fits(out, want, keys=["y", "x", "sigma_y", "sigma_x", "amplitude", "background"])
    np.testing.assert_allclose(out["z"], want["z"], atol=1e-3 * 1200.0, rtol=0)
