"""``sequitr_tpu_torch.ops.qc`` against ``sequitr_tpu.ops.qc`` on the CPU.

The frame QC (``frame_qc``) against the jitted ``cached_frame_qc`` and,
on a (Z, H, W) volume, against the vmapped ``cached_volume_qc``: uint16
and f32 frames, odd shapes, a full-scale and an infinite saturation
level. ``p01``/``p99`` (``percentile_linear``) and ``sat_frac`` are
bit-equal. ``focus_vol``, ``tenengrad``, ``mean`` and ``std`` are
whole-frame sums in each backend's own order: held at ``REDUCED_RTOL``
(measured here: at most 1.2e-6 relative on textured frames, 8.9e-6 on a
constant full-scale plane, where XLA's order reads a mean of 65535.58 and
the port's 65535.004; ``std`` relative to the larger of itself and the
frame's mean, since its deviations carry the mean's rounding). ``flag_frames`` and ``default_saturation_level`` are host
copies: equal on random tables, the degenerate-MAD case included.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequitr_tpu.ops import qc as jax_qc
from sequitr_tpu_torch.ops import qc

REDUCED_RTOL = 1.5e-5  # measured <= 8.9e-6 (the constant plane), <= 1.2e-6 elsewhere
EXACT = ("p01", "p99", "sat_frac")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _frame(rng, shape, dtype):
    if dtype == np.uint16:
        f = rng.gamma(2.0, 800.0, shape).clip(0, 65535).astype(np.uint16)
        f.reshape(-1)[: f.size // 40] = 65535  # 2.5% saturated
        return f
    return (rng.normal(0.0, 1.0, shape) * 30 + 100).astype(np.float32)


def _hold(got, want):
    """Bit-equal where the port's arithmetic is JAX's, the bar elsewhere."""
    assert got.shape == want.shape and got.dtype == np.float32
    idx = {m: i for i, m in enumerate(qc.METRICS)}
    for m in EXACT:
        np.testing.assert_array_equal(got[..., idx[m]], want[..., idx[m]], err_msg=m)
    for m in ("focus_vol", "tenengrad", "mean"):
        a, b = got[..., idx[m]].astype(np.float64), want[..., idx[m]].astype(np.float64)
        assert np.all(np.abs(a - b) <= REDUCED_RTOL * np.abs(b)), m
    a, b = got[..., idx["std"]].astype(np.float64), want[..., idx["std"]].astype(np.float64)
    scale = np.maximum(np.abs(b), np.abs(want[..., idx["mean"]]))
    assert np.all(np.abs(a - b) <= REDUCED_RTOL * scale)


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
@pytest.mark.parametrize("shape", [(64, 64), (37, 53), (3, 5), (200, 131)])
@pytest.mark.parametrize("sat", ["full", "inf"])
def test_frame_qc_matches_jax(shape, dtype, sat):
    rng = np.random.default_rng(shape[0] * 1000 + shape[1] + (sat == "inf"))
    f = _frame(rng, shape, dtype)
    level = np.inf if sat == "inf" else (65535.0 if dtype == np.uint16 else 120.0)
    want = np.asarray(jax_qc.cached_frame_qc()(f, jnp.float32(level)))
    got = qc.frame_qc(torch.from_numpy(f), float(np.float32(level))).numpy()
    _hold(got, want)
    if sat == "inf":
        assert got[qc.METRICS.index("sat_frac")] == 0.0


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
def test_volume_qc_matches_jax_in_one_pass(dtype):
    rng = np.random.default_rng(7)
    vol = _frame(rng, (9, 41, 30), dtype)
    vol[4] = 65535 if dtype == np.uint16 else 1e4  # a constant plane
    level = 65535.0 if dtype == np.uint16 else 150.0
    want = np.asarray(jax_qc.cached_volume_qc()(vol, jnp.float32(level)))
    got = qc.frame_qc(torch.from_numpy(vol), level).numpy()
    assert got.shape == (9, 7)
    _hold(got, want)
    # each plane of the batch is the plane scored alone
    for z in (0, 4, 8):
        np.testing.assert_array_equal(qc.frame_qc(torch.from_numpy(np.ascontiguousarray(vol[z])), level).numpy(),
                                      got[z])


def test_whole_frame_sums_differ_only_by_order():
    """The two backends' whole-frame sums differ (the bar is needed) and
    stay within a few f32 ulps on textured frames."""
    rng = np.random.default_rng(3)
    gaps = []
    for shape in ((64, 64), (256, 256), (37, 53)):
        f = _frame(rng, shape, np.uint16)
        want = np.asarray(jax_qc.cached_frame_qc()(f, jnp.float32(65535.0))).astype(np.float64)
        got = qc.frame_qc(torch.from_numpy(f), 65535.0).numpy().astype(np.float64)
        gaps.append(np.max(np.abs(got - want)[:4] / np.abs(want)[:4]))
    assert 0 < max(gaps) <= 2e-6  # about 16 f32 ulps


def test_flag_frames_matches_jax_on_random_tables():
    rng = np.random.default_rng(11)
    for n in (1, 2, 5, 40):
        for _ in range(10):
            t = np.abs(rng.normal(100.0, 30.0, (n, 7)))
            t[:, 6] = rng.uniform(0, 0.03, n)
            if n > 2:
                t[rng.integers(0, n), 0] *= 0.05  # a defocused frame
                t[rng.integers(0, n), 2] *= 0.2  # a dark frame
            kw = dict(mad_k=float(rng.uniform(1, 5)), dark_fraction=float(rng.uniform(0, 0.9)),
                      sat_max=float(rng.uniform(0.001, 0.02)), focus_drop=float(rng.uniform(0.1, 1.0)))
            assert qc.flag_frames(t, **kw) == jax_qc.flag_frames(t, **kw)


def test_flag_frames_degenerate_mad():
    """>= 50% identical focus scores collapse the MAD: a grossly defocused
    frame is still flagged, the same way in both packages."""
    t = np.full((7, 7), 100.0)
    t[:, 6] = 0.0
    t[5, 0] = 2.0
    assert qc.flag_frames(t) == jax_qc.flag_frames(t)
    assert qc.flag_frames(t)[5] == ["focus"]


def test_flag_table_validation_and_saturation_levels():
    for bad in (np.zeros((3, 6)), np.zeros(7)):
        with pytest.raises(ValueError) as e_port:
            qc.flag_frames(bad)
        with pytest.raises(ValueError) as e_jax:
            jax_qc.flag_frames(bad)
        assert str(e_port.value) == str(e_jax.value)
    for dt in (np.uint8, np.uint16, np.int16, np.int32, np.float32, np.float64):
        assert qc.default_saturation_level(dt) == jax_qc.default_saturation_level(dt)
    assert qc.METRICS == jax_qc.METRICS
