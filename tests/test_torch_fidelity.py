"""The port's fidelity meters against the JAX package's, both on the CPU.

On the CPU both packages run the served path at f32 (their ``auto``
normalize is the plain 4096-bin histogram there) against the f32 exact
reference, on the same committed fixtures, seeds and frames, so each meter
must return the same keys and values within the tolerance stated with it.
The meters are called as ``tests/test_fidelity.py`` calls the JAX ones:
small frames, ``n=1``.
"""

import numpy as np
import pytest
import torch

from sequitr_tpu import fidelity as jax_fidelity
from sequitr_tpu_torch import fidelity


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# key -> absolute tolerance, with the reason: counts and names are equal;
# label and instance agreement moves by a pixel flip or two (f32 convs sum
# in another order near a tie); a PSNR against the reference measures
# f32 round-off itself, which differs between the two implementations by
# up to a few dB at ~60-100 dB, so it is held to a floor instead; PSNR
# against a target and L1 move with the outputs' last bits only
TOL = {
    "miou_vs_ref": 2e-3, "miou_truth": 2e-3, "miou_truth_ref": 2e-3,
    "psnr_target_db": 0.02, "psnr_truth_db": 0.02, "psnr_noisy_db": 0.0,
    "l1_vs_ref": 1e-4,
    "ap50_vs_ref": 0.02, "ap50_truth": 0.02, "matched_iou_truth": 2e-3,
}
PSNR_VS_REF_FLOOR_DB = 50.0


def _same(got, want):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k, v in want.items():
        if k == "psnr_vs_ref_db":
            assert got[k] >= PSNR_VS_REF_FLOOR_DB and v >= PSNR_VS_REF_FLOOR_DB, (got[k], v)
        elif isinstance(v, float):
            assert abs(got[k] - v) <= TOL[k], (k, got[k], v)
        else:
            assert got[k] == v, (k, got[k], v)


METERS = {
    "seg": ("seg_fidelity", ("unet2d_cells", (256, 256)), {"n": 1}),
    "seg3d": ("seg_fidelity", ("unet3d_cells", (8, 64, 64)), {"n": 1}),
    "gan": ("gan_fidelity", (), {"frame_shape": (128, 128), "n": 1}),
    "n2v": ("n2v_fidelity", (), {"frame_shape": (128, 128), "n": 1}),
    "flows": ("flows_fidelity", (), {"frame_shape": (128, 128), "n": 1}),
    "stars": ("stars_fidelity", (), {"frame_shape": (128, 128), "n": 1}),
}


@pytest.mark.parametrize("meter", sorted(METERS))
def test_meter_matches_the_jax_meter(meter):
    name, args, kwargs = METERS[meter]
    want = getattr(jax_fidelity, name)(*args, **kwargs)
    got = getattr(fidelity, name)(*args, **kwargs, device="cpu")
    _same(got, want)


def test_measures():
    """The shared measures on known cases: an absent class scores 1.0, one
    instance of two found is ap50 0.5, an error of 0.1 everywhere is 20 dB."""
    a = np.array([[0, 1], [1, 1]])
    assert fidelity.miou(a, a, 3) == 1.0
    assert fidelity.miou(a, np.zeros_like(a), 2) == pytest.approx((0.25 + 0.0) / 2)
    want = np.zeros((8, 8), np.int32)
    want[:3, :3], want[5:, 5:] = 1, 2
    got = np.where(want == 1, 1, 0)
    assert fidelity.ap50(want, got) == 0.5
    assert fidelity.psnr_db(np.full((4, 4), 0.6), np.full((4, 4), 0.5)) == pytest.approx(20.0)


@pytest.mark.parametrize("kind", ["unet2d", "gan"])
def test_train_fidelity_matches_the_jax_meter(kind):
    """On the CPU both sides of both meters run f32, so the deviation is 0
    for both packages (the JAX test's bar is 1e-3). The final losses come
    from each package's own init draws (the port's generator cannot replay
    ``jax.random``) and augmentation draws: losses of the same model on the
    same batches after the same steps, held within a factor 1.6 of each
    other (read: 1.23 / 1.46 for unet2d, 44.2 / 37.7 for gan)."""
    kw = dict(steps=2, batch=2, size=64)
    want = jax_fidelity.train_fidelity(kind, **kw)
    got = fidelity.train_fidelity(kind, device="cpu", **kw)
    assert set(got) == set(want)
    assert got["steps"] == want["steps"] == 2
    assert got["loss_rel_dev_max"] <= 1e-3 and want["loss_rel_dev_max"] <= 1e-3
    for k in ("loss_final_dev", "loss_final_ref"):
        assert 1 / 1.6 <= got[k] / want[k] <= 1.6, (k, got[k], want[k])


@pytest.mark.parametrize("polyphase", [False, True], ids=["standard", "polyphase"])
def test_train_fidelity_unet3d_and_polyphase(polyphase):
    """The 3D meter and the polyphase meter (GAN) run on the CPU at f32:
    deviations within the JAX test's 1e-3."""
    kind = "gan" if polyphase else "unet3d"
    r = fidelity.train_fidelity(kind, steps=2, batch=2, size=32, polyphase=polyphase, device="cpu")
    assert set(r) == {"loss_rel_dev_max", "loss_final_dev", "loss_final_ref", "steps"}
    assert r["loss_rel_dev_max"] <= 1e-3 and r["loss_final_ref"] > 0


# the geometry meters carry no model: keys equal, the pixel errors within
# 1e-4 plus the 4-decimal rounding (shifts agree to 1e-5 px,
# test_torch_registration.py), the photometric and illumination numbers to
# the rounding of their last digit (the corrector is bit-equal)
GEOMETRY = {
    "register": ("register_fidelity", {"n": 4, "shape": (64, 64)}),
    "register_default_shape": ("register_fidelity", {"n": 3}),
    "mosaic": ("mosaic_fidelity", {"grid": (2, 2), "tile": (96, 96), "overlap": 24}),
    "illum": ("illum_fidelity", {"t": 8, "shape": (64, 64)}),
}
GEOMETRY_TOL = {
    "trajectory_rmse_px": 2e-4, "max_err_px": 2e-4, "position_rmse_px": 2e-4,
    "seam_rms_residual_px": 2e-4, "photometric_residual_frac": 2e-4,
    "bleach_rate_err": 1e-6, "drift_ratio": 1e-4, "shading_rmse": 1e-4, "rel_err_p99": 1e-4,
}


@pytest.mark.parametrize("meter", sorted(GEOMETRY))
def test_geometry_meter_matches_the_jax_meter(meter):
    name, kwargs = GEOMETRY[meter]
    want = getattr(jax_fidelity, name)(**kwargs)
    got = getattr(fidelity, name)(**kwargs, device="cpu")
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k, v in want.items():
        if isinstance(v, float):
            assert abs(got[k] - v) <= GEOMETRY_TOL[k], (k, got[k], v)
        else:
            assert got[k] == v, (k, got[k], v)
    if meter == "mosaic":
        # the JAX tests' bars (tests/test_fidelity.py)
        assert got["position_rmse_px"] < 0.05 and got["seam_rms_residual_px"] < 0.05
        assert got["photometric_residual_frac"] < 0.08
