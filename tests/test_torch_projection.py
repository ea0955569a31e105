"""``sequitr_tpu_torch.ops.projection`` against the jitted
``sequitr_tpu.ops.projection.cached_projector`` on the CPU.

Every method on uint16 and f32 focus volumes (one sharp plane, the rest
blurred, as ``tests/test_projection.py::_focus_volume`` builds them) at z
counts that are and are not powers of two. Bit-equal: the selection
methods in the input dtype (uint16 through int32), ``sum``, ``mean``
(plane-by-plane sum times f32(1/Z)), ``median`` (``percentile_linear`` at
50), ``std`` (fused squared deviations, float64 square root rounded once),
``best_focus``'s plane and the EDoF height map (the raster-order box sum)
and ``select`` projection. The ``blend`` projection is held at
``BLEND_RTOL`` of the volume's largest value: its weights take XLA's
``pow`` in the JAX package and a float64 power rounded once here (the two
part by one ulp on a small share of f32 inputs, measured below).
Validation messages are the JAX package's.
"""

import jax
import numpy as np
import pytest
import torch

from sequitr_tpu.ops import projection as jax_proj
from sequitr_tpu_torch.ops import projection

BLEND_RTOL = 1e-6  # measured: bit-equal on these volumes; f32 ulps where the powers part


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _blur(img, n):
    for _ in range(n):
        img = (img + np.roll(img, 1, 0) + np.roll(img, -1, 0) + np.roll(img, 1, 1) + np.roll(img, -1, 1)) / 5.0
    return img


def _focus_volume(seed, z, shape, sharp_z, dtype):
    rng = np.random.default_rng(seed)
    base = rng.random(shape).astype(np.float32) * 100
    vol = np.stack([base if k == sharp_z else _blur(base, 1 + abs(k - sharp_z)) for k in range(z)])
    vol = vol + rng.normal(0, 0.5, vol.shape)
    if dtype == np.uint16:
        return np.round(vol * 300).clip(0, 65535).astype(np.uint16)
    return vol.astype(np.float32)


CASES = [
    ("max", {}), ("min", {}), ("sum", {}), ("mean", {}), ("std", {}), ("median", {}), ("best_focus", {}),
    ("edof", {"mode": "select"}), ("edof", {"mode": "select", "radius": 0}), ("edof", {}),
    ("edof", {"radius": 0}), ("edof", {"radius": 2, "gamma": 2.5}),
]


@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
@pytest.mark.parametrize("z", [4, 9])
@pytest.mark.parametrize("method,kw", CASES, ids=[f"{m}-{'-'.join(f'{k}{v}' for k, v in kw.items())}" for m, kw in CASES])
def test_projector_matches_jax(method, kw, z, dtype):
    vol = _focus_volume(z * 10 + len(kw), z, (37, 44), z // 2, dtype)
    pj, aj = (np.asarray(a) for a in jax_proj.cached_projector(method, **kw)(vol))
    pt, at = projection.make_projector(method, **kw)(torch.from_numpy(vol))
    pt, at = pt.numpy(), at.numpy()
    assert pt.dtype == pj.dtype and pt.shape == pj.shape
    assert at.dtype == np.int32 and at.shape == aj.shape
    np.testing.assert_array_equal(at, aj)
    if projection.METHODS[method]:
        assert pt.dtype == vol.dtype
    if method == "edof" and kw.get("mode") != "select":
        np.testing.assert_allclose(pt, pj, rtol=0, atol=BLEND_RTOL * float(np.abs(vol).max()))
    else:
        np.testing.assert_array_equal(pt, pj)
    if method == "best_focus":
        assert int(at) == z // 2
        np.testing.assert_array_equal(pt, vol[z // 2])


@pytest.mark.parametrize("method", ["max", "min", "best_focus"])
def test_uint32_selection_matches_jax(method):
    """uint32 (a TIFF sample type) selects through int64 and an int32 view."""
    vol = (_focus_volume(3, 6, (21, 17), 2, np.float32).astype(np.float64) * 4e7).astype(np.uint32)
    want = np.asarray(jax_proj.cached_projector(method)(vol)[0])
    got = projection.make_projector(method)(torch.from_numpy(vol))[0].numpy()
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)


def test_sentinel_and_flat_volume():
    """Methods without per-volume metadata return the -1 sentinel; a flat
    volume blends to its plain mean (no 0/0)."""
    flat = np.full((3, 8, 8), 7.0, np.float32)
    proj, aux = projection.make_projector("edof")(torch.from_numpy(flat))
    np.testing.assert_array_equal(proj.numpy(), np.asarray(jax_proj.cached_projector("edof")(flat)[0]))
    np.testing.assert_allclose(proj.numpy(), 7.0)
    _, aux = projection.make_projector("mean")(torch.from_numpy(flat))
    assert aux.dtype == torch.int32 and int(aux) == -1


def test_power_gap_is_small():
    """The blend's power: XLA's f32 ``pow`` against the port's float64
    power rounded once, on 2^18 uniform values in [0, 1): they part on a
    small share, by one ulp."""
    a = np.random.default_rng(0).uniform(0, 1, 2**18).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: x**4.0)(a))
    got = (torch.from_numpy(a).double() ** 4.0).float().numpy()
    share = float(np.mean(got != want))
    assert share < 2e-3
    np.testing.assert_array_max_ulp(got, want, maxulp=1)


@pytest.mark.parametrize("args", [
    ("nope",), ("edof", -1), ("edof", 4, 0.0), ("edof", 4, -2.0), ("edof", 4, 4.0, "soft"), ("max", "x"),
])
def test_validation_messages_match(args):
    with pytest.raises((ValueError, TypeError)) as e_jax:
        jax_proj.make_projector(*args)
    with pytest.raises((ValueError, TypeError)) as e_port:
        projection.make_projector(*args)
    assert type(e_port.value) is type(e_jax.value)
    assert str(e_port.value) == str(e_jax.value)


def test_volume_rank_is_checked():
    with pytest.raises(ValueError, match=r"volume must be \(Z, Y, X\)"):
        projection.make_projector("max")(torch.zeros(4, 4))
    assert set(projection.METHODS.items()) == set(jax_proj.METHODS.items())
