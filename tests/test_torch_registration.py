"""``sequitr_tpu_torch.ops.registration`` against ``sequitr_tpu.ops.registration``
on the same inputs (CPU).

Bars: shifts within 1e-5 px, responses at rtol 1e-4, integer-mode
resamples byte-equal, the host helpers exact. Fourier resamples of values
~120 within 2e-4: each CPU FFT library (XLA's, PyTorch's) lands some
7e-5 from the float64 resample on its own, and the two errors are
independent. The committed ``register_step.npz`` golden holds at
``test_goldens.py``'s tolerances for the shift and the response; its
resampled frame is 1.1444e-4 from the port's on 1 of 9,216 pixels (bar
1e-4), so the port's frame is held within 1e-4 of the float64 resample of
the same input instead, and within 1.2e-4 of the golden bytes.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequitr_tpu.ops import registration as J
from sequitr_tpu_torch.data.synthetic import bandlimited_scene
from sequitr_tpu_torch.ops import registration as T

SHIFT_TOL = 1e-5
RESP_RTOL = 1e-4
RESAMPLE_TOL = 2e-4
GOLDEN_CORRECTED_GAP = 1.2e-4  # measured 1.1444e-4 (PyTorch 2.13 CPU FFT)
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "register_step.npz")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _scene(shape, seed):
    return bandlimited_scene(shape, np.random.default_rng(seed), sigma=0.12 if len(shape) == 3 else 0.08)


def _moved(base, shift):
    return np.array(J.apply_shift(jnp.asarray(base), jnp.asarray(shift, jnp.float32)))


SHAPES = {"2d": ((64, 80), [2.3, -1.7]), "3d": ((8, 32, 32), [0.6, 1.4, -0.9])}


@pytest.mark.parametrize("n", [7, 48, 64, 80, 96])
def test_hann_and_fftfreq(n):
    np.testing.assert_allclose(T.hann_window((n,)).numpy(), np.asarray(J.hann_window((n,))), atol=6e-8)
    np.testing.assert_array_equal(T._fftfreq(n, "cpu").numpy(), np.asarray(jnp.fft.fftfreq(n)))
    w2 = T.hann_window((n, 32)).numpy()
    np.testing.assert_allclose(w2, np.asarray(J.hann_window((n, 32))), atol=6e-8)


@pytest.mark.parametrize("dim", sorted(SHAPES))
def test_apply_shift_and_ramp(dim):
    shape, shift = SHAPES[dim]
    base = _scene(shape, 11)
    got = T.apply_shift(torch.from_numpy(base), torch.tensor(shift))
    np.testing.assert_allclose(got.numpy(), _moved(base, shift), atol=RESAMPLE_TOL)
    ramp_t = T._shift_ramp(shape, torch.tensor(shift)).numpy()
    ramp_j = np.asarray(J._shift_ramp(shape, jnp.asarray(shift, jnp.float32)))
    np.testing.assert_allclose(ramp_t, ramp_j, atol=2e-6)
    # batched: each item by its own shift
    batch = T.apply_shift(torch.from_numpy(np.stack([base, base])), torch.tensor([shift, [0.0] * len(shift)]))
    np.testing.assert_allclose(batch[0].numpy(), got.numpy(), atol=1e-6)
    np.testing.assert_allclose(batch[1].numpy(), base, atol=RESAMPLE_TOL)


@pytest.mark.parametrize("refine", [1, 2, 3])
@pytest.mark.parametrize("window", [True, False])
@pytest.mark.parametrize("subpixel", [True, False])
@pytest.mark.parametrize("dim", sorted(SHAPES))
def test_phase_correlate(dim, subpixel, window, refine):
    shape, shift = SHAPES[dim]
    base = _scene(shape, 12)
    mov = _moved(base, shift)
    kw = dict(subpixel=subpixel, window=window, refine=refine)
    sj, rj = J.phase_correlate(jnp.asarray(base), jnp.asarray(mov), **kw)
    st, rt = T.phase_correlate(torch.from_numpy(base), torch.from_numpy(mov), **kw)
    assert st.dtype == torch.float32 and st.shape == (len(shape),)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=SHIFT_TOL)
    np.testing.assert_allclose(float(rt), float(rj), rtol=RESP_RTOL)
    if subpixel and refine == 3 and dim == "2d":
        np.testing.assert_allclose(st.numpy(), -np.asarray(shift), atol=0.02)


@pytest.mark.parametrize("refine", [1, 2, 3])
@pytest.mark.parametrize("subpixel", [True, False])
@pytest.mark.parametrize("dim", sorted(SHAPES))
def test_register_step(dim, subpixel, refine):
    shape, shift = SHAPES[dim]
    base = _scene(shape, 13)
    frame = np.round(_moved(base, shift)).astype(np.uint16)
    cum0 = [0.25] * len(shape)
    aj = jnp.fft.fftn(jnp.asarray(base) * J.hann_window(shape))
    at = torch.fft.fftn(torch.from_numpy(base) * T.hann_window(shape))
    kw = dict(subpixel=subpixel, refine=refine)
    fj, cj, corr_j, step_j, rj = J.register_step(aj, jnp.asarray(frame), jnp.asarray(cum0, jnp.float32), **kw)
    ft, ct, corr_t, step_t, rt = T.register_step(at, torch.from_numpy(frame), torch.tensor(cum0), **kw)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=SHIFT_TOL)
    np.testing.assert_allclose(step_t.numpy(), np.asarray(step_j), atol=SHIFT_TOL)
    np.testing.assert_allclose(float(rt), float(rj), rtol=RESP_RTOL)
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-5, atol=2e-2)
    if subpixel:
        np.testing.assert_allclose(corr_t.numpy(), np.asarray(corr_j), atol=RESAMPLE_TOL)
    else:
        assert corr_t.dtype == torch.float32
        assert corr_t.numpy().tobytes() == np.asarray(corr_j).tobytes()
    _, _, none, _, _ = T.register_step(at, torch.from_numpy(frame), torch.tensor(cum0), resample=False)
    assert none is None


@pytest.mark.parametrize("resample", [True, False])
@pytest.mark.parametrize("subpixel", [True, False])
@pytest.mark.parametrize("dim", sorted(SHAPES))
def test_register_batch(dim, subpixel, resample):
    shape, shift = SHAPES[dim]
    base = _scene(shape, 14)
    frames = np.stack([_moved(base, [k * s for s in shift]) for k in range(3)])
    kw = dict(subpixel=subpixel, resample=resample)
    sj, rj, cj = J.register_batch(jnp.asarray(base), jnp.asarray(frames), **kw)
    st, rt, ct = T.register_batch(torch.from_numpy(base), torch.from_numpy(frames), **kw)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=SHIFT_TOL)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=RESP_RTOL)
    assert ct.shape == cj.shape
    if not resample:
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    elif subpixel:
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), atol=RESAMPLE_TOL)
    else:
        assert ct.numpy().tobytes() == np.asarray(cj).tobytes()
    # the batch equals the streaming step against the same reference
    at = torch.fft.fftn(torch.from_numpy(base) * T.hann_window(shape))
    for k in range(3):
        _, cum, _, _, resp = T.register_step(
            at, torch.from_numpy(frames[k]), torch.zeros(len(shape)), subpixel=subpixel, resample=False
        )
        np.testing.assert_allclose(cum.numpy(), st[k].numpy(), atol=1e-6)


def test_response_uses_population_std():
    rng = np.random.default_rng(3)
    surface = rng.normal(size=(12, 10)).astype(np.float32)
    surface[4, 7] = 9.0
    shift_t, resp_t = T._correlation_peak(torch.from_numpy(surface), True, 2)
    shift_j, resp_j = J._correlation_peak(jnp.asarray(surface), True)
    s64 = surface.astype(np.float64)
    want = (9.0 - s64.mean()) / s64.std()  # numpy's std is the population std
    bessel = (9.0 - s64.mean()) / s64.std(ddof=1)
    np.testing.assert_allclose(float(resp_t), want, rtol=1e-6)
    np.testing.assert_allclose(float(resp_t), float(resp_j), rtol=RESP_RTOL)
    assert abs(float(resp_t) - bessel) > 1e-3
    np.testing.assert_allclose(shift_t.numpy(), np.asarray(shift_j), atol=1e-6)


@pytest.mark.parametrize("subpixel", [True, False])
def test_first_maximum_wins_a_tie(subpixel):
    surface = np.zeros((8, 10), np.float32)
    surface[6, 1] = surface[2, 3] = surface[2, 8] = 5.0  # three equal peaks
    surface[1, 3], surface[3, 3], surface[2, 2], surface[2, 4] = 1.0, 2.0, 0.5, 3.0
    shift_t, resp_t = T._correlation_peak(torch.from_numpy(surface), subpixel, 2)
    shift_j, resp_j = J._correlation_peak(jnp.asarray(surface), subpixel)
    np.testing.assert_allclose(shift_t.numpy(), np.asarray(shift_j), atol=1e-6)
    assert np.round(shift_t.numpy()).tolist() == [2.0, 3.0]
    np.testing.assert_allclose(float(resp_t), float(resp_j), rtol=1e-6)
    # batched: each surface finds its own first maximum
    flipped = surface[:, ::-1].copy()
    shifts, _ = T._correlation_peak(torch.from_numpy(np.stack([surface, flipped])), subpixel, 2)
    np.testing.assert_allclose(shifts[0].numpy(), shift_t.numpy())
    want = np.asarray(J._correlation_peak(jnp.asarray(flipped), subpixel)[0])
    np.testing.assert_allclose(shifts[1].numpy(), want, atol=1e-6)


def test_flat_surface_gives_zero_shift():
    flat = np.full((6, 6), 2.0, np.float32)
    shift, resp = T._correlation_peak(torch.from_numpy(flat), True, 2)
    assert shift.tolist() == [0.0, 0.0] and float(resp) == 0.0
    base = _scene((32, 32), 15)
    s, _ = T.phase_correlate(torch.from_numpy(base), torch.from_numpy(base))
    np.testing.assert_allclose(s.numpy(), 0.0, atol=1e-5)


@pytest.mark.parametrize("case", ["wrapping", "smooth", "3d"])
def test_unwrap_and_common_crop(case):
    rng = np.random.default_rng(7)
    if case == "wrapping":
        shape = (64, 48)
        true = np.cumsum(rng.normal(0, 3, (30, 2)), 0) + [0, 40]
        shifts = (true + np.array(shape) / 2) % np.array(shape) - np.array(shape) / 2
    elif case == "smooth":
        shape = (64, 48)
        shifts = np.cumsum(rng.normal(0, 0.7, (20, 2)), 0)
    else:
        shape = (16, 32, 32)
        shifts = np.cumsum(rng.normal(0, 0.5, (6, 3)), 0)
    u_t = T.unwrap_trajectory(shifts, shape)
    u_j = J.unwrap_trajectory(shifts, shape)
    np.testing.assert_array_equal(u_t, u_j)
    if case != "wrapping":
        assert T.common_crop(u_t, shape) == J.common_crop(u_j, shape)
    with pytest.raises(ValueError, match="drift exceeds the frame"):
        T.common_crop(np.array([[0.0] * len(shape), [s + 1.0 for s in shape]]), shape)


def test_register_step_golden():
    """``test_goldens.py::test_register_step`` on the port, at its tolerances."""
    g = np.load(GOLDEN)
    rng = np.random.default_rng(80_001)
    f = np.fft.fft2(rng.normal(0, 1, (96, 96)))
    fy = np.fft.fftfreq(96)[:, None]
    fx = np.fft.fftfreq(96)[None, :]
    base = (np.fft.ifft2(f * np.exp(-(fy**2 + fx**2) / (2 * 0.08**2))).real * 50 + 120).astype(np.float32)
    mov = T.apply_shift(torch.from_numpy(base), torch.tensor([2.3, -1.7]))
    anchor = torch.fft.fftn(torch.from_numpy(base) * T.hann_window(base.shape))
    _, cum, corr, _, resp = T.register_step(anchor, mov, torch.zeros(2))
    np.testing.assert_allclose(cum.numpy(), g["shift"], atol=1e-5)
    np.testing.assert_allclose(np.float32(resp), g["response"], rtol=1e-4)
    np.testing.assert_allclose(corr.numpy(), g["corrected"], atol=GOLDEN_CORRECTED_GAP)
    spectrum = np.fft.fft2(mov.numpy().astype(np.float64))
    ramp = np.exp(-2j * np.pi * (fy * float(cum[0]) + fx * float(cum[1])))
    np.testing.assert_allclose(corr.numpy(), np.fft.ifft2(spectrum * ramp).real, atol=1e-4)
    f3 = np.fft.fftn(rng.normal(0, 1, (8, 32, 32)))
    grids = np.meshgrid(*[np.fft.fftfreq(n) for n in (8, 32, 32)], indexing="ij")
    r2 = sum(gr**2 for gr in grids)
    vol = (np.fft.ifftn(f3 * np.exp(-r2 / (2 * 0.12**2))).real * 50 + 120).astype(np.float32)
    vols = torch.stack([
        T.apply_shift(torch.from_numpy(vol), torch.tensor([0.4 * k, 0.9 * k, -0.6 * k])) for k in range(3)
    ])
    shifts3, resps3, _ = T.register_batch(torch.from_numpy(vol), vols, resample=False)
    np.testing.assert_allclose(shifts3.numpy(), g["shifts3"], atol=1e-5)
    np.testing.assert_allclose(resps3.numpy(), g["responses3"], rtol=1e-4)
