"""The port's PSF builders, ``psf_convolve`` and Richardson-Lucy against
``sequitr_tpu.psf`` on the same numpy inputs, mirroring
``tests/test_misc.py::TestPSF``.

Bars: the kernels within 1e-7 (two ``exp`` implementations, values <= 1);
``psf_convolve`` within 1e-6 of the output's largest value. Richardson-Lucy
runs 20 iterations of two FFT round trips each through a different CPU FFT
library on each side; measured gaps, relative to the output's largest
value: 7.7e-7 (128x128) and 8.3e-7 (16x64x64) against the jitted JAX
function, 7.6e-7 and 7.0e-7 against a float64 numpy Richardson-Lucy, and
JAX itself lands 6.5e-7 and 5.9e-7 from the float64 one. Held at
``RL_REL`` = 2e-6 on both sides: neither library is nearer the float64
result than the other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequitr_tpu import psf as jax_psf
from sequitr_tpu_torch import psf

RL_REL = 2e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _rl64(img, kernel, iterations, eps=1e-6):
    """Richardson-Lucy in float64 numpy: the same padding, roll and
    mirror, no f32 rounding anywhere."""
    shape = img.shape
    axes = tuple(range(img.ndim))

    def otf(k):
        pad = np.zeros(shape)
        pad[tuple(slice(0, s) for s in k.shape)] = k
        return np.fft.rfftn(np.roll(pad, [-(s // 2) for s in k.shape], axis=axes), axes=axes)

    h, hm = otf(kernel), otf(np.flip(kernel))
    img = np.maximum(img, 0.0)
    est = np.full(shape, img.mean() + eps)
    for _ in range(iterations):
        conv = np.fft.irfftn(np.fft.rfftn(est, axes=axes) * h, s=shape, axes=axes)
        est = est * np.fft.irfftn(np.fft.rfftn(img / np.maximum(conv, eps), axes=axes) * hm, s=shape, axes=axes)
    return est


def test_gaussian_psf_2d_matches_jax():
    for size, sigma in ((15, 2.0), (9, 1.5), (5, 1.0)):
        k = psf.gaussian_psf_2d(size, sigma, "cpu")
        want = np.asarray(jax_psf.gaussian_psf_2d(size, sigma))
        np.testing.assert_allclose(k.numpy(), want, atol=1e-7, rtol=0)
        np.testing.assert_allclose(float(k.sum()), 1.0, rtol=1e-6)
        assert np.unravel_index(int(k.argmax()), k.shape) == (size // 2, size // 2)


def test_gaussian_psf_3d_matches_jax():
    k = psf.gaussian_psf_3d(9, 5, 1.5, 2.5, "cpu")
    assert k.shape == (5, 9, 9)
    np.testing.assert_allclose(float(k.sum()), 1.0, rtol=1e-5)
    np.testing.assert_allclose(k.numpy(), np.asarray(jax_psf.gaussian_psf_3d(9, 5, 1.5, 2.5)), atol=1e-7, rtol=0)


def test_sigma_from_na():
    s = psf.gaussian_sigma_from_na(510.0, 1.4, 65.0)
    assert s == jax_psf.gaussian_sigma_from_na(510.0, 1.4, 65.0)
    assert 1.0 < s < 1.3


@pytest.mark.parametrize("shape,ksize", [((32, 32), (9, 9)), ((33, 40), (7, 7)), ((8, 20, 24), (3, 5, 5))])
def test_psf_convolve_matches_jax(shape, ksize):
    rng = np.random.default_rng(sum(shape))
    img = rng.gamma(2.0, 50.0, shape).astype(np.float32)
    kernel = rng.random(ksize).astype(np.float32)
    kernel /= kernel.sum()
    want = np.asarray(jax_psf.psf_convolve(jnp.asarray(img), jnp.asarray(kernel)))
    got = psf.psf_convolve(torch.from_numpy(img), torch.from_numpy(kernel)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(), rtol=0)


def test_psf_convolve_preserves_mass_and_centre():
    img = torch.zeros(32, 32)
    img[16, 16] = 100.0
    out = psf.psf_convolve(img, psf.gaussian_psf_2d(9, 1.5, "cpu"))
    np.testing.assert_allclose(float(out.sum()), 100.0, rtol=1e-4)
    assert np.unravel_index(int(out.argmax()), out.shape) == (16, 16)


def test_psf_convolve_batches_leading_axes():
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.random((3, 24, 28)).astype(np.float32))
    k = psf.gaussian_psf_2d(7, 1.2, "cpu")
    batched = psf.psf_convolve(img, k)
    for i in range(3):
        np.testing.assert_allclose(batched[i].numpy(), psf.psf_convolve(img[i], k).numpy(), atol=1e-5)


@pytest.mark.parametrize("case", ["2d", "3d"])
def test_richardson_lucy_matches_jax_and_float64(case):
    rng = np.random.default_rng(0 if case == "2d" else 1)
    if case == "2d":
        x = rng.gamma(2.0, 100.0, (128, 128)).astype(np.float32)
        kj, kt = jax_psf.gaussian_psf_2d(9, 1.5), psf.gaussian_psf_2d(9, 1.5, "cpu")
    else:
        x = rng.gamma(2.0, 100.0, (16, 64, 64)).astype(np.float32)
        kj, kt = jax_psf.gaussian_psf_3d(9, 5, 1.5, 3.0), psf.gaussian_psf_3d(9, 5, 1.5, 3.0, "cpu")
    want = np.asarray(jax.jit(lambda v: jax_psf.richardson_lucy(v, kj, 20))(jnp.asarray(x)))
    got = psf.richardson_lucy(torch.from_numpy(x), kt, 20).numpy()
    ref = _rl64(x.astype(np.float64), kt.numpy().astype(np.float64), 20)
    scale = np.abs(ref).max()
    assert np.abs(got - want).max() / scale <= RL_REL
    assert np.abs(got - ref).max() / scale <= RL_REL
    assert np.abs(want - ref).max() / scale <= RL_REL


def test_richardson_lucy_sharpens():
    img = torch.zeros(32, 32)
    img[16, 16] = 100.0
    k = psf.gaussian_psf_2d(9, 2.0, "cpu")
    blurred = psf.psf_convolve(img, k)
    deconv = psf.richardson_lucy(blurred, k, iterations=30)
    assert float(deconv.max()) > float(blurred.max()) * 2


def test_richardson_lucy_frame_per_channel():
    """(H, W, C): each channel equals that channel deconvolved alone (bit
    for bit), and holds the JAX package's vmapped channels at RL_REL."""
    rng = np.random.default_rng(9)
    x = rng.gamma(2.0, 60.0, (40, 36, 3)).astype(np.float32)
    kt, kj = psf.gaussian_psf_2d(9, 1.2, "cpu"), jax_psf.gaussian_psf_2d(9, 1.2)
    got = psf.richardson_lucy_frame(torch.from_numpy(x), kt, 6).numpy()
    assert got.shape == x.shape
    for c in range(3):
        np.testing.assert_array_equal(got[..., c], psf.richardson_lucy_frame(torch.from_numpy(x[..., c]), kt, 6).numpy())
    want = np.asarray(jax.jit(lambda v: jax_psf.richardson_lucy_frame(v, kj, 6))(jnp.asarray(x)))
    assert np.abs(got - want).max() / np.abs(want).max() <= RL_REL


def test_richardson_lucy_clamps_negative_input_and_batches():
    rng = np.random.default_rng(4)
    x = (rng.random((2, 20, 20)) - 0.3).astype(np.float32)
    k = psf.gaussian_psf_2d(5, 1.0, "cpu")
    batched = psf.richardson_lucy(torch.from_numpy(x), k, 4).numpy()
    want = np.stack([np.asarray(jax_psf.richardson_lucy(jnp.asarray(f), jax_psf.gaussian_psf_2d(5, 1.0), 4)) for f in x])
    assert np.isfinite(batched).all()
    assert np.abs(batched - want).max() / np.abs(want).max() <= RL_REL
