"""The port's exact percentile normalize against the JAX package's as it
runs under ``jax.jit`` (``make_frame_inferrer`` jits it), bit for bit.

``torch.quantile`` differed from the jitted ``jnp.percentile`` on 24 of
200 quantiles of gamma slices and refuses slices of more than 2^24
values; ``ops.normalize.percentile_linear`` sorts once and applies JAX's
linear method: q = p / 100 folded exactly, the position q * (f32(n) - 1),
the two order statistics, and ``low * (1 - w) + high * w`` with the first
product fused into the sum as XLA's CPU backend emits it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequitr_tpu.ops import normalize as jax_norm
from sequitr_tpu_torch.ops import illumination
from sequitr_tpu_torch.ops import normalize as torch_norm


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_lohi(x, qs, channel_axis=False):
    flat = x.reshape(-1, x.shape[-1]) if channel_axis else x.reshape(-1, 1)
    fn = jax.jit(lambda f: jnp.stack([jnp.percentile(f, q, axis=0) for q in qs]))
    return np.asarray(fn(jnp.asarray(flat, jnp.float32)))


def _jax_normalize(x, p_lo=5.0, p_hi=99.5, channel_axis=False):
    fn = jax.jit(lambda v: jax_norm.percentile_normalize(v, p_lo, p_hi, channel_axis=channel_axis))
    return np.asarray(fn(jnp.asarray(x)))


def test_gamma_slices_bit_equal():
    """100 gamma slices of 1e3-2e5 values (sizes drawn from a seed) at q 5
    and 99.5: every quantile equal to the jitted jnp.percentile."""
    rng = np.random.default_rng(0)
    sizes = rng.integers(1000, 200_000, 100)
    for i, n in enumerate(sizes):
        x = rng.gamma(2.0, 100.0, int(n)).astype(np.float32)
        got = torch_norm.percentile_linear(torch.from_numpy(x).reshape(-1, 1), (5.0, 99.5))[:, 0].numpy()
        np.testing.assert_array_equal(got, _jax_lohi(x, (5.0, 99.5))[:, 0], err_msg=f"slice {i}, n={n}")


@pytest.mark.parametrize("shape,channel_axis", [((256, 256), False), ((97, 61), False), ((48, 40, 3), True),
                                                ((6, 40, 44), False)])
def test_normalized_frames_bit_equal(shape, channel_axis):
    rng = np.random.default_rng(sum(shape))
    scale = (1 + 9 * rng.random(shape[-1:])) if channel_axis else 1.0
    x = (rng.gamma(2.0, 60.0, shape) * scale).astype(np.float32)
    got = torch_norm.percentile_normalize(torch.from_numpy(x), 5.0, 99.5, channel_axis=channel_axis).numpy()
    np.testing.assert_array_equal(got, _jax_normalize(x, channel_axis=channel_axis))
    got2 = torch_norm.percentile_normalize(torch.from_numpy(x), 2.0, 98.0, channel_axis=channel_axis).numpy()
    np.testing.assert_array_equal(got2, _jax_normalize(x, 2.0, 98.0, channel_axis=channel_axis))


@pytest.mark.parametrize("n", [1, 2, 3, 20, 21, 101, 200, 201, 1001, 2001, 4097])
def test_ulp_positions(n):
    """Counts where q * (n - 1) lands on or an ulp beside an integer (the
    eager JAX path multiplies by 0.01 and picks other neighbours), at the
    serving percentiles and at a spread of others."""
    rng = np.random.default_rng(n)
    x = rng.gamma(2.0, 100.0, n).astype(np.float32)
    qs = (0.0, 1.0, 5.0, 25.0, 50.0, 75.0, 99.0, 99.5, 100.0, 33.3, 0.1)
    got = torch_norm.percentile_linear(torch.from_numpy(x).reshape(-1, 1), qs)[:, 0].numpy()
    np.testing.assert_array_equal(got, _jax_lohi(x, qs)[:, 0])


def test_one_and_two_value_slices():
    for vals in ([7.5], [3.0, 11.0], [-2.0, -2.0], [0.0, 1e-30]):
        x = np.asarray(vals, np.float32)
        got = torch_norm.percentile_linear(torch.from_numpy(x).reshape(-1, 1), (5.0, 99.5))[:, 0].numpy()
        np.testing.assert_array_equal(got, _jax_lohi(x, (5.0, 99.5))[:, 0])
        img = np.broadcast_to(x, (3, len(vals))).copy()
        np.testing.assert_array_equal(torch_norm.percentile_normalize(torch.from_numpy(img)).numpy(), _jax_normalize(img))


def test_nan_slice_gives_nan_like_jax():
    x = np.arange(50, dtype=np.float32).reshape(50, 1).repeat(2, axis=1)
    x[7, 1] = np.nan
    got = torch_norm.percentile_linear(torch.from_numpy(x), (5.0, 50.0))
    want = _jax_lohi(x, (5.0, 50.0), channel_axis=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert np.isnan(got[:, 1].numpy()).all() and np.isfinite(got[:, 0].numpy()).all()


def test_slice_past_2_24_values():
    """A (2^24 + 1)-value slice (64 MB of f32): torch.quantile refuses it;
    the sort-based path runs and equals the jitted jnp.percentile (f32(n)
    rounds 2^24 + 1 down to 2^24, as in JAX)."""
    n = 2**24 + 1
    rng = np.random.default_rng(24)
    x = rng.gamma(2.0, 100.0, n).astype(np.float32)
    with pytest.raises(RuntimeError):
        torch.quantile(torch.from_numpy(x), 0.05)
    got = torch_norm.percentile_linear(torch.from_numpy(x).reshape(-1, 1), (5.0, 99.5))[:, 0].numpy()
    np.testing.assert_array_equal(got, _jax_lohi(x, (5.0, 99.5))[:, 0])
    out = torch_norm.percentile_normalize(torch.from_numpy(x)[:4096], 5.0, 99.5).numpy()
    np.testing.assert_array_equal(out, _jax_normalize(x[:4096]))


def _median_linear_before(x, dim=0):
    """``_median_linear`` as it stood before it became a call of
    ``percentile_linear``: the regression reference."""
    n = x.shape[dim]
    q = np.float32(0.5) * np.float32(n - 1)
    low, high = int(np.floor(q)), int(np.ceil(q))
    high_w = np.float32(q - np.float32(low))
    low_w = np.float32(1.0) - high_w
    ordered = torch.sort(x, dim=dim).values
    lo = ordered.narrow(dim, low, 1).squeeze(dim)
    hi = ordered.narrow(dim, high, 1).squeeze(dim)
    return lo * float(low_w) + hi * float(high_w)


@pytest.mark.parametrize("shape", [(47 * 63, 1), (64 * 64, 3), (1, 2), (2, 1), (9, 4), (1000, 2)])
def test_median_linear_unchanged(shape):
    rng = np.random.default_rng(shape[0])
    x = torch.from_numpy(rng.gamma(2.0, 100.0, shape).astype(np.float32))
    np.testing.assert_array_equal(illumination._median_linear(x, 0).numpy(), _median_linear_before(x, 0).numpy())
    np.testing.assert_array_equal(illumination._median_linear(x, 0).numpy(), _jax_lohi(x.numpy(), (50.0,), True)[0])
