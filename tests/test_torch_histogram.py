"""The port's quantile pass against the Pallas kernel (interpret mode).

Same pixels, made with numpy from seeds, through
``sequitr_tpu.ops.pallas.histogram`` (the TPU kernel, run by the Pallas
interpreter on the CPU) and ``sequitr_tpu_torch.ops.kernels.histogram``
(on a CPU tensor: the kernels' plain PyTorch versions). Counts must be
integer-equal; lo, scale and quantiles bit-equal; normalized frames agree
to f32 rounding. The CUDA kernels themselves are held against the same
plain versions on the card by ``chip_smoke.py``, and rehearsed on the CPU
by ``test_torch_histogram_rehearsal.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequitr_tpu.ops import normalize as jax_norm
from sequitr_tpu.ops.pallas import histogram as jax_hist
from sequitr_tpu_torch.ops import normalize as torch_norm
from sequitr_tpu_torch.ops.kernels import histogram as torch_hist


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _lo_scale(x: np.ndarray, bins: int):
    lo = np.float32(x.min())
    scale = np.float32(bins - 1) / np.maximum(np.float32(x.max()) - lo, np.float32(1e-20))
    return lo, np.float32(scale)


@pytest.mark.parametrize(
    "shape,bins", [((16, 256), 1024), ((8, 512), 1024), ((8, 256), 4096), ((24, 256), 64)]
)
def test_counts_integer_equal(shape, bins):
    rng = np.random.default_rng(sum(shape) + bins)
    x = rng.gamma(2.0, 100.0, shape).astype(np.float32)
    lo, scale = _lo_scale(x, bins)
    want = np.asarray(
        jax_hist.histogram_2d(
            jnp.asarray(x), jnp.asarray(lo), jnp.asarray(scale), bins=bins,
            interpret=True,
        )
    )
    got = torch_hist.histogram_2d(
        torch.from_numpy(x.reshape(1, -1)),
        torch.tensor([lo]), torch.tensor([scale]), bins=bins,
    )
    assert got.dtype == torch.int32 and got.shape == (1, bins)
    np.testing.assert_array_equal(got[0].numpy(), want.astype(np.int64))


def test_counts_per_slice_in_one_call():
    """Slices (channels, frames of a batch) each get their own lo/scale."""
    rng = np.random.default_rng(5)
    xs = [rng.gamma(2.0, s, (8, 256)).astype(np.float32) for s in (1.0, 50.0, 900.0)]
    los, scales, wants = [], [], []
    for x in xs:
        lo, scale = _lo_scale(x, 1024)
        los.append(lo)
        scales.append(scale)
        wants.append(
            np.asarray(
                jax_hist.histogram_2d(
                    jnp.asarray(x), jnp.asarray(lo), jnp.asarray(scale),
                    interpret=True,
                )
            )
        )
    got = torch_hist.histogram_2d(
        torch.from_numpy(np.stack([x.reshape(-1) for x in xs])),
        torch.tensor(los), torch.tensor(scales),
    )
    np.testing.assert_array_equal(got.numpy(), np.stack(wants).astype(np.int64))


def test_wrapper_checks_inputs():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError):
        torch_hist.histogram_2d(x, torch.zeros(3), torch.ones(2))
    with pytest.raises(TypeError):
        torch_hist.histogram_2d(x.double(), torch.zeros(2), torch.ones(2))
    with pytest.raises(ValueError):
        torch_hist.histogram_2d(x.to("meta"), torch.zeros(2), torch.ones(2))


def test_cpu_tensors_never_count_launches():
    before = torch_hist.histogram_2d.launches
    torch_hist.kernel_quantiles(torch.rand(1, 100), [0.5])
    assert torch_hist.histogram_2d.launches == before


# the cases of tests/test_pallas.py: padded rows, ragged and wide widths
@pytest.mark.parametrize(
    "shape", [(256, 256), (100, 128), (8, 257), (8, 480), (8, 640), (64, 1500), (64, 2048)]
)
def test_quantiles_match_pallas(shape):
    rng = np.random.default_rng(shape[0] * 7 + shape[1])
    x = rng.gamma(2.0, 100.0, shape).astype(np.float32)
    want = np.asarray(
        jax_hist.pallas_quantiles(jnp.asarray(x), [0.05, 0.995], interpret=True)
    )
    got = torch_hist.kernel_quantiles(
        torch.from_numpy(x.reshape(1, -1)), [0.05, 0.995]
    )[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_normalize_pallas_frame():
    rng = np.random.default_rng(2)
    x = rng.gamma(2.0, 80.0, (128, 256)).astype(np.float32)
    want = np.asarray(jax_norm.percentile_normalize_pallas(x, interpret=True))
    got = torch_norm.percentile_normalize_pallas(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_normalize_pallas_volume():
    """(Z, H, W) volumes fold into one slice of the same pixel multiset."""
    rng = np.random.default_rng(6)
    vol = rng.gamma(2.0, 1.0, (4, 32, 64)).astype(np.float32)
    want = np.asarray(jax_norm.percentile_normalize_pallas(vol, interpret=True))
    got = torch_norm.percentile_normalize_pallas(torch.from_numpy(vol)).numpy()
    assert got.shape == vol.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_normalize_pallas_two_channels():
    rng = np.random.default_rng(11)
    x = np.stack(
        [rng.gamma(2.0, 1.0, (32, 64)), rng.gamma(2.0, 500.0, (32, 64))], axis=-1
    ).astype(np.float32)
    want = np.asarray(
        jax_norm.percentile_normalize_pallas(x, interpret=True, channel_axis=True)
    )
    got = torch_norm.percentile_normalize_pallas(
        torch.from_numpy(x), channel_axis=True
    ).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, want, atol=1e-6)


def _jax_lo_scale(x: np.ndarray, bins: int = 1024):
    """lo and scale as ``pallas_quantiles`` computes them, in jnp."""
    xj = jnp.asarray(x)
    lo = jnp.min(xj)
    return np.float32(lo), np.float32((bins - 1) / jnp.maximum(jnp.max(xj) - lo, 1e-20))


def _hold_pass(x: np.ndarray, qs):
    """The port's lo, scale, counts and quantiles bit-equal to the JAX
    package's on one frame (one slice)."""
    lo, scale = _jax_lo_scale(x)
    want_q = np.asarray(jax_hist.pallas_quantiles(jnp.asarray(x), qs, interpret=True))
    want_counts = np.asarray(
        jax_hist.histogram_2d(
            jnp.asarray(x), jnp.asarray(lo), jnp.asarray(scale), interpret=True
        )
    ) if x.shape[0] % 8 == 0 and x.shape[1] % min(x.shape[1], 256) == 0 else None
    got_lo, got_scale, got_counts, got_q = torch_hist.quantile_pass(
        torch.from_numpy(x.reshape(1, -1)), qs
    )
    np.testing.assert_array_equal(got_lo.numpy(), [lo])
    np.testing.assert_array_equal(got_scale.numpy(), [scale])
    np.testing.assert_array_equal(got_q[0].numpy(), want_q)
    if want_counts is not None:
        np.testing.assert_array_equal(got_counts[0].numpy(), want_counts.astype(np.int64))
    return got_q[0].numpy()


# rng.gamma(2, 100, (64, 256)) with seed 98: PyTorch's 1023 / t (the
# tensor's reciprocal times 1023) is an ulp off jnp's quotient, and 3 pixels
# land in another bin under it
ULP_SEED = 98


def test_ulp_frame_scale_and_quantiles_bit_equal():
    x = np.random.default_rng(ULP_SEED).gamma(2.0, 100.0, (64, 256)).astype(np.float32)
    lo, scale = _jax_lo_scale(x)
    d = torch.tensor([np.float32(x.max()) - lo])
    assert float((1023 / d)[0]) != scale  # the fault this frame shows
    assert float(torch_hist.scale_of(torch.tensor([lo]), torch.tensor([np.float32(x.max())]), 1024)[0]) == scale
    _hold_pass(x, [0.05, 0.995])


def test_tie_frame_5th_percentile():
    """5 zeros and 95 values in [1, 100]: cum[0] / n = 5 / 100 is exactly
    f32(0.05), so bin 0 holds the 5th percentile; 5 * f32(1 / 100) would
    fall short of it and pick bin 10."""
    x = np.concatenate([np.zeros(5), np.linspace(1.0, 100.0, 95)]).astype(np.float32)
    x = x.reshape(10, 10)
    q = _hold_pass(x, [0.05, 0.995])
    lo, scale = _jax_lo_scale(x)
    assert q[0] == np.float32(np.float32(lo + np.float32(1) / scale) - np.float32(0.5) / scale)
    assert q[0] < 0.05


@pytest.mark.parametrize(
    "shape", [(256, 256), (100, 128), (8, 257), (8, 480), (8, 640), (64, 1500), (64, 2048)]
)
def test_quantile_pass_lo_scale_counts_bit_equal(shape):
    rng = np.random.default_rng(shape[0] * 7 + shape[1])
    x = rng.gamma(2.0, 100.0, shape).astype(np.float32)
    _hold_pass(x, [0.05, 0.5, 0.995])


def test_quantile_pass_slices_and_q_above_one():
    """Several slices in one call, each against the JAX package on its own;
    a q above 1 takes bin 0, as jnp's argmax of all-false does."""
    rng = np.random.default_rng(17)
    xs = [rng.gamma(2.0, s, (8, 256)).astype(np.float32) for s in (1.0, 50.0, 900.0)]
    qs = [0.02, 0.98, 1.5]
    lo, scale, counts, q = torch_hist.quantile_pass(
        torch.from_numpy(np.stack([x.reshape(-1) for x in xs])), qs
    )
    for i, x in enumerate(xs):
        want = np.asarray(jax_hist.pallas_quantiles(jnp.asarray(x), qs, interpret=True))
        np.testing.assert_array_equal(q[i].numpy(), want)
        np.testing.assert_array_equal([lo[i], scale[i]], _jax_lo_scale(x))
        assert int(counts[i].sum()) == x.size
    assert float(q[0, 2]) == float(q[0].min())


def test_scale_of_is_one_division():
    """scale_of divides once, correctly rounded, where 1023 / t does not."""
    rng = np.random.default_rng(4)
    d = (rng.random(20_000) * 1e4 + 1e-3).astype(np.float32)
    want = np.float32(1023) / d
    got = torch_hist.scale_of(torch.zeros(d.size), torch.from_numpy(d), 1024).numpy()
    np.testing.assert_array_equal(got, want)
    assert (1023 / torch.from_numpy(d)).numpy().tolist() != want.tolist()


def test_fast_path_ulp_frame_bit_equal():
    """The plain 4096-bin path (``histogram_quantiles``) on the ulp frame."""
    x = np.random.default_rng(ULP_SEED).gamma(2.0, 100.0, (64, 256)).astype(np.float32)
    flat = x.reshape(-1, 1)
    qs = [0.05, 0.995]
    for bins in (1024, 4096):
        want = np.asarray(
            jax_norm.histogram_quantiles(jnp.asarray(flat), jnp.asarray(qs, jnp.float32), bins)
        )
        got = torch_norm.histogram_quantiles(torch.from_numpy(flat), qs, bins).numpy()
        np.testing.assert_array_equal(got, want)
