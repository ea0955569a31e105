"""The port's streaming histogram against the Pallas kernel (interpret mode).

Same pixels, made with numpy from seeds, through
``sequitr_tpu.ops.pallas.histogram`` (the TPU kernel, run by the Pallas
interpreter on the CPU) and ``sequitr_tpu_torch.ops.kernels.histogram``
(on a CPU tensor: the kernel's plain PyTorch version). Counts must be
integer-equal; quantiles and normalized frames agree to f32 rounding.
The CUDA kernel itself is held against the same plain version on the card
by ``chip_smoke.py``.
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
    np.testing.assert_allclose(got, want, rtol=1e-6)


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
