"""The port's exact and fast percentile normalize against the goldens and
``sequitr_tpu.ops.normalize`` on the same numpy inputs."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequitr_tpu.ops import normalize as jax_norm
from sequitr_tpu_torch.data import synthetic
from sequitr_tpu_torch.ops import normalize as torch_norm

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "normalize_quantiles.npz")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def golden():
    g = np.load(GOLDEN)
    img, _ = synthetic.cells_frame(70_001, (256, 256))
    return g, img


def test_exact_matches_golden(golden):
    g, img = golden
    x = torch.from_numpy(img)[..., None]
    flat = x.reshape(-1, 1)
    lohi = [torch.quantile(flat, q, dim=0).item() for q in (0.05, 0.995)]
    np.testing.assert_allclose(lohi, g["lohi_exact"], rtol=1e-6)
    out = torch_norm.percentile_normalize(x, 5.0, 99.5).numpy()
    np.testing.assert_allclose(out, g["normalized"], atol=1e-6)


def test_fast_quantiles_match_golden(golden):
    g, img = golden
    flat = torch.from_numpy(img).reshape(-1, 1)
    fast = torch_norm.histogram_quantiles(flat, [0.05, 0.995], bins=4096)[:, 0]
    np.testing.assert_allclose(fast.numpy(), g["lohi_fast"], rtol=1e-6)


@pytest.mark.parametrize("channel_axis", [False, True])
@pytest.mark.parametrize("path", ["exact", "fast"])
def test_matches_jax(path, channel_axis):
    rng = np.random.default_rng(3 + channel_axis)
    shape = (48, 40, 2) if channel_axis else (48, 40)
    x = (rng.gamma(2.0, 60.0, shape) * (1 + 9 * rng.random(shape[-1:]))).astype(np.float32)
    jax_fn = {"exact": jax_norm.percentile_normalize, "fast": jax_norm.percentile_normalize_fast}[path]
    torch_fn = {"exact": torch_norm.percentile_normalize, "fast": torch_norm.percentile_normalize_fast}[path]
    want = np.asarray(jax_fn(jnp.asarray(x), 2.0, 98.0, channel_axis=channel_axis))
    got = torch_fn(torch.from_numpy(x), 2.0, 98.0, channel_axis=channel_axis).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_uint16_frames_cast_like_jax():
    rng = np.random.default_rng(9)
    x = rng.integers(0, 65535, (32, 32), dtype=np.uint16)
    want = np.asarray(jax_norm.percentile_normalize_fast(jnp.asarray(x)))
    got = torch_norm.percentile_normalize_fast(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
