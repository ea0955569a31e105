"""The port's volume inference against ``sequitr_tpu.pipeline.infer`` run op
by op (``jit=False``) on the same numpy volumes and weights: the 3D
inferrer (whole-volume and tiled, symmetric edge pad on odd sizes, TTA
1/2/4/8, polyphase), the 3D denoiser, and the volume normalize, whose lo,
scale and quantiles are bit-equal to ``pallas_quantiles(...,
interpret=True)`` over the whole (Z, H, W) volume as one slice."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequitr_tpu.models import convert as jax_convert
from sequitr_tpu.models import unet as jax_unet
from sequitr_tpu.ops import normalize as jax_norm
from sequitr_tpu.ops.pallas import histogram as jax_hist
from sequitr_tpu.pipeline import infer as jax_infer
from sequitr_tpu_torch.models import convert as torch_convert
from sequitr_tpu_torch.models import unet as torch_unet
from sequitr_tpu_torch.ops.kernels import histogram as torch_hist
from sequitr_tpu_torch.pipeline import infer as torch_infer

QS = [0.05, 0.995]


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pair(seed, num_classes=3, in_channels=1):
    """A depth-2 f32 3D U-Net with BN (non-trivial biases and statistics,
    so no logits tie), as JAX pytrees and as the port's folded model."""
    cfg = jax_unet.UNetConfig(
        dims=3, depth=2, base_features=4, num_classes=num_classes,
        in_channels=in_channels, compute_dtype=jnp.float32,
    )
    params, state = jax_unet.init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed + 1)
    params = jax.tree.map(lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32), params)
    state = jax.tree.map(lambda a: a + 0.1 * rng.random(a.shape).astype(np.float32), state)
    flat = jax_convert.flatten_params(params)
    flat.update({f"state/{k}": v for k, v in jax_convert.flatten_params(state).items()})
    tcfg = torch_unet.UNetConfig(**{**dataclasses.asdict(cfg), "compute_dtype": "float32"})
    model = torch_convert.load_flat(tcfg, flat, device="cpu")
    return cfg, params, state, tcfg, model


@pytest.fixture(scope="module")
def seg3d():
    return _pair(seed=3)


def _clear(probs: np.ndarray, margin=1e-4) -> np.ndarray:
    top2 = np.sort(probs, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > margin


# (volume, patch, overlap, tta, polyphase): whole volume, an odd volume
# padded (symmetric) up to the patch, tiled grids, every 3D TTA group
CASES = {
    "whole": ((8, 16, 20), (8, 16, 20), (0, 0, 0), 1, False),
    "odd padded": ((7, 13, 18), (8, 16, 20), (0, 0, 0), 1, False),
    "tiled": ((7, 13, 18), (4, 8, 8), (2, 4, 4), 1, False),
    "tta2": ((8, 16, 20), (8, 16, 20), (0, 0, 0), 2, False),
    "tta4 tiled": ((7, 13, 18), (4, 8, 8), (0, 2, 2), 4, False),
    "tta8": ((6, 12, 12), (4, 12, 12), (2, 0, 0), 8, False),
    "polyphase whole": ((8, 16, 20), (8, 16, 20), (0, 0, 0), 1, True),
    "polyphase tiled odd": ((7, 13, 18), (4, 8, 8), (2, 4, 4), 2, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_volume_inferrer_matches_jax(seg3d, case):
    shape, patch, overlap, tta, poly = CASES[case]
    cfg, params, state, tcfg, model = seg3d
    vol = np.random.default_rng(len(case)).gamma(2.0, 50.0, shape).astype(np.float32)
    kw = dict(patch=patch, overlap=overlap, tta=tta, polyphase=poly)
    jprobs, jlabels = jax_infer.make_frame_inferrer(
        cfg, jax_infer.TileConfig(**kw), shape, jit=False
    )(params, state, jnp.asarray(vol))
    # the server serves folded models; polyphase needs them folded
    served = torch_unet.fold_batchnorm(model) if poly else model
    probs, labels = torch_infer.make_frame_inferrer(
        tcfg, torch_infer.TileConfig(**kw), shape, device="cpu"
    )(served, vol)
    jprobs = np.asarray(jprobs)
    assert probs.shape == jprobs.shape == shape + (3,)
    assert np.max(np.abs(probs.numpy() - jprobs)) < 1e-5
    clear = _clear(jprobs)
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(labels.numpy()[clear], np.asarray(jlabels)[clear])


def test_labels_only_volume_matches(seg3d):
    """``emit_probs=False``, whole volume: argmax of logits (no softmax)."""
    cfg, params, state, tcfg, model = seg3d
    vol = np.random.default_rng(9).gamma(2.0, 50.0, (8, 16, 16)).astype(np.uint16)
    kw = dict(patch=(8, 16, 16), overlap=(0, 0, 0))
    jprobs, jlabels = jax_infer.make_frame_inferrer(
        cfg, jax_infer.TileConfig(**kw), vol.shape, jit=False
    )(params, state, jnp.asarray(vol))
    probs, labels = torch_infer.make_frame_inferrer(
        tcfg, torch_infer.TileConfig(emit_probs=False, labels_dtype="uint16", **kw),
        vol.shape, device="cpu",
    )(torch_unet.fold_batchnorm(model), torch.from_numpy(vol.astype(np.int32)).to(torch.uint16))
    assert probs is None and labels.dtype == torch.uint16
    clear = _clear(np.asarray(jprobs))
    np.testing.assert_array_equal(labels.numpy().astype(np.int64)[clear], np.asarray(jlabels)[clear])


def test_tta_variants_3d_match_jax():
    for tta in (1, 2, 4, 8):
        assert torch_infer._tta_variants(3, tta, (3, 8, 9)) == jax_infer._tta_variants(3, tta, (3, 8, 9))
        assert torch_infer._tta_variants(2, tta, (8, 8)) == jax_infer._tta_variants(2, tta, (8, 8))


@pytest.mark.parametrize("shape", [(4, 32, 64), (3, 17, 29), (32, 16, 16)])
def test_volume_normalize_bit_equal_to_pallas(shape):
    """A (Z, H, W) volume is ONE slice of Z*H*W values: lo, scale and the
    quantiles bit-equal to ``pallas_quantiles`` on the volume folded into
    rows (as ``percentile_normalize_pallas`` folds it), and the
    normalized volume through ``infer._normalize`` in ``pallas`` mode equal
    to the JAX package's to f32 rounding."""
    vol = np.random.default_rng(sum(shape)).gamma(2.0, 100.0, shape).astype(np.float32)
    rows = vol.reshape(-1, shape[-1])
    want_q = np.asarray(jax_hist.pallas_quantiles(jnp.asarray(rows), QS, interpret=True))
    xj = jnp.asarray(vol)
    want_lo = np.float32(jnp.min(xj))
    want_scale = np.float32(1023 / jnp.maximum(jnp.max(xj) - jnp.min(xj), 1e-20))
    lo, scale, counts, q = torch_hist.quantile_pass(torch.from_numpy(vol.reshape(1, -1)), QS)
    np.testing.assert_array_equal(lo.numpy(), [want_lo])
    np.testing.assert_array_equal(scale.numpy(), [want_scale])
    np.testing.assert_array_equal(q[0].numpy(), want_q)
    assert int(counts.sum()) == vol.size
    tc = torch_infer.TileConfig(normalize="pallas")
    got = torch_infer._normalize(torch.from_numpy(vol)[None, ..., None], tc)[0, ..., 0]
    want = np.asarray(jax_norm.percentile_normalize_pallas(vol, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_volume_normalize_two_channels_and_frames():
    """Multi-channel volumes give one slice per channel, and a batch of
    volumes one slice per (volume, channel) pair, in one pass."""
    rng = np.random.default_rng(21)
    vols = rng.gamma(2.0, 1.0, (2, 4, 16, 24, 2)).astype(np.float32)
    vols[..., 1] *= 300.0
    tc = torch_infer.TileConfig(normalize="pallas")
    got = torch_infer._normalize(torch.from_numpy(vols), tc).numpy()
    for b in range(2):
        want = np.asarray(
            jax_norm.percentile_normalize_pallas(vols[b], interpret=True, channel_axis=True)
        )
        np.testing.assert_allclose(got[b], want, atol=1e-6)


@pytest.fixture(scope="module")
def n2v3d():
    return _pair(seed=5, num_classes=1)


@pytest.mark.parametrize(
    "patch,overlap,tta,poly",
    [((8, 16, 16), (0, 0, 0), 1, False), ((4, 8, 8), (2, 4, 4), 8, False), ((4, 8, 8), (2, 4, 4), 2, True)],
)
def test_volume_denoiser_matches_jax(n2v3d, patch, overlap, tta, poly):
    cfg, params, state, tcfg, model = n2v3d
    vol = np.random.default_rng(7).random((8, 16, 16)).astype(np.float32)
    kw = dict(patch=patch, overlap=overlap, tta=tta, polyphase=poly, normalize="none")
    want = np.asarray(jax_infer.make_denoiser(cfg, jax_infer.TileConfig(**kw), vol.shape)(
        params, state, jnp.asarray(vol)
    ))
    # the denoiser folds the model's batch norm itself, as the JAX one does
    got = torch_infer.make_denoiser(tcfg, torch_infer.TileConfig(**kw), vol.shape, device="cpu")(
        model, vol
    )
    assert got.shape == want.shape == (8, 16, 16, 1) and got.dtype == torch.float32
    assert np.max(np.abs(got.numpy() - want)) < 1e-4
