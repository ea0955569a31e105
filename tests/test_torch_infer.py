"""The port's frame inference against the goldens and ``sequitr_tpu``'s
tiling and inferrer on the same numpy inputs and weights."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequitr_tpu.models import convert as jax_convert
from sequitr_tpu.models import unet as jax_unet
from sequitr_tpu.ops import tiling as jax_tiling
from sequitr_tpu.pipeline import infer as jax_infer
from sequitr_tpu_torch.models import convert as torch_convert
from sequitr_tpu_torch.models import fixtures as torch_fixtures
from sequitr_tpu_torch.models import unet as torch_unet
from sequitr_tpu_torch.ops import tiling as torch_tiling
from sequitr_tpu_torch.pipeline import infer as torch_infer

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "unet2d_infer.npz")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _labels_close(got, want, frac=0.002):
    flips = np.mean(np.asarray(got) != np.asarray(want))
    assert flips <= frac, f"label flip fraction {flips:.4%} > {frac:.2%}"


@pytest.fixture(scope="module")
def small_pair():
    """A depth-2 f32 U-Net with BN, as JAX pytrees and as the port's model."""
    cfg = jax_unet.UNetConfig(depth=2, base_features=4, compute_dtype=jnp.float32)
    params, state = jax_unet.init(jax.random.PRNGKey(4), cfg)
    flat = jax_convert.flatten_params(params)
    flat.update({f"state/{k}": v for k, v in jax_convert.flatten_params(state).items()})
    tcfg = torch_unet.UNetConfig(**{**dataclasses.asdict(cfg), "compute_dtype": "float32"})
    model = torch_unet.fold_batchnorm(torch_convert.load_flat(tcfg, flat, device="cpu"))
    return cfg, params, state, tcfg, model


@pytest.mark.parametrize("tiled", [False, True])
def test_unet2d_golden(tiled):
    """tests/goldens/unet2d_infer.npz (the fixture at its bf16 compute
    dtype): at most 0.2% label flips; 99.9% of probs within 5e-3, all
    within 1.5e-2.

    The golden holds the JAX package's jitted CPU numerics, in which XLA
    drops the bf16 rounding of each conv's output (the convert to f32 that
    follows it cancels it). The port rounds where ``unet.py`` says, as
    cuDNN does on the card; ``unet.apply`` run without jit rounds there
    too and misses the golden by the same margin (47 of 49,152 values over
    5e-3, max 1.2e-2, on the CPU). That rounding point is held tightly by
    ``test_torch_unet.py::test_unet2d_cells_bf16_rounds_where_unet_py_does``:
    each of the fixture's 18 convs bit-equal to unet.py's on >= 99.97% of
    its outputs, the rest one bf16 step apart, where a conv without the
    rounding is bit-equal on <= 0.2%. A real semantic change (padding,
    fold, stitch weights) moves outputs far beyond either bar.
    """
    g = np.load(GOLDEN)
    _, cfg, model, _ = torch_fixtures.load("unet2d_cells", device="cpu")
    model = torch_unet.fold_batchnorm(model)
    if tiled:
        tc = torch_infer.TileConfig(patch=(96, 96), overlap=(32, 32), normalize="exact")
    else:
        tc = torch_infer.TileConfig(patch=(128, 128), overlap=(0, 0), normalize="exact")
    probs, labels = torch_infer.make_frame_inferrer(cfg, tc, (128, 128), device="cpu")(
        model, g["image"]
    )
    suffix = "_tiled" if tiled else ""
    _labels_close(labels.numpy(), g["labels" + suffix])
    err = np.abs(probs.numpy() - g["probs" + suffix])
    assert np.quantile(err, 0.999) <= 5e-3
    assert err.max() <= 1.5e-2


@pytest.mark.parametrize("window", ["hann", "tri", "flat"])
def test_extract_and_stitch_match_jax(window):
    rng = np.random.default_rng(7)
    img = rng.random((70, 90, 3)).astype(np.float32)
    grid = torch_tiling.tile_grid((70, 90), (32, 40), (8, 12))
    assert grid == jax_tiling.tile_grid((70, 90), (32, 40), (8, 12))
    got = torch_tiling.extract_patches(torch.from_numpy(img), grid, (32, 40))
    want = np.asarray(jax_tiling.extract_patches(jnp.asarray(img), grid, (32, 40)))
    np.testing.assert_array_equal(got.numpy(), want)
    patches = rng.random(want.shape).astype(np.float32)
    got_s = torch_tiling.stitch_patches(torch.from_numpy(patches), grid, (70, 90), (8, 12), window)
    want_s = np.asarray(jax_tiling.stitch_patches(jnp.asarray(patches), grid, (70, 90), (8, 12), window))
    np.testing.assert_allclose(got_s.numpy(), want_s, atol=1e-6)


@pytest.mark.parametrize("seed", range(4))
def test_field_round_trip(seed):
    """Extract -> stitch reproduces the field for any frame/patch/overlap
    (the invariant the blend is built on), as the JAX stitch does."""
    rng = np.random.default_rng(200 + seed)
    ph, pw = (int(v) for v in rng.choice([8, 16, 24], 2))
    h, w = ph + int(rng.integers(0, 33)), pw + int(rng.integers(0, 33))
    ov = (int(rng.integers(0, ph // 2 + 1)), int(rng.integers(0, pw // 2 + 1)))
    grid = torch_tiling.tile_grid((h, w), (ph, pw), ov)
    field = rng.random((h, w, 3)).astype(np.float32)
    patches = torch_tiling.extract_patches(torch.from_numpy(field), grid, (ph, pw))
    out = torch_tiling.stitch_patches(patches, grid, (h, w), ov).numpy()
    want = np.asarray(
        jax_tiling.stitch_patches(jnp.asarray(patches.numpy()), grid, (h, w), ov)
    )
    np.testing.assert_allclose(out, field, atol=1e-5)
    np.testing.assert_allclose(out, want, atol=1e-6)


@pytest.mark.parametrize("shape", [(45, 37), (3, 4), (20, 7)])
@pytest.mark.parametrize("mode", ["symmetric", "edge"])
def test_trailing_pad_matches_numpy(shape, mode):
    """numpy's "symmetric" repeats the edge pixel (torch's "reflect" does
    not); pads up to the frame size on odd-sized frames."""
    rng = np.random.default_rng(1)
    x = rng.random((2,) + shape + (3,)).astype(np.float32)
    pads = tuple(min(s, 5) if mode == "symmetric" else 2 * s + 1 for s in shape)
    want = np.pad(x, [(0, 0)] + [(0, d) for d in pads] + [(0, 0)], mode=mode)
    got = torch_infer._pad_trailing(torch.from_numpy(x), pads, mode)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize(
    "frame_shape,tc_kw",
    [
        # odd frame smaller than the patch: symmetric mirror pad, then crop
        ((27, 21), dict(patch=(32, 32), overlap=(0, 0))),
        # less than half a patch on one axis: edge pad
        ((12, 31), dict(patch=(32, 32), overlap=(0, 0))),
        # tiled, with test-time augmentation over 4 flips
        ((40, 40), dict(patch=(24, 24), overlap=(8, 8), tta=4)),
        # labels-only single tile: the softmax-free path
        ((32, 32), dict(patch=(32, 32), overlap=(0, 0), emit_probs=False)),
    ],
)
def test_inferrer_matches_jax(small_pair, frame_shape, tc_kw):
    cfg, params, state, tcfg, model = small_pair
    frame = (np.random.default_rng(5).gamma(2.0, 100.0, frame_shape)).astype(np.float32)
    tc_j = jax_infer.TileConfig(normalize="fast", **tc_kw)
    tc_t = torch_infer.TileConfig(normalize="auto", **tc_kw)  # auto = fast on the CPU
    # op by op (jit=False): jitted whole, XLA's CPU backend picks other
    # conv numerics for some shapes (measured up to 1e-3 on these probs)
    probs_j, labels_j = jax_infer.make_frame_inferrer(cfg, tc_j, frame_shape, jit=False)(
        params, state, jnp.asarray(frame)
    )
    probs_t, labels_t = torch_infer.make_frame_inferrer(tcfg, tc_t, frame_shape, device="cpu")(
        model, frame
    )
    assert labels_t.shape == frame_shape
    if tc_kw.get("emit_probs", True):
        probs_j = np.asarray(probs_j)
        np.testing.assert_allclose(probs_t.numpy(), probs_j, atol=1e-5)
        # labels agree except where JAX's top two probabilities nearly tie
        top2 = np.sort(probs_j, axis=-1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > 1e-5
        np.testing.assert_array_equal(labels_t.numpy()[clear], np.asarray(labels_j)[clear])
        assert clear.mean() > 0.5
    else:
        assert probs_t is None and probs_j is None
        np.testing.assert_array_equal(labels_t.numpy(), np.asarray(labels_j))


def test_batch_inferrer_matches_single(small_pair):
    _, _, _, tcfg, model = small_pair
    frames = np.random.default_rng(8).integers(0, 4000, (3, 32, 32), dtype=np.uint16)
    tc = torch_infer.TileConfig(
        patch=(32, 32), overlap=(0, 0), labels_dtype="uint16", probs_dtype="float16"
    )
    probs_b, labels_b = torch_infer.cached_batch_inferrer(tcfg, tc, (32, 32), 3, "cpu")(
        model, torch.from_numpy(frames)
    )
    one = torch_infer.cached_frame_inferrer(tcfg, tc, (32, 32), "cpu")
    assert labels_b.dtype == torch.uint16 and probs_b.dtype == torch.float16
    for k in range(3):
        probs, labels = one(model, torch.from_numpy(frames[k]))
        assert torch.equal(labels_b[k], labels)
        torch.testing.assert_close(probs_b[k], probs, atol=1e-3, rtol=0)


def test_infer_stack_streams_in_order(small_pair):
    _, _, _, tcfg, model = small_pair
    frames = [np.full((32, 32), float(v), np.float32) + np.eye(32, dtype=np.float32) * v for v in (1, 5, 9, 2)]
    tc = torch_infer.TileConfig(patch=(32, 32), overlap=(0, 0), normalize="none")
    fn = torch_infer.make_frame_inferrer(tcfg, tc, (32, 32), device="cpu")
    results = list(torch_infer.infer_stack(fn, model, iter(frames), fetch_probs=True, device="cpu"))
    assert len(results) == 4
    for f, r in zip(frames, results):
        probs, labels = fn(model, f)
        np.testing.assert_array_equal(np.asarray(r.labels), labels.numpy())
        np.testing.assert_array_equal(np.asarray(r.probs), probs.numpy())
