"""The training slice's ops against the JAX package: the augmentation's
apply on the reference's own draws (``augment_elastic.npz``, 2D and 3D),
the elastic field's bicubic against ``jax.image.resize``, the losses and
metrics, the first-tie max-pool gradient; and the two repairs of the
port's serving path: folds follow in-place weight updates, and float32
entry points run without TF32.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sequitr_tpu.data import synthetic
from sequitr_tpu.ops import augment as jax_aug
from sequitr_tpu.ops import losses as jax_losses
from sequitr_tpu_torch import utils
from sequitr_tpu_torch.models import convert as torch_convert
from sequitr_tpu_torch.models import unet as torch_unet
from sequitr_tpu_torch.ops import augment as aug
from sequitr_tpu_torch.ops import losses
from sequitr_tpu_torch.pipeline import infer as torch_infer
from sequitr_tpu_torch.pipeline import train as torch_train

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_draws(key, plane, dims=2, alpha=20.0, grid=4, p=1.0):
    """The draws ``augment.augment_example`` makes from ``key`` (photometry
    off): flip bits, rotation, the field already zeroed when the warp is
    off — computed with the reference's own functions."""
    k_flip, k_rot, k_el, k_p = jax.random.split(key, 4)
    bits = [bool(b) for b in np.asarray(jax.random.bernoulli(k_flip, shape=(dims,)))]
    rot = int(jax.random.randint(k_rot, (), 0, 4))
    dy, dx = jax_aug.elastic_fields(k_el, plane, alpha, grid)
    on = bool(jax.random.bernoulli(k_p, p))
    field = [torch.from_numpy(np.array(f) * on) for f in (dy, dx)]
    return aug.AugmentDraws(bits, rot, *field)


def test_augment_golden_on_the_reference_draws():
    """``augment_elastic.npz`` (PRNGKey(7), flip + rot90 + elastic on): the
    port's apply on the reference's draws; labels exact, image and weights
    within 1e-6 (the golden's own bars)."""
    g = np.load(os.path.join(GOLDENS, "augment_elastic.npz"))
    img, lab = synthetic.cells_frame(60_001, (96, 96))
    w = np.linspace(0, 1, 96 * 96, dtype=np.float32).reshape(96, 96)
    draws = _jax_draws(jax.random.PRNGKey(7), (96, 96))
    a_img, a_lab, a_w = aug.apply_example(
        torch.from_numpy(img)[..., None], torch.from_numpy(lab.astype(np.int32)),
        torch.from_numpy(w), draws,
    )
    np.testing.assert_array_equal(a_lab.numpy(), g["labels"])
    np.testing.assert_allclose(a_img.numpy(), g["image"], atol=1e-6)
    np.testing.assert_allclose(a_w.numpy(), g["weights"], atol=1e-6)


@pytest.mark.parametrize("seed", [3, 11])
def test_augment_3d_against_augment_example(seed):
    """``augment_example(dims=3)``: 3-axis flips, in-plane rotation and the
    same field on every z-plane, on the reference's draws."""
    rng = np.random.default_rng(seed)
    vol = (rng.random((4, 32, 32, 2)) * 100).astype(np.float32)
    lab = rng.integers(0, 3, (4, 32, 32)).astype(np.int32)
    w = rng.random((4, 32, 32)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    want = jax_aug.augment_example(
        key, jnp.asarray(vol), jnp.asarray(lab), jnp.asarray(w), p_elastic=1.0, dims=3
    )
    draws = _jax_draws(key, (32, 32), dims=3)
    got = aug.apply_example(
        torch.from_numpy(vol), torch.from_numpy(lab), torch.from_numpy(w), draws, dims=3
    )
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), atol=1e-6)


def test_augment_batch_matches_per_example():
    """The batch form (one warp for the batch) equals the per-example apply
    on the same draws, and the generator's draws are reproducible."""
    rng = np.random.default_rng(5)
    imgs = torch.from_numpy(rng.random((3, 32, 32, 1)).astype(np.float32))
    labs = torch.from_numpy(rng.integers(0, 3, (3, 32, 32)).astype(np.int32))
    ws = torch.from_numpy(rng.random((3, 32, 32)).astype(np.float32))
    knobs = dict(p_elastic=1.0, gain_jitter=0.2, offset_jitter=0.1, noise_std=0.05)
    out = aug.augment_batch(torch.Generator().manual_seed(9), imgs, labs, ws, **knobs)
    again = aug.augment_batch(torch.Generator().manual_seed(9), imgs, labs, ws, **knobs)
    gen = torch.Generator().manual_seed(9)
    for i in range(3):
        draws = aug.draw_example(gen, (32, 32, 1), **knobs)
        one = aug.apply_example(imgs[i], labs[i], ws[i], draws)
        for a, b, c in zip(out, again, one):
            assert torch.equal(a[i], b[i]) and torch.equal(a[i], c)


@pytest.mark.parametrize("order", [0, 1])
def test_elastic_warp_against_jax(order):
    """``elastic_warp`` of a channel-less and a 2-channel image, bilinear and
    nearest-neighbour, on the reference's field."""
    rng = np.random.default_rng(order)
    dy, dx = (np.array(f) for f in jax_aug.elastic_fields(jax.random.PRNGKey(4), (40, 40), 6.0, 4))
    for img in (rng.random((40, 40)) * 100, rng.random((40, 40, 2))):
        img = img.astype(np.float32)
        want = np.asarray(jax_aug.elastic_warp(jnp.asarray(img), jnp.asarray(dy), jnp.asarray(dx), order=order))
        got = aug.elastic_warp(torch.from_numpy(img), torch.from_numpy(dy), torch.from_numpy(dx), order=order)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6 * max(1.0, float(np.abs(img).max())))


@pytest.mark.parametrize("grid,shape", [
    (4, (64, 64)), (4, (256, 256)), (8, (512, 512)), (2, (16, 16)),
    (4, (96, 96)), (3, (33, 47)), (5, (97, 61)), (6, (200, 128)), (4, (7, 7)),
])
def test_elastic_fields_against_jax_resize(grid, shape):
    """The field is ``jax.image.resize(..., "bicubic")`` of the lattice:
    bit-equal at power-of-two widths; elsewhere within 1e-6 of the field's
    largest value (XLA's CPU dot sums the taps in an order that depends on
    the shape: two accumulators at width 96, one at 64)."""
    key = jax.random.PRNGKey(grid * 1000 + shape[0])
    lattice = np.asarray(jax.random.normal(key, (2, grid, grid), jnp.float32) * 20.0)
    want = np.asarray(jax.image.resize(jnp.asarray(lattice), (2,) + shape, "bicubic"))
    dy, dx = aug.elastic_fields(torch.from_numpy(lattice.copy()), shape)
    got = np.stack([dy.numpy(), dx.numpy()])
    if all(s & (s - 1) == 0 for s in shape):
        np.testing.assert_array_equal(got, want)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    # the reference's own entry point draws the same lattice
    jdy, _ = jax_aug.elastic_fields(key, shape, 20.0, grid)
    assert np.abs(dy.numpy() - np.asarray(jdy)).max() <= 1e-6 * np.abs(want).max()


def test_elastic_fields_batched_and_not_interpolate():
    """A (B, 2, g, g) batch gives each lattice's field; and the field is not
    ``F.interpolate``'s bicubic (a = -0.75, clamped edges)."""
    lat = torch.randn((3, 2, 4, 4), generator=torch.Generator().manual_seed(0)) * 20
    dy, dx = aug.elastic_fields(lat, (64, 64))
    for i in range(3):
        one = aug.elastic_fields(lat[i], (64, 64))
        assert torch.equal(dy[i], one[0]) and torch.equal(dx[i], one[1])
    theirs = F.interpolate(lat[:, :1], size=(64, 64), mode="bicubic", align_corners=False)[:, 0]
    assert (theirs - dy).abs().max() > 0.05


def _logits_labels(seed, shape=(2, 16, 16), k=3):
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=shape + (k,)).astype(np.float32) * 3
    labels = rng.integers(0, k, shape).astype(np.int32)
    weights = rng.random(shape).astype(np.float32) * 4
    return logits, labels, weights


@pytest.mark.parametrize("form", ["int", "onehot", "unweighted", "zero_weights"])
def test_weighted_ce_against_jax(form):
    logits, labels, weights = _logits_labels(1)
    lab = np.eye(3, dtype=np.float32)[labels] if form == "onehot" else labels
    w = None if form == "unweighted" else (weights * 0 if form == "zero_weights" else weights)
    want = float(jax_losses.weighted_softmax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(lab), None if w is None else jnp.asarray(w)
    ))
    got = float(losses.weighted_softmax_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(lab), None if w is None else torch.from_numpy(w)
    ))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_metrics_against_jax():
    logits, labels, _ = _logits_labels(2, (4, 32, 32), k=4)
    pred = logits.argmax(-1).astype(np.int32)
    pred[0] = 3  # a class present in one map only
    labels[1][labels[1] == 2] = 0  # and one absent from the target
    for ours, theirs in ((losses.iou, jax_losses.iou), (losses.dice, jax_losses.dice)):
        got = ours(torch.from_numpy(pred), torch.from_numpy(labels), 5).numpy()
        want = np.asarray(theirs(jnp.asarray(pred), jnp.asarray(labels), 5))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    cm = losses.confusion_matrix_np(pred, labels, 5)
    np.testing.assert_array_equal(cm, jax_losses.confusion_matrix_np(pred, labels, 5))
    for a, b in zip(losses.metrics_from_confusion(cm), jax_losses.metrics_from_confusion(cm)):
        np.testing.assert_array_equal(a, b)
    x, y = np.random.default_rng(3).normal(size=(2, 50)).astype(np.float32)
    t = (y > 0).astype(np.float32)
    np.testing.assert_allclose(
        float(losses.sigmoid_bce_with_logits(torch.from_numpy(x), torch.from_numpy(t))),
        float(jax_losses.sigmoid_bce_with_logits(jnp.asarray(x), jnp.asarray(t))), rtol=1e-6,
    )
    np.testing.assert_allclose(
        float(losses.l1_loss(torch.from_numpy(x), torch.from_numpy(y))),
        float(jax_losses.l1_loss(jnp.asarray(x), jnp.asarray(y))), rtol=1e-6,
    )


def _tied(dims, seed):
    """(N, *spatial, C) values on a coarse grid: many 2x2(x2) windows hold
    tied maxima."""
    rng = np.random.default_rng(seed)
    shape = (2,) + (8,) * dims + (3,)
    return rng.integers(0, 3, shape).astype(np.float32)


@pytest.mark.parametrize("dims", [2, 3])
@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
def test_maxpool_gradient_goes_to_the_first_tied_max(dims, layout):
    """XLA's select-and-scatter (``unet._maxpool``'s gradient) sends each
    window's cotangent to its first maximal element in row-major window
    order; so does the port's pool, on the layout the UNet trains in."""
    x = _tied(dims, seed=dims)
    cot = np.random.default_rng(7).random((2,) + (4,) * dims + (3,)).astype(np.float32)
    window = (1,) + (2,) * dims + (1,)

    def pool_sum(v):
        y = jax.lax.reduce_window(v, -jnp.inf, jax.lax.max, window, window, "VALID")
        return jnp.sum(y * cot)

    want = np.asarray(jax.grad(pool_sum)(jnp.asarray(x)))
    assert np.sum(want != 0) < x.size  # ties were there to break
    model = torch_unet.UNet(torch_unet.UNetConfig(dims=dims, depth=2, base_features=4), device="cpu")
    t = torch.movedim(torch.from_numpy(x), -1, 1)
    if layout == "channels_last":
        t = torch_unet.channels_last(t)
    t.requires_grad_(True)
    y = model._pool(t)
    (torch.movedim(y, 1, -1) * torch.from_numpy(cot)).sum().backward()
    got = torch.movedim(t.grad, 1, -1).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# repairs: stale folds, TF32 under float32
# ---------------------------------------------------------------------------


def _bn_unet(seed=0, dtype="float32"):
    cfg = torch_unet.UNetConfig(depth=2, base_features=8, num_classes=1, compute_dtype=dtype)
    model = torch_unet.init(cfg, torch.Generator().manual_seed(seed), device="cpu")
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for bn in model.bn_layers():
            bn.mean.copy_(torch.rand(bn.mean.shape, generator=gen) * 0.1)
            bn.var.copy_(1 + torch.rand(bn.var.shape, generator=gen))
        for m in model.modules():
            if isinstance(m, torch_unet._Conv):
                m.b.copy_(torch.randn(m.b.shape, generator=gen) * 0.1)
    return cfg, model


@pytest.mark.parametrize("polyphase", [False, True])
def test_denoiser_follows_in_place_updates(polyphase):
    """A model whose parameters change in place is folded anew: the same
    denoiser and a new one both give the updated model's output. (Before
    the repair both returned the old output, bit-equal: the fold was
    cached by the module's identity.)"""
    cfg, model = _bn_unet()
    tc = torch_infer.TileConfig(patch=(32, 32), overlap=(0, 0), polyphase=polyphase)
    frame = np.random.default_rng(0).gamma(2.0, 50.0, (32, 32)).astype(np.float32)
    denoise = torch_infer.make_denoiser(cfg, tc, (32, 32), device="cpu")
    before = denoise(model, frame).clone()
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(2.0)
    doubled = torch_convert.load_flat(cfg, torch_convert.to_flat(model), device="cpu")
    want = torch_infer.make_denoiser(cfg, tc, (32, 32), device="cpu")(doubled, frame)
    assert not torch.equal(want, before)
    assert torch.equal(denoise(model, frame), want)
    assert torch.equal(torch_infer.make_denoiser(cfg, tc, (32, 32), device="cpu")(model, frame), want)


def test_fold_is_held_on_the_model_and_freed_with_it():
    import gc
    import weakref

    cfg, model = _bn_unet()
    folded = torch_infer._folded_unet(model)
    assert torch_infer._folded_unet(model) is folded  # built once per state
    ref = weakref.ref(folded)
    del model, folded
    gc.collect()
    assert ref() is None


@pytest.fixture
def tf32_calls(monkeypatch):
    calls = []
    real = utils._set_tf32
    monkeypatch.setattr(utils, "_set_tf32", lambda m, c: (calls.append((m, c)), real(m, c)))
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_float32_entry_points_run_without_tf32(tf32_calls, dtype):
    """Every float32 entry point turns TF32 off and restores the previous
    switches after (recorded at the setter); bfloat16 ones leave them."""
    cfg, model = _bn_unet(dtype=dtype)
    frame = np.random.default_rng(1).gamma(2.0, 50.0, (32, 32)).astype(np.float32)
    tc = torch_infer.TileConfig(patch=(32, 32), overlap=(0, 0))
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    expect = [(False, False), prev] if dtype == "float32" else []

    def check(call):
        tf32_calls.clear()
        call()
        assert tf32_calls[:1] + tf32_calls[-1:] == expect, tf32_calls
        assert all(c == (False, False) for c in tf32_calls[:-1])
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == prev

    folded = torch_unet.fold_batchnorm(model)
    check(lambda: torch_infer.make_frame_inferrer(cfg, tc, (32, 32), device="cpu")(folded, frame))
    check(lambda: torch_infer.make_denoiser(cfg, tc, (32, 32), device="cpu")(model, frame))
    poly_tc = dataclasses.replace(tc, polyphase=True)
    check(lambda: torch_infer.make_frame_inferrer(cfg, poly_tc, (32, 32), device="cpu")(folded, frame))
    tcfg = torch_train.TrainConfig(augment=False)
    state = torch_train.create_unet_state(cfg, tcfg, model=model)
    step = torch_train.make_unet_train_step(cfg, tcfg)
    batch = {"image": torch.rand(2, 32, 32, 1), "labels": torch.zeros(2, 32, 32, dtype=torch.int32)}
    check(lambda: step(state, batch))
