"""Noise2Void training against the JAX package: the masking and flip applies
on the JAX package's own draws (bit for bit: uniform and median modes,
structN2V along each axis, 2D and volumes, borders and duplicate
positions), the masked MSE, three train steps from the same weights,
``fit_n2v`` with its holdout evaluator, a resume, and ``train_n2v`` served
by both servers (the same shards byte for byte, the same registered
config, the same JobErrors).

The draws are the JAX package's: each test replays the key splits of
``sequitr_tpu/pipeline/train.py`` (``make_n2v_train_step``: ``k_aug,
k_mask = split(key)``; ``n2v_flip_batch``: ``kf, kt = split(k_aug)``;
``_n2v_mask_nd``: a key a sample, ``split(k, 2 * D)``, centres from the
first D keys, offsets from the last D) with ``jax.random`` and hands the
values to the port's applies. The steps are held to the card-vs-CPU
train bars of ``chip_smoke.py`` (loss rtol 1e-4, grad_norm 2e-3, updates'
L2 0.2, statistics 1e-3; ``_assert_params_close``).
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequitr_tpu.config import ServerConfiguration as JaxConfig
from sequitr_tpu.models import convert as jax_convert
from sequitr_tpu.models import unet as jax_unet
from sequitr_tpu.pipeline import fit as jax_fit
from sequitr_tpu.pipeline import train as jax_train
from sequitr_tpu.server import ImageServer as JaxServer
from sequitr_tpu.server import submit_job as jax_submit
from sequitr_tpu_torch.config import ServerConfiguration as TorchConfig
from sequitr_tpu_torch.data import records, synthetic, tiff
from sequitr_tpu_torch.models import convert as torch_convert
from sequitr_tpu_torch.models import unet as torch_unet
from sequitr_tpu_torch.pipeline import fit, train
from sequitr_tpu_torch.server import ImageServer as TorchServer
from sequitr_tpu_torch.server import submit_job as torch_submit
from sequitr_tpu_torch.server.server import load_model


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the JAX package's draws, replayed
# ---------------------------------------------------------------------------


def jax_mask_draws(key, shape, n_mask, radii, mode="uniform", struct=None):
    b, spatial = shape[0], shape[1:-1]
    nd = len(spatial)
    n_rep = n_mask * (1 if struct is None else 2 * struct[1] + 1)
    centers, offsets = [], []
    for k in jax.random.split(key, b):
        ks = jax.random.split(k, 2 * nd)
        centers.append([np.asarray(jax.random.randint(ks[a], (n_mask,), 0, s)) for a, s in enumerate(spatial)])
        offsets.append([
            np.zeros(n_rep, np.int64) if struct is not None and a == struct[0]
            else np.asarray(jax.random.randint(ks[nd + a], (n_rep,), -r, r + 1))
            for a, r in enumerate(radii)
        ])
    return train.N2VMaskDraws(
        torch.from_numpy(np.asarray(centers, np.int64)),
        torch.from_numpy(np.asarray(offsets, np.int64)) if mode == "uniform" else None,
    )


def jax_flip_draws(key, shape, transpose=True):
    spatial = shape[1:-1]
    kf, kt = jax.random.split(key)
    flips = torch.from_numpy(np.array(jax.random.bernoulli(kf, 0.5, (shape[0], len(spatial)))))
    ts = None
    if transpose and spatial[-1] == spatial[-2]:
        ts = torch.from_numpy(np.array(jax.random.bernoulli(kt, 0.5, (shape[0],))))
    return train.N2VFlipDraws(flips, ts)


def jax_step_draws(key, shape, mask_frac, radii, mode="uniform", struct=None, augment=True):
    """The draws of one ``make_n2v_train_step`` call on ``key``."""
    k_aug, k_mask = jax.random.split(key)
    n_mask = max(1, int(mask_frac * int(np.prod(shape[1:-1]))))
    transpose = struct is None or struct[0] < len(shape) - 4
    flip = jax_flip_draws(k_aug, shape, transpose) if augment else None
    return train.N2VDraws(flip, jax_mask_draws(k_mask, shape, n_mask, radii, mode, struct))


# ---------------------------------------------------------------------------
# the masking, the flips and the loss
# ---------------------------------------------------------------------------

MASK_CASES = {
    # name: (shape, radii, mode, struct, n_mask)
    "uniform_2d": ((3, 32, 32, 1), (5, 5), "uniform", None, 40),
    "uniform_2d_channels": ((2, 16, 16, 2), (2, 3), "uniform", None, 30),
    "median_2d_120_taps": ((3, 32, 32, 1), (5, 5), "median", None, 40),
    "median_2d_14_taps": ((2, 16, 16, 2), (1, 2), "median", None, 30),
    "struct_y_uniform": ((2, 16, 16, 1), (5, 5), "uniform", (0, 4), 30),
    "struct_x_median": ((2, 16, 16, 1), (5, 5), "median", (1, 3), 30),
    "uniform_3d": ((2, 6, 16, 16, 1), (2, 5, 5), "uniform", None, 50),
    "median_3d": ((2, 6, 16, 16, 1), (1, 3, 3), "median", None, 50),
    "struct_z_uniform": ((2, 6, 16, 16, 1), (2, 5, 5), "uniform", (0, 2), 30),
    "struct_z_median": ((2, 6, 16, 16, 1), (2, 3, 3), "median", (0, 2), 30),
    "struct_y_3d": ((2, 6, 16, 16, 1), (0, 3, 3), "uniform", (1, 2), 30),
    "in_plane_radius_0": ((2, 6, 16, 16, 1), (0, 3, 3), "median", None, 30),
    # every position near a border: reflections and self-hits everywhere
    "borders_uniform": ((4, 6, 7, 1), (5, 5), "uniform", None, 20),
    "borders_median": ((4, 6, 7, 1), (5, 5), "median", None, 20),
    # far more centres than pixels: every position drawn many times
    "duplicates_uniform": ((3, 8, 8, 1), (3, 3), "uniform", None, 200),
    "duplicates_median": ((3, 8, 8, 1), (3, 3), "median", None, 200),
    # overlapping struct segments (span 3 on 8 rows)
    "duplicates_struct": ((3, 8, 8, 1), (3, 3), "uniform", (0, 3), 40),
    "duplicates_struct_3d": ((2, 4, 8, 8, 1), (1, 3, 3), "median", (2, 3), 40),
}


def _mask_both(name, seed=7):
    shape, radii, mode, struct, n_mask = MASK_CASES[name]
    img = np.random.default_rng(seed).random(shape, dtype=np.float32)
    key = jax.random.PRNGKey(seed)
    want, want_c = jax_train._n2v_mask_nd(key, jnp.asarray(img), n_mask, radii, mode=mode, struct=struct)
    draws = jax_mask_draws(key, shape, n_mask, radii, mode, struct)
    got, got_c = train.n2v_mask_apply(torch.from_numpy(img), draws, radii, mode, struct)
    return np.asarray(want), [np.asarray(c) for c in want_c], got.numpy(), [c.numpy() for c in got_c], draws


@pytest.mark.parametrize("name", sorted(MASK_CASES))
def test_mask_apply_bit_equal_on_the_reference_draws(name):
    want, want_c, got, got_c, draws = _mask_both(name)
    assert np.array_equal(got, want)
    assert all(np.array_equal(a, b) for a, b in zip(got_c, want_c))
    assert not np.array_equal(got, np.random.default_rng(7).random(got.shape, dtype=np.float32))
    if name.startswith("duplicates"):
        _, _, _, struct, n_mask = MASK_CASES[name]
        c = draws.centers.numpy()
        flat = np.ravel_multi_index(tuple(c[0]), MASK_CASES[name][0][1:-1])
        assert len(np.unique(flat)) < n_mask  # the case does draw duplicates


@pytest.mark.parametrize("shape,radius", [((2, 16, 16, 1), 3), ((2, 4, 16, 16, 1), (1, 3, 3))], ids=["2d", "3d"])
def test_mask_batch_is_the_apply_on_its_generators_draws(shape, radius):
    """``n2v_mask_batch`` / ``_3d``: ``n2v_draw_mask`` then the apply, the
    coordinates returned one array an axis, as the JAX functions."""
    img = torch.rand(shape, generator=torch.Generator().manual_seed(0))
    fn = train.n2v_mask_batch if len(shape) == 4 else train.n2v_mask_batch_3d
    got = fn(torch.Generator().manual_seed(1), img, 10, radius, "median", None)
    radii = train._n2v_radii(radius, len(shape) - 2)
    draws = train.n2v_draw_mask(torch.Generator().manual_seed(1), shape, 10, radii, "median")
    masked, coords = train.n2v_mask_apply(img, draws, radii, "median")
    assert len(got) == len(shape) - 1 and torch.equal(got[0], masked)
    assert all(torch.equal(a, b) for a, b in zip(got[1:], coords))


def test_duplicates_take_the_last_write():
    """Two writes of one position with different values: XLA's serial
    scatter keeps the last, and so does the port (a first-wins write
    would not match)."""
    img = jnp.zeros((5,), jnp.float32)
    assert float(img.at[jnp.asarray([2, 2, 2])].set(jnp.asarray([2.0, 3.0, 4.0]))[2]) == 4.0
    # the port: centres 3 and 3 (same pixel) with different neighbours
    image = torch.arange(16, dtype=torch.float32).reshape(1, 4, 4, 1)
    draws = train.N2VMaskDraws(
        torch.tensor([[[1, 1], [1, 1]]]), torch.tensor([[[0, 0], [1, -1]]])
    )
    masked, _ = train.n2v_mask_apply(image, draws, (1, 1))
    assert float(masked[0, 1, 1, 0]) == float(image[0, 1, 0, 0])  # the second offset (-1) wins


def test_window_median_is_jnp_median():
    """The two middles averaged for an even count (every window of the
    masking is even: a product of odd extents less the centre); odd
    counts take the middle. ``torch.median`` returns the lower middle."""
    rng = np.random.default_rng(3)
    for t in (119, 120, 121, 14):
        vals = rng.normal(size=(2, t, 5, 1)).astype(np.float32)
        want = np.asarray(jnp.median(jnp.asarray(vals), axis=1))
        assert np.array_equal(train._window_median(torch.from_numpy(vals)).numpy(), want), t
    even = torch.arange(120, dtype=torch.float32)[None, :, None, None]
    assert float(train._window_median(even)) == 59.5 == float(jnp.median(jnp.arange(120.0)))
    assert float(torch.median(even)) == 59.0


def test_an_even_window_fails_with_torch_median(monkeypatch):
    """The median mode's hold fails when the window's median is
    ``torch.median``'s lower middle."""
    monkeypatch.setattr(train, "_window_median", lambda vals: torch.median(vals, dim=1).values)
    want, _, got, _, _ = _mask_both("median_2d_120_taps")
    assert not np.array_equal(got, want)


@pytest.mark.parametrize("shape", [(4, 16, 16, 1), (3, 16, 12, 2), (3, 4, 16, 16, 1)], ids=["square", "oblong", "volume"])
@pytest.mark.parametrize("transpose", [True, False], ids=["transpose", "flips_only"])
def test_flip_apply_bit_equal_on_the_reference_draws(shape, transpose):
    img = np.random.default_rng(5).random(shape, dtype=np.float32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jax_train.n2v_flip_batch(key, jnp.asarray(img), transpose=transpose))
        got = train.n2v_flip_batch(torch.from_numpy(img), jax_flip_draws(key, shape, transpose)).numpy()
        assert np.array_equal(got, want)


def test_masked_mse_matches_the_reference():
    rng = np.random.default_rng(2)
    pred, tgt = (rng.normal(size=(3, 16, 16, 2)).astype(np.float32) for _ in range(2))
    ys, xs = rng.integers(0, 16, (2, 3, 10))
    ys[:, :3] = xs[:, :3] = 4  # a centre drawn three times counts three times
    want = float(jax_train.n2v_masked_mse(jnp.asarray(pred), jnp.asarray(tgt), jnp.asarray(ys), jnp.asarray(xs)))
    got = float(train.n2v_masked_mse(torch.from_numpy(pred), torch.from_numpy(tgt), torch.from_numpy(ys), torch.from_numpy(xs)))
    assert abs(got - want) <= 1e-6 * abs(want)


def test_mask_validation_messages():
    img = torch.zeros(1, 8, 8, 1)
    draws = train.n2v_draw_mask(None, img.shape, 4, (2, 2))
    with pytest.raises(ValueError, match="must be < the patch extent"):
        train.n2v_mask_apply(img, draws, (8, 2))
    with pytest.raises(ValueError, match="mask mode"):
        train.n2v_mask_apply(img, draws, (2, 2), mode="mean")
    with pytest.raises(ValueError, match="OUTSIDE"):
        train.n2v_mask_apply(img, draws, (2, 0), struct=(0, 1))
    with pytest.raises(ValueError, match="struct span 8 must be < the patch extent"):
        train.n2v_mask_apply(img, draws, (2, 2), struct=(1, 8))
    with pytest.raises(ValueError, match="at least"):
        train._n2v_radii(0, 2)
    with pytest.raises(ValueError, match="mask_frac"):
        train.make_n2v_train_step(torch_unet.UNetConfig(num_classes=1), train.TrainConfig(), mask_frac=0.0)


# ---------------------------------------------------------------------------
# three steps from the same weights
# ---------------------------------------------------------------------------

KW = dict(in_channels=1, num_classes=1, depth=2, base_features=8)
LR = 4e-4  # train_n2v's default


def _flat(params, state):
    flat = dict(jax_convert.flatten_params(params))
    flat.update({f"state/{k}": v for k, v in jax_convert.flatten_params(state).items()})
    return {k: np.asarray(v) for k, v in flat.items()}


def _pair(dims, polyphase=False, seed=0, lr=LR):
    jcfg = jax_unet.UNetConfig(compute_dtype=jnp.float32, dims=dims, **KW)
    tcfg = torch_unet.UNetConfig(compute_dtype="float32", dims=dims, **KW)
    jtc = jax_train.TrainConfig(learning_rate=lr, polyphase=polyphase)
    ttc = train.TrainConfig(learning_rate=lr, polyphase=polyphase)
    jstate = jax_train.create_unet_state(jax.random.PRNGKey(seed), jcfg, jtc)
    tstate = torch_convert.load_train_state(tcfg, ttc, _flat(jstate.params, jstate.model_state), device="cpu")
    return jcfg, tcfg, jtc, ttc, jstate, tstate


def _bn_nulled(key):
    return key.endswith(("conv1/b", "conv2/b", "/mean"))


def _assert_params_close(tstate, jstate, start, steps, lr=LR):
    """The train bars of ``chip_smoke.py``, for steps that cannot agree bit for bit: every value
    within ``2 * steps * lr`` (Adam moves a weight by up to lr a step); the
    updates of the values a batch norm does not null differ by at most 0.2
    of their L2 norm, and the running statistics by at most 1e-3 of each
    tensor's largest value beyond what a running mean's bias can move. A
    value-by-value bar does not hold here: a first-layer weight's gradient
    is a cancelling sum over every pixel, Adam's first step is its sign,
    and in 3D a sum at round-off level flips it (a difference of 2 * lr on
    step 1; the 3D polyphase case reads 0.014 of the L2 norm after 3
    steps, the others below 0.002)."""
    got = torch_convert.to_flat(tstate.model)
    want = _flat(jstate.params, jstate.model_state)
    assert set(got) == set(want)
    num = den = stats = 0.0
    for k in want:
        d = np.abs(got[k].astype(np.float64) - want[k])
        assert d.max() <= 2 * steps * lr, k
        if k.startswith("state/"):
            slack = steps * lr if k.endswith("/mean") else 0.0
            stats = max(stats, float(np.maximum(d - slack, 0).max() / np.abs(want[k]).max()))
        elif not _bn_nulled(k):
            num += float((d**2).sum())
            den += float(((want[k].astype(np.float64) - start[k]) ** 2).sum())
    assert (num / den) ** 0.5 <= 0.2, (num / den) ** 0.5
    assert stats <= 1e-3, stats


def _noisy(shape, seed):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) * 0.5 + 0.25 + rng.normal(0, 0.1, shape)).astype(np.float32)


STEP_CASES = {
    "2d": (2, False, (4, 32, 32, 1), 5, "uniform", None),
    "2d_polyphase": (2, True, (4, 32, 32, 1), 5, "uniform", None),
    "2d_median_struct_x": (2, False, (4, 32, 32, 1), 5, "median", (1, 4)),
    "3d": (3, False, (2, 8, 32, 32, 1), (2, 5, 5), "uniform", None),
    "3d_polyphase": (3, True, (2, 8, 32, 32, 1), (2, 5, 5), "uniform", None),
}


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_three_n2v_steps_match_the_reference(name):
    dims, poly, shape, radius, mode, struct = STEP_CASES[name]
    jcfg, tcfg, jtc, ttc, jstate, tstate = _pair(dims, poly)
    start = _flat(jstate.params, jstate.model_state)
    kw = dict(mask_frac=0.02, radius=radius, mask_mode=mode, struct=struct)
    jstep = jax_train.make_n2v_train_step(jcfg, jtc, **kw)
    tstep = train.make_n2v_train_step(tcfg, ttc, **kw)
    radii = train._n2v_radii(radius, dims)
    for s in range(3):
        img = _noisy(shape, 40 + s)
        key = jax.random.PRNGKey(100 + s)
        jstate, jm = jstep(jstate, {"image": jnp.asarray(img)}, key)
        draws = jax_step_draws(key, shape, 0.02, radii, mode, struct)
        tstate, tm = tstep(tstate, {"image": torch.from_numpy(img)}, draws=draws)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=2e-3)  # chip_smoke's TRAIN_GRAD_NORM_RTOL
    assert tstate.step == 3
    _assert_params_close(tstate, jstate, start, 3)


def test_step_draws_from_its_generator():
    """The same generator seed gives the same step; the draws a step takes
    (flips, then the mask) are those ``n2v_draw_flip`` and
    ``n2v_draw_mask`` make from it, in that order."""
    cfg = torch_unet.UNetConfig(compute_dtype="float32", **KW)
    tc = train.TrainConfig(learning_rate=LR)
    flat = torch_convert.to_flat(torch_unet.init(cfg, torch.Generator().manual_seed(0), device="cpu"))
    img = torch.from_numpy(_noisy((2, 16, 16, 1), 1))
    step = train.make_n2v_train_step(cfg, tc, mask_frac=0.05)
    losses = []
    for how in ("generator", "draws"):
        state = train.create_unet_state(cfg, tc, model=torch_convert.load_flat(cfg, flat, device="cpu"))
        g = torch.Generator().manual_seed(9)
        if how == "generator":
            _, m = step(state, {"image": img}, g)
        else:
            flip = train.n2v_draw_flip(g, img.shape)
            mask = train.n2v_draw_mask(g, img.shape, 12, (5, 5))
            _, m = step(state, {"image": img}, draws=train.N2VDraws(flip, mask))
        losses.append(float(m["loss"]))
    assert losses[0] == losses[1]


# ---------------------------------------------------------------------------
# fit_n2v
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def image_shards(tmp_path_factory):
    """12 noisy 32x32 crops of normalized ``cells_frame``s, in 2 shards."""
    tmp = tmp_path_factory.mktemp("n2v_shards")
    rng = np.random.default_rng(0)
    payloads = []
    for i in range(12):
        img, _ = synthetic.cells_frame(93_000 + i, (32, 32))
        lo, hi = np.percentile(img, [5.0, 99.5])
        img = np.clip((img - lo) / (hi - lo), 0, 1) + rng.normal(0, 0.1, img.shape)
        payloads.append(fit.encode_image_example(img.astype(np.float32)))
    return records.write_shards(str(tmp / "train"), iter(payloads), shard_size=6)


def _rows(path, kind):
    with open(path) as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


def test_image_codec_is_the_reference_codec():
    x = np.random.default_rng(1).random((5, 7, 2), dtype=np.float32)
    assert fit.encode_image_example(x) == jax_fit.encode_image_example(x)
    assert np.array_equal(fit._decode_image(jax_fit.encode_image_example(x[..., 0]))["image"][..., 0], x[..., 0])


def test_fit_n2v_against_the_reference(image_shards, tmp_path, monkeypatch):
    """6 steps, batch 2, holdout every 3rd example, eval every 3 steps, each
    step on the JAX loop's draws (``fold_in(PRNGKey(seed), step)``) and the
    evaluator on the JAX evaluator's mask (``PRNGKey(0)``): the train
    losses and the eval metrics follow the JAX package's."""
    fit_kw = dict(steps=6, batch_size=2, log_every=1, seed=4, shuffle_buffer=5, holdout_every=3,
                  eval_every=3, checkpoint_every=3)
    mask_kw = dict(mask_frac=0.02, radius=3, mask_mode="median")
    # lr 1e-4: in inference mode the BN-nulled conv biases, which Adam
    # moves on round-off by up to lr a step, no longer cancel
    jcfg, tcfg, jtc, ttc, jstate, tstate = _pair(2, lr=1e-4)
    jpath, tpath = str(tmp_path / "jax.jsonl"), str(tmp_path / "torch.jsonl")
    jax_fit.fit_n2v(jcfg, jtc, jax_fit.FitConfig(metrics_path=jpath, **fit_kw), image_shards,
                    ckpt_dir=str(tmp_path / "jax_ckpt"), init_state=jstate, **mask_kw)

    real = train.make_n2v_train_step

    def on_jax_draws(cfg, tc, **kw):
        step = real(cfg, tc, **kw)

        def run(state, batch, generator=None):
            key = jax.random.fold_in(jax.random.PRNGKey(fit_kw["seed"]), state.step)
            draws = jax_step_draws(key, tuple(batch["image"].shape), 0.02, (3, 3), "median")
            return step(state, batch, draws=draws)

        return run

    monkeypatch.setattr(fit.train_lib, "make_n2v_train_step", on_jax_draws)
    holdout = fit.load_holdout(image_shards, fit._decode_image, 3, 16)["image"]
    n_mask = max(1, int(0.02 * 32 * 32))
    eval_draws = jax_mask_draws(jax.random.PRNGKey(0), holdout.shape, n_mask, (3, 3), "median")
    fit.fit_n2v(tcfg, ttc, fit.FitConfig(metrics_path=tpath, **fit_kw), image_shards,
                ckpt_dir=str(tmp_path / "torch_ckpt"), init_state=tstate, device="cpu",
                eval_draws=eval_draws, **mask_kw)
    jt, tt = _rows(jpath, "train"), _rows(tpath, "train")
    assert [r["step"] for r in tt] == [r["step"] for r in jt] == list(range(1, 7))
    np.testing.assert_allclose([r["loss"] for r in tt], [r["loss"] for r in jt], rtol=1e-4)
    je, te = _rows(jpath, "eval"), _rows(tpath, "eval")
    assert [r["step"] for r in te] == [r["step"] for r in je] == [3, 6]
    for a, b in zip(te, je):
        assert set(a) == set(b)
        np.testing.assert_allclose(a["eval_n2v_mse"], b["eval_n2v_mse"], rtol=1e-3)
        # -10 log10 of the same mse: 1e-3 of it is 0.0043 dB
        np.testing.assert_allclose(a["eval_psnr_masked"], b["eval_psnr_masked"], atol=0.0044)
    assert sorted(os.listdir(tmp_path / "torch_ckpt")) == ["final", "step_00000003", "step_00000006"]


def test_fit_n2v_resume_equals_uninterrupted(image_shards, tmp_path):
    """The masking and flips included: cancelled at step 3, resumed from its
    checkpoint, the run ends with the weights of a run that went through."""
    cfg = torch_unet.UNetConfig(compute_dtype="float32", **KW)
    tc = train.TrainConfig(learning_rate=LR)

    def run(name, stop_at=None, init_state=None):
        calls = {"n": 0}

        def should_stop():
            calls["n"] += 1
            return stop_at is not None and calls["n"] > stop_at

        fc = fit.FitConfig(steps=6, batch_size=2, log_every=1, seed=7, shuffle_buffer=5, checkpoint_every=2,
                           ema_decay=0.9, metrics_path=str(tmp_path / f"{name}.jsonl"))
        state = init_state or train.create_unet_state(cfg, tc, torch.Generator().manual_seed(1), device="cpu")
        return fit.fit_n2v(cfg, tc, fc, image_shards, ckpt_dir=str(tmp_path / name), init_state=state,
                           should_stop=should_stop, device="cpu", mask_frac=0.02, struct=(0, 2))

    whole = run("a")
    with pytest.raises(fit.TrainingCancelled):
        run("b", stop_at=3)
    ckpt = fit.latest_checkpoint(str(tmp_path / "b"))
    restored = train.restore_checkpoint(ckpt, train.create_unet_state(cfg, tc, device="cpu"))
    resumed = run("b", init_state=restored)
    assert resumed.step == whole.step == 6
    for (k, a), b in zip(whole.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert [r["loss"] for r in _rows(str(tmp_path / "a.jsonl"), "train")] == [
        r["loss"] for r in _rows(str(tmp_path / "b.jsonl"), "train")
    ]


# ---------------------------------------------------------------------------
# train_n2v through both servers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("n2v_jobs")
    rng = np.random.default_rng(11)
    frames = np.stack([synthetic.cells_frame(94_000 + i, (48, 48))[0] for i in range(3)])
    noisy = (frames + rng.normal(0, 200, frames.shape)).clip(0, 65535).astype(np.uint16)
    vols = (rng.random((2 * 8, 32, 32)) * 1000 + 500).astype(np.uint16)  # 2 volumes of 8 planes
    paths = {"frames": str(tmp / "noisy.tif"), "volumes": str(tmp / "volumes.tif"),
             "small": str(tmp / "small.tif"), "cube": str(tmp / "cube.tif")}
    tiff.write_stack(paths["frames"], noisy)
    tiff.write_stack(paths["volumes"], vols)
    tiff.write_stack(paths["small"], np.zeros((2, 8, 8), np.float32))
    tiff.write_stack(paths["cube"], rng.normal(0.5, 0.1, (16, 16, 16)).astype(np.float32))
    return dict(tmp=tmp, paths=paths)


def _run(env, which, name, module, inputs, params):
    tmp = env["tmp"]
    out = str(tmp / f"{which}_{name}")
    jobs = str(tmp / f"{which}_jobs")
    models = str(tmp / f"{which}_models")
    spec = {"module": module, "params": params, "input": inputs, "output": out}
    if which == "jax":
        jax_submit(jobs, spec)
        assert JaxServer(JaxConfig(jobs_dir=jobs, models_dir=models, compilation_cache_dir=None)).poll_once()
    else:
        torch_submit(jobs, spec)
        assert TorchServer(TorchConfig(jobs_dir=jobs, models_dir=models, device="cpu")).poll_once()
    with open(os.path.join(out, "status.json")) as f:
        return json.load(f)


def _job_error(error):
    """The JobError's message, the job's id left out."""
    line = [ln for ln in error.splitlines() if "JobError: " in ln][-1]
    return re.sub(r"job [0-9a-f]+", "job <id>", line.split("JobError: ", 1)[1])


def _shard_bytes(env, which, name):
    d = env["tmp"] / f"{which}_{name}" / "records"
    return {f: (d / f).read_bytes() for f in sorted(os.listdir(d)) if f.endswith(".tfrecord")}


def _config(env, which, model):
    with open(env["tmp"] / f"{which}_models" / model / "config.json") as f:
        return json.load(f)


N2V_JOBS = {
    "2d": ("frames", dict(patch=[32, 32], patches_per_frame=3, shard_size=4, seed=2, depth=2, base_features=8,
                          steps=3, batch_size=2, log_every=1, mask_mode="median", struct_axis="y")),
    "3d": ("volumes", dict(dims=3, z=8, patch=[4, 16, 16], patches_per_frame=2, depth=2, base_features=8,
                           steps=2, batch_size=2, log_every=1, radius=3, radius_z=1, compute_dtype="float32")),
}


@pytest.mark.parametrize("case", sorted(N2V_JOBS))
def test_train_n2v_served_by_both_servers(env, case):
    """The same job JSON: the same shards byte for byte and the same
    registered config; the port's model serves through ``denoise``."""
    src, params = N2V_JOBS[case]
    params = dict(params, model=f"n2v_{case}")
    st = _run(env, "torch", f"n2v_{case}", "train_n2v", [env["paths"][src]], params)
    sj = _run(env, "jax", f"n2v_{case}", "train_n2v", [env["paths"][src]], params)
    assert st["state"] == "complete", st.get("error")
    assert sj["state"] == "complete", sj.get("error")
    ours, theirs = _shard_bytes(env, "torch", f"n2v_{case}"), _shard_bytes(env, "jax", f"n2v_{case}")
    assert ours == theirs and ours
    assert _config(env, "torch", f"n2v_{case}") == _config(env, "jax", f"n2v_{case}")
    kind, cfg, _ = load_model(str(env["tmp"] / "torch_models"), f"n2v_{case}", device="cpu")
    assert kind == "n2v" and cfg.depth == 2 and cfg.dims == (3 if case == "3d" else 2)
    # a second run of the job resumes from its final checkpoint and shards
    again = _run(env, "torch", f"n2v_{case}", "train_n2v", [env["paths"][src]], params)
    assert again["state"] == "complete", again.get("error")
    if case == "2d":
        served = _run(env, "torch", "denoise_2d", "denoise", [env["paths"]["frames"]], {"model": "n2v_2d"})
        assert served["state"] == "complete", served.get("error")


ERROR_JOBS = {
    "patch": ("small", {"patch": [64, 64]}, "patch"),
    "struct_outside": ("cube", {"dims": 3, "z": 4, "patch": [4, 16, 16], "steps": 5, "batch_size": 2,
                                "struct_axis": "z", "radius": 0, "radius_z": 2, "depth": 2,
                                "base_features": 4, "normalize": False}, "OUTSIDE"),
    "struct_extent": ("cube", {"patch": [16, 16], "steps": 5, "batch_size": 2, "struct_axis": "x",
                               "struct_span": 16, "depth": 2, "base_features": 4, "normalize": False}, "extent"),
    "dims": ("small", {"dims": 4}, "dims 2 or 3"),
    "s2d_volume": ("small", {"dims": 3, "space_to_depth": 2}, "2D-only"),
    "mask_mode": ("cube", {"patch": [16, 16], "mask_mode": "mean", "depth": 2, "base_features": 4}, "mask_mode"),
    "struct_axis": ("cube", {"patch": [16, 16], "struct_axis": "z", "depth": 2, "base_features": 4}, "struct_axis"),
    "struct_span": ("cube", {"patch": [16, 16], "struct_span": 2, "depth": 2, "base_features": 4}, "without struct_axis"),
    "keep_best": ("cube", {"patch": [16, 16], "keep_best": True, "depth": 2, "base_features": 4}, "holdout_every"),
}


@pytest.mark.parametrize("case", sorted(ERROR_JOBS))
def test_train_n2v_job_errors_match_the_reference(env, case):
    """The JAX package's ``test_train_n2v_param_errors`` cases and the other
    param checks: both servers fail the job with a JobError of equal text."""
    src, params, frag = ERROR_JOBS[case]
    params = dict(params, model=f"bad_{case}")
    st = _run(env, "torch", f"bad_{case}", "train_n2v", [env["paths"][src]], params)
    sj = _run(env, "jax", f"bad_{case}", "train_n2v", [env["paths"][src]], params)
    assert st["state"] == sj["state"] == "failed", (st, sj)
    assert "JobError" in st["error"] and frag in st["error"], st["error"]

    assert _job_error(st["error"]) == _job_error(sj["error"])
