"""Flows and stars training against the JAX package: the flip applies on the
JAX package's own bits (the flow components' signs, the ray permutations),
the BCE against optax, three steps of each family from the same weights on
the JAX step's draws, both holdout evaluators on soft probability targets,
``fit_flows`` / ``fit_stars``, and ``train_flows`` (2D and volumes) and
``train_stars`` served by both servers (the same shards byte for byte, the
same registered config, the same JobErrors).

The draws are the JAX step's: ``k_flip, k_phot = split(key)``, a key a
sample from ``split(k_flip, B)`` with ``bernoulli(k, shape=(D,))``, and
(with a jitter) a key a sample from ``split(k_phot, B)`` split in three for
the gain, the offset and the noise (``ops.augment.photometric_jitter``),
replayed with ``jax.random``. Steps are held to the card-vs-CPU train
bars of ``chip_smoke.py``, as in ``test_torch_n2v_train.py``.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
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
from sequitr_tpu_torch.ops import flows as flows_ops
from sequitr_tpu_torch.ops import losses
from sequitr_tpu_torch.ops import stardist as sd
from sequitr_tpu_torch.pipeline import fit, train
from sequitr_tpu_torch.server import ImageServer as TorchServer
from sequitr_tpu_torch.server import submit_job as torch_submit
from sequitr_tpu_torch.server.server import load_model

LR = 3e-4  # train_flows' and train_stars' default
N_RAYS = 8


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def jax_flip_draws(key, shape, n_axes, jitter=None):
    """The draws of one flows or stars step on ``key`` (``jitter``: the
    (gain, offset, noise) knobs, or None)."""
    k_flip, k_phot = jax.random.split(key)
    bits = np.stack([np.array(jax.random.bernoulli(k, shape=(n_axes,))) for k in jax.random.split(k_flip, shape[0])])
    phot = None
    if jitter is not None:
        g, o, n = jitter
        c = shape[-1]
        phot = []
        for k in jax.random.split(k_phot, shape[0]):
            k_gain, k_off, k_noise = jax.random.split(k, 3)
            hi = jnp.log1p(g)
            gain = np.array(jnp.exp(jax.random.uniform(k_gain, (c,), minval=-hi, maxval=hi))) if g > 0 else None
            off = np.array(jax.random.normal(k_off, (c,)) * o) if o > 0 else None
            noise = np.array(jax.random.normal(k_noise, shape[1:]) * n) if n > 0 else None
            phot.append(tuple(None if t is None else torch.from_numpy(t) for t in (gain, off, noise)))
    return train.FlipDraws(torch.from_numpy(bits), phot)


# ---------------------------------------------------------------------------
# targets and data
# ---------------------------------------------------------------------------


def _flows_batch(n, size, seed, dims=2):
    imgs, flows, probs = [], [], []
    for i in range(n):
        if dims == 2:
            img, lab = synthetic.instances_frame(seed + i, (size, size), density=1 / 256.0)
        else:
            img, lab = synthetic.cells_volume(seed + i, (8, size, size))
            from scipy import ndimage

            lab, _ = ndimage.label(lab > 0)
        lo, hi = np.percentile(img, [5.0, 99.5])
        imgs.append(np.clip((img - lo) / (hi - lo), 0, 1).astype(np.float32))
        f, p = flows_ops.flow_targets(lab.astype(np.int64))
        flows.append(f)
        probs.append(p)
    return np.stack(imgs)[..., None], np.stack(flows).astype(np.float32), np.stack(probs).astype(np.float32)


def _stars_batch(n, size, seed):
    imgs, dists, probs = [], [], []
    for i in range(n):
        img, lab = synthetic.instances_frame(seed + i, (size, size), density=1 / 256.0)
        lo, hi = np.percentile(img, [5.0, 99.5])
        imgs.append(np.clip((img - lo) / (hi - lo), 0, 1).astype(np.float32))
        d, p = sd.star_targets(lab.astype(np.int64), n_rays=N_RAYS)
        dists.append(d)
        probs.append(p)
    return np.stack(imgs)[..., None], np.stack(dists).astype(np.float32), np.stack(probs).astype(np.float32)


# ---------------------------------------------------------------------------
# the flips and the BCE
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dims", [2, 3])
def test_flows_flip_bit_equal_on_the_reference_bits(dims):
    x, f, p = _flows_batch(3, 32, 300, dims)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = jax_train.flows_flip_batch(key, jnp.asarray(x), jnp.asarray(f), jnp.asarray(p))
        # the bits of split(key, B), as the step's split(k_flip, B)
        bits = torch.from_numpy(np.stack([
            np.array(jax.random.bernoulli(k, shape=(dims,))) for k in jax.random.split(key, x.shape[0])
        ]))
        got = train.flows_flip_batch(torch.from_numpy(x), torch.from_numpy(f), torch.from_numpy(p), bits)
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), np.asarray(b))
    assert bits.any() and not bits.all()


def test_stars_flip_bit_equal_on_the_reference_bits():
    x, d, p = _stars_batch(4, 32, 310)
    perms = np.stack([sd.ray_flip_perm(N_RAYS, 0), sd.ray_flip_perm(N_RAYS, 1)])
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = jax_train.stars_flip_batch(key, jnp.asarray(x), jnp.asarray(d), jnp.asarray(p), jnp.asarray(perms))
        bits = torch.from_numpy(np.stack([
            np.array(jax.random.bernoulli(k, shape=(2,))) for k in jax.random.split(key, x.shape[0])
        ]))
        got = train.stars_flip_batch(
            torch.from_numpy(x), torch.from_numpy(d), torch.from_numpy(p), bits, torch.from_numpy(perms)
        )
        for a, b in zip(got, want):
            assert np.array_equal(a.numpy(), np.asarray(b))


def test_bce_is_optax_sigmoid_binary_cross_entropy():
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(2, 16, 16)) * 8).astype(np.float32)
    for targets in (rng.random((2, 16, 16)).astype(np.float32), (rng.random((2, 16, 16)) > 0.5).astype(np.float32)):
        want = float(jnp.mean(optax.sigmoid_binary_cross_entropy(jnp.asarray(logits), jnp.asarray(targets))))
        got = float(losses.sigmoid_bce_with_logits(torch.from_numpy(logits), torch.from_numpy(targets)))
        assert abs(got - want) <= 1e-6 * want


def test_bce_gradient_is_optax_at_zero_logits():
    """At z == 0 (a pixel whose features a ReLU zeroed, before a zero head
    bias) the gradient is sigmoid(0) - t, as optax's, not a subgradient of
    the max/abs form."""
    targets = np.array([0.0, 0.3, 1.0], np.float32)
    want = np.asarray(jax.grad(lambda z: jnp.sum(optax.sigmoid_binary_cross_entropy(z, jnp.asarray(targets))))(
        jnp.zeros(3, jnp.float32)))
    z = torch.zeros(3, requires_grad=True)
    (losses.sigmoid_bce_with_logits(z, torch.from_numpy(targets)) * 3).backward()
    np.testing.assert_allclose(z.grad.numpy(), want, rtol=1e-6)


# ---------------------------------------------------------------------------
# three steps from the same weights
# ---------------------------------------------------------------------------


def _flat(params, state):
    flat = dict(jax_convert.flatten_params(params))
    flat.update({f"state/{k}": v for k, v in jax_convert.flatten_params(state).items()})
    return {k: np.asarray(v) for k, v in flat.items()}


def _pair(num_classes, dims=2, polyphase=False, jitter=(0.0, 0.0, 0.0), lr=LR, augment=True):
    kw = dict(in_channels=1, num_classes=num_classes, depth=2, base_features=8, dims=dims)
    tkw = dict(learning_rate=lr, polyphase=polyphase, augment=augment, gain_jitter=jitter[0],
               offset_jitter=jitter[1], noise_std=jitter[2])
    jcfg = jax_unet.UNetConfig(compute_dtype=jnp.float32, **kw)
    tcfg = torch_unet.UNetConfig(compute_dtype="float32", **kw)
    jtc, ttc = jax_train.TrainConfig(**tkw), train.TrainConfig(**tkw)
    jstate = jax_train.create_unet_state(jax.random.PRNGKey(0), jcfg, jtc)
    tstate = torch_convert.load_train_state(tcfg, ttc, _flat(jstate.params, jstate.model_state), device="cpu")
    return jcfg, tcfg, jtc, ttc, jstate, tstate


def _bn_nulled(key):
    return key.endswith(("conv1/b", "conv2/b", "/mean"))


def _assert_params_close(tstate, jstate, start, steps, lr=LR):
    """The train bars (``test_torch_n2v_train.py::_assert_params_close``):
    every value within ``2 * steps * lr``, the updates' L2 difference
    within 0.2 of their norm, the running statistics within 1e-3."""
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


STEP_CASES = {
    "flows_2d": ("flows", 2, False, None),
    "flows_2d_jitter": ("flows", 2, False, (0.2, 0.05, 0.02)),
    "flows_2d_polyphase": ("flows", 2, True, None),
    "flows_3d": ("flows", 3, False, None),
    "stars": ("stars", 2, False, None),
    "stars_jitter_polyphase": ("stars", 2, True, (0.2, 0.05, 0.02)),
}


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_three_steps_match_the_reference(name):
    family, dims, poly, jitter = STEP_CASES[name]
    num_classes = dims + 1 if family == "flows" else 1 + N_RAYS
    jcfg, tcfg, jtc, ttc, jstate, tstate = _pair(num_classes, dims, poly, jitter or (0.0, 0.0, 0.0))
    start = _flat(jstate.params, jstate.model_state)
    if family == "flows":
        jstep, tstep, extra = jax_train.make_flows_train_step(jcfg, jtc), train.make_flows_train_step(tcfg, ttc), "flow_mse"
    else:
        jstep, tstep, extra = jax_train.make_stars_train_step(jcfg, jtc), train.make_stars_train_step(tcfg, ttc), "dist_mae"
    for s in range(3):
        if family == "flows":
            x, t, p = _flows_batch(4 if dims == 2 else 2, 32, 400 + 4 * s, dims)
            batch = {"image": x, "flow": t, "prob": p}
        else:
            x, t, p = _stars_batch(4, 32, 500 + 4 * s)
            batch = {"image": x, "dist": t, "prob": p}
            assert 0 < p.max() <= 1 and np.any((p > 0) & (p < 1))  # soft targets
        key = jax.random.PRNGKey(200 + s)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()}, key)
        draws = jax_flip_draws(key, x.shape, dims, jitter)
        tstate, tm = tstep(tstate, {k: torch.from_numpy(v) for k, v in batch.items()}, draws=draws)
        for m in ("loss", extra, "prob_bce"):
            np.testing.assert_allclose(float(tm[m]), float(jm[m]), rtol=1e-4, err_msg=m)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=2e-3)  # chip_smoke's TRAIN_GRAD_NORM_RTOL
    assert tstate.step == 3
    _assert_params_close(tstate, jstate, start, 3)


def test_step_errors():
    with pytest.raises(ValueError, match="num_classes == dims \\+ 1"):
        train.make_flows_train_step(torch_unet.UNetConfig(num_classes=4), train.TrainConfig())
    with pytest.raises(ValueError, match="2D only"):
        train.make_stars_train_step(torch_unet.UNetConfig(num_classes=9, dims=3), train.TrainConfig())
    with pytest.raises(ValueError, match="positive multiple of 4"):
        train.make_stars_train_step(torch_unet.UNetConfig(num_classes=7), train.TrainConfig())


# ---------------------------------------------------------------------------
# codecs, evaluators and the fit loops
# ---------------------------------------------------------------------------


def test_codecs_are_the_reference_codecs():
    x, f, p = _flows_batch(1, 32, 600, 3)
    assert fit.encode_flow_example(x[0, ..., 0], f[0], p[0]) == jax_fit.encode_flow_example(x[0, ..., 0], f[0], p[0])
    x, d, p = _stars_batch(1, 32, 610)
    payload = jax_fit.encode_stars_example(x[0, ..., 0], d[0], p[0])
    assert fit.encode_stars_example(x[0, ..., 0], d[0], p[0]) == payload
    for k, v in fit._decode_stars(payload).items():
        assert np.array_equal(v, jax_fit._decode_stars(payload)[k]), k


@pytest.fixture(scope="module")
def family_shards(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("family_shards")
    x, f, p = _flows_batch(12, 32, 700)
    flows_paths = records.write_shards(
        str(tmp / "flows"), (fit.encode_flow_example(*e) for e in zip(x, f, p)), shard_size=6
    )
    x, d, p = _stars_batch(12, 32, 720)
    stars_paths = records.write_shards(
        str(tmp / "stars"), (fit.encode_stars_example(*e) for e in zip(x, d, p)), shard_size=6
    )
    return {"flows": flows_paths, "stars": stars_paths}


@pytest.mark.parametrize("family", ["flows", "stars"])
def test_evaluators_match_the_reference_on_soft_targets(family_shards, family):
    """The same weights: the holdout evaluators' numbers (stars: distances
    weighted by the soft ``prob`` itself, not ``prob > 0`` as the step)."""
    num_classes = 3 if family == "flows" else 1 + N_RAYS
    jcfg, tcfg, jtc, ttc, jstate, tstate = _pair(num_classes)
    fc_kw = dict(holdout_every=3, eval_limit=16)
    make_j = jax_fit._make_flows_evaluator if family == "flows" else jax_fit._make_stars_evaluator
    make_t = fit._make_flows_evaluator if family == "flows" else fit._make_stars_evaluator
    want = make_j(jcfg, jax_fit.FitConfig(**fc_kw), family_shards[family])(jstate, 0)
    got = make_t(tcfg, fit.FitConfig(**fc_kw), family_shards[family], torch.device("cpu"))(tstate, 0)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5, err_msg=k)
    if family == "stars":
        held = fit.load_holdout(family_shards["stars"], fit._decode_stars, 3, 16)
        assert np.any((held["prob"] > 0) & (held["prob"] < 1))


def _rows(path, kind):
    with open(path) as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


@pytest.mark.parametrize("family", ["flows", "stars"])
def test_fit_against_the_reference(family_shards, tmp_path, monkeypatch, family):
    """6 steps, batch 2, holdout every 3rd example, eval every 3 steps, each
    step on the JAX loop's draws (``fold_in(PRNGKey(seed), step)``): the
    train losses and the eval metrics follow the JAX package's."""
    fit_kw = dict(steps=6, batch_size=2, log_every=1, seed=4, shuffle_buffer=5, holdout_every=3,
                  eval_every=3, checkpoint_every=3)
    num_classes = 3 if family == "flows" else 1 + N_RAYS
    jcfg, tcfg, jtc, ttc, jstate, tstate = _pair(num_classes, lr=1e-4)
    jpath, tpath = str(tmp_path / "jax.jsonl"), str(tmp_path / "torch.jsonl")
    jfit = jax_fit.fit_flows if family == "flows" else jax_fit.fit_stars
    jfit(jcfg, jtc, jax_fit.FitConfig(metrics_path=jpath, **fit_kw), family_shards[family],
         ckpt_dir=str(tmp_path / "jax_ckpt"), init_state=jstate)

    name = f"make_{family}_train_step"
    real = getattr(train, name)

    def on_jax_draws(cfg, tc):
        step = real(cfg, tc)

        def run(state, batch, generator=None):
            key = jax.random.fold_in(jax.random.PRNGKey(fit_kw["seed"]), state.step)
            return step(state, batch, draws=jax_flip_draws(key, tuple(batch["image"].shape), 2))

        return run

    monkeypatch.setattr(fit.train_lib, name, on_jax_draws)
    tfit = fit.fit_flows if family == "flows" else fit.fit_stars
    tfit(tcfg, ttc, fit.FitConfig(metrics_path=tpath, **fit_kw), family_shards[family],
         ckpt_dir=str(tmp_path / "torch_ckpt"), init_state=tstate, device="cpu")
    jt, tt = _rows(jpath, "train"), _rows(tpath, "train")
    assert [r["step"] for r in tt] == [r["step"] for r in jt] == list(range(1, 7))
    np.testing.assert_allclose([r["loss"] for r in tt], [r["loss"] for r in jt], rtol=1e-4)
    je, te = _rows(jpath, "eval"), _rows(tpath, "eval")
    assert [r["step"] for r in te] == [r["step"] for r in je] == [3, 6]
    for a, b in zip(te, je):
        assert set(a) == set(b)
        for k in a:
            if k.startswith("eval_"):
                # inference-mode BN: the BN-nulled biases no longer cancel
                np.testing.assert_allclose(a[k], b[k], rtol=1e-3, err_msg=k)
    assert sorted(os.listdir(tmp_path / "torch_ckpt")) == ["final", "step_00000003", "step_00000006"]


def test_keep_best_metric_sets():
    """A misspelt keep_best_metric fails before training, naming the set."""
    for fn, nc, known in (
        (fit.fit_flows, 3, ["eval_flow_mse", "eval_loss", "eval_prob_bce"]),
        (fit.fit_stars, 33, ["eval_dist_mae", "eval_loss", "eval_prob_bce"]),
    ):
        with pytest.raises(ValueError, match=re.escape(str(known))):
            fn(torch_unet.UNetConfig(num_classes=nc), train.TrainConfig(),
               fit.FitConfig(keep_best_metric="eval_miou"), [], device="cpu")


# ---------------------------------------------------------------------------
# train_flows and train_stars through both servers
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    from scipy import ndimage

    tmp = tmp_path_factory.mktemp("instance_jobs")
    scenes = [synthetic.instances_frame(800 + i, (48, 48), density=1 / 300.0) for i in range(3)]
    frames = np.stack([img for img, _ in scenes]).clip(0, 65535).astype(np.uint16)
    labels = np.stack([lab for _, lab in scenes]).astype(np.uint16)
    vols, vlabs = [], []
    for t in range(2):
        v, lab = synthetic.cells_volume(810 + t, (8, 32, 32))
        vols.append(v.clip(0, 65535).astype(np.uint16))
        vlabs.append(ndimage.label(lab > 0)[0].astype(np.uint16))
    paths = {k: str(tmp / f"{k}.tif") for k in ("frames", "labels", "volumes", "vlabels", "short")}
    tiff.write_stack(paths["frames"], frames)
    tiff.write_stack(paths["labels"], labels)
    tiff.write_stack(paths["volumes"], np.concatenate(vols))
    tiff.write_stack(paths["vlabels"], np.concatenate(vlabs))
    tiff.write_stack(paths["short"], labels[:1])
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


SMALL = dict(depth=2, base_features=8, steps=2, batch_size=2, log_every=1)
JOBS = {
    "flows_2d": ("train_flows", ["frames", "labels"], dict(SMALL, patch=[32, 32], patches_per_frame=3,
                                                            shard_size=4, seed=5)),
    "flows_3d": ("train_flows", ["volumes", "vlabels"], dict(SMALL, dims=3, z=8, patch=[4, 16, 16],
                                                              patches_per_frame=2)),
    "stars": ("train_stars", ["frames", "labels"], dict(SMALL, patch=[32, 32], n_rays=N_RAYS, max_dist=20,
                                                        compute_dtype="float32")),
}


@pytest.mark.parametrize("case", sorted(JOBS))
def test_train_job_served_by_both_servers(env, case):
    module, inputs, params = JOBS[case]
    params = dict(params, model=case)
    paths = [env["paths"][k] for k in inputs]
    st = _run(env, "torch", case, module, paths, params)
    sj = _run(env, "jax", case, module, paths, params)
    assert st["state"] == "complete", st.get("error")
    assert sj["state"] == "complete", sj.get("error")
    ours, theirs = _shard_bytes(env, "torch", case), _shard_bytes(env, "jax", case)
    assert ours == theirs and ours
    assert _config(env, "torch", case) == _config(env, "jax", case)
    kind, cfg, _ = load_model(str(env["tmp"] / "torch_models"), case, device="cpu")
    assert kind == module.split("_")[1] and cfg.depth == 2
    if case == "stars":
        served = _run(env, "torch", "segment_stars", "segment_stars", [env["paths"]["frames"]], {"model": "stars"})
        assert served["state"] == "complete", served.get("error")


ERRORS = {
    "flows_dims": ("train_flows", ["frames", "labels"], {"dims": 4}, "dims 2 or 3"),
    "flows_one_input": ("train_flows", ["frames"], {}, "need [image(s)..., instance labels]"),
    "flows_3d_three": ("train_flows", ["volumes", "vlabels", "vlabels"], {"dims": 3, "z": 8}, "2 entries"),
    "flows_patch": ("train_flows", ["frames", "labels"], {"patch": [64, 64]}, "patch"),
    "flows_mismatch": ("train_flows", ["frames", "short"], {}, "shape mismatch"),
    "flows_keep_best": ("train_flows", ["frames", "labels"], {"patch": [32, 32], "keep_best": True}, "holdout_every"),
    "stars_dims": ("train_stars", ["frames", "labels"], {"dims": 3}, "2D only"),
    "stars_rays": ("train_stars", ["frames", "labels"], {"n_rays": 6}, "multiple of 4"),
    "stars_patch": ("train_stars", ["frames", "labels"], {"patch": [32]}, "patch"),
    "stars_best_metric": ("train_stars", ["frames", "labels"],
                          {"patch": [32, 32], "keep_best": True, "holdout_every": 2, "keep_best_metric": "eval_miou",
                           "n_rays": N_RAYS, "max_dist": 10, "depth": 2, "base_features": 4}, "keep_best_metric"),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_job_errors_match_the_reference(env, case):
    module, inputs, params, frag = ERRORS[case]
    params = dict(params, model=f"bad_{case}")
    paths = [env["paths"][k] for k in inputs]
    st = _run(env, "torch", f"bad_{case}", module, paths, params)
    sj = _run(env, "jax", f"bad_{case}", module, paths, params)
    assert st["state"] == sj["state"] == "failed", (st, sj)
    assert "JobError" in st["error"] and frag in st["error"], st["error"]

    assert _job_error(st["error"]) == _job_error(sj["error"])
