"""GAN training against the JAX package: the losses, three train steps from
the same weights (standard and polyphase generator forward), ``fit_gan``
with its holdout evaluator and a resume, ``build_gan_pairs`` shards byte for
byte, and ``train_gan`` served by both servers from one init.

Weights cross in the flat interchange layout. Bars as in
``test_torch_train_step.py``: losses at rtol 1e-4 (f32 convs summed in
another order); every weight within ``2 * steps * lr`` (Adam moves a weight
by up to lr a step, and a conv bias a batch norm follows has a round-off
gradient two implementations may step in opposite directions; its running
mean carries it), and all but 1e-4 of the other values within 1e-5.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from sequitr_tpu.config import ServerConfiguration as JaxConfig
from sequitr_tpu.models import convert as jax_convert
from sequitr_tpu.models import gan as jax_gan
from sequitr_tpu.ops import losses as jax_losses
from sequitr_tpu.pipeline import fit as jax_fit
from sequitr_tpu.pipeline import train as jax_train
from sequitr_tpu.server import ImageServer as JaxServer
from sequitr_tpu.server import submit_job as jax_submit
from sequitr_tpu.server.server import load_model as jax_load_model
from sequitr_tpu_torch.config import ServerConfiguration as TorchConfig
from sequitr_tpu_torch.data import synthetic
from sequitr_tpu_torch.data import tiff as torch_tiff
from sequitr_tpu_torch.models import convert as torch_convert
from sequitr_tpu_torch.models import gan as torch_gan
from sequitr_tpu_torch.ops import losses as torch_losses
from sequitr_tpu_torch.pipeline import fit, train
from sequitr_tpu_torch.server import ImageServer as TorchServer
from sequitr_tpu_torch.server import submit_job as torch_submit
from sequitr_tpu_torch.server.server import read_model

LR = 2e-4  # train_gan's default learning rate (beta1 0.5)
GAN_KW = dict(gen_depth=3, gen_base_features=8, disc_layers=2, disc_base_features=8)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _flat(params, state):
    flat = dict(jax_convert.flatten_params(params))
    flat.update({f"state/{k}": v for k, v in jax_convert.flatten_params(state).items()})
    return {k: np.asarray(v) for k, v in flat.items()}


def _pair(polyphase=False):
    jcfg = jax_gan.GANConfig(compute_dtype=jnp.float32, **GAN_KW)
    tcfg = torch_gan.GANConfig(compute_dtype="float32", **GAN_KW)
    jtc = jax_train.TrainConfig(learning_rate=LR, beta1=0.5, augment=False, polyphase=polyphase)
    ttc = train.TrainConfig(learning_rate=LR, beta1=0.5, augment=False, polyphase=polyphase)
    jstate = jax_train.create_gan_state(jax.random.PRNGKey(0), jcfg, jtc)
    model = torch_convert.load_flat(tcfg, _flat(jstate.params, jstate.model_state), device="cpu")
    return jcfg, tcfg, jtc, ttc, jstate, train.create_gan_state(tcfg, ttc, model=model)


def _pairs(n, size, seed):
    """``n`` normalized cells frames and their smoothed targets, (N, H, W, 1)."""
    xs = []
    for i in range(n):
        img, _ = synthetic.cells_frame(seed + i, (size, size))
        lo, hi = np.percentile(img, [5.0, 99.5])
        xs.append(np.clip((img - lo) / (hi - lo), 0, 1).astype(np.float32))
    ys = [ndimage.gaussian_filter(x, 1.5).astype(np.float32) for x in xs]
    return np.stack(xs)[..., None], np.stack(ys)[..., None]


def _bn_nulled(key):
    return key.endswith(("conv1/b", "conv2/b", "/mean"))


def _assert_weights_close(got, want, steps, share=1e-4):
    """``share``: the fraction of the non-nulled values allowed beyond 1e-5
    (those stay within lr / 2)."""
    assert set(got) == set(want)
    diff = {k: np.abs(got[k] - want[k]).ravel() for k in sorted(want)}
    worst = max(float(d.max()) for d in diff.values())
    assert worst <= 2 * steps * LR, worst
    rest = np.concatenate([d for k, d in diff.items() if not _bn_nulled(k)])
    assert np.mean(rest > 1e-5) < share, np.mean(rest > 1e-5)
    assert rest.max() <= LR / 2, rest.max()


def test_gan_losses_match_the_reference():
    rng = np.random.default_rng(0)
    real, fake = (rng.normal(size=(2, 4, 4, 1)).astype(np.float32) * 3 for _ in range(2))
    img, tgt = (rng.random((2, 8, 8, 1)).astype(np.float32) for _ in range(2))
    want_d = float(jax_losses.gan_discriminator_loss(jnp.asarray(real), jnp.asarray(fake)))
    got_d = float(torch_losses.gan_discriminator_loss(torch.from_numpy(real), torch.from_numpy(fake)))
    np.testing.assert_allclose(got_d, want_d, rtol=1e-6)
    for w in (100.0, 1.0):
        want_g = float(jax_losses.gan_generator_loss(
            jnp.asarray(fake), jnp.asarray(img), jnp.asarray(tgt), w))
        got_g = float(torch_losses.gan_generator_loss(
            torch.from_numpy(fake), torch.from_numpy(img), torch.from_numpy(tgt), w))
        np.testing.assert_allclose(got_g, want_g, rtol=1e-6)


def test_gan_init_shapes_and_scale():
    """``gan.init``: the JAX package's shapes (the flat keys of
    ``jax_gan.init``), He-normal kernels, zero biases, BN at identity."""
    cfg = torch_gan.GANConfig(compute_dtype="float32", **GAN_KW)
    got = torch_convert.to_flat(torch_gan.init(cfg, torch.Generator().manual_seed(3), device="cpu"))
    jp, js = jax_gan.init(jax.random.PRNGKey(3), jax_gan.GANConfig(compute_dtype=jnp.float32, **GAN_KW))
    want = _flat(jp, js)
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    for k, v in got.items():
        if k.endswith("/w"):
            fan_in = int(np.prod(v.shape[:-1]))
            assert abs(v.std() * np.sqrt(fan_in / 2.0) - 1.0) < 0.35, k
        elif k.endswith(("/b", "/bias", "/mean")):
            assert not v.any(), k
        else:
            assert (v == 1).all(), k


@pytest.mark.parametrize("polyphase", [False, True], ids=["standard", "polyphase"])
def test_three_gan_steps_match_the_reference(polyphase):
    """3 f32 steps from the JAX init's weights: losses at rtol 1e-4, the
    weights within the module's bars. Polyphase: the phase-domain level 0
    sums in another order in both packages, and at the GAN's lr (2e-4) and
    beta1 (0.5) Adam turns those round-off differences of small gradients
    into weight differences up to 2.3e-5 on 15 of ~40,000 values (0.04%),
    so that case allows 0.1% of values beyond 1e-5 (all within lr / 2)."""
    jcfg, tcfg, jtc, ttc, jstate, tstate = _pair(polyphase)
    jstep = jax_train.make_gan_train_step(jcfg, jtc)
    tstep = train.make_gan_train_step(tcfg, ttc)
    key = jax.random.PRNGKey(1)
    for s in range(3):
        x, y = _pairs(2, 32, 60_000 + 2 * s)
        jstate, jm = jstep(jstate, {"input": jnp.asarray(x), "target": jnp.asarray(y)},
                           jax.random.fold_in(key, s))
        tstate, tm = tstep(tstate, {"input": torch.from_numpy(x), "target": torch.from_numpy(y)})
        for k in ("d_loss", "g_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=f"{k} @ {s}")
    assert tstate.step == 3 and int(jstate.step) == 3
    _assert_weights_close(
        torch_convert.to_flat(tstate.model), _flat(jstate.params, jstate.model_state), 3,
        share=1e-3 if polyphase else 1e-4,
    )


def test_discriminator_step_precedes_the_generator_loss():
    """The step moves the discriminator exactly as its own update on (real,
    detached fake) does, bit for bit: the generator's loss, taken after it,
    sends it no gradient."""
    _, tcfg, _, _, _, _ = _pair()
    model = torch_gan.init(tcfg, torch.Generator().manual_seed(5), device="cpu")
    x, y = _pairs(2, 32, 61_000)
    batch = {"input": torch.from_numpy(x), "target": torch.from_numpy(y)}
    ttc = train.TrainConfig(learning_rate=LR, beta1=0.5, augment=False)
    state = train.create_gan_state(tcfg, ttc, model=model)
    disc0 = [p.detach().clone() for p in model.disc.parameters()]
    # D's update alone, by hand
    opt = ttc.make_optimizer()
    dstate = opt.init(list(model.disc.parameters()))
    with torch.no_grad():
        fake = torch_gan.generator_train(model, batch["input"])[0]
    ref = [p.detach().clone().requires_grad_(True) for p in disc0]
    saved = [p.data.clone() for p in model.disc.parameters()]
    d_loss = torch_losses.gan_discriminator_loss(
        torch_gan.discriminator_apply(model, batch["input"], batch["target"]),
        torch_gan.discriminator_apply(model, batch["input"], fake),
    )
    grads = torch.autograd.grad(d_loss, list(model.disc.parameters()))
    opt.update(ref, grads, dstate)
    for p, s in zip(model.disc.parameters(), saved):
        assert torch.equal(p.data, s)
    _, metrics = train.make_gan_train_step(tcfg, ttc)(state, batch)
    for got, want in zip(model.disc.parameters(), ref):
        torch.testing.assert_close(got.detach(), want.detach(), rtol=0, atol=0)
    assert float(metrics["d_loss"]) == pytest.approx(float(d_loss.detach()), rel=1e-6)


@pytest.fixture(scope="module")
def pair_shards(tmp_path_factory):
    """12 (raw, target) 32x32 pairs in 2 shards."""
    from sequitr_tpu_torch.data import records

    tmp = tmp_path_factory.mktemp("pairs")
    x, y = _pairs(12, 32, 62_000)
    paths = []
    for s in range(2):
        path = str(tmp / f"pairs-{s:05d}-of-00002.tfrecord")
        with records.RecordWriter(path) as w:
            for i in range(6 * s, 6 * s + 6):
                w.write(fit.encode_pair(x[i, ..., 0], y[i, ..., 0]))
        paths.append(path)
    return paths


def _rows(path, kind):
    with open(path) as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


def test_fit_gan_against_the_reference(pair_shards, tmp_path):
    """6 steps, batch 2, holdout every 3rd pair, eval every 3 steps, EMA of
    the generator: the train losses and the eval metrics follow the JAX
    package's, and the EMA twins hold the generator alone."""
    fit_kw = dict(
        steps=6, batch_size=2, log_every=1, seed=4, shuffle_buffer=5,
        holdout_every=3, eval_every=3, checkpoint_every=3, ema_decay=0.5,
    )
    jcfg, tcfg, jtc, ttc, jstate, tstate = _pair()
    jpath, tpath = str(tmp_path / "jax.jsonl"), str(tmp_path / "torch.jsonl")
    jax_fit.fit_gan(
        jcfg, jtc, jax_fit.FitConfig(metrics_path=jpath, **fit_kw), pair_shards,
        ckpt_dir=str(tmp_path / "jax_ckpt"), init_state=jstate,
    )
    fit.fit_gan(
        tcfg, ttc, fit.FitConfig(metrics_path=tpath, **fit_kw), pair_shards,
        ckpt_dir=str(tmp_path / "torch_ckpt"), init_state=tstate, device="cpu",
    )
    jt, tt = _rows(jpath, "train"), _rows(tpath, "train")
    assert [r["step"] for r in tt] == [r["step"] for r in jt] == list(range(1, 7))
    for k in ("d_loss", "g_loss"):
        np.testing.assert_allclose([r[k] for r in tt], [r[k] for r in jt], rtol=1e-4, err_msg=k)
    je, te = _rows(jpath, "eval"), _rows(tpath, "eval")
    assert [r["step"] for r in te] == [r["step"] for r in je] == [3, 6]
    for a, b in zip(te, je):
        assert set(a) == set(b) >= {"eval_l1", "eval_psnr"}
        # eval-mode BN on running means that carry the BN-nulled biases
        np.testing.assert_allclose(a["eval_l1"], b["eval_l1"], rtol=1e-3)
        np.testing.assert_allclose(a["eval_psnr"], b["eval_psnr"], atol=1e-2)
    assert sorted(os.listdir(tmp_path / "torch_ckpt")) == [
        "ema_final", "ema_step_00000003", "ema_step_00000006", "final", "step_00000003", "step_00000006",
    ]
    ema = train.restore_checkpoint(
        str(tmp_path / "torch_ckpt" / "ema_final"), [p.detach().clone() for p in tstate.model.gen.parameters()]
    )
    assert len(ema) == len(list(tstate.model.gen.parameters()))


def test_fit_gan_resume_equals_uninterrupted(pair_shards, tmp_path):
    """Cancelled after 3 steps (checkpointed), resumed from the newest
    checkpoint: the same weights, optimizer states and EMA as a run that
    went through, bit for bit."""
    tcfg = torch_gan.GANConfig(compute_dtype="float32", **GAN_KW)
    ttc = train.TrainConfig(learning_rate=LR, beta1=0.5, augment=False)

    def run(ckpt, stop_at=None, init_state=None):
        calls = {"n": 0}

        def should_stop():
            calls["n"] += 1
            return stop_at is not None and calls["n"] > stop_at

        fc = fit.FitConfig(steps=5, batch_size=2, seed=2, shuffle_buffer=5, checkpoint_every=3, ema_decay=0.9)
        state = init_state or train.create_gan_state(tcfg, ttc, torch.Generator().manual_seed(1), device="cpu")
        return fit.fit_gan(tcfg, ttc, fc, pair_shards, ckpt_dir=ckpt, init_state=state,
                           should_stop=should_stop, device="cpu")

    whole = run(str(tmp_path / "a"))
    with pytest.raises(fit.TrainingCancelled):
        run(str(tmp_path / "b"), stop_at=3)
    ckpt = fit.latest_checkpoint(str(tmp_path / "b"))
    assert os.path.basename(ckpt) == "step_00000003"
    restored = train.restore_checkpoint(ckpt, train.create_gan_state(tcfg, ttc, device="cpu"))
    assert restored.step == 3
    resumed = run(str(tmp_path / "b"), init_state=restored)
    for a, b in zip(whole.model.state_dict().values(), resumed.model.state_dict().values()):
        assert torch.equal(a, b)
    for a, b in ((whole.gen_opt_state, resumed.gen_opt_state), (whole.disc_opt_state, resumed.disc_opt_state)):
        assert a.count == b.count and torch.equal(a.mu, b.mu) and torch.equal(a.nu, b.nu)
    ea = train.restore_checkpoint(str(tmp_path / "a" / "ema_final"), [p.detach().clone() for p in whole.model.gen.parameters()])
    eb = train.restore_checkpoint(str(tmp_path / "b" / "ema_final"), [p.detach().clone() for p in whole.model.gen.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(ea, eb))


# ---------------------------------------------------------------------------
# the jobs through both servers
# ---------------------------------------------------------------------------


def _serve(tmp, which, name, module, params, inputs, models):
    out = str(tmp / f"{which}_{name}")
    jobs = str(tmp / f"{which}_jobs")
    spec = {"module": module, "params": params, "input": inputs, "output": out}
    if which == "jax":
        jax_submit(jobs, spec)
        assert JaxServer(JaxConfig(jobs_dir=jobs, models_dir=models, compilation_cache_dir=None)).poll_once()
    else:
        torch_submit(jobs, spec)
        assert TorchServer(TorchConfig(jobs_dir=jobs, models_dir=models, device="cpu")).poll_once()
    with open(os.path.join(out, "status.json")) as f:
        status = json.load(f)
    assert status["state"] == "complete", status.get("error")
    return status["outputs"]


@pytest.fixture(scope="module")
def gan_stacks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gan_jobs")
    raw = np.stack([synthetic.cells_frame(63_000 + i, (32, 32))[0] for i in range(6)])
    raw = raw.clip(0, 65535).astype(np.uint16)
    tgt = np.stack([ndimage.gaussian_filter(r.astype(np.float32), 1.5) for r in raw])
    paths = (str(tmp / "raw.tif"), str(tmp / "target.tif"))
    torch_tiff.write_stack(paths[0], raw)
    torch_tiff.write_stack(paths[1], tgt)
    return tmp, paths


@pytest.mark.parametrize("params", [{"shard_size": 4}, {"normalize": False, "p_lo": 1.0}],
                         ids=["normalized", "raw"])
def test_build_gan_pairs_shards_byte_equal(gan_stacks, params):
    tmp, paths = gan_stacks
    name = "pairs_" + "_".join(sorted(params))
    oj = _serve(tmp, "jax", name, "build_gan_pairs", params, list(paths), str(tmp / "jm"))
    ot = _serve(tmp, "torch", name, "build_gan_pairs", params, list(paths), str(tmp / "tm"))
    assert ot["n_examples"] == oj["n_examples"] == "6"
    fj, ft = sorted(glob.glob(oj["shards"])), sorted(glob.glob(ot["shards"]))
    assert [os.path.basename(p) for p in ft] == [os.path.basename(p) for p in fj]
    for a, b in zip(ft, fj):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


def test_train_gan_served_by_both_servers(gan_stacks):
    """build_gan_pairs -> train_gan (4 steps, EMA of the generator) on both
    servers from one init (each server's step-0 checkpoint of the JAX
    init's weights, which the job resumes from): the registered
    configurations are equal, the registered generators agree within the
    step bars, and ``enhancement_gan`` serves each."""
    tmp, paths = gan_stacks
    jm, tm = str(tmp / "train_jm"), str(tmp / "train_tm")
    oj = _serve(tmp, "jax", "pairs", "build_gan_pairs", {}, list(paths), jm)
    _serve(tmp, "torch", "pairs", "build_gan_pairs", {}, list(paths), tm)
    params = dict(model="trained", steps=4, batch_size=2, log_every=1, ema_decay=0.5,
                  compute_dtype="float32", **GAN_KW)
    jcfg, tcfg, jtc, ttc, jstate, tstate = _pair()
    for which, state in (("jax", jstate), ("torch", tstate)):
        ckpt = str(tmp / f"{which}_train" / "ckpts" / "step_00000000")
        os.makedirs(os.path.dirname(ckpt), exist_ok=True)
        (jax_train if which == "jax" else train).save_checkpoint(ckpt, state)
    shards = os.path.dirname(oj["shards"])
    oj = _serve(tmp, "jax", "train", "train_gan", params, [shards], jm)
    ot = _serve(tmp, "torch", "train", "train_gan", params, [shards], tm)
    jt, tt = _rows(oj["metrics_file"], "train"), _rows(ot["metrics_file"], "train")
    for k in ("d_loss", "g_loss"):
        np.testing.assert_allclose([r[k] for r in tt], [r[k] for r in jt], rtol=1e-4, err_msg=k)
    with open(os.path.join(jm, "trained", "config.json")) as f:
        jconf = json.load(f)
    with open(os.path.join(tm, "trained", "config.json")) as f:
        tconf = json.load(f)
    assert tconf == {k: (str(v) if k == "compute_dtype" else v) for k, v in jconf.items()}
    kind, _, got = read_model(tm, "trained")
    _, _, jparams, jstate_ = jax_load_model(jm, "trained")
    assert kind == "gan"
    _assert_weights_close(got, _flat(jparams, jstate_), 4)
    for which, models in (("jax", jm), ("torch", tm)):
        out = _serve(tmp, which, "enhance", "enhancement_gan", {"model": "trained"}, [paths[0]], models)
        assert torch_tiff.read_stack(out["enhanced"]).shape == (6, 32, 32)
