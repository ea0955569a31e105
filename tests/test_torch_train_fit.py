"""``fit_unet`` against the JAX package's on the same shards (augmentation
off, weights carried across), and the loop's own contracts: an interrupted
run resumed from its checkpoint equals the uninterrupted run, and
keep_best and the EMA keep and register the right weights.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequitr_tpu.models import convert as jax_convert
from sequitr_tpu.pipeline import fit as jax_fit
from sequitr_tpu.pipeline import train as jax_train
from sequitr_tpu.models import unet as jax_unet
from sequitr_tpu_torch.data import records, synthetic
from sequitr_tpu_torch.models import convert as torch_convert
from sequitr_tpu_torch.models import unet as torch_unet
from sequitr_tpu_torch.ops import weightmaps
from sequitr_tpu_torch.pipeline import fit, train
from sequitr_tpu_torch.server.server import _ema_or_raw_params


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """12 normalized 32x32 patches of ``synthetic.cells_frame`` with U-Net
    weight maps, in 2 shards."""
    tmp = tmp_path_factory.mktemp("shards")
    examples = []
    for i in range(12):
        img, lab = synthetic.cells_frame(91_000 + i, (32, 32))
        lo, hi = np.percentile(img, [5.0, 99.5])
        img = np.clip((img - lo) / (hi - lo), 0, 1).astype(np.float32)
        w = weightmaps.unet_weight_map(lab, num_classes=3)
        examples.append(records.SegExample(img, lab, w))
    return records.write_segmentation_shards(str(tmp / "train"), iter(examples), shard_size=6)


KW = dict(in_channels=1, num_classes=3, depth=2, base_features=8)


def _jax_state(cfg, tc, seed=0):
    return jax_train.create_unet_state(jax.random.PRNGKey(seed), cfg, tc)


def _carried(jstate, tc):
    flat = dict(jax_convert.flatten_params(jstate.params))
    flat.update({f"state/{k}": v for k, v in jax_convert.flatten_params(jstate.model_state).items()})
    cfg = torch_unet.UNetConfig(compute_dtype="float32", **KW)
    return cfg, torch_convert.load_train_state(cfg, tc, {k: np.asarray(v) for k, v in flat.items()}, device="cpu")


def _rows(path, kind):
    with open(path) as f:
        return [r for r in map(json.loads, f) if r["kind"] == kind]


def test_fit_unet_against_the_reference(shards, tmp_path):
    """6 steps, batch 2, holdout every 3rd example, eval every 3 steps:
    the train losses and the eval metrics follow the JAX package's."""
    fit_kw = dict(
        steps=6, batch_size=2, log_every=1, seed=4, shuffle_buffer=5,
        holdout_every=3, eval_every=3, checkpoint_every=3,
    )
    jcfg = jax_unet.UNetConfig(compute_dtype=jnp.float32, **KW)
    jtc = jax_train.TrainConfig(augment=False, learning_rate=1e-3)
    ttc = train.TrainConfig(augment=False, learning_rate=1e-3)
    jstate = _jax_state(jcfg, jtc)
    cfg, tstate = _carried(jstate, ttc)
    jpath, tpath = str(tmp_path / "jax.jsonl"), str(tmp_path / "torch.jsonl")
    jax_fit.fit_unet(
        jcfg, jtc, jax_fit.FitConfig(metrics_path=jpath, **fit_kw), shards,
        ckpt_dir=str(tmp_path / "jax_ckpt"), init_state=jstate,
    )
    fit.fit_unet(
        cfg, ttc, fit.FitConfig(metrics_path=tpath, **fit_kw), shards,
        ckpt_dir=str(tmp_path / "torch_ckpt"), init_state=tstate, device="cpu",
    )
    jt, tt = _rows(jpath, "train"), _rows(tpath, "train")
    assert [r["step"] for r in tt] == [r["step"] for r in jt] == list(range(1, 7))
    np.testing.assert_allclose([r["loss"] for r in tt], [r["loss"] for r in jt], rtol=1e-4)
    np.testing.assert_allclose([r["grad_norm"] for r in tt], [r["grad_norm"] for r in jt], rtol=1e-3)
    je, te = _rows(jpath, "eval"), _rows(tpath, "eval")
    assert [r["step"] for r in te] == [r["step"] for r in je] == [3, 6]
    # eval runs batch norm on its running statistics, where a conv bias no
    # longer cancels: the biases' round-off gradients, which Adam turns into
    # steps of up to lr either way (test_torch_train_step.py), show there
    for a, b in zip(te, je):
        assert set(a) == set(b)
        np.testing.assert_allclose(a["eval_loss"], b["eval_loss"], rtol=1e-3)
        np.testing.assert_allclose(a["eval_miou"], b["eval_miou"], atol=2e-3)
    assert sorted(os.listdir(tmp_path / "torch_ckpt")) == ["final", "step_00000003", "step_00000006"]


def _port_run(shards, ckpt_dir, metrics, stop_at=None, init_state=None, **fit_kw):
    cfg = torch_unet.UNetConfig(compute_dtype="float32", **KW)
    tc = train.TrainConfig(p_elastic=1.0, learning_rate=1e-3, noise_std=0.01)
    fc = fit.FitConfig(
        batch_size=2, log_every=1, seed=7, shuffle_buffer=5, metrics_path=metrics, **fit_kw
    )
    calls = {"n": 0}

    def should_stop():
        calls["n"] += 1
        return stop_at is not None and calls["n"] > stop_at

    state = init_state or train.create_unet_state(cfg, tc, torch.Generator().manual_seed(1), device="cpu")
    return cfg, tc, fc, fit.fit_unet(
        cfg, tc, fc, shards, ckpt_dir=ckpt_dir, init_state=state,
        should_stop=should_stop, device="cpu",
    )


def test_resumed_run_equals_uninterrupted(shards, tmp_path):
    """Augmentation, EMA and the record stream included: cancelled at step 3
    (checkpointed), resumed from the newest checkpoint, the run ends with
    the weights, statistics, optimizer state and EMA of a run that went
    through, bit for bit."""
    kw = dict(steps=6, checkpoint_every=2, ema_decay=0.9)
    _, _, _, whole = _port_run(shards, str(tmp_path / "a"), str(tmp_path / "a.jsonl"), **kw)
    with pytest.raises(fit.TrainingCancelled):
        _port_run(shards, str(tmp_path / "b"), str(tmp_path / "b.jsonl"), stop_at=3, **kw)
    ckpt = fit.latest_checkpoint(str(tmp_path / "b"))
    assert os.path.basename(ckpt) == "step_00000003"
    cfg = torch_unet.UNetConfig(compute_dtype="float32", **KW)
    template = train.create_unet_state(cfg, train.TrainConfig(), device="cpu")
    restored = train.restore_checkpoint(ckpt, template)
    assert restored.step == 3
    _, _, _, resumed = _port_run(
        shards, str(tmp_path / "b"), str(tmp_path / "b.jsonl"), init_state=restored, **kw
    )
    assert resumed.step == whole.step == 6
    for (k, a), b in zip(whole.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert torch.equal(whole.opt_state.mu, resumed.opt_state.mu)
    assert torch.equal(whole.opt_state.nu, resumed.opt_state.nu)
    ema_a = train.restore_checkpoint(str(tmp_path / "a" / "ema_final"), [torch.zeros_like(p) for p in whole.params])
    ema_b = train.restore_checkpoint(str(tmp_path / "b" / "ema_final"), [torch.zeros_like(p) for p in whole.params])
    assert all(torch.equal(a, b) for a, b in zip(ema_a, ema_b))
    losses_a = [r["loss"] for r in _rows(str(tmp_path / "a.jsonl"), "train")]
    losses_b = [r["loss"] for r in _rows(str(tmp_path / "b.jsonl"), "train")]
    assert losses_a == losses_b


def test_keep_best_and_ema_register_the_right_weights(shards, tmp_path):
    """keep_best on eval_loss keeps the best eval's step as ``best`` (and
    its EMA as ``ema_best``); the job's registration takes ``ema_best``'s
    parameters with ``best``'s batch-norm statistics."""
    ckpt = str(tmp_path / "c")
    metrics = str(tmp_path / "c.jsonl")
    cfg, tc, fc, state = _port_run(
        shards, ckpt, metrics, steps=6, checkpoint_every=1, keep_checkpoints=0,
        holdout_every=3, eval_every=1, keep_best_metric="eval_loss", ema_decay=0.8,
    )
    evals = _rows(metrics, "eval")
    best_step = min(evals, key=lambda r: r["eval_loss"])["step"]
    assert _rows(metrics, "best")[-1]["step"] == best_step

    def tensors(name):
        return torch.load(os.path.join(ckpt, name, "state.pt"), weights_only=True)

    best, at_step = tensors("best"), tensors(f"step_{best_step:08d}")
    assert best["step"] == best_step
    for k, v in at_step["model"].items():
        assert torch.equal(best["model"][k], v), k
    ema_best, ema_at = tensors("ema_best"), tensors(f"ema_step_{best_step:08d}")
    assert all(torch.equal(a, b) for a, b in zip(ema_best["tensors"], ema_at["tensors"]))
    train.restore_checkpoint(os.path.join(ckpt, "best"), state)
    reg = _ema_or_raw_params(ckpt, fc, state, used_best=True)
    for (name, p), e in zip(reg.named_parameters(), ema_best["tensors"]):
        assert torch.equal(p, e), name
    for (name, b), want in zip(reg.named_buffers(), state.model.buffers()):
        assert torch.equal(b, want), name
    # without EMA the state's own module is registered
    plain = fit.FitConfig()
    assert _ema_or_raw_params(ckpt, plain, state, used_best=True) is state.model
