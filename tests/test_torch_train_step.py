"""The U-Net train step against the JAX package: the ``train2d_losses.npz``
golden from the reference's own init weights, the step itself (loss,
accuracy, grad_norm, weights), train-mode batch norm, the optimizer
against optax, and a resume from the reference's train state.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sequitr_tpu.data import synthetic
from sequitr_tpu.models import convert as jax_convert
from sequitr_tpu.models import unet as jax_unet
from sequitr_tpu.pipeline import train as jax_train
from sequitr_tpu_torch.models import convert as torch_convert
from sequitr_tpu_torch.models import unet as torch_unet
from sequitr_tpu_torch.pipeline import train as torch_train

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _flat(params, state, opt_state=None, step=None):
    flat = dict(jax_convert.flatten_params(params))
    flat.update({f"state/{k}": v for k, v in jax_convert.flatten_params(state).items()})
    if opt_state is not None:
        adam = next(
            s for s in jax.tree.leaves(opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
            if isinstance(s, optax.ScaleByAdamState)
        )
        flat.update({f"opt/mu/{k}": v for k, v in jax_convert.flatten_params(adam.mu).items()})
        flat.update({f"opt/nu/{k}": v for k, v in jax_convert.flatten_params(adam.nu).items()})
        flat["opt/count"] = np.asarray(adam.count)
        flat["opt/step"] = np.asarray(step)
    return {k: np.asarray(v) for k, v in flat.items()}


def _golden_batch(s):
    """Step ``s``'s batch of ``tools/make_goldens.py::make_train2d_losses``."""
    imgs, labs = [], []
    for b in range(2):
        img, lab = synthetic.cells_frame(50_000 + s * 2 + b, (64, 64))
        lo, hi = np.percentile(img, [5.0, 99.5])
        imgs.append(np.clip((img - lo) / (hi - lo), 0, 1).astype(np.float32))
        labs.append(lab)
    return (
        np.stack(imgs)[..., None],
        np.stack(labs).astype(np.int32),
        np.ones((2, 64, 64), np.float32),
    )


CFG_KW = dict(in_channels=1, num_classes=3, depth=3, base_features=16)


def _pair(**tc_kw):
    jcfg = jax_unet.UNetConfig(compute_dtype=jnp.float32, **CFG_KW)
    tcfg = torch_unet.UNetConfig(compute_dtype="float32", **CFG_KW)
    jtc = jax_train.TrainConfig(augment=False, **tc_kw)
    ttc = torch_train.TrainConfig(augment=False, **tc_kw)
    jstate = jax_train.create_unet_state(jax.random.PRNGKey(0), jcfg, jtc)
    tstate = torch_convert.load_train_state(tcfg, ttc, _flat(jstate.params, jstate.model_state), device="cpu")
    return jcfg, tcfg, jtc, ttc, jstate, tstate


def _torch_batch(image, labels, weights):
    return {
        "image": torch.from_numpy(image), "labels": torch.from_numpy(labels),
        "weights": torch.from_numpy(weights),
    }


def _jax_batch(image, labels, weights):
    return {"image": jnp.asarray(image), "labels": jnp.asarray(labels), "weights": jnp.asarray(weights)}


def _bn_nulled(key):
    """A conv bias that a batch norm follows, or that norm's running mean:
    the norm subtracts the bias again, so the bias's true gradient is 0."""
    return key.endswith(("conv1/b", "conv2/b", "/mean"))


def _assert_params_close(tstate, jstate, steps, lr=1e-4):
    """Every weight and statistic within ``2 * steps * lr``: Adam moves a
    weight by up to ``lr`` a step, on a gradient that is round-off too (the
    BN-nulled biases; their running means take 0.1 of it), and two runs
    may move it in opposite directions. All but 1e-4 of the other values
    within 1e-6."""
    got = torch_convert.to_flat(tstate.model)
    want = _flat(jstate.params, jstate.model_state)
    assert set(got) == set(want)
    diff = {k: np.abs(got[k] - want[k]).ravel() for k in sorted(want)}
    worst = max(float(d.max()) for d in diff.values())
    assert worst <= 2 * steps * lr, worst
    rest = np.concatenate([d for k, d in diff.items() if not _bn_nulled(k)])
    assert np.mean(rest > 1e-6) < 1e-4, np.mean(rest > 1e-6)


def test_train2d_golden_from_the_reference_init():
    """4 f32 steps from ``unet.init(PRNGKey(0))``'s weights carried across:
    the loss trajectory at rtol 5e-4 (the JAX test's own bar,
    ``tests/test_goldens.py``); the reference's step called here agrees per
    step on loss, accuracy and grad_norm, and on every weight after."""
    g = np.load(os.path.join(GOLDENS, "train2d_losses.npz"))
    jcfg, tcfg, jtc, ttc, jstate, tstate = _pair()
    jstep = jax_train.make_unet_train_step(jcfg, jtc)
    tstep = torch_train.make_unet_train_step(tcfg, ttc)
    key = jax.random.PRNGKey(1)
    got = []
    for s in range(4):
        batch = _golden_batch(s)
        jstate, jm = jstep(jstate, _jax_batch(*batch), jax.random.fold_in(key, s))
        tstate, tm = tstep(tstate, _torch_batch(*batch))
        got.append(float(tm["loss"]))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["accuracy"]), float(jm["accuracy"]), atol=1e-3)
    np.testing.assert_allclose(got, g["losses"], rtol=5e-4)
    assert tstate.step == 4 and int(jstate.step) == 4
    _assert_params_close(tstate, jstate, steps=4)


@pytest.mark.parametrize("remat", [False, True])
def test_resume_from_the_reference_train_state(remat):
    """Two reference steps, the whole TrainState (weights, BN statistics,
    Adam's moments and count) carried across, then two more steps on each
    side agree; ``remat`` changes nothing but memory."""
    jcfg, tcfg, jtc, ttc, jstate, _ = _pair(remat=remat)
    jstep = jax_train.make_unet_train_step(jcfg, jtc)
    for s in range(2):
        jstate, _ = jstep(jstate, _jax_batch(*_golden_batch(s)), jax.random.PRNGKey(s))
    flat = _flat(jstate.params, jstate.model_state, jstate.opt_state, jstate.step)
    tstate = torch_convert.load_train_state(tcfg, ttc, flat, device="cpu")
    assert tstate.step == 2 and tstate.opt_state.count == 2
    tstep = torch_train.make_unet_train_step(tcfg, ttc)
    for s in range(2, 4):
        batch = _golden_batch(s)
        jstate, jm = jstep(jstate, _jax_batch(*batch), jax.random.PRNGKey(s))
        tstate, tm = tstep(tstate, _torch_batch(*batch))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    _assert_params_close(tstate, jstate, steps=2)


@pytest.mark.parametrize("dims", [2, 3])
def test_train_mode_batch_norm(dims):
    """``forward_train`` against ``unet.apply(train=True)``: logits (batch
    statistics, biased variance) and the new running statistics (m = 0.9,
    the same biased variance), and the module's own statistics untouched
    until ``set_bn_stats``."""
    cfg_kw = dict(in_channels=2, num_classes=3, depth=2, base_features=4, dims=dims)
    jcfg = jax_unet.UNetConfig(compute_dtype=jnp.float32, **cfg_kw)
    tcfg = torch_unet.UNetConfig(compute_dtype="float32", **cfg_kw)
    params, state = jax_unet.init(jax.random.PRNGKey(dims), jcfg)
    rng = np.random.default_rng(dims)
    state = jax.tree.map(lambda a: a + 0.2 * rng.random(a.shape).astype(np.float32), state)
    model = torch_convert.load_flat(tcfg, _flat(params, state), device="cpu")
    x = rng.random((2,) + (8,) * dims + (2,)).astype(np.float32) * 3
    logits, new_state = jax_unet.apply(jcfg, params, state, jnp.asarray(x), train=True)
    before = torch_convert.to_flat(model)
    got, stats = model.forward_train(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(logits), rtol=1e-4, atol=1e-5)
    assert all(np.array_equal(v, before[k]) for k, v in torch_convert.to_flat(model).items())
    model.set_bn_stats(stats)
    after = torch_convert.to_flat(model)
    want = {f"state/{k}": v for k, v in jax_convert.flatten_params(new_state).items()}
    for k, v in want.items():
        np.testing.assert_allclose(after[k], np.asarray(v), rtol=1e-5, atol=1e-6, err_msg=k)


def test_init_is_he_normal():
    """``unet.init``: He-normal kernels (std sqrt(2 / fan_in)), zero biases,
    unit BN; the same generator seed gives the same weights."""
    cfg = torch_unet.UNetConfig(depth=3, base_features=16)
    a = torch_unet.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = torch_unet.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
    conv = a.enc[1].conv2.w  # (32, 32, 3, 3): fan_in 288
    assert abs(float(conv.std()) - (2 / 288) ** 0.5) < 0.01
    assert float(a.enc[1].conv2.b.abs().max()) == 0.0
    up = a.up[0].w  # transposed (64, 32, 2, 2): fan_in 4 * 64
    assert abs(float(up.std()) - (2 / 256) ** 0.5) < 0.01
    assert not any(p.requires_grad for p in a.parameters())


OPT_CASES = {
    "constant_clip": dict(grad_clip=0.5),
    "constant_noclip": dict(grad_clip=None),
    "warmup_cosine_accum2_clip": dict(
        grad_clip=0.5, grad_accum=2, lr_schedule="cosine", lr_warmup_steps=3, lr_decay_steps=10,
    ),
    "warmup_cosine_accum2_noclip": dict(
        grad_clip=None, grad_accum=2, lr_schedule="cosine", lr_warmup_steps=3, lr_decay_steps=10,
    ),
    "exponential_adamw": dict(
        grad_clip=1.0, lr_schedule="exponential", lr_decay_steps=6, weight_decay=0.01, beta1=0.5,
    ),
    "warmup_constant_accum3": dict(grad_clip=0.2, grad_accum=3, lr_warmup_steps=4),
}


@pytest.mark.parametrize("case", sorted(OPT_CASES))
def test_optimizer_against_optax(case):
    """10 steps of ``TrainConfig.make_optimizer`` on both sides from the
    same weights and gradients: every weight within 2 f32 steps of 1 (the
    schedules are evaluated in float64 here, in float32 by optax)."""
    kw = dict(learning_rate=1e-2, **OPT_CASES[case])
    jtx = jax_train.TrainConfig(**kw).make_optimizer()
    topt = torch_train.TrainConfig(**kw).make_optimizer()
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = [torch.from_numpy(params[k].copy()) for k in sorted(shapes)]
    jst, tst = jtx.init(jp), topt.init(tp)
    for step in range(10):
        scale = 2.0 if step % 2 else 0.05  # both sides of the clip
        grads = {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in shapes.items()}
        upd, jst = jtx.update({k: jnp.asarray(v) for k, v in grads.items()}, jst, jp)
        jp = optax.apply_updates(jp, upd)
        topt.update(tp, [torch.from_numpy(grads[k]) for k in sorted(shapes)], tst)
        for k, t in zip(sorted(shapes), tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]), rtol=0, atol=2.4e-7, err_msg=f"{k} @ {step}")
    assert tst.count == (10 // kw.get("grad_accum", 1))


def test_polyphase_training_names_its_slice():
    """``TrainConfig(polyphase=True)`` builds a step; a model outside the
    polyphase cover is refused with the JAX package's message."""
    tc = torch_train.TrainConfig(polyphase=True, augment=False)
    jtc = jax_train.TrainConfig(polyphase=True, augment=False)
    base = dict(depth=2, base_features=4, compute_dtype="float32")
    torch_train.make_unet_train_step(torch_unet.UNetConfig(**base), tc)
    for bad in (dict(space_to_depth=2), dict(upsample="resize"), dict(depth=1)):
        cfg = dict(base, **bad)
        with pytest.raises(ValueError) as want:
            jax_train._train_forward(jax_unet.UNetConfig(**cfg), jtc)
        with pytest.raises(ValueError) as got:
            torch_train.make_unet_train_step(torch_unet.UNetConfig(**cfg), tc)
        assert str(got.value) == str(want.value)


def test_distill_step_against_the_reference():
    """``make_unet_distill_step``: hard-label CE plus T^2-scaled soft KL from
    a teacher (here a differently seeded model of another depth), two steps
    from carried-across weights: loss, ce and kd per step."""
    jcfg, tcfg, jtc, ttc, jstate, tstate = _pair()
    t_kw = dict(CFG_KW, depth=2, base_features=8)
    t_jcfg = jax_unet.UNetConfig(compute_dtype=jnp.float32, **t_kw)
    t_tcfg = torch_unet.UNetConfig(compute_dtype="float32", **t_kw)
    t_params, t_state = jax_unet.init(jax.random.PRNGKey(5), t_jcfg)
    teacher = torch_unet.fold_batchnorm(
        torch_convert.load_flat(t_tcfg, _flat(t_params, t_state), device="cpu")
    )
    jstep = jax_train.make_unet_distill_step(jcfg, t_jcfg, jtc, t_params, t_state, alpha=0.3, temperature=3.0)
    tstep = torch_train.make_unet_distill_step(tcfg, teacher, ttc, alpha=0.3, temperature=3.0)
    for s in range(2):
        batch = _golden_batch(s)
        jstate, jm = jstep(jstate, _jax_batch(*batch), jax.random.PRNGKey(s))
        tstate, tm = tstep(tstate, _torch_batch(*batch))
        for k in ("loss", "ce", "kd"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
    _assert_params_close(tstate, jstate, steps=2)
