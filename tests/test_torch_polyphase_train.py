"""The port's polyphase training forward (``models.polyphase.apply_train``,
``apply3d_train``) and ``TrainConfig(polyphase=True)`` against the JAX
package's on the same numpy inputs and carried-across weights, at f32.

Logits, batch-norm statistics and gradients with respect to the original
weights within 1e-5 of the largest value (the gradients of the global
gradient scale, as the JAX package's own test: a conv bias a batch norm
follows has a true gradient of 0 and holds round-off on both sides), against
the JAX functions and against the port's standard ``forward_train``; pool
ties route to the first maximum in 2D and 3D; three polyphase train steps
against the JAX package's step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sequitr_tpu.models import convert as jax_convert
from sequitr_tpu.models import polyphase as jax_poly
from sequitr_tpu.models import unet as jax_unet
from sequitr_tpu.ops import losses as jax_losses
from sequitr_tpu.pipeline import train as jax_train
from sequitr_tpu_torch.models import convert as torch_convert
from sequitr_tpu_torch.models import polyphase as torch_poly
from sequitr_tpu_torch.models import unet as torch_unet
from sequitr_tpu_torch.ops import losses as torch_losses
from sequitr_tpu_torch.pipeline import train as torch_train

BAR = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _flat(params, state):
    flat = dict(jax_convert.flatten_params(params))
    flat.update({f"state/{k}": v for k, v in jax_convert.flatten_params(state).items()})
    return {k: np.asarray(v) for k, v in flat.items()}


def _models(dims, depth, base, seed=0, tied=False):
    """A JAX U-Net with batch norm (running statistics moved off their
    initial values) and the port's copy of it, parameters taking gradients.

    ``tied``: no batch norm, and level 0's kernels drawn from {-1, 0, 1}, so
    on an input of small integers its activations are exact integers that
    tie within most pool windows, from different input patches."""
    kw = dict(dims=dims, depth=depth, base_features=base, num_classes=3, norm="none" if tied else "batch")
    jcfg = jax_unet.UNetConfig(compute_dtype=jnp.float32, **kw)
    params, state = jax_unet.init(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    if tied:
        for name in ("conv1", "conv2"):
            w = params["enc"][0][name]["w"]
            params["enc"][0][name]["w"] = jnp.asarray(rng.integers(-1, 2, w.shape), jnp.float32)
    else:
        state = jax.tree.map(
            lambda v: jnp.asarray(np.asarray(v) + rng.uniform(0.1, 0.5, v.shape), jnp.float32), state
        )
        params = jax.tree.map(
            lambda v: jnp.asarray(np.asarray(v) + (rng.normal(size=v.shape) * 0.1 if v.ndim == 1 else 0), jnp.float32),
            params,
        )
    tcfg = torch_unet.UNetConfig(compute_dtype="float32", **kw)
    model = torch_convert.load_flat(tcfg, _flat(params, state), device="cpu").requires_grad_(True)
    return jcfg, params, state, model


def _grads_flat(model, grads):
    """Gradients as flat keys in the JAX layouts: written into a copy of the
    model and read back through ``to_flat``."""
    holder = torch_convert.load_flat(model.cfg, torch_convert.to_flat(model), device="cpu")
    with torch.no_grad():
        for p, g in zip(holder.parameters(), grads):
            p.copy_(g)
    return {k: v for k, v in torch_convert.to_flat(holder).items() if not k.startswith("state/")}


def _assert_close(got, want, what):
    """Within ``BAR`` of the largest value of ``want`` (all arrays)."""
    assert set(got) == set(want), what
    scale = max((float(np.abs(w).max()) for w in want.values()), default=0.0)
    for k in want:
        diff = float(np.abs(np.asarray(got[k]) - np.asarray(want[k])).max())
        assert diff <= BAR * scale, f"{what} {k}: {diff} > {BAR} x {scale}"


def _inputs(dims, n, spatial, seed, tied=False):
    rng = np.random.default_rng(seed)
    shape = (n,) + tuple(spatial)
    x = rng.integers(0, 3, shape + (1,)) if tied else rng.normal(size=shape + (1,))
    lab = rng.integers(0, 3, shape)
    w = rng.uniform(0.5, 2.0, shape)
    return x.astype(np.float32), lab.astype(np.int32), w.astype(np.float32)


CASES = [
    (2, 3, 4, (32, 32)),
    (3, 2, 4, (4, 16, 16)),
]


@pytest.mark.parametrize("tied", [False, True], ids=["random", "tied"])
@pytest.mark.parametrize("dims,depth,base,spatial", CASES, ids=["2d", "3d"])
def test_apply_train_matches_jax_and_the_standard_forward(dims, depth, base, spatial, tied):
    """Logits, statistics and the weighted CE's gradients: the port's
    polyphase forward against JAX ``apply_train`` / ``apply3d_train`` and
    against the port's ``forward_train``. ``tied`` makes most of level 0's
    pool windows tie at positive values from different input patches (in 3D
    across z too): the gradients agree only if every tie goes to the
    window's first maximum."""
    jcfg, params, state, model = _models(dims, depth, base, seed=dims, tied=tied)
    x, lab, w = _inputs(dims, 2, spatial, seed=10 + dims, tied=tied)
    jfwd = jax_poly.apply3d_train if dims == 3 else jax_poly.apply_train
    tfwd = torch_poly.apply3d_train if dims == 3 else torch_poly.apply_train

    def jloss(p):
        logits, ms = jfwd(jcfg, p, state, jnp.asarray(x), train=True)
        return jax_losses.weighted_softmax_cross_entropy(logits, jnp.asarray(lab), jnp.asarray(w)), (logits, ms)

    (_, (jlogits, jms)), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    want_stats = {k: v for k, v in _flat(params, jms).items() if k.startswith("state/")}
    want_grads = {k: np.asarray(v) for k, v in jax_convert.flatten_params(jgrads).items()}

    results = {}
    for name, fwd in (("polyphase", lambda m, t: tfwd(m, t)), ("standard", lambda m, t: m.forward_train(t))):
        logits, stats = fwd(model, torch.from_numpy(x))
        loss = torch_losses.weighted_softmax_cross_entropy(logits, torch.from_numpy(lab), torch.from_numpy(w))
        grads = torch.autograd.grad(loss, list(model.parameters()))
        holder = torch_convert.load_flat(model.cfg, torch_convert.to_flat(model), device="cpu")
        holder.set_bn_stats([tuple(t.detach() for t in pair) for pair in stats])
        got_stats = {k: v for k, v in torch_convert.to_flat(holder).items() if k.startswith("state/")}
        results[name] = (logits.detach().numpy(), got_stats, _grads_flat(model, grads))
        _assert_close({"logits": results[name][0]}, {"logits": np.asarray(jlogits)}, f"{name} logits")
        _assert_close(got_stats, want_stats, f"{name} statistics")
        _assert_close(results[name][2], want_grads, f"{name} gradients")
    # and the two forwards of the port against each other
    _assert_close({"logits": results["polyphase"][0]}, {"logits": results["standard"][0]}, "logits")
    _assert_close(results["polyphase"][2], results["standard"][2], "gradients")


@pytest.mark.parametrize("dims", [2, 3])
def test_phase_pool_gradient_goes_to_the_first_tied_max(dims):
    """The phase-domain pool on values drawn from {0, 1, 2} (ties in most
    windows): its gradient, moved back to full resolution, equals the
    standard pool's (``max_pool2d`` / ``max_pool3d``, pinned to the first
    maximum by ``test_torch_train_ops.py``) and the explicit first-max
    routing of the 2x2 (2x2x2) window in row-major order; ``amax``'s own
    gradient splits ties and does not."""
    g = torch.Generator().manual_seed(dims)
    spatial = (8, 16, 16) if dims == 3 else (16, 16)
    full = torch.randint(0, 3, (2, 3) + spatial, generator=g).float()
    cot = torch.rand((2, 3) + tuple(s // 2 for s in spatial), generator=g)

    def phase_pool(t, first):
        n, c = t.shape[:2]
        nchw = t if dims == 2 else t.reshape(n, c * spatial[0], *spatial[1:])
        ph = torch_unet._space_to_depth(nchw, 2)  # (N, 4 * C', h, w), phase-major
        ph = ph.reshape(n, 4, -1, *ph.shape[2:]).movedim(1, -1)  # (N, C', h, w, 4)
        m = torch_poly._first_max(ph, -1) if first else ph.amax(-1)
        if dims == 3:
            m = m.reshape(n, c, spatial[0] // 2, 2, *m.shape[2:])
            m = torch_poly._first_max(m, 3) if first else m.amax(3)
        return m

    def grad(f):
        t = full.clone().requires_grad_(True)
        (f(t) * cot).sum().backward()
        return t.grad

    pool = F.max_pool3d if dims == 3 else F.max_pool2d
    want = grad(lambda t: pool(t, 2))
    # explicit: the first maximum of each window in (z,) y, x order
    win = full
    for ax in range(2, 2 + dims):
        win = win.unfold(ax, 2, 2)
    win = win.reshape(win.shape[: 2 + dims] + (-1,))
    first = torch.zeros_like(win).scatter_(-1, win.argmax(-1, keepdim=True), 1.0) * cot[..., None]
    first = first.reshape(first.shape[: 2 + dims] + (2,) * dims)
    perm = [0, 1] + [a for i in range(dims) for a in (2 + i, 2 + dims + i)]
    first = first.permute(perm).reshape(full.shape)
    assert torch.equal(want, first)
    assert torch.equal(grad(lambda t: phase_pool(t, True)), want)
    assert not torch.equal(grad(lambda t: phase_pool(t, False)), want)


def test_polyphase_train_steps_match_the_reference():
    """Three ``TrainConfig(polyphase=True)`` steps from the same weights and
    batches: the port's step against the JAX package's, per step on loss,
    accuracy and grad_norm (the terms of ``test_torch_train_step.py``), and
    on every weight after."""
    kw = dict(in_channels=1, num_classes=3, depth=3, base_features=8)
    jcfg = jax_unet.UNetConfig(compute_dtype=jnp.float32, **kw)
    tcfg = torch_unet.UNetConfig(compute_dtype="float32", **kw)
    jtc = jax_train.TrainConfig(augment=False, polyphase=True)
    ttc = torch_train.TrainConfig(augment=False, polyphase=True)
    jstate = jax_train.create_unet_state(jax.random.PRNGKey(0), jcfg, jtc)
    tstate = torch_convert.load_train_state(tcfg, ttc, _flat(jstate.params, jstate.model_state), device="cpu")
    jstep = jax_train.make_unet_train_step(jcfg, jtc)
    tstep = torch_train.make_unet_train_step(tcfg, ttc)
    for s in range(3):
        x, lab, w = _inputs(2, 2, (32, 32), seed=100 + s)
        x = (x - x.min()) / (x.max() - x.min())
        jstate, jm = jstep(
            jstate, {"image": jnp.asarray(x), "labels": jnp.asarray(lab), "weights": jnp.asarray(w)},
            jax.random.PRNGKey(s),
        )
        tstate, tm = tstep(
            tstate, {"image": torch.from_numpy(x), "labels": torch.from_numpy(lab), "weights": torch.from_numpy(w)}
        )
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        np.testing.assert_allclose(float(tm["accuracy"]), float(jm["accuracy"]), atol=1e-3)
    got = torch_convert.to_flat(tstate.model)
    want = _flat(jstate.params, jstate.model_state)
    lr = ttc.learning_rate
    for k in want:
        diff = float(np.abs(got[k] - want[k]).max())
        # a conv bias a batch norm follows (and the running mean carrying
        # it) moves on round-off: up to 2 * steps * lr apart
        bar = 2 * 3 * lr if k.endswith(("conv1/b", "conv2/b", "/mean")) else 1e-5
        assert diff <= bar, (k, diff)


@pytest.mark.parametrize("dims", [2, 3])
def test_polyphase_step_remat_and_bf16(dims):
    """``remat`` recomputes the polyphase forward in the backward and
    changes nothing at f32; a bf16 model's polyphase step runs and keeps its
    loss within bf16's reach of the standard step's."""
    spatial = (4, 16, 16) if dims == 3 else (32, 32)
    x, lab, w = _inputs(dims, 2, spatial, seed=7)
    batch = {"image": torch.from_numpy(x), "labels": torch.from_numpy(lab), "weights": torch.from_numpy(w)}
    cfg = torch_unet.UNetConfig(dims=dims, depth=2, base_features=4, compute_dtype="float32")
    losses = {}
    for dtype in ("float32", "bfloat16"):
        c = dataclasses.replace(cfg, compute_dtype=dtype)
        for name, tc in (
            ("standard", torch_train.TrainConfig(augment=False)),
            ("polyphase", torch_train.TrainConfig(augment=False, polyphase=True)),
            ("polyphase remat", torch_train.TrainConfig(augment=False, polyphase=True, remat=True)),
        ):
            state = torch_train.create_unet_state(c, tc, torch.Generator().manual_seed(0), device="cpu")
            step = torch_train.make_unet_train_step(c, tc)
            ms = [float(step(state, batch)[1]["loss"]) for _ in range(2)]
            losses[dtype, name] = (ms, torch_convert.to_flat(state.model))
    f32 = losses["float32", "polyphase"]
    again = losses["float32", "polyphase remat"]
    assert f32[0] == again[0]
    assert all(np.array_equal(f32[1][k], again[1][k]) for k in f32[1])
    np.testing.assert_allclose(f32[0], losses["float32", "standard"][0], rtol=1e-5)
    np.testing.assert_allclose(losses["bfloat16", "polyphase"][0], losses["bfloat16", "standard"][0], rtol=2e-2)


def test_train_step_without_batch_norm():
    """A ``norm: "none"`` model trains, standard and polyphase, and its step
    agrees with the JAX package's (the step used to fail committing an empty
    list of running statistics)."""
    kw = dict(in_channels=1, num_classes=3, depth=2, base_features=4, norm="none")
    jcfg = jax_unet.UNetConfig(compute_dtype=jnp.float32, **kw)
    tcfg = torch_unet.UNetConfig(compute_dtype="float32", **kw)
    x, lab, w = _inputs(2, 2, (16, 16), seed=5)
    for poly in (False, True):
        jtc = jax_train.TrainConfig(augment=False, polyphase=poly)
        ttc = torch_train.TrainConfig(augment=False, polyphase=poly)
        jstate = jax_train.create_unet_state(jax.random.PRNGKey(0), jcfg, jtc)
        tstate = torch_convert.load_train_state(tcfg, ttc, _flat(jstate.params, jstate.model_state), device="cpu")
        _, jm = jax_train.make_unet_train_step(jcfg, jtc)(
            jstate, {"image": jnp.asarray(x), "labels": jnp.asarray(lab), "weights": jnp.asarray(w)},
            jax.random.PRNGKey(0),
        )
        _, tm = torch_train.make_unet_train_step(tcfg, ttc)(
            tstate, {"image": torch.from_numpy(x), "labels": torch.from_numpy(lab), "weights": torch.from_numpy(w)}
        )
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)


def test_training_after_serving_in_inference_mode():
    """The phase kernels' tap index is made once per device: made first by
    a serve inside ``torch.inference_mode``, it must still serve a training
    forward's backward."""
    torch_poly._TAP_INDEX.clear()
    cfg = torch_unet.UNetConfig(depth=2, base_features=4, compute_dtype="float32")
    model = torch_unet.init(cfg, torch.Generator().manual_seed(0), device="cpu")
    x = torch.rand((1, 16, 16, 1))
    with torch.inference_mode():
        torch_poly.apply(torch_unet.fold_batchnorm(model), x)
    model.requires_grad_(True)
    logits, _ = torch_poly.apply_train(model, x)
    (g,) = torch.autograd.grad(logits.sum(), [model.enc[0].conv1.w])
    assert torch.isfinite(g).all()
