"""The port's sharded train steps against the JAX package's: the spatial
(halo-exchange) step of ``parallel.spatial_train`` and the data-parallel
step of ``parallel.make_dp_train_step``, mirroring ``tests/test_spatial.py``'s
``TestSpatialTraining``.

The JAX steps run on the 8 virtual CPU devices of ``tests/conftest.py``;
the port's on ``parallel.virtual_devices(n)``. The sharded step is the
unsharded step up to float reassociation, so the bars are the JAX test's
own: loss rtol 1e-5, accuracy within 0.01 (a few argmax tie flips),
``grad_norm`` rtol 1e-4, every weight rtol 2e-4 / atol 1e-6 and every
batch-norm statistic rtol 1e-4 / atol 1e-6 over three steps. With batch
norm a conv bias that feeds it has an analytic gradient of 0 (the norm
subtracts it again), so Adam turns round-off into O(lr) moves on both
sides: those biases are held at 2 * steps * lr, and the running means
(which accumulate the biases) only on the first step; the raw gradients
of every leaf are held in ``test_gradient_parity_every_leaf``.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequitr_tpu import parallel as jax_parallel
from sequitr_tpu.models import convert as jax_convert
from sequitr_tpu.models import unet as jax_unet
from sequitr_tpu.ops import losses as jax_losses
from sequitr_tpu.pipeline import train as jax_train
from sequitr_tpu_torch import parallel
from sequitr_tpu_torch.models import convert as torch_convert
from sequitr_tpu_torch.models import unet as torch_unet
from sequitr_tpu_torch.parallel import spatial_train
from sequitr_tpu_torch.pipeline import train as torch_train

LR = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _flat(params, state):
    flat = jax_convert.flatten_params(params)
    flat.update({f"state/{k}": v for k, v in jax_convert.flatten_params(state).items()})
    return {k: np.asarray(v) for k, v in flat.items()}


def _setup(seed=0, batch=1, spatial=(32, 16), weights=True, **cfg_kw):
    """The JAX and port configs, train configs, states from one init, and a
    numpy batch."""
    kw = {**dict(in_channels=1, num_classes=3, depth=3, base_features=4), **cfg_kw}
    jcfg = jax_unet.UNetConfig(compute_dtype=jnp.float32, **kw)
    tcfg = torch_unet.UNetConfig(compute_dtype="float32", **kw)
    jtc = jax_train.TrainConfig(learning_rate=LR, augment=False)
    ttc = torch_train.TrainConfig(learning_rate=LR, augment=False)
    jstate = jax_train.create_unet_state(jax.random.PRNGKey(seed), jcfg, jtc)
    tstate = torch_convert.load_train_state(tcfg, ttc, _flat(jstate.params, jstate.model_state), device="cpu")
    rng = np.random.default_rng(seed + 1)
    b = {
        "image": rng.normal(size=(batch, *spatial, jcfg.in_channels)).astype(np.float32),
        "labels": rng.integers(0, jcfg.num_classes, size=(batch, *spatial)).astype(np.int32),
    }
    if weights:
        b["weights"] = (1.0 + rng.random((batch, *spatial))).astype(np.float32)
    return jcfg, tcfg, jtc, ttc, jstate, tstate, b


def _bn_fed_bias(key):
    return key.endswith(("conv1/b", "conv2/b"))


def _compare(tstate, tm, jstate, jm, steps, bn=True, first=True):
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5, atol=1e-6)
    assert float(tm["accuracy"]) == pytest.approx(float(jm["accuracy"]), abs=0.01)
    if "grad_norm" in jm:
        np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
    got = torch_convert.to_flat(tstate.model)
    want = _flat(jstate.params, jstate.model_state)
    assert set(got) == set(want)
    for k in sorted(want):
        if k.startswith("state/"):
            if k.endswith("/mean") and bn and not first:
                assert np.abs(got[k] - want[k]).max() <= 2 * steps * LR, k
                continue
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
        elif bn and _bn_fed_bias(k):
            assert np.abs(got[k] - want[k]).max() <= 2 * steps * LR, k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=1e-6, err_msg=k)


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


@pytest.mark.parametrize("ways", [2, 4, 8])
def test_train_step_matches_unsharded(ways):
    jcfg, tcfg, jtc, ttc, jstate, tstate, b = _setup()
    ref = jax_train.make_unet_train_step(jcfg, jtc)
    with parallel.virtual_devices(ways):
        step = spatial_train.make_spatial_train_step(tcfg, ttc, parallel.make_mesh(device="cpu"), (32, 16), batch=1)
        for i in range(3):
            jstate, jm = ref(jstate, _jax_batch(b), jax.random.PRNGKey(9))
            tstate, tm = step(tstate, b)
            _compare(tstate, tm, jstate, jm, i + 1, first=i == 0)
    assert tstate.step == 3


def test_matches_the_jax_spatial_step():
    """The two sharded steps side by side (8 ways each): one step."""
    jcfg, tcfg, jtc, ttc, jstate, tstate, b = _setup(seed=2)
    from sequitr_tpu.parallel import spatial_train as jax_spatial_train

    jstep = jax_spatial_train.make_spatial_train_step(jcfg, jtc, jax_parallel.make_mesh(), (32, 16), batch=1)
    jstate, jm = jstep(jstate, _jax_batch(b), None)
    with parallel.virtual_devices(8):
        step = spatial_train.make_spatial_train_step(tcfg, ttc, parallel.make_mesh(device="cpu"), (32, 16), batch=1)
        tstate, tm = step(tstate, b)
    _compare(tstate, tm, jstate, jm, 1)


def test_remat_changes_nothing_but_memory():
    _, tcfg, _, ttc, _, tstate, b = _setup(seed=5)
    other = torch_convert.load_train_state(
        tcfg, ttc, torch_convert.to_flat(tstate.model), device="cpu")
    with parallel.virtual_devices(4):
        mesh = parallel.make_mesh(device="cpu")
        plain = spatial_train.make_spatial_train_step(tcfg, ttc, mesh, (32, 16), batch=1)
        remat = spatial_train.make_spatial_train_step(
            tcfg, dataclasses.replace(ttc, remat=True), mesh, (32, 16), batch=1)
        for _ in range(2):
            tstate, ma = plain(tstate, b)
            other, mb = remat(other, b)
    assert float(ma["loss"]) == float(mb["loss"])
    for (k, p), q in zip(tstate.model.state_dict().items(), other.model.state_dict().values()):
        assert torch.equal(p, q), k


def test_unweighted_loss_matches():
    jcfg, tcfg, jtc, ttc, jstate, tstate, b = _setup(seed=3, weights=False)
    jstate, jm = jax_train.make_unet_train_step(jcfg, jtc)(jstate, _jax_batch(b), jax.random.PRNGKey(9))
    with parallel.virtual_devices(8):
        step = spatial_train.make_spatial_train_step(tcfg, ttc, parallel.make_mesh(device="cpu"), (32, 16), batch=1)
        tstate, tm = step(tstate, b)
    _compare(tstate, tm, jstate, jm, 1)


def test_hybrid_data_space_matches_unsharded():
    """2-way data x 4-way space: statistics and loss over both axes."""
    jcfg, tcfg, jtc, ttc, jstate, tstate, b = _setup(seed=5, batch=2, spatial=(16, 16))
    ref = jax_train.make_unet_train_step(jcfg, jtc)
    with parallel.virtual_devices(8):
        step = spatial_train.make_spatial_train_step(
            tcfg, ttc, parallel.make_mesh2d((2, 4), device="cpu"), (16, 16), batch=2,
            space_axis="space", data_axis="data",
        )
        for i in range(2):
            jstate, jm = ref(jstate, _jax_batch(b), jax.random.PRNGKey(9))
            tstate, tm = step(tstate, b)
            _compare(tstate, tm, jstate, jm, i + 1, first=i == 0)


def test_volumetric_train_matches_unsharded():
    jcfg, tcfg, jtc, ttc, jstate, tstate, b = _setup(seed=7, spatial=(16, 8, 8), dims=3, depth=2)
    jstate, jm = jax_train.make_unet_train_step(jcfg, jtc)(jstate, _jax_batch(b), jax.random.PRNGKey(9))
    with parallel.virtual_devices(8):
        step = spatial_train.make_spatial_train_step(tcfg, ttc, parallel.make_mesh(device="cpu"), (16, 8, 8), batch=1)
        tstate, tm = step(tstate, b)
    _compare(tstate, tm, jstate, jm, 1)


def test_norm_none_trajectory_fully_strict():
    jcfg, tcfg, jtc, ttc, jstate, tstate, b = _setup(seed=11, norm="none")
    ref = jax_train.make_unet_train_step(jcfg, jtc)
    with parallel.virtual_devices(8):
        step = spatial_train.make_spatial_train_step(tcfg, ttc, parallel.make_mesh(device="cpu"), (32, 16), batch=1)
        for i in range(3):
            jstate, jm = ref(jstate, _jax_batch(b), jax.random.PRNGKey(9))
            tstate, tm = step(tstate, b)
            _compare(tstate, tm, jstate, jm, i + 1, bn=False)


def _refusal(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("case", ["augment", "shape", "batch"])
def test_refusals_carry_the_jax_messages(case):
    jcfg, tcfg, jtc, ttc, *_ = _setup()
    shape, batch = ((30, 16), 1) if case == "shape" else ((32, 16), 3 if case == "batch" else 1)
    if case == "augment":
        jtc, ttc = dataclasses.replace(jtc, augment=True), dataclasses.replace(ttc, augment=True)
    if case == "batch":
        want = _refusal(lambda: jax_parallel.spatial_train.make_spatial_train_step(
            jcfg, jtc, jax_parallel.make_mesh2d((2, 4)), shape, batch, space_axis="space", data_axis="data"))
    else:
        want = _refusal(lambda: jax_parallel.spatial_train.make_spatial_train_step(
            jcfg, jtc, jax_parallel.make_mesh(), shape, batch))
    with parallel.virtual_devices(8):
        if case == "batch":
            got = _refusal(lambda: spatial_train.make_spatial_train_step(
                tcfg, ttc, parallel.make_mesh2d((2, 4), device="cpu"), shape, batch,
                space_axis="space", data_axis="data"))
        else:
            got = _refusal(lambda: spatial_train.make_spatial_train_step(
                tcfg, ttc, parallel.make_mesh(device="cpu"), shape, batch))
    assert got == want
    if case == "augment":
        assert "augment" in got


def test_gradient_parity_every_leaf():
    """The sharded loss's raw gradients against ``jax.grad`` of the
    unsharded loss, every leaf (the BN-fed conv biases included: their
    gradients are round-off, held by the absolute bar): rtol 5e-4, atol
    1e-6, the JAX test's bars."""
    jcfg, tcfg, _, _, jstate, tstate, b = _setup(seed=21)
    params, state = jstate.params, jstate.model_state

    def ref_loss(p):
        logits, _ = jax_unet.apply(jcfg, p, state, jnp.asarray(b["image"]), train=True)
        return jax_losses.weighted_softmax_cross_entropy(logits, jnp.asarray(b["labels"]), jnp.asarray(b["weights"]))

    g_ref = torch_convert.load_flat(tcfg, _flat(jax.grad(ref_loss)(params), state), device="cpu")
    model = tstate.model
    with parallel.virtual_devices(8):
        tmesh = spatial_train.TrainMesh(parallel.make_mesh(device="cpu"), space_axis="data")
        logits, _ = spatial_train.sharded_forward_train(model, torch.from_numpy(b["image"]), tmesh)
    labels = spatial_train._split_plain(torch.from_numpy(b["labels"]), tmesh.devices)
    weights = spatial_train._split_plain(torch.from_numpy(b["weights"]), tmesh.devices)
    num = den = 0.0
    for lrow, yrow, wrow in zip(logits, labels, weights):
        for lg, y, w in zip(lrow, yrow, wrow):
            ce = -torch.gather(torch.log_softmax(lg, -1), -1, y.long()[..., None])[..., 0]
            num, den = num + (w * ce).sum(), den + w.sum()
    grads = torch.autograd.grad(num / den, list(model.parameters()))
    for (name, want), got in zip(g_ref.named_parameters(), grads):
        np.testing.assert_allclose(got.numpy(), want.detach().numpy(), rtol=5e-4, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("ways", [2, 4, 8])
def test_dp_step_has_global_batch_norm(ways):
    """The data-parallel step against the JAX DP step (8 devices) and the
    port's single-device step: the statistics, the loss and the gradient
    of the GLOBAL batch, three steps. Per-replica statistics (what
    ``nn.DataParallel`` gives) would differ: the first layer's statistics
    of each replica's slice are checked to miss the global ones by far
    more than the bar."""
    jcfg, tcfg, jtc, ttc, jstate, tstate, b = _setup(seed=4, batch=8, spatial=(16, 16))
    single = torch_convert.load_train_state(tcfg, ttc, torch_convert.to_flat(tstate.model), device="cpu")
    jstep = jax_parallel.make_dp_train_step(
        jax_train.make_unet_train_step(jcfg, jtc), jax_parallel.make_mesh())
    sstep = torch_train.make_unet_train_step(tcfg, ttc)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    with parallel.virtual_devices(ways):
        tstep = parallel.make_dp_train_step(
            functools.partial(torch_train.make_unet_train_step, tcfg, ttc), parallel.make_mesh(device="cpu"))
        for i in range(3):
            jstate, jm = jstep(jstate, _jax_batch(b), jax.random.PRNGKey(0))
            tstate, tm = tstep(tstate, tb)
            single, sm = sstep(single, tb)
            _compare(tstate, tm, jstate, jm, i + 1, first=i == 0)
            np.testing.assert_allclose(float(tm["loss"]), float(sm["loss"]), rtol=1e-5)
    # per-replica statistics: the first conv's output mean on each slice
    with torch.no_grad():
        x = torch.movedim(tb["image"], -1, 1)
        conv1 = tstate.model.enc[0].conv1
        y = torch_unet.conv(tcfg, x, conv1.w, conv1.b)
        g_mean = y.mean(dim=(0, 2, 3))
        part = [y[s].mean(dim=(0, 2, 3)) for s in torch.split(torch.arange(8), 8 // ways)]
    assert max(float((p - g_mean).abs().max()) for p in part) > 1e-3


FAMILIES = ("n2v", "flows", "stars", "gan")


def _family(family, seed=30, batch=8, size=16):
    """The JAX and port steps of ``family`` (augment off), states from one
    JAX init, a numpy batch, and the port step's keyword arguments for
    JAX step ``key`` (the N2V mask draws of that key)."""
    from sequitr_tpu.models import gan as jax_gan
    from sequitr_tpu_torch.models import gan as torch_gan

    rng = np.random.default_rng(seed)
    jtc = jax_train.TrainConfig(learning_rate=LR, augment=False)
    ttc = torch_train.TrainConfig(learning_rate=LR, augment=False)
    image = rng.random((batch, size, size, 1)).astype(np.float32)
    if family == "gan":
        kw = dict(gen_depth=2, gen_base_features=4, disc_layers=2, disc_base_features=4)
        jcfg = jax_gan.GANConfig(compute_dtype=jnp.float32, **kw)
        tcfg = torch_gan.GANConfig(compute_dtype="float32", **kw)
        jstate = jax_train.create_gan_state(jax.random.PRNGKey(seed), jcfg, jtc)
        model = torch_convert.load_flat(tcfg, _flat(jstate.params, jstate.model_state), device="cpu")
        tstate = torch_train.create_gan_state(tcfg, ttc, model=model)
        b = {"input": image, "target": rng.random(image.shape).astype(np.float32)}
        return jax_train.make_gan_train_step(jcfg, jtc), functools.partial(
            torch_train.make_gan_train_step, tcfg, ttc), jstate, tstate, b, lambda key: {}
    k = {"n2v": 1, "flows": 3, "stars": 5}[family]
    jcfg, tcfg, _, _, jstate, tstate, _ = _setup(seed=seed, num_classes=k, depth=2)
    tstate = torch_convert.load_train_state(tcfg, ttc, _flat(jstate.params, jstate.model_state), device="cpu")
    b = {"image": image}
    if family == "flows":
        b.update(flow=rng.normal(size=(batch, size, size, 2)).astype(np.float32),
                 prob=(rng.random((batch, size, size)) > 0.5).astype(np.float32))
    elif family == "stars":
        b.update(dist=(rng.random((batch, size, size, 4)) * 5).astype(np.float32),
                 prob=rng.random((batch, size, size)).astype(np.float32))
    draws = lambda key: {}
    if family == "n2v":
        from tests.test_torch_n2v_train import jax_step_draws

        kw = dict(mask_frac=0.05, radius=3)
        draws = lambda key: {"draws": jax_step_draws(key, image.shape, 0.05, (3, 3), augment=False)}
        return jax_train.make_n2v_train_step(jcfg, jtc, **kw), functools.partial(
            torch_train.make_n2v_train_step, tcfg, ttc, **kw), jstate, tstate, b, draws
    return getattr(jax_train, f"make_{family}_train_step")(jcfg, jtc), functools.partial(
        getattr(torch_train, f"make_{family}_train_step"), tcfg, ttc), jstate, tstate, b, draws


@pytest.mark.parametrize("family", FAMILIES)
def test_dp_family_steps_match_the_jax_dp_step(family):
    """Every train step factory takes the mesh: three DP steps (4 ways) of
    the N2V, flows, stars and GAN steps against the JAX package's DP step
    (``make_dp_train_step`` over its 8 devices) from the same converted
    weights, on the same batches and mask draws, at the U-Net DP test's
    bars (every metric rtol 1e-5, every weight rtol 2e-4 / atol 1e-6, the
    batch-norm-fed conv biases within 2 * steps * lr, the running means
    strict on the first step only); the port's single-device step is held
    to the DP step at the same bars. Every weight leaf that no batch norm
    nulls has moved by more than lr / 2 from its start (Adam's first step
    moves it by about lr), so a skipped update cannot pass."""
    jmake, make, jstate, tstate, b, draws = _family(family)
    start = _flat(jstate.params, jstate.model_state)
    single = copy.deepcopy(tstate)
    jstep = jax_parallel.make_dp_train_step(jmake, jax_parallel.make_mesh())
    sstep = make()
    tb = {k: torch.from_numpy(v) for k, v in b.items()}
    with parallel.virtual_devices(4):
        dp = parallel.make_dp_train_step(make, parallel.make_mesh(device="cpu"))
        for i in range(3):
            key = jax.random.PRNGKey(100 + i)
            jstate, jm = jstep(jstate, _jax_batch(b), key)
            tstate, tm = dp(tstate, tb, **draws(key))
            single, sm = sstep(single, tb, **draws(key))
            _compare_family(tstate, tm, _flat(jstate.params, jstate.model_state), jm, i + 1, first=i == 0)
            _compare_family(single, sm, torch_convert.to_flat(tstate.model), tm, i + 1, first=i == 0)
    got = torch_convert.to_flat(tstate.model)
    for k in start:
        if not k.startswith("state/") and not _bn_fed_bias(k):
            assert np.abs(got[k] - start[k]).max() > LR / 2, k


def _compare_family(tstate, tm, want, wm, steps, first):
    """``_compare`` for any train state and metric set: ``want`` flat."""
    assert set(tm) == set(wm)
    for m in wm:
        np.testing.assert_allclose(float(tm[m]), float(wm[m]), rtol=1e-5, atol=1e-7, err_msg=m)
    got = torch_convert.to_flat(tstate.model)
    assert set(got) == set(want)
    for k in sorted(want):
        if (k.endswith("/mean") and k.startswith("state/") and not first) or _bn_fed_bias(k):
            assert np.abs(got[k] - want[k]).max() <= 2 * steps * LR, k
        elif k.startswith("state/"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=1e-6, err_msg=k)


def test_polyphase_on_a_mesh_is_refused():
    cfg = torch_unet.UNetConfig(depth=2, base_features=4, compute_dtype="float32")
    tc = torch_train.TrainConfig(augment=False, polyphase=True)
    with parallel.virtual_devices(2):
        with pytest.raises(ValueError, match="polyphase training does not run on a device mesh"):
            parallel.make_dp_train_step(
                functools.partial(torch_train.make_unet_train_step, cfg, tc), parallel.make_mesh(device="cpu"))



def test_placed_weights_copy_once_and_return_their_gradient():
    """``spatial_train._Placed`` on a device other than the weight's (the
    path of a multi-card pool): one copy per weight and device within a
    forward, and the gradients of every use flow back to the master
    weight."""
    placed = spatial_train._Placed()
    w = torch.arange(4.0, requires_grad=True)
    other = torch.device("cpu", 1)
    a, b = placed(w, other), placed(w, other)
    assert a is b and a is not w and placed(w, torch.device("cpu")) is w
    (a * 2 + b * 3 + w).sum().backward()
    assert torch.equal(w.grad, torch.full((4,), 6.0))
