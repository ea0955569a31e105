"""The port's ``parallel`` package against the JAX package's: the mesh, the
halo-exchanged spatial forwards (2D, 3D, multichannel, space-to-depth, the
GAN generator, the hybrid data x space forms) and the data-parallel
wrappers, mirroring ``tests/test_spatial.py``'s inference classes.

The JAX functions run on the 8 virtual CPU devices of ``tests/conftest.py``;
the port's on ``parallel.virtual_devices(n)`` (n = 2, 4, 8) over the CPU.
Tolerances (f32 compute): the port's n-way forward against its own
whole-frame forward and against the JAX 8-way forward, probabilities
within 1e-5 absolute (they lie in [0, 1]), labels equal; enhanced frames
within 1e-5. Refusals carry the JAX messages. The data-parallel wrappers
equal the port's single-device functions bit for bit (the same per-frame
work, on another slice).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequitr_tpu import parallel as jax_parallel
from sequitr_tpu.models import convert as jax_convert
from sequitr_tpu.models import gan as jax_gan
from sequitr_tpu.models import unet as jax_unet
from sequitr_tpu.parallel import spatial as jax_spatial
from sequitr_tpu_torch import parallel
from sequitr_tpu_torch import psf as torch_psf
from sequitr_tpu_torch.models import convert as torch_convert
from sequitr_tpu_torch.models import gan as torch_gan
from sequitr_tpu_torch.models import unet as torch_unet
from sequitr_tpu_torch.ops import registration as torch_reg
from sequitr_tpu_torch.parallel import spatial

PROB_TOL = 1e-5
WAYS = (2, 4, 8)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _flat(params, state):
    flat = jax_convert.flatten_params(params)
    flat.update({f"state/{k}": v for k, v in jax_convert.flatten_params(state).items()})
    return flat


VARIANTS = {
    "batch_norm": dict(),
    "norm_none": dict(norm="none"),
    "multichannel": dict(in_channels=2),
    "space_to_depth": dict(space_to_depth=2, base_features=8),
}


def _unet_pair(seed=0, **kw):
    """A JAX U-Net (f32, depth 3, base 4) with perturbed statistics and the
    same weights in the port."""
    cfg = jax_unet.UNetConfig(
        **{**dict(in_channels=1, num_classes=3, depth=3, base_features=4, compute_dtype=jnp.float32), **kw}
    )
    params, state = jax_unet.init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed + 1)
    state = jax.tree.map(lambda a: a + 0.05 * rng.random(a.shape).astype(np.float32), state)
    tcfg = torch_unet.UNetConfig(**{**dataclasses.asdict(cfg), "compute_dtype": "float32"})
    return cfg, params, state, tcfg, torch_convert.load_flat(tcfg, _flat(params, state), device="cpu")


_JAX_CACHE = {}


def _jax_spatial_2d(variant):
    """(pair, frame, JAX 8-way probs, labels), computed once a variant."""
    if variant not in _JAX_CACHE:
        cfg, params, state, tcfg, model = pair = _unet_pair(seed=3, **VARIANTS[variant])
        shape = (64, 32) if cfg.in_channels == 1 else (64, 32, 2)
        frame = np.random.default_rng(2).normal(size=shape).astype(np.float32)
        fn = jax_spatial.spatial_unet2d_infer(cfg, params, state, jax_parallel.make_mesh(), (64, 32))
        probs, labels = fn(params, state, jnp.asarray(frame))
        _JAX_CACHE[variant] = (pair, frame, np.asarray(probs), np.asarray(labels))
    return _JAX_CACHE[variant]


@pytest.mark.parametrize("ways", WAYS)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_spatial_unet2d_matches_whole_frame_and_jax(variant, ways):
    (cfg, params, state, tcfg, model), frame, jp, jl = _jax_spatial_2d(variant)
    with parallel.virtual_devices(ways):
        mesh = parallel.make_mesh(device="cpu")
        assert mesh.size == ways
        fn = spatial.spatial_unet2d_infer(tcfg, mesh, (64, 32))
        probs, labels = fn(model, frame)
    x = torch.from_numpy(frame)
    whole = torch.softmax(model(x[None] if x.ndim == 3 else x[None, ..., None]), -1)[0]
    assert probs.shape == whole.shape == jp.shape
    assert float((probs - whole).abs().max()) <= PROB_TOL
    np.testing.assert_allclose(probs.numpy(), jp, atol=PROB_TOL)
    np.testing.assert_array_equal(labels.numpy(), jl)
    np.testing.assert_array_equal(labels.numpy(), whole.argmax(-1).numpy())


@pytest.mark.parametrize("ways", WAYS)
@pytest.mark.parametrize("channels", [1, 2])
def test_spatial_unet3d_matches_whole_volume_and_jax(channels, ways):
    cfg, params, state, tcfg, model = _unet_pair(seed=5, dims=3, depth=2, in_channels=channels)
    shape = (16, 8, 8) if channels == 1 else (16, 8, 8, 2)
    vol = np.random.default_rng(6).normal(size=shape).astype(np.float32)
    fn = jax_spatial.spatial_unet3d_infer(cfg, params, state, jax_parallel.make_mesh(), (16, 8, 8))
    jp, jl = (np.asarray(a) for a in fn(params, state, jnp.asarray(vol)))
    with parallel.virtual_devices(ways):
        probs, labels = spatial.spatial_unet3d_infer(tcfg, parallel.make_mesh(device="cpu"), (16, 8, 8))(model, vol)
    x = torch.from_numpy(vol)
    whole = torch.softmax(model(x[None] if channels == 2 else x[None, ..., None]), -1)[0]
    assert float((probs - whole).abs().max()) <= PROB_TOL
    np.testing.assert_allclose(probs.numpy(), jp, atol=PROB_TOL)
    np.testing.assert_array_equal(labels.numpy(), jl)


def _gan_pair(seed=0, depth=3):
    cfg = jax_gan.GANConfig(
        gen_depth=depth, gen_base_features=4, disc_layers=2, disc_base_features=4, compute_dtype=jnp.float32,
    )
    params, state = jax_gan.init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed + 1)
    state = jax.tree.map(lambda a: a + 0.1 * rng.random(a.shape).astype(np.float32), state)
    tcfg = torch_gan.GANConfig(**{**dataclasses.asdict(cfg), "compute_dtype": "float32"})
    model = torch_convert.load_flat(tcfg, _flat(params, state), device="cpu")
    cfg_f, p_f, s_f = jax_gan.fold_generator(cfg, params, state)
    return (cfg_f, p_f, s_f), torch_gan.fold_generator(model)


@pytest.mark.parametrize("ways", WAYS)
def test_spatial_gan_enhance_matches_whole_frame_and_jax(ways):
    (cfg_f, p_f, s_f), folded = _gan_pair()
    frame = np.random.default_rng(2).normal(size=(64, 32)).astype(np.float32)
    ref = np.asarray(jax_spatial.spatial_gan_enhance(cfg_f, p_f, s_f, jax_parallel.make_mesh(), (64, 32))(
        p_f, s_f, jnp.asarray(frame)))
    with parallel.virtual_devices(ways):
        fn = spatial.spatial_gan_enhance(folded.cfg, parallel.make_mesh(device="cpu"), (64, 32))
        out = fn(folded, frame)
    assert out.shape == (64, 32, 1)
    whole = torch_gan.generator_apply(folded, torch.from_numpy(frame)[None, ..., None])[0]
    assert float((out - whole).abs().max()) <= 1e-5
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("variant", ["batch_norm", "multichannel"])
def test_hybrid_unet2d_matches_per_frame_and_jax(variant):
    cfg, params, state, tcfg, model = _unet_pair(seed=9, **VARIANTS[variant])
    shape = (4, 32, 16) if cfg.in_channels == 1 else (4, 32, 16, 2)
    frames = np.random.default_rng(10).normal(size=shape).astype(np.float32)
    mesh2 = jax_parallel.make_mesh2d((2, 4))
    jp, jl = (np.asarray(a) for a in jax_spatial.hybrid_unet2d_infer(
        cfg, params, state, mesh2, (32, 16), batch=4)(params, state, jnp.asarray(frames)))
    with parallel.virtual_devices(8):
        fn = spatial.hybrid_unet2d_infer(tcfg, parallel.make_mesh2d((2, 4), device="cpu"), (32, 16), batch=4)
        probs, labels = fn(model, frames)
    x = torch.from_numpy(frames)
    whole = torch.softmax(model(x if x.ndim == 4 else x[..., None]), -1)
    assert probs.shape == whole.shape == jp.shape
    assert float((probs - whole).abs().max()) <= PROB_TOL
    np.testing.assert_allclose(probs.numpy(), jp, atol=PROB_TOL)
    np.testing.assert_array_equal(labels.numpy(), jl)


def test_hybrid_gan_matches_per_frame_and_jax():
    (cfg_f, p_f, s_f), folded = _gan_pair(seed=3, depth=2)
    frames = np.random.default_rng(4).normal(size=(2, 32, 16)).astype(np.float32)
    ref = np.asarray(jax_spatial.hybrid_gan_enhance(
        cfg_f, p_f, s_f, jax_parallel.make_mesh2d((2, 4)), (32, 16), batch=2)(p_f, s_f, jnp.asarray(frames)))
    with parallel.virtual_devices(8):
        fn = spatial.hybrid_gan_enhance(folded.cfg, parallel.make_mesh2d((2, 4), device="cpu"), (32, 16), batch=2)
        out = fn(folded, frames)
    assert out.shape == (2, 32, 16, 1)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


def _message(fn):
    with pytest.raises((ValueError, NotImplementedError)) as e:
        fn()
    return str(e.value)


REFUSALS = {
    "h_not_divisible": ("unet2d", (60, 32)),
    "w_not_pooled": ("unet2d", (64, 30)),
    "z_not_divisible": ("unet3d", (12, 8, 8)),
    "axes_mismatch": ("unet2d", (64, 32, 8)),
    "unfolded_generator": ("gan", (64, 32)),
    "gan_shape": ("gan_folded", (60, 32)),
    "hybrid_batch": ("hybrid", (32, 16)),
    "hybrid_gan_batch": ("hybrid_gan", (32, 16)),
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusals_carry_the_jax_messages(case):
    kind, shape = REFUSALS[case]
    if kind.startswith("gan") or kind == "hybrid_gan":
        gcfg = jax_gan.GANConfig(gen_depth=2, gen_base_features=4, disc_layers=2, disc_base_features=4,
                                 compute_dtype=jnp.float32, gen_norm="none" if kind != "gan" else "batch")
        params, state = jax_gan.init(jax.random.PRNGKey(1), gcfg)
        tcfg = torch_gan.GANConfig(**{**dataclasses.asdict(gcfg), "compute_dtype": "float32"})
        if kind == "hybrid_gan":
            want = _message(lambda: jax_spatial.hybrid_gan_enhance(
                gcfg, params, state, jax_parallel.make_mesh2d((2, 4)), shape, batch=3))
        else:
            want = _message(lambda: jax_spatial.spatial_gan_enhance(
                gcfg, params, state, jax_parallel.make_mesh(), shape))
        with parallel.virtual_devices(8):
            if kind == "hybrid_gan":
                got = _message(lambda: spatial.hybrid_gan_enhance(
                    tcfg, parallel.make_mesh2d((2, 4), device="cpu"), shape, batch=3))
            else:
                got = _message(lambda: spatial.spatial_gan_enhance(tcfg, parallel.make_mesh(device="cpu"), shape))
        if kind == "gan":
            assert "fold" in got
    else:
        cfg, params, state, tcfg, _ = _unet_pair(dims=3, depth=2) if kind == "unet3d" else _unet_pair()
        if kind == "hybrid":
            want = _message(lambda: jax_spatial.hybrid_unet2d_infer(
                cfg, params, state, jax_parallel.make_mesh2d((2, 4)), shape, batch=3))
        else:
            jfn = jax_spatial.spatial_unet3d_infer if kind == "unet3d" else jax_spatial.spatial_unet2d_infer
            want = _message(lambda: jfn(cfg, params, state, jax_parallel.make_mesh(), shape))
        with parallel.virtual_devices(8):
            if kind == "hybrid":
                got = _message(lambda: spatial.hybrid_unet2d_infer(
                    tcfg, parallel.make_mesh2d((2, 4), device="cpu"), shape, batch=3))
            else:
                tfn = spatial.spatial_unet3d_infer if kind == "unet3d" else spatial.spatial_unet2d_infer
                got = _message(lambda: tfn(tcfg, parallel.make_mesh(device="cpu"), shape))
    assert got == want


def test_mesh_matches_jax_shapes_and_messages():
    with parallel.virtual_devices(8):
        m = parallel.make_mesh(device="cpu")
        m4 = parallel.make_mesh(4, device="cpu")
        m2 = parallel.make_mesh2d((2, 4), device="cpu")
        got = _message(lambda: parallel.make_mesh2d((4, 4), device="cpu"))
    j, j4, j2 = jax_parallel.make_mesh(), jax_parallel.make_mesh(4), jax_parallel.make_mesh2d((2, 4))
    assert m.shape == dict(j.shape) and m4.shape == dict(j4.shape) and m2.shape == dict(j2.shape)
    assert m.axis_names == j.axis_names and m2.axis_names == j2.axis_names
    assert got == _message(lambda: jax_parallel.make_mesh2d((4, 4)))
    # without virtual devices the CPU is one device; the context restores it
    assert parallel.device_pool("cpu") == [torch.device("cpu")]
    with parallel.virtual_devices(2):
        with parallel.virtual_devices(3):
            assert len(parallel.device_pool("cpu")) == 3
        assert len(parallel.device_pool("cpu")) == 2
    assert parallel.make_mesh(device="cpu").size == 1


def test_shard_batch_is_contiguous_like_partition_spec():
    x = np.arange(8 * 3).reshape(8, 3)
    with parallel.virtual_devices(4):
        mesh = parallel.make_mesh(device="cpu")
        shards = parallel.shard_batch(mesh, {"image": x, "labels": x[:, 0]})
        reps = parallel.replicated(mesh, torch.ones(2))
    for i, s in enumerate(shards["image"]):
        np.testing.assert_array_equal(s.numpy(), x[2 * i:2 * i + 2])
    assert [len(s) for s in shards["labels"]] == [2] * 4
    assert len(reps) == 4 and all(r is reps[0] for r in reps)  # one copy a distinct device
    with pytest.raises(ValueError, match="not divisible"):
        parallel.batch_sharded(mesh, x[:7])


@pytest.mark.parametrize("ways", [2, 4])
def test_dp_frame_inferrer_equals_single_device(ways):
    from sequitr_tpu_torch.pipeline import infer

    _, _, _, tcfg, model = _unet_pair(seed=12)
    model = torch_unet.fold_batchnorm(model)
    tc = infer.TileConfig(patch=(32, 32), overlap=(0, 0), labels_dtype="uint16")
    frames = (np.random.default_rng(13).random((ways, 32, 32)) * 4000).astype(np.uint16)
    one = infer.cached_batch_inferrer(tcfg, tc, (32, 32), 1, "cpu")
    want = [one(model, frames[k:k + 1]) for k in range(ways)]
    with parallel.virtual_devices(ways):
        dp = parallel.make_dp_frame_inferrer(
            lambda d: infer.cached_batch_inferrer(tcfg, tc, (32, 32), 1, d), parallel.make_mesh(device="cpu"))
        probs, labels = dp(model, frames)
    assert torch.equal(probs, torch.cat([w[0] for w in want]))
    assert torch.equal(labels, torch.cat([w[1] for w in want]))


def test_dp_localizers_and_deconvolver_equal_per_frame():
    rng = np.random.default_rng(4)
    frames = rng.normal(10.0, 0.5, (4, 32, 32)).astype(np.float32)
    yy, xx = np.mgrid[:32, :32]
    for k in range(4):
        frames[k] += 80.0 * np.exp(-((yy - 10.3 - k) ** 2 + (xx - 20.6) ** 2) / (2 * 1.5**2))
    thrs = np.full(4, 30.0, np.float32)
    with parallel.virtual_devices(4):
        mesh = parallel.make_mesh(device="cpu")
        yx, valid, fits = parallel.make_dp_localizer(mesh, max_peaks=8)(frames, thrs)
        kernel = torch_psf.gaussian_psf_2d(7, 1.2, "cpu")
        deconv = parallel.make_dp_deconvolver(mesh, kernel, 5)(frames)
    for k in range(4):
        y1, v1, f1 = torch_psf._detect_and_fit(
            torch.from_numpy(frames[k]), torch.tensor(30.0), max_peaks=8, min_distance=2, window=7, sigma=1.5)
        assert torch.equal(yx[k], y1) and torch.equal(valid[k], v1)
        for key in f1:
            assert torch.equal(fits[key][k], f1[key]), key
        assert torch.equal(deconv[k], torch_psf.richardson_lucy_frame(torch.from_numpy(frames[k]), kernel, 5))


def test_dp_registerer_and_seam_correlator():
    rng = np.random.default_rng(7)
    ref = rng.random((32, 32)).astype(np.float32)
    frames = np.stack([np.roll(ref, (k, -k), (0, 1)) for k in range(4)])
    refs5 = np.concatenate([frames, frames[:1]])
    movs5 = np.concatenate([frames[::-1], frames[:1]])
    with parallel.virtual_devices(2):
        mesh = parallel.make_mesh(device="cpu")
        shifts, resp, corr = parallel.make_dp_registerer(mesh)(torch.from_numpy(ref), torch.from_numpy(frames))
        # 5 pairs on 2 devices: padded to 6 with the last pair, then cut
        s5, r5 = parallel.make_dp_seam_correlator(mesh)(refs5, movs5)
    for i in range(2):  # each device registers its two frames as one batch
        s1, r1, c1 = torch_reg.register_batch(torch.from_numpy(ref), torch.from_numpy(frames[2 * i:2 * i + 2]))
        assert torch.equal(shifts[2 * i:2 * i + 2], s1) and torch.equal(corr[2 * i:2 * i + 2], c1)
    np.testing.assert_allclose(shifts.numpy(), [[-k, k] for k in range(4)], atol=0.05)
    assert s5.shape == (5, 2) and r5.shape == (5,)
    for i in range(2):
        sl = slice(3 * i, 3 * i + 3)
        pad = np.concatenate([refs5, refs5[-1:]]), np.concatenate([movs5, movs5[-1:]])
        s1, r1 = torch_reg._correlate(torch.from_numpy(pad[0][sl]), torch.from_numpy(pad[1][sl]), 2, True, True, 2)
        n = min(3, 5 - 3 * i)
        np.testing.assert_array_equal(s5[3 * i:3 * i + n], s1.numpy().astype(np.float64)[:n])



def _two_device_mesh(n=4):
    """An ``n``-way mesh over two devices the code tells apart (``cpu:0``
    and ``cpu:1``; a CPU tensor's device is ``cpu`` whatever the index, so
    the shards' devices do not carry the index, but the mesh's do)."""
    devs = np.empty(n, dtype=object)
    devs[:] = [torch.device("cpu", k % 2) for k in range(n)]
    return parallel.Mesh(devs, ("data",), torch.device("cpu"))


def test_replicas_on_distinct_devices(monkeypatch):
    """The weight copies a multi-card pool makes: ``mesh.replica`` copies
    the model once to each device it does not live on (kept with the model
    until its weights change), ``spatial.replica_weights`` maps every
    parameter to its own copy on each device, and the data-parallel
    inferrer serves each slice with its device's copy: outputs bit-equal
    to the single-device ones."""
    from sequitr_tpu_torch.parallel import mesh as mesh_mod
    from sequitr_tpu_torch.pipeline import infer

    copies = []
    real_copy = mesh_mod._copy_to
    monkeypatch.setattr(mesh_mod, "_copy_to", lambda m, d: copies.append(str(d)) or real_copy(m, d))
    _, _, _, tcfg, model = _unet_pair(seed=12)
    devs = [torch.device("cpu", 0), torch.device("cpu", 1)]
    wt = spatial.replica_weights(model, devs * 2)
    assert sorted(copies) == ["cpu:0", "cpu:1"]
    for dev in devs:
        rep = mesh_mod.replica(model, dev)
        assert rep is not model and mesh_mod.replica(model, dev) is rep
        for (name, p), (rname, q) in zip(model.named_parameters(), rep.named_parameters()):
            assert name == rname and wt(p, dev) is q and q is not p and torch.equal(q, p), name
    assert len(copies) == 2
    with torch.no_grad():
        model.head.b.add_(1.0)
    rep = mesh_mod.replica(model, devs[1])
    assert len(copies) == 3 and torch.equal(rep.head.b, model.head.b)

    copies.clear()
    folded = torch_unet.fold_batchnorm(model)
    tc = infer.TileConfig(patch=(32, 32), overlap=(0, 0), labels_dtype="uint16")
    frames = (np.random.default_rng(13).random((4, 32, 32)) * 4000).astype(np.uint16)
    make = lambda d: infer.cached_batch_inferrer(tcfg, tc, (32, 32), 1, d)
    got = parallel.make_dp_frame_inferrer(make, _two_device_mesh())(folded, frames)
    one = make("cpu")
    want = [one(folded, frames[k:k + 1]) for k in range(4)]
    assert sorted(copies) == ["cpu:0", "cpu:1"]
    assert torch.equal(got[0], torch.cat([w[0] for w in want]))
    assert torch.equal(got[1], torch.cat([w[1] for w in want]))
