"""The port's fixture writer and the library names it adds, against the JAX
package's on the same inputs.

- ``fixtures.save``: the same weights (JAX params carried into the port)
  saved by the JAX ``save`` (its ``_DIR`` monkeypatched to ``tmp_path``, in
  this test only) and by the port's give npz files with the same keys in the
  same order, the same dtypes and the same array bytes, and equal manifest
  entries. (The zip container stamps each member with the time it was
  written, so the files are compared member by member.)
- A port-saved fixture loads in the JAX ``fixtures.load`` (``_DIR``
  monkeypatched) and its JAX forward equals the port's at f32 (atol 1e-5).
- ``save`` refuses the committed directory; ``load`` / ``manifest`` /
  ``names`` read another directory when given one and the committed one by
  default.
- ``convert.flatten_params`` / ``unflatten_like`` / ``load_npz_weights``
  (mirroring ``tests/test_misc.py``'s conversion cases), ``prefetch.
  batch_iterator``, ``losses.softmax_label_map``, ``unet.param_count``,
  ``registration.hann2d``, ``mesh.make_dp_frame_mapper`` and
  ``tf_reference.measure_tf_cpu_fps``, each held against its JAX function
  on seeded numpy inputs: exact where both compute the same values the same
  way, 1e-6 for the softmax and the window (two libraries' exp and cos),
  1e-5 for U-Net forwards.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequitr_tpu import parallel as jax_parallel
from sequitr_tpu.data import prefetch as jax_prefetch
from sequitr_tpu.models import convert as jax_convert
from sequitr_tpu.models import fixtures as jax_fixtures
from sequitr_tpu.models import gan as jax_gan
from sequitr_tpu.models import tf_reference as jax_tf_reference
from sequitr_tpu.models import unet as jax_unet
from sequitr_tpu.models import zoo as jax_zoo
from sequitr_tpu.ops import losses as jax_losses
from sequitr_tpu.ops import registration as jax_registration
from sequitr_tpu_torch import parallel
from sequitr_tpu_torch.data import prefetch
from sequitr_tpu_torch.models import convert, fixtures, gan, tf_reference, unet, zoo
from sequitr_tpu_torch.ops import losses, registration


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


UNET = dict(in_channels=1, num_classes=3, depth=3, base_features=4)
GAN = dict(gen_depth=2, gen_base_features=4, disc_base_features=4)


def _perturbed(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: a + 0.25 * rng.random(a.shape).astype(np.float32), tree)


def _flat(params, state):
    flat = {k: np.asarray(v) for k, v in jax_convert.flatten_params(params).items()}
    flat.update({f"state/{k}": np.asarray(v) for k, v in jax_convert.flatten_params(state).items()})
    return flat


def _pair(kind, seed=0, **kw):
    """A JAX model of ``kind`` (f32, small) with perturbed statistics, and
    the same weights in the port: ``(jcfg, params, state, tcfg, model)``."""
    if kind == "gan":
        jcfg = jax_gan.GANConfig(**{**GAN, "compute_dtype": jnp.float32, **kw})
        params, state = jax_gan.init(jax.random.PRNGKey(seed), jcfg)
        tcfg = gan.GANConfig(**{**dataclasses.asdict(jcfg), "compute_dtype": "float32"})
    else:
        jcfg = jax_unet.UNetConfig(**{**UNET, "compute_dtype": jnp.float32, **kw})
        params, state = jax_unet.init(jax.random.PRNGKey(seed), jcfg)
        tcfg = unet.UNetConfig(**{**dataclasses.asdict(jcfg), "compute_dtype": "float32"})
    state = _perturbed(state, seed + 1)
    return jcfg, params, state, tcfg, convert.load_flat(tcfg, _flat(params, state), device="cpu")


META = {"task": "a test", "recipe": {"steps": 3, "batch": 2, "lr": "1e-3 cosine"}, "holdout_miou": 0.5}

CASES = {
    "unet": ("unet", dict()),
    "unet3d": ("unet", dict(dims=3, depth=2)),
    "s2d": ("unet", dict(space_to_depth=2)),
    "n2v": ("n2v", dict(num_classes=1)),
    "gan": ("gan", dict()),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_save_writes_the_jax_layout(case, tmp_path, monkeypatch):
    kind, kw = CASES[case]
    jcfg, params, state, tcfg, model = _pair("gan" if kind == "gan" else "unet", **kw)
    monkeypatch.setattr(jax_fixtures, "_DIR", str(tmp_path / "jax"))
    jpath = jax_fixtures.save(case, kind, jcfg, params, state, META)
    tpath = fixtures.save(case, kind, tcfg, model, META, str(tmp_path / "port"))
    with np.load(jpath) as j, np.load(tpath) as t:
        assert t.files == j.files
        for k in j.files:
            assert t[k].dtype == j[k].dtype, k
            assert t[k].shape == j[k].shape, k
            assert t[k].tobytes() == j[k].tobytes(), k
        assert {j[k].dtype for k in j.files if not k.startswith("state/")} == {np.dtype(np.float16)}
        assert {j[k].dtype for k in j.files if k.startswith("state/")} <= {np.dtype(np.float32)}
    assert fixtures.manifest(str(tmp_path / "port")) == jax_fixtures.manifest()
    assert not os.path.exists(os.path.join(str(tmp_path / "port"), "manifest.json.tmp"))


def test_save_keeps_other_entries(tmp_path):
    *_, tcfg, model = _pair("unet")
    out = str(tmp_path)
    fixtures.save("a", "unet", tcfg, model, META, out)
    fixtures.save("b", "flows", tcfg, model, dict(META, holdout_ap50=1.0), out)
    fixtures.save("a", "unet", tcfg, model, dict(META, holdout_miou=0.75), out)
    assert fixtures.names(out) == ["a", "b"]
    assert fixtures.manifest(out)["a"]["holdout_miou"] == 0.75
    assert fixtures.manifest(out)["b"]["kind"] == "flows"


@pytest.mark.parametrize("kind", ["unet", "gan"])
def test_port_saved_fixture_runs_in_jax(kind, tmp_path, monkeypatch):
    """Saved by the port from port-initialised weights, loaded by both
    packages from the same float16 file: the forwards agree at f32."""
    if kind == "gan":
        tcfg = gan.GANConfig(**GAN, compute_dtype="float32")
        model = gan.init(tcfg, torch.Generator().manual_seed(5), device="cpu")
        bns = model.gen.bn_layers()
    else:
        tcfg = unet.UNetConfig(**UNET, compute_dtype="float32")
        model = unet.init(tcfg, torch.Generator().manual_seed(5), device="cpu")
        bns = model.bn_layers()
    rng = np.random.default_rng(6)
    with torch.no_grad():
        for bn in bns:
            bn.mean.copy_(torch.as_tensor(rng.normal(0, 0.2, bn.mean.shape).astype(np.float32)))
            bn.var.copy_(torch.as_tensor(rng.uniform(0.5, 2.0, bn.var.shape).astype(np.float32)))
    out = str(tmp_path)
    fixtures.save("fx", kind, tcfg, model, META, out)
    monkeypatch.setattr(jax_fixtures, "_DIR", out)
    jkind, jcfg, params, state, meta = jax_fixtures.load("fx", compute_dtype=jnp.float32)
    assert jkind == kind and meta["task"] == META["task"]
    _, cfg2, back, _ = fixtures.load("fx", compute_dtype="float32", device="cpu", directory=out)
    assert cfg2 == tcfg
    x = np.random.default_rng(7).random((2, 32, 32, 1)).astype(np.float32)
    with torch.inference_mode():
        if kind == "gan":
            got = gan.generator_apply(back, torch.as_tensor(x)).numpy()
            want = np.asarray(jax_gan.generator_apply(jcfg, params, state, jnp.asarray(x))[0])
        else:
            got = back(torch.as_tensor(x)).numpy()
            want = np.asarray(jax_unet.apply(jcfg, params, state, jnp.asarray(x))[0])
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_save_refuses_the_committed_directory(tmp_path):
    *_, tcfg, model = _pair("unet")
    before = sorted(os.listdir(fixtures.fixture_dir()))
    for directory in (
        fixtures.fixture_dir(),
        fixtures.fixture_dir() + os.sep,
        os.path.join(fixtures.fixture_dir(), "..", "fixtures"),
    ):
        with pytest.raises(ValueError, match="committed fixtures"):
            fixtures.save("unet2d_cells", "unet", tcfg, model, META, directory)
    assert sorted(os.listdir(fixtures.fixture_dir())) == before


def test_directory_argument_defaults_to_the_committed_fixtures(tmp_path):
    assert fixtures.names() == fixtures.names(None) == sorted(fixtures.manifest())
    assert fixtures.manifest() == jax_fixtures.manifest()
    assert fixtures.manifest(str(tmp_path)) == {} and fixtures.names(str(tmp_path)) == []
    with pytest.raises(KeyError, match="unknown fixture"):
        fixtures.load("unet2d_cells", device="cpu", directory=str(tmp_path))


# ---------------------------------------------------------------------------
# convert: flatten_params, unflatten_like, load_npz_weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["unet", "gan"])
def test_flatten_params_equals_jax(case):
    _, params, _, _, model = _pair(case)
    want = jax_convert.flatten_params(params)
    got = convert.flatten_params(model)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_flatten_unflatten_roundtrip():
    _, params, _, tcfg, model = _pair("unet", norm="none")
    flat = convert.flatten_params(model)
    assert any(k.startswith("enc/0/conv1/") for k in flat)
    back = convert.unflatten_like(unet.UNet(tcfg, device="cpu"), flat)
    for (name, a), b in zip(model.state_dict().items(), back.state_dict().values()):
        assert torch.equal(a, b), name


def test_unflatten_like_lists_every_problem():
    _, params, _, tcfg, model = _pair("unet")
    flat = convert.flatten_params(model)
    jflat = jax_convert.flatten_params(params)
    first, second = sorted(flat)[:2]
    for d in (flat, jflat):
        d.pop(first)
        d[second] = np.zeros((1, 2, 3), np.float32)
    template = unet.UNet(tcfg, device="cpu")
    before = {k: v.clone() for k, v in template.state_dict().items()}
    with pytest.raises(ValueError) as got:
        convert.unflatten_like(template, flat)
    with pytest.raises(ValueError) as want:
        jax_convert.unflatten_like(params, jflat)
    assert str(got.value) == str(want.value)
    assert f"missing: {first}" in str(got.value) and f"shape mismatch at {second}" in str(got.value)
    assert all(torch.equal(v, before[k]) for k, v in template.state_dict().items())  # the template is untouched


def test_load_npz_weights_equals_jax(tmp_path):
    _, params, _, tcfg, model = _pair("unet", seed=1)
    p = str(tmp_path / "w.npz")
    np.savez(p, **jax_convert.flatten_params(params))
    got = convert.load_npz_weights(p, unet.UNet(tcfg, device="cpu"))
    for k, v in jax_convert.flatten_params(jax_convert.load_npz_weights(p, params)).items():
        np.testing.assert_array_equal(convert.flatten_params(got)[k], v)
    # a torch-layout export with foreign names: name_map renames, kernel_map
    # takes each kernel to HWIO on its canonical path
    flat = jax_convert.flatten_params(params)
    torch_layout = {
        "model." + k: (np.transpose(v, (3, 2, 0, 1)) if k.endswith("/w") and "up/" not in k else v)
        for k, v in flat.items()
    }
    torch_layout["model.ignored"] = np.zeros(3, np.float32)
    q = str(tmp_path / "t.npz")
    np.savez(q, **torch_layout)
    kw = dict(
        name_map=lambda n: None if n == "model.ignored" else n[len("model."):],
        kernel_map=lambda n, a: (
            convert.torch_kernel_to_jax(a) if n.endswith("/w") and not n.startswith("up/") else a
        ),
    )
    jkw = dict(kw, kernel_map=lambda n, a: (
        jax_convert.torch_kernel_to_jax(a) if n.endswith("/w") and not n.startswith("up/") else a
    ))
    got = convert.flatten_params(convert.load_npz_weights(q, unet.UNet(tcfg, device="cpu"), **kw))
    want = jax_convert.flatten_params(jax_convert.load_npz_weights(q, params, **jkw))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


# ---------------------------------------------------------------------------
# batch_iterator, softmax_label_map, param_count, hann2d
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("drop_remainder", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_batch_iterator_equals_jax(drop_remainder, shuffle):
    rng = np.random.default_rng(11)
    examples = [
        {"image": rng.random((4, 4, 1)).astype(np.float32), "label": np.int32(i),
         "pair": (rng.random(3), np.arange(2) + i)}
        for i in range(11)
    ]
    key = (lambda: np.random.default_rng(3)) if shuffle else (lambda: None)
    got = list(prefetch.batch_iterator(examples, 4, key(), drop_remainder=drop_remainder))
    want = list(jax_prefetch.batch_iterator(examples, 4, key(), drop_remainder=drop_remainder))
    assert len(got) == len(want) == (2 if drop_remainder else 3)
    for g, w in zip(got, want):
        assert jax.tree.structure(g) == jax.tree.structure(w)
        for a, b in zip(jax.tree.leaves(g), jax.tree.leaves(w)):
            np.testing.assert_array_equal(a, b)
    collate = lambda chunk: [int(ex["label"]) for ex in chunk]  # noqa: E731
    assert list(prefetch.batch_iterator(examples, 4, key(), collate)) == list(
        jax_prefetch.batch_iterator(examples, 4, key(), collate)
    )


def test_softmax_label_map_equals_jax():
    logits = np.random.default_rng(12).normal(0, 3, (2, 8, 8, 4)).astype(np.float32)
    probs, labels = losses.softmax_label_map(torch.as_tensor(logits).to(torch.bfloat16))
    jprobs, jlabels = jax_losses.softmax_label_map(jnp.asarray(logits).astype(jnp.bfloat16))
    assert probs.dtype == torch.float32 and labels.dtype == torch.int32
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-6)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jlabels))


@pytest.mark.parametrize("name", sorted(jax_zoo.names()))
def test_param_count_equals_jax_for_every_preset(name):
    jcfg = jax_zoo.get(name)
    init = jax_gan.init if isinstance(jcfg, jax_gan.GANConfig) else jax_unet.init
    jparams, jstate = jax.eval_shape(lambda: init(jax.random.PRNGKey(0), jcfg))
    cfg = zoo.get(name)
    model = gan.GAN(cfg, device="cpu") if isinstance(cfg, gan.GANConfig) else unet.UNet(cfg, device="cpu")
    assert unet.param_count(model) == jax_unet.param_count(jparams)
    # the buffers are the batch-norm statistics, which it leaves out
    assert sum(b.numel() for b in model.buffers()) == jax_unet.param_count(jstate)


@pytest.mark.parametrize("shape", [(16, 24), (7, 5), (1, 8)])
def test_hann2d_equals_jax(shape):
    got = registration.hann2d(shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_registration.hann2d(shape)), atol=1e-6)
    assert torch.equal(got, registration.hann_window(shape))


# ---------------------------------------------------------------------------
# make_dp_frame_mapper, measure_tf_cpu_fps
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ways", [2, 4])
def test_make_dp_frame_mapper_equals_jax(ways):
    jcfg, params, state, tcfg, model = _pair("unet", num_classes=1)
    frames = np.random.default_rng(13).random((8, 16, 16, 1)).astype(np.float32)
    jfn = jax_parallel.make_dp_frame_mapper(
        lambda p, s, f: jax_unet.apply(jcfg, p, s, f[None])[0][0], jax_parallel.make_mesh(ways)
    )
    want = np.asarray(jfn(params, state, jnp.asarray(frames)))
    with parallel.virtual_devices(ways):
        mesh = parallel.make_mesh(device="cpu")
        with torch.inference_mode():
            got = parallel.make_dp_frame_mapper(lambda m, f: m(f[None])[0], mesh)(model, frames)
            with pytest.raises(TypeError, match="one tensor"):
                parallel.make_dp_frame_mapper(lambda m, f: (f, f), mesh)(model, frames)
            with pytest.raises(ValueError, match="not divisible"):
                parallel.make_dp_frame_mapper(lambda m, f: f, mesh)(None, frames[:ways + 1])
    assert got.shape == want.shape == (8, 16, 16, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    with torch.inference_mode():
        one_device = torch.stack([model(torch.as_tensor(f[None]))[0] for f in frames])
    assert torch.equal(got, one_device)


def test_measure_tf_cpu_fps_runs_like_jax():
    """Both measure the same Keras network (random weights) on the CPU; the
    rates are wall-clock and only checked to be finite and positive."""
    kw = dict(frame=32, iters=1, depth=2, base_features=2)
    got = tf_reference.measure_tf_cpu_fps(**kw)
    want = jax_tf_reference.measure_tf_cpu_fps(**kw)
    assert np.isfinite(got) and got > 0 and np.isfinite(want) and want > 0
