"""Post-training int8 quantization of the port (``studies.ptq_unet``)
against the JAX package's ``sequitr_tpu.studies.ptq_unet``.

On the same weights and seeded inputs: ``_pack`` is bit-equal to JAX's on
the same folded f32 weights; ``apply``'s logits are bit-equal to JAX's
``apply`` run eagerly on the same qparams (``from_jax``), for depth 3, base
8 (``tests/test_studies.py``'s model) with the transposed and the resize
upsample, ``space_to_depth=2`` and in 3D; calibration scales lie within
1e-5 relative of JAX's (the f32 site forwards sum in other orders) and the
quantile is bit-equal to the jitted ``jnp.quantile`` on identical
activations; the port's own ``quantize`` passes the JAX test's bars
(labels agree on > 98% of pixels, logits within 0.15 * max(|ref|, 1) of the
folded f32 forward); ``template`` has JAX's structure, shapes and dtypes; an
empty calibration raises. On the CPU every conv is ``qconv``'s plain
version; the card's kernel is held to it by ``chip_smoke.py --phases quant``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequitr_tpu.models import convert as jax_convert
from sequitr_tpu.models import unet as jax_unet
from sequitr_tpu.studies import ptq_unet as jax_ptq
from sequitr_tpu_torch.models import convert as torch_convert
from sequitr_tpu_torch.models import unet as torch_unet
from sequitr_tpu_torch.ops.normalize import quantile_linear
from sequitr_tpu_torch.studies import ptq_unet

VARIANTS = {
    "transpose": ({}, (32, 32)),
    "resize": ({"upsample": "resize"}, (32, 32)),
    "s2d2": ({"space_to_depth": 2}, (32, 32)),
    "3d": ({"dims": 3}, (8, 16, 16)),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _flat(params, state):
    flat = jax_convert.flatten_params(params)
    flat.update({f"state/{k}": v for k, v in jax_convert.flatten_params(state).items()})
    return {k: np.asarray(v) for k, v in flat.items()}


def _model(variant, seed=0):
    """JAX (cfg, params, state) of the JAX test's model (batch norm moved
    off its init so the fold matters), the port's model from the same
    weights, calibration batches and an input."""
    kw, spatial = VARIANTS[variant]
    cfg = jax_unet.UNetConfig(in_channels=1, num_classes=3, depth=3, base_features=8,
                              compute_dtype=jnp.float32, **kw)
    params, state = jax_unet.init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    state = jax.tree.map(lambda a: a + 0.1 * rng.random(a.shape).astype(np.float32), state)
    tcfg = torch_unet.UNetConfig(**{**cfg.__dict__, "compute_dtype": "float32"})
    model = torch_convert.load_flat(tcfg, _flat(params, state), device="cpu")
    calib = [rng.random((2, *spatial, 1)).astype(np.float32) for _ in range(3)]
    x = rng.random((2, *spatial, 1)).astype(np.float32)
    return cfg, params, state, model, calib, x


def _sites(fparams):
    """(site, folded conv) in the qparams layout's order."""
    for lvl, bp in enumerate(fparams["enc"]):
        for i in (1, 2):
            yield f"enc{lvl}/conv{i}", bp[f"conv{i}"]
    for i, p in enumerate(fparams["up"]):
        yield f"up{i}", p
    for i, bp in enumerate(fparams["dec"]):
        for j in (1, 2):
            yield f"dec{i}/conv{j}", bp[f"conv{j}"]
    yield "head", fparams["head"]


def _jax_qparams(fparams, scales):
    """JAX's qparams from JAX's folded weights and the given scales."""
    packed = {site: jax_ptq._pack(conv, scales[site]) for site, conv in _sites(fparams)}
    return {
        "enc": [{f"conv{i}": packed[f"enc{lvl}/conv{i}"] for i in (1, 2)} for lvl in range(len(fparams["enc"]))],
        "up": [packed[f"up{i}"] for i in range(len(fparams["up"]))],
        "dec": [{f"conv{j}": packed[f"dec{i}/conv{j}"] for j in (1, 2)} for i in range(len(fparams["dec"]))],
        "head": packed["head"],
    }


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_pack_and_apply_are_bit_equal_to_jax(variant):
    """Scales from the port's calibration; JAX's ``_pack`` of JAX's folded
    weights against the port's ``_pack`` of the same arrays, then the two
    ``apply``s on the same qparams and input."""
    cfg, params, state, model, calib, x = _model(variant)
    fcfg, fparams, _ = jax_unet.fold_batchnorm(cfg, params, state)
    scales = ptq_unet.calibrate(torch_unet.fold_batchnorm(model), calib)
    jq = _jax_qparams(fparams, scales)
    for site, conv in _sites(fparams):
        got = ptq_unet._pack({"w": torch.from_numpy(np.array(conv["w"])),
                              "b": torch.from_numpy(np.array(conv["b"]))}, scales[site])
        want = jax_ptq._pack(conv, scales[site])
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == torch.from_numpy(np.array(want[k])).dtype, (site, k)
            np.testing.assert_array_equal(_bits(got[k].numpy()), _bits(want[k]), err_msg=f"{site}/{k}")
    want = np.asarray(jax_ptq.apply(fcfg, jq, jnp.asarray(x)))
    qcfg = torch_unet.UNetConfig(**{**fcfg.__dict__, "compute_dtype": "float32"})
    got = ptq_unet.apply(qcfg, ptq_unet.from_jax(jq), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == x.shape[:-1] + (3,)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_calibration_scales_match_jax():
    cfg, params, state, model, calib, _ = _model("transpose", seed=1)
    fcfg, fparams, _ = jax_unet.fold_batchnorm(cfg, params, state)
    want = jax_ptq.calibrate(fcfg, fparams, calib)
    got = ptq_unet.calibrate(torch_unet.fold_batchnorm(model), calib)
    assert set(got) == set(want)
    for site in want:
        assert got[site] == pytest.approx(want[site], rel=1e-5), site


@pytest.mark.parametrize("n", [1, 2, 7, 4096, 20001])
def test_calibration_quantile_is_bit_equal_on_identical_activations(n):
    """The per-site statistic: ``jnp.quantile(|t|.ravel(), 0.9999)`` under
    ``jax.jit`` (what ``calibrate``'s jitted ``stats`` runs) against
    ``quantile_linear`` on the same activations."""
    t = np.random.default_rng(n).normal(size=n).astype(np.float32) * 3
    want = jax.jit(lambda a: jnp.quantile(jnp.abs(a).astype(jnp.float32).ravel(), 0.9999))(jnp.asarray(t))
    got = quantile_linear(torch.from_numpy(np.abs(t)).reshape(-1), [0.9999])[0]
    assert np.asarray(want).view(np.int32) == got.numpy().view(np.int32)


def test_quantized_forward_tracks_f32():
    """The port's own recipe at the JAX test's bars (tests/test_studies.py)."""
    cfg, params, state, model, calib, x = _model("transpose")
    qcfg, qparams = ptq_unet.quantize(model, calib)
    assert qcfg.norm == "none"
    logits_q = ptq_unet.apply(qcfg, qparams, torch.from_numpy(x))
    folded = torch_unet.fold_batchnorm(model)
    with torch.no_grad():
        logits_f = folded(torch.from_numpy(x))
    agree = float((torch.argmax(logits_q, -1) == torch.argmax(logits_f, -1)).float().mean())
    assert agree > 0.98, agree
    err = float((logits_q - logits_f).abs().max())
    ref = float(logits_f.abs().max())
    assert err < 0.15 * max(ref, 1.0), (err, ref)


@pytest.mark.parametrize("variant", ["transpose", "3d"])
def test_template_matches_jax(variant):
    cfg = _model(variant)[0]
    want = jax_ptq.template(cfg)
    got = ptq_unet.template(torch_unet.UNetConfig(**{**cfg.__dict__, "compute_dtype": "float32"}))
    leaves_w, tree_w = jax.tree.flatten(want)
    leaves_g, tree_g = jax.tree.flatten(got)
    assert tree_g == tree_w
    for g, w in zip(leaves_g, leaves_w):
        assert tuple(g.shape) == tuple(w.shape)
        assert g.dtype == torch.from_numpy(np.array(w)).dtype
    _, _, _, model, calib, _ = _model(variant)
    _, qparams = ptq_unet.quantize(model, calib[:1])
    assert jax.tree.structure(qparams) == tree_g


def test_calibration_requires_batches():
    model = _model("transpose", seed=2)[3]
    with pytest.raises(ValueError):
        ptq_unet.calibrate(torch_unet.fold_batchnorm(model), [])
    with pytest.raises(ValueError):  # an unfolded model: its norms would be skipped
        ptq_unet.calibrate(model, [np.zeros((1, 8, 8, 1), np.float32)])
