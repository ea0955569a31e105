"""The port's U-Net against ``sequitr_tpu.models.unet.apply`` on identical
weights (carried across in the flat interchange layout), at f32 within the
1e-4 bar of tests/test_parity.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequitr_tpu.models import convert as jax_convert
from sequitr_tpu.models import fixtures as jax_fixtures
from sequitr_tpu.models import unet as jax_unet
from sequitr_tpu_torch.models import convert as torch_convert
from sequitr_tpu_torch.models import fixtures as torch_fixtures
from sequitr_tpu_torch.models import unet as torch_unet
from sequitr_tpu_torch.pipeline import infer as torch_infer


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _flat(params, state):
    flat = jax_convert.flatten_params(params)
    flat.update({f"state/{k}": v for k, v in jax_convert.flatten_params(state).items()})
    return flat


def _torch_cfg(cfg):
    return torch_unet.UNetConfig(
        **{**dataclasses.asdict(cfg), "compute_dtype": np.dtype(cfg.compute_dtype).name}
    )


def _pair(norm="batch", s2d=1, upsample="transpose", depth=2):
    cfg = jax_unet.UNetConfig(
        depth=depth, base_features=4, norm=norm, space_to_depth=s2d,
        upsample=upsample, compute_dtype=jnp.float32,
    )
    params, state = jax_unet.init(jax.random.PRNGKey(0), cfg)
    if norm == "batch":
        # non-trivial running statistics so BN (and its fold) is exercised
        rng = np.random.default_rng(1)
        state = jax.tree.map(
            lambda a: a + 0.1 * rng.random(a.shape).astype(np.float32), state
        )
    model = torch_convert.load_flat(_torch_cfg(cfg), _flat(params, state), device="cpu")
    return cfg, params, state, model


def test_fixture_round_trip_all_keys():
    with np.load(jax_fixtures.fixture_dir() + "/unet2d_cells.npz") as npz:
        flat = {k: npz[k] for k in npz.files}
    assert len(flat) == 92
    _, cfg, model, _ = torch_fixtures.load("unet2d_cells", device="cpu")
    back = torch_convert.to_flat(model)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v.astype(np.float32), err_msg=k)
    again = torch_convert.to_flat(torch_convert.load_flat(cfg, back, device="cpu"))
    for k in flat:
        np.testing.assert_array_equal(again[k], back[k])


def test_load_flat_reports_missing_and_mismatched():
    cfg, params, state, _ = _pair()
    flat = _flat(params, state)
    flat.pop("enc/0/conv1/b")
    flat["head/w"] = np.zeros((1, 1, 2, 2), np.float32)
    with pytest.raises(ValueError, match="missing: enc/0/conv1/b"):
        torch_convert.load_flat(_torch_cfg(cfg), flat, device="cpu")


@pytest.mark.parametrize(
    "norm,s2d,upsample,fold",
    [
        ("batch", 1, "transpose", False),
        ("batch", 1, "transpose", True),
        ("none", 1, "transpose", False),
        ("batch", 2, "transpose", True),
        ("batch", 1, "resize", False),
    ],
)
def test_forward_matches_apply_f32(norm, s2d, upsample, fold):
    cfg, params, state, model = _pair(norm, s2d, upsample)
    if fold:
        model = torch_unet.fold_batchnorm(model)
        assert model.cfg.norm == "none"
    x = np.random.default_rng(2).normal(size=(2, 16, 16, 1)).astype(np.float32)
    want = np.asarray(jax_unet.apply(cfg, params, state, jnp.asarray(x))[0])
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 16, 16, 3)
    assert np.max(np.abs(got - want)) < 1e-4


def _pytree(flat):
    """The flat interchange dict as (params, state) pytrees — what
    ``fixtures.load`` returns, without its full-size random init."""
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(v, np.float32)

    def lists(n):
        if not isinstance(n, dict):
            return n
        if n and all(k.isdigit() for k in n):
            return [lists(n[str(i)]) for i in range(len(n))]
        return {k: lists(v) for k, v in n.items()}

    tree = lists(tree)
    state = tree.pop("state")
    return tree, state


@pytest.fixture(scope="module")
def cells_logits():
    """unet2d_cells at f32 through unet.apply, on one seeded input."""
    with np.load(jax_fixtures.fixture_dir() + "/unet2d_cells.npz") as npz:
        params, state = _pytree({k: npz[k] for k in npz.files})
    cfg = jax_unet.UNetConfig(compute_dtype=jnp.float32)  # the fixture's architecture
    x = np.random.default_rng(3).random((1, 32, 32, 1)).astype(np.float32)
    return x, np.asarray(jax_unet.apply(cfg, params, state, jnp.asarray(x))[0])


@pytest.mark.parametrize("fold", [False, True])
def test_unet2d_cells_matches_apply_f32(fold, cells_logits):
    x, want = cells_logits
    _, tcfg, model, _ = torch_fixtures.load("unet2d_cells", compute_dtype="float32", device="cpu")
    assert (tcfg.depth, tcfg.base_features, tcfg.num_classes) == (4, 32, 3)
    if fold:
        model = torch_unet.fold_batchnorm(model)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert np.max(np.abs(got - want)) < 1e-4


@pytest.mark.parametrize("fold", [False, True])
def test_unet2d_cells_bf16_rounds_where_unet_py_does(fold):
    """Every conv of unet2d_cells' bf16 forward against unet.py's ``_conv`` /
    ``_conv_transpose`` run op by op on the same input and weights: bf16
    operands, bf16 conv output, bias added in f32 after the upcast.

    Measured on the CPU: each conv bit-equal on >= 99.97% of its outputs,
    the rest one bf16 step apart (<= 0.0066 of the value before the bias).
    A conv that keeps its f32 output (the rounding point XLA's jitted CPU
    graph takes) is bit-equal on <= 0.2% of outputs, so the bar below
    fails it on every layer.
    """
    _, _, model, _ = torch_fixtures.load("unet2d_cells", device="cpu")
    if fold:
        model = torch_unet.fold_batchnorm(model)
    calls = []
    conv = model._conv

    def record(x, p):
        y = conv(x, p)
        calls.append((x, p, y))
        return y

    model._conv = record
    x = np.random.default_rng(3).random((1, 32, 32, 1)).astype(np.float32)
    with torch.inference_mode():
        model(torch.from_numpy(x))
    assert len(calls) == 18
    jcfg = jax_unet.UNetConfig()  # bf16 compute
    assert jcfg.compute_dtype == jnp.bfloat16
    for i, (xi, p, y) in enumerate(calls):
        if p.transpose:  # torch (c_in, c_out, kh, kw) -> stored (kh, kw, c_in, c_out)
            w, fn = p.w.permute(2, 3, 0, 1), jax_unet._conv_transpose
        else:  # torch (c_out, c_in, kh, kw) -> HWIO
            w, fn = p.w.permute(2, 3, 1, 0), jax_unet._conv
        b = p.b.numpy()
        want = np.asarray(fn(
            jnp.asarray(xi.permute(0, 2, 3, 1).float().numpy()),
            {"w": jnp.asarray(w.numpy()), "b": jnp.asarray(b)},
            jcfg,
        ))
        got = y.permute(0, 2, 3, 1).numpy()
        assert np.mean(got == want) >= 0.999, f"conv {i}"
        step = np.abs(want - b) * 2.0**-7  # one bf16 step of the conv output
        assert np.all(np.abs(got - want) <= step + 1e-30), f"conv {i}"


def test_spatial_multiple_enforced():
    _, _, _, model = _pair()
    with pytest.raises(ValueError, match="not divisible"):
        model(torch.zeros(1, 15, 16, 1))


def test_dims3_names_later_slice():
    """3D is ported (tests/test_torch_unet3d.py); space-to-depth stays
    2D-only, as ``unet.init`` says."""
    model = torch_unet.UNet(torch_unet.UNetConfig(dims=3, depth=2, base_features=4), device="cpu")
    assert model.enc[0].conv1.w.shape == (4, 1, 3, 3, 3)
    with pytest.raises(ValueError, match="2D-only"):
        jax_unet.init(jax.random.PRNGKey(0), jax_unet.UNetConfig(dims=3, space_to_depth=2))
    with pytest.raises(ValueError, match="2D-only"):
        torch_unet.UNet(torch_unet.UNetConfig(dims=3, space_to_depth=2), device="cpu")


@pytest.mark.parametrize("bias,want", [((1.0, 1.0, 0.0), 0), ((0.0, 2.0, 2.0), 1), ((3.0, 3.0, 3.0), 0)])
def test_tied_logits_take_first_max(bias, want):
    """Argmax ties resolve to the first class, as jnp.argmax does: a zero
    network whose head bias ties the logits everywhere."""
    cfg = torch_unet.UNetConfig(depth=2, base_features=4, norm="none", compute_dtype="float32")
    model = torch_unet.UNet(cfg, device="cpu")
    with torch.no_grad():
        model.head.b.copy_(torch.tensor(bias))
    tc = torch_infer.TileConfig(patch=(16, 16), overlap=(0, 0), normalize="none", emit_probs=False)
    _, labels = torch_infer.make_frame_inferrer(cfg, tc, (16, 16), device="cpu")(
        model, torch.zeros(16, 16)
    )
    assert int(jnp.argmax(jnp.asarray(bias))) == want
    assert torch.all(labels == want)
    _, labels_p = torch_infer.make_frame_inferrer(
        cfg, dataclasses.replace(tc, emit_probs=True), (16, 16), device="cpu"
    )(model, torch.zeros(16, 16))
    assert torch.all(labels_p == want)
