"""The port's 3D U-Net against ``sequitr_tpu.models.unet.apply`` on identical
weights (carried across in the flat interchange layout, DHWIO kernels), at
f32 within the 1e-4 bar of tests/test_parity.py; each bf16 conv against
unet.py's op-by-op conv; and the ``unet3d_infer`` golden."""

import dataclasses
import os

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

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "unet3d_infer.npz")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _flat(params, state):
    flat = jax_convert.flatten_params(params)
    flat.update({f"state/{k}": v for k, v in jax_convert.flatten_params(state).items()})
    return flat


def _pair(norm="batch", upsample="transpose", depth=2, in_channels=1):
    cfg = jax_unet.UNetConfig(
        dims=3, depth=depth, base_features=4, norm=norm, upsample=upsample,
        in_channels=in_channels, compute_dtype=jnp.float32,
    )
    params, state = jax_unet.init(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)
    if norm == "batch":
        state = jax.tree.map(lambda a: a + 0.1 * rng.random(a.shape).astype(np.float32), state)
    tcfg = torch_unet.UNetConfig(**{**dataclasses.asdict(cfg), "compute_dtype": "float32"})
    return cfg, params, state, torch_convert.load_flat(tcfg, _flat(params, state), device="cpu")


def _pytree(flat):
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


def test_fixture_round_trip_all_keys():
    """Every key of unet3d_cells.npz (66, DHWIO kernels) crosses and back."""
    with np.load(jax_fixtures.fixture_dir() + "/unet3d_cells.npz") as npz:
        flat = {k: npz[k] for k in npz.files}
    assert len(flat) == 66
    _, cfg, model, _ = torch_fixtures.load("unet3d_cells", device="cpu")
    assert (cfg.dims, cfg.depth, cfg.base_features, cfg.features_cap) == (3, 3, 32, 256)
    assert model.up[0].w.shape == (128, 64, 2, 2, 2)  # (c_in, c_out, kd, kh, kw)
    assert model.enc[0].conv1.w.shape == (32, 1, 3, 3, 3)
    assert model.enc[0].conv1.w.is_contiguous(memory_format=torch.channels_last_3d)
    back = torch_convert.to_flat(model)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v.astype(np.float32), err_msg=k)


@pytest.mark.parametrize(
    "norm,upsample,fold,depth",
    [
        ("batch", "transpose", False, 2),
        ("batch", "transpose", True, 2),
        ("none", "transpose", False, 3),
        ("batch", "resize", False, 2),
        ("batch", "resize", True, 3),
    ],
)
def test_forward_matches_apply_f32(norm, upsample, fold, depth):
    cfg, params, state, model = _pair(norm, upsample, depth)
    if fold:
        model = torch_unet.fold_batchnorm(model)
        assert model.cfg.norm == "none"
    x = np.random.default_rng(2).normal(size=(2, 8, 8, 12, 1)).astype(np.float32)
    want = np.asarray(jax_unet.apply(cfg, params, state, jnp.asarray(x))[0])
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 8, 8, 12, 3)
    assert np.max(np.abs(got - want)) < 1e-4


def test_two_channels_and_spatial_multiple():
    cfg, params, state, model = _pair(in_channels=2)
    x = np.random.default_rng(3).normal(size=(1, 4, 8, 6, 2)).astype(np.float32)
    want = np.asarray(jax_unet.apply(cfg, params, state, jnp.asarray(x))[0])
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert np.max(np.abs(got - want)) < 1e-4
    with pytest.raises(ValueError, match="not divisible"):
        model(torch.zeros(1, 5, 8, 8, 2))


@pytest.fixture(scope="module")
def cells3d():
    """unet3d_cells at f32 through unet.apply, on one seeded input."""
    with np.load(jax_fixtures.fixture_dir() + "/unet3d_cells.npz") as npz:
        params, state = _pytree({k: npz[k] for k in npz.files})
    cfg = jax_unet.UNetConfig(
        dims=3, depth=3, base_features=32, features_cap=256, compute_dtype=jnp.float32
    )
    x = np.random.default_rng(5).random((1, 8, 16, 16, 1)).astype(np.float32)
    return x, np.asarray(jax_unet.apply(cfg, params, state, jnp.asarray(x))[0])


@pytest.mark.parametrize("fold", [False, True])
def test_unet3d_cells_matches_apply_f32(fold, cells3d):
    x, want = cells3d
    _, _, model, _ = torch_fixtures.load("unet3d_cells", compute_dtype="float32", device="cpu")
    if fold:
        model = torch_unet.fold_batchnorm(model)
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert np.max(np.abs(got - want)) < 1e-4


def test_unet3d_cells_bf16_rounds_where_unet_py_does():
    """Every conv of the folded bf16 unet3d_cells against unet.py's
    ``_conv`` / ``_conv_transpose`` run op by op on the same input and
    weights (bf16 operands and output, bias added in f32): bit-equal on >=
    99.9% of outputs, the rest within one bf16 step of the conv output
    plus 1e-5 of the layer's largest output (a 3x3x3 sum that cancels to
    near zero differs in its f32 last bits by more than its own bf16 step:
    measured on the CPU, one output of 2.9e-5 off by 2.4e-7; every other
    difference is at most one step)."""
    _, _, model, _ = torch_fixtures.load("unet3d_cells", device="cpu")
    model = torch_unet.fold_batchnorm(model)
    calls = []
    conv = model._conv

    def record(x, p):
        y = conv(x, p)
        calls.append((x, p, y))
        return y

    model._conv = record
    x = np.random.default_rng(6).random((1, 8, 16, 16, 1)).astype(np.float32)
    with torch.inference_mode():
        model(torch.from_numpy(x))
    assert len(calls) == 13
    jcfg = jax_unet.UNetConfig(dims=3)
    assert jcfg.compute_dtype == jnp.bfloat16
    for i, (xi, p, y) in enumerate(calls):
        # torch (c_out, c_in, kd, kh, kw) / (c_in, c_out, ...) -> DHWIO
        w = p.w.permute(2, 3, 4, 0, 1) if p.transpose else p.w.permute(2, 3, 4, 1, 0)
        fn = jax_unet._conv_transpose if p.transpose else jax_unet._conv
        b = p.b.numpy()
        want = np.asarray(fn(
            jnp.asarray(xi.permute(0, 2, 3, 4, 1).float().numpy()),
            {"w": jnp.asarray(w.numpy()), "b": jnp.asarray(b)},
            jcfg,
        ))
        got = y.permute(0, 2, 3, 4, 1).numpy()
        assert np.mean(got == want) >= 0.999, f"conv {i}"
        step = np.abs(want - b) * 2.0**-7
        f32_sums = 1e-5 * np.abs(want - b).max()
        assert np.all(np.abs(got - want) <= step + f32_sums), f"conv {i}"


def test_unet3d_golden():
    """tests/goldens/unet3d_infer.npz (unet3d_cells at its bf16 compute
    dtype, whole 8x64x64 volume, exact normalize; jitted JAX CPU graph,
    probs stored as float16): at most 0.2% label flips, 99.9% of probs
    within 5e-3, all within 2e-2. The golden carries XLA-CPU numerics,
    which drop the bf16 rounding of each conv's output; the port rounds
    where unet.py says (held per conv by the test above)."""
    g = np.load(GOLDEN)
    _, cfg, model, _ = torch_fixtures.load("unet3d_cells", device="cpu")
    model = torch_unet.fold_batchnorm(model)
    tc = torch_infer.TileConfig(patch=(8, 64, 64), overlap=(0, 0, 0), normalize="exact")
    probs, labels = torch_infer.make_frame_inferrer(cfg, tc, (8, 64, 64), device="cpu")(
        model, g["volume"]
    )
    flips = np.mean(labels.numpy() != g["labels"])
    assert flips <= 0.002, flips
    err = np.abs(probs.numpy() - g["probs"].astype(np.float32))
    assert np.quantile(err, 0.999) <= 5e-3
    assert err.max() <= 2e-2
