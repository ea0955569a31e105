"""The port's polyphase serving forward against ``sequitr_tpu.models.polyphase``
and against the port's own standard forward, on identical weights.

The JAX forward runs op by op (``jax.disable_jit``): the jitted CPU graph
reassociates differently and is not the reference for rounding points. At
f32 polyphase and standard forwards hold the same sums in another order:
relative error < 1e-5, argmax agreement >= 0.999 (the bars of
tests/test_studies.py).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequitr_tpu.models import convert as jax_convert
from sequitr_tpu.models import fixtures as jax_fixtures
from sequitr_tpu.models import polyphase as jax_poly
from sequitr_tpu.models import unet as jax_unet
from sequitr_tpu_torch.config import ServerConfiguration
from sequitr_tpu_torch.data import synthetic, tiff
from sequitr_tpu_torch.models import convert as torch_convert
from sequitr_tpu_torch.models import fixtures as torch_fixtures
from sequitr_tpu_torch.models import polyphase as torch_poly
from sequitr_tpu_torch.models import unet as torch_unet
from sequitr_tpu_torch.pipeline import infer as torch_infer
from sequitr_tpu_torch.server import ImageServer, save_model, submit_job
from sequitr_tpu_torch.studies import polyphase_conv


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pair(seed=0, **kw):
    """A folded f32 U-Net as JAX pytrees and as the port's model."""
    cfg = jax_unet.UNetConfig(
        in_channels=kw.pop("in_channels", 1), num_classes=kw.pop("num_classes", 3),
        depth=kw.pop("depth", 4), base_features=8, norm=kw.pop("norm", "batch"),
        compute_dtype=jnp.float32, **kw,
    )
    params, state = jax_unet.init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed + 1)
    # non-trivial biases: a zero bias would hide a wrong bias tiling
    params = jax.tree.map(
        lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32), params
    )
    flat = jax_convert.flatten_params(params)
    flat.update({f"state/{k}": v for k, v in jax_convert.flatten_params(state).items()})
    tcfg = torch_unet.UNetConfig(**{**dataclasses.asdict(cfg), "compute_dtype": "float32"})
    model = torch_unet.fold_batchnorm(torch_convert.load_flat(tcfg, flat, device="cpu"))
    return jax_unet.fold_batchnorm(cfg, params, state), model


def _jax_cells_folded():
    """unet2d_cells as folded JAX pytrees at f32, from the flat npz."""
    with np.load(jax_fixtures.fixture_dir() + "/unet2d_cells.npz") as npz:
        flat = {k: np.asarray(npz[k], np.float32) for k in npz.files}
    tree = {}
    for key, v in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v

    def lists(n):
        if not isinstance(n, dict):
            return n
        if n and all(k.isdigit() for k in n):
            return [lists(n[str(i)]) for i in range(len(n))]
        return {k: lists(v) for k, v in n.items()}

    params = lists(tree)
    state = params.pop("state")
    cfg = jax_unet.UNetConfig(compute_dtype=jnp.float32)  # the fixture's architecture
    return jax_unet.fold_batchnorm(cfg, params, state)


def _rel_err(a, b):
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-9)


@pytest.mark.parametrize("c_in,c_out", [(2, 3), (1, 8), (8, 8)])
def test_phase_kernel_bit_equal_after_layout_map(c_in, c_out):
    w = np.random.default_rng(c_in * 10 + c_out).normal(size=(3, 3, c_in, c_out)).astype(np.float32)
    want = np.asarray(jax_poly.phase_kernel(jnp.asarray(w)))
    got = torch_poly.phase_kernel(torch_convert.conv_to_torch(w))
    assert got.shape == (4 * c_out, 4 * c_in, 3, 3)
    np.testing.assert_array_equal(torch_convert.conv_from_torch(got), want)


def test_phase_up_kernel_bit_equal_after_layout_map():
    w = np.random.default_rng(4).normal(size=(2, 2, 5, 3)).astype(np.float32)
    want = np.asarray(jax_poly.phase_up_kernel(jnp.asarray(w)))  # (C_in, 4C_out)
    # the stored HWIO kernel in the port's transposed-conv layout (C_in, C_out, 2, 2)
    got = torch_poly.phase_up_kernel(torch.from_numpy(np.transpose(w, (2, 3, 0, 1)).copy()))
    assert got.shape == (12, 5, 1, 1)
    np.testing.assert_array_equal(got[:, :, 0, 0].numpy().T, want)
    with pytest.raises(ValueError):
        torch_poly.phase_up_kernel(torch.zeros(5, 3, 3, 3))
    with pytest.raises(ValueError):
        torch_poly.phase_kernel(torch.zeros(5, 3, 2, 2))


def test_phase_kernel_structure():
    """9 of every 36 (tap, phase-pair) slots nonzero; each original tap
    appears once per output phase."""
    w = torch.from_numpy(np.random.default_rng(0).normal(size=(3, 2, 3, 3)).astype(np.float32))
    pw = torch_poly.phase_kernel(w)
    blocks = pw.reshape(4, 3, 4, 2, 3, 3)
    nonzero = sum(
        1 for sy in range(3) for sx in range(3) for pi in range(4) for po in range(4)
        if torch.any(blocks[po, :, pi, :, sy, sx] != 0)
    )
    assert nonzero == 9 * 4
    assert np.isclose(float(pw.abs().sum()), 4 * float(w.abs().sum()))


def test_matches_jax_polyphase_and_standard_forward():
    (fcfg, fp, fs), model = _pair()
    x = np.random.default_rng(0).gamma(2.0, 100.0, (2, 64, 64, 1)).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jax_poly.apply(fcfg, fp, fs, jnp.asarray(x)))
    with torch.inference_mode():
        got = torch_poly.apply(model, torch.from_numpy(x)).numpy()
        base = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 64, 64, 3)
    assert _rel_err(got, want) < 1e-5
    assert _rel_err(got, base) < 1e-5
    assert np.mean(got.argmax(-1) == base.argmax(-1)) >= 0.999
    assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.999


@pytest.mark.parametrize("dtype,bar", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_unet2d_cells_polyphase_matches_standard(dtype, bar):
    """The committed fixture, folded, at 64x64. At bf16 both forwards round
    every conv output to bf16 but sum in another order, so single values
    land one bf16 step apart (measured 3e-3 of the logit range)."""
    _, _, model, _ = torch_fixtures.load("unet2d_cells", compute_dtype=dtype, device="cpu")
    model = torch_unet.fold_batchnorm(model)
    frame, _ = synthetic.cells_frame(424_200, (64, 64))
    x = torch.from_numpy((frame / frame.max()).astype(np.float32))[None, ..., None]
    with torch.inference_mode():
        base = model(x).numpy()
        got = polyphase_conv.polyphase_apply(model, x).numpy()
    assert _rel_err(got, base) < bar
    assert np.mean(got.argmax(-1) == base.argmax(-1)) >= 0.999
    if dtype == "float32":
        fcfg, fp, fs = _jax_cells_folded()
        with jax.disable_jit():
            want = np.asarray(jax_poly.apply(fcfg, fp, fs, jnp.asarray(x.numpy())))
        assert _rel_err(got, want) < 1e-5
        assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.999


def test_multichannel_multiclass_shallow():
    (fcfg, fp, fs), model = _pair(seed=1, in_channels=3, num_classes=5, depth=3, norm="none")
    x = np.random.default_rng(1).normal(size=(1, 32, 32, 3)).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jax_poly.apply(fcfg, fp, fs, jnp.asarray(x)))
    with torch.inference_mode():
        got = torch_poly.apply(model, torch.from_numpy(x)).numpy()
        base = model(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 32, 32, 5)
    assert _rel_err(got, want) < 1e-5 and _rel_err(got, base) < 1e-5


def test_depth_two_has_no_middle_decoder():
    (_, _, _), model = _pair(seed=2, depth=2, norm="none")
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(1, 16, 24, 1)).astype(np.float32))
    with torch.inference_mode():
        assert _rel_err(torch_poly.apply(model, x).numpy(), model(x).numpy()) < 1e-5


def test_rejects_unsupported_configs():
    """The rejections of tests/test_studies.py: batch norm not folded,
    resize upsampling; and odd sizes, s2d models, the later slices."""
    x = torch.zeros(1, 32, 32, 1)
    cfg = torch_unet.UNetConfig(depth=2, base_features=4, compute_dtype="float32")
    with pytest.raises(ValueError, match="folded"):
        torch_poly.apply(torch_unet.UNet(cfg, device="cpu"), x)
    for bad in (dict(upsample="resize"), dict(space_to_depth=2), dict(depth=1)):
        model = torch_unet.UNet(dataclasses.replace(cfg, norm="none", **bad), device="cpu")
        with pytest.raises(ValueError):
            torch_poly.Polyphase(model)
    ok = torch_unet.UNet(dataclasses.replace(cfg, norm="none"), device="cpu")
    with pytest.raises(ValueError, match="even"):
        torch_poly.apply(ok, torch.zeros(1, 31, 32, 1))
    assert torch_poly.serving(ok) is torch_poly.serving(ok)  # built once
    assert torch_poly.eligible(ok.cfg, (32, 32)) and not torch_poly.eligible(ok.cfg, (32, 31))
    # the training forwards are ported (tests/test_torch_polyphase_train.py):
    # on a model without batch norm, apply_train is the plain forward with no
    # statistics, and apply3d_train takes 3D models only
    with torch.no_grad():
        logits, stats = torch_poly.apply_train(ok, x + 1.0)
        assert stats == [] and torch.allclose(logits, ok(x + 1.0), atol=1e-6)
    with pytest.raises(ValueError, match="covers 3D"):
        torch_poly.apply3d_train(ok, x)
    # apply3d is ported (tests/test_torch_polyphase3d.py) and takes 3D models only
    with pytest.raises(ValueError, match="3D models"):
        torch_poly.apply3d(ok, x)


def test_frame_inferrer_polyphase_branch():
    (_, _, _), model = _pair(seed=3, depth=3)
    cfg = dataclasses.replace(model.cfg, norm="batch")  # the stored config
    frame = np.random.default_rng(3).gamma(2.0, 50.0, (48, 64)).astype(np.float32)
    outs = {}
    for poly in (False, True):
        tc = torch_infer.TileConfig(patch=(32, 32), overlap=(8, 8), polyphase=poly)
        outs[poly] = torch_infer.make_frame_inferrer(cfg, tc, (48, 64), device="cpu")(model, frame)
    assert np.max(np.abs(outs[True][0].numpy() - outs[False][0].numpy())) < 1e-5
    assert torch.mean((outs[True][1] == outs[False][1]).float()) >= 0.999
    tc = torch_infer.TileConfig(patch=(31, 32), overlap=(0, 0), polyphase=True)
    with pytest.raises(ValueError, match="polyphase serving requires"):
        torch_infer.make_frame_inferrer(cfg, tc, (31, 32), device="cpu")
    s2d = dataclasses.replace(cfg, space_to_depth=2)
    tc = torch_infer.TileConfig(patch=(32, 32), overlap=(0, 0), polyphase=True)
    with pytest.raises(ValueError, match="polyphase serving requires"):
        torch_infer.make_frame_inferrer(s2d, tc, (32, 32), device="cpu")
    # 3D models phase (H, W) of a 3-axis patch (tests/test_torch_infer3d.py)
    cfg3 = dataclasses.replace(cfg, dims=3)
    with pytest.raises(ValueError, match="polyphase serving requires"):
        torch_infer._check_polyphase(tc, cfg3)
    torch_infer._check_polyphase(dataclasses.replace(tc, patch=(5, 32, 32)), cfg3)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """unet2d_cells and an s2d model in a model store, and a 3-frame stack."""
    tmp = tmp_path_factory.mktemp("poly")
    models = str(tmp / "models")
    _, cfg, model, _ = torch_fixtures.load("unet2d_cells", compute_dtype="float32", device="cpu")
    save_model(models, "cells", "unet", cfg, model)
    s2d_cfg = torch_unet.UNetConfig(depth=2, base_features=4, space_to_depth=2, compute_dtype="float32")
    save_model(models, "s2d", "unet", s2d_cfg, torch_unet.UNet(s2d_cfg, device="cpu"))
    frames = np.stack(
        [synthetic.cells_frame(424_300 + i, (64, 96))[0] for i in range(3)]
    ).clip(0, 65535).astype(np.uint16)
    stack = str(tmp / "stack.tif")
    tiff.write_stack(stack, frames)
    return dict(tmp=tmp, models=models, stack=stack)


def _serve(served, name, params):
    tmp = served["tmp"]
    out, jobs = str(tmp / f"out_{name}"), str(tmp / f"jobs_{name}")
    submit_job(jobs, {
        "module": "segmentation_unet2d", "params": dict(localize=False, **params),
        "input": [served["stack"]], "output": out,
    })
    cfg = ServerConfiguration(jobs_dir=jobs, models_dir=served["models"], device="cpu")
    assert ImageServer(cfg).poll_once()
    with open(os.path.join(out, "status.json")) as f:
        return json.load(f)


def test_served_polyphase_job_agrees_with_plain_job(served):
    plain = _serve(served, "plain", {"model": "cells"})
    poly = _serve(served, "poly", {"model": "cells", "polyphase": True})
    tiled = _serve(served, "tiled", {
        "model": "cells", "polyphase": True, "save_probs": True,
        "patch": [32, 32], "overlap": [8, 8],
    })
    for st in (plain, poly, tiled):
        assert st["state"] == "complete", st.get("error")
        assert not st.get("warnings"), st.get("warnings")
    a = tiff.read_stack(plain["outputs"]["labels"])
    b = tiff.read_stack(poly["outputs"]["labels"])
    assert a.shape == b.shape == (3, 64, 96) and b.dtype == np.uint16
    assert len(np.unique(a)) == 3
    assert np.mean(a == b) >= 0.999
    assert tiff.read_stack(tiled["outputs"]["probs"]).shape == (9, 64, 96)


@pytest.mark.parametrize(
    "name,params,message",
    [
        ("odd", {"model": "cells", "polyphase": True, "patch": [33, 32]},
         "polyphase needs even H/W patch axes, got (33, 32)"),
        ("s2d", {"model": "s2d", "polyphase": True},
         "polyphase serving requires a space_to_depth=1 transpose-upsample model "
         "of depth >= 2; this model has s2d=2, upsample='transpose', depth=2"),
        ("spatial", {"model": "cells", "polyphase": True, "spatial_parallel": True},
         "polyphase + spatial_parallel is not supported"),
    ],
)
def test_served_polyphase_rejections(served, name, params, message):
    st = _serve(served, name, params)
    assert st["state"] == "failed"
    assert "JobError" in st["error"] and message in st["error"]
