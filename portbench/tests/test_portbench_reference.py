"""The plain reference against the port's float32 path, the counts, and the
imports the benchmark may not make."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import counts, inputs, reference, weights
from portbench.reference import normalize as norm_ref
from portbench.reference import tiling as tiling_ref
from portbench.tests.conftest import ROOT

BENCH = os.path.join(ROOT, "portbench")


def _manifest(name):
    with open(os.path.join(ROOT, "sequitr_tpu", "fixtures", "manifest.json")) as f:
        return json.load(f)[name]["config"]


def _flat(name):
    with np.load(os.path.join(ROOT, "sequitr_tpu", "fixtures", f"{name}.npz")) as z:
        return {k: z[k] for k in z.files}


def _item(shape, seed=5):
    """A stored frame, or a volume of frames (the benchmark makes frames
    only; the reference's 3D path is held to the port's on these)."""
    if len(shape) == 2:
        return inputs.cells_frame(seed, shape).clip(0, 65535).astype(np.uint16)
    return np.stack([_item(shape[1:], seed * 1000 + z) for z in range(shape[0])])


def _port_f32(name, polyphase=False):
    from sequitr_tpu_torch.models import convert, unet

    cfg = unet.UNetConfig(**{**_manifest(name), "compute_dtype": "float32"})
    return cfg, unet.fold_batchnorm(convert.load_flat(cfg, _flat(name), device="cpu"))


CASES = [
    ("unet2d_cells", (64, 64), (64, 64), (0, 0), False),
    ("unet2d_cells", (128, 96), (64, 64), (16, 16), False),
    ("unet2d_cells", (64, 64), (64, 64), (0, 0), True),
    ("unet3d_cells", (16, 64, 64), (8, 32, 32), (2, 8, 8), False),
    ("unet3d_cells", (8, 32, 32), (8, 32, 32), (0, 0, 0), True),
]


@pytest.mark.parametrize("name,shape,patch,overlap,polyphase", CASES)
def test_reference_matches_the_ports_float32_path(name, shape, patch, overlap, polyphase):
    """Normalize (the 1024-bin rule), fold, tiles, Hann stitch, softmax and
    argmax: the reference equals the port's exact path to float32 rounding,
    whole, tiled and through the polyphase forward."""
    from sequitr_tpu_torch.pipeline import infer

    cfg, model = _port_f32(name)
    item = _item(shape)
    tc = infer.TileConfig(patch=patch, overlap=overlap, normalize="pallas", polyphase=polyphase)
    probs, labels = infer.make_frame_inferrer(cfg, tc, shape, "cpu")(model, item)
    wts = reference.load_weights(_flat(name), _manifest(name), "cpu")
    ref = reference.class_scores(wts, item, patch, overlap, "cpu")
    assert float((ref.movedim(0, -1) - probs).abs().max()) < 2e-5
    assert torch.equal(ref.argmax(0), labels.long())


def _benchmark_config(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)


def test_the_published_widths_carry_the_trained_nets_labels():
    """The configuration's 31 M parameters hold the trained fixture in their
    first channels and seeded He-normal draws elsewhere (the same for the
    same seed); the reference on them gives the fixture's probabilities, and
    the port's float32 path on them equals the reference."""
    from sequitr_tpu_torch.models import convert, unet
    from sequitr_tpu_torch.pipeline import infer

    config = _benchmark_config("unet2d_ronneberger")
    model = config["model"]
    flat = weights.make_flat(config, 2**31 + 5, "cpu", ROOT)
    assert sum(v.size for v in flat.values()) == 31_030_723
    again = weights.make_flat(config, 2**31 + 5, "cpu", ROOT)
    assert all(np.array_equal(flat[k], again[k]) for k in flat)
    other = weights.make_flat(config, 6, "cpu", ROOT)
    assert not np.array_equal(flat["enc/4/conv1/w"], other["enc/4/conv1/w"])
    assert np.array_equal(flat["enc/0/conv1/w"][..., :32], other["enc/0/conv1/w"][..., :32])
    assert np.count_nonzero(flat["enc/0/conv2/w"][..., 32:]) == 3 * 3 * 64 * 32
    item = _item((64, 64))
    ref = reference.class_scores(reference.load_weights(flat, model, "cpu"), item, (64, 64),
                                 (0, 0), "cpu")
    fixture = reference.class_scores(
        reference.load_weights(_flat("unet2d_cells"), _manifest("unet2d_cells"), "cpu"), item,
        (64, 64), (0, 0), "cpu")
    assert float((ref - fixture).abs().max()) < 5e-3  # the float16 rounding of the folded weights
    assert float((ref.argmax(0) == fixture.argmax(0)).float().mean()) > 0.999
    cfg = unet.UNetConfig(**{**model, "compute_dtype": "float32"})
    port = unet.fold_batchnorm(convert.load_flat(cfg, flat, device="cpu"))
    tc = infer.TileConfig(patch=(64, 64), overlap=(0, 0), normalize="pallas")
    probs, labels = infer.make_frame_inferrer(cfg, tc, (64, 64), "cpu")(port, item)
    assert float((ref.movedim(0, -1) - probs).abs().max()) < 2e-5
    assert torch.equal(ref.argmax(0), labels.long())


def test_the_fold_is_the_references():
    """``weights.fold`` and the reference's own fold give the same net."""
    flat, model = _flat("unet2d_cells"), _manifest("unet2d_cells")
    folded = weights.fold(flat, model)
    assert not any("/bn" in k or k.startswith("state/") for k in folded)
    item = _item((64, 64))
    a = reference.class_scores(reference.load_weights(flat, model, "cpu"), item, (64, 64),
                               (0, 0), "cpu")
    b = reference.class_scores(reference.load_weights(folded, {**model, "norm": "none"}, "cpu"),
                               item, (64, 64), (0, 0), "cpu")
    assert float((a - b).abs().max()) < 1e-5


@pytest.mark.parametrize("shape", [(64, 64), (1, 37, 53), (8, 32, 32)])
def test_percentiles_are_the_quantile_pass_rule(shape):
    from sequitr_tpu_torch.ops.kernels.histogram import quantile_pass_reference

    item = _item(shape if len(shape) != 3 or shape[0] > 4 else shape[1:], seed=11)
    q = quantile_pass_reference(torch.from_numpy(item.astype(np.float32)).reshape(1, -1),
                                [0.05, 0.995])[3][0].numpy()
    np.testing.assert_array_equal(norm_ref.histogram_percentiles(item), q)


@pytest.mark.parametrize("shape,patch,overlap", [
    ((32, 512, 512), (16, 128, 128), (4, 32, 32)), ((1024, 768), (256, 256), (64, 64)),
])
def test_tiling_is_the_servers(shape, patch, overlap):
    from sequitr_tpu_torch.ops import tiling

    assert tiling_ref.grid(shape, patch, overlap) == list(tiling.tile_grid(shape, patch, overlap))
    np.testing.assert_array_equal(
        tiling_ref.window(patch, overlap), tiling.blend_window(patch, overlap).numpy())
    assert len(tiling_ref.grid((32, 512, 512), (16, 128, 128), (4, 32, 32))) == 75


def test_tiling_of_follows_the_servers_policy():
    assert reference.tiling_of({}, (1024, 1024)) == ((1024, 1024), (0, 0))
    assert reference.tiling_of({}, (32, 512, 512)) == ((16, 128, 128), (4, 32, 32))
    assert reference.tiling_of({"patch": [32, 512, 512], "overlap": [0, 0, 0]}, (32, 512, 512)) \
        == ((32, 512, 512), (0, 0, 0))


def _benchmark_model(name):
    with open(os.path.join(BENCH, "configs", f"{name}.json")) as f:
        return json.load(f)["model"]


@pytest.mark.parametrize("model,per_voxel", [
    (_benchmark_model("unet2d_ronneberger"), 1_467_904),
    (_manifest("unet2d_cells"), 280_320),
    (_manifest("unet3d_cells"), 374_400),
], ids=["unet2d_ronneberger", "fixture_unet2d_cells", "fixture_unet3d_cells"])
def test_flops_per_voxel(model, per_voxel):
    assert counts.unet_flops_per_voxel(model) == per_voxel


@pytest.mark.parametrize("name", ["unet2d_ronneberger", "unet2d_cells"])
def test_flops_count_every_mac_of_the_reference(name):
    """The count equals the multiply-adds the plain forward runs, hooked
    conv by conv on a small 2D input."""
    import torch.nn.functional as F

    from portbench.reference import unet as unet_ref

    if name == "unet2d_cells":
        model, flat = _manifest(name), _flat(name)
    else:
        model = _benchmark_model(name)
        flat = weights.make_flat(_benchmark_config(name), 3, "cpu", ROOT)
    wts = unet_ref.load_weights(flat, model, "cpu")
    macs = []
    real = {"c": F.conv2d, "t": F.conv_transpose2d}

    def conv(x, w, **kw):
        y = real["c"](x, w, **kw)
        macs.append(y[0, 0].numel() * w[0].numel() * w.shape[0])
        return y

    def tconv(x, w, **kw):
        macs.append(x[0, 0].numel() * w.numel())
        return real["t"](x, w, **kw)

    F.conv2d, F.conv_transpose2d = conv, tconv
    try:
        unet_ref.forward(wts, torch.zeros(1, 1, 64, 64))
    finally:
        F.conv2d, F.conv_transpose2d = real["c"], real["t"]
    assert 2 * sum(macs) == counts.unet_flops_per_voxel(model) * 64 * 64


def test_quantile_pass_bytes():
    assert counts.quantile_pass_bytes_per_voxel("uint16") == 2
    # a 1024x1024 uint16 frame's bound: 0.626 us at 3.35 TB/s
    assert abs(1024 * 1024 * 2 / counts.PEAK_HBM_BYTES_PER_S - 0.626e-6) < 1e-9


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _sources(sub=""):
    for d, dirs, files in os.walk(os.path.join(BENCH, sub)):
        dirs[:] = [x for x in dirs if x not in ("tests", "__pycache__")]
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    bad = {"jax", "jaxlib", "flax", "sequitr_tpu"}
    found = [(p, m) for p in _sources() for m in _imports(p) if m.split(".")[0] in bad]
    assert found == []


def test_the_reference_imports_nothing_of_the_program():
    found = [(p, m) for p in _sources("reference") for m in _imports(p)
             if m.split(".")[0] in {"sequitr_tpu_torch", "sequitr_tpu", "jax"}]
    assert found == []
    code = ("import sys; import portbench.reference, portbench.check, portbench.kinds.unet; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'sequitr_tpu_torch', 'sequitr_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True).stdout
    assert out.strip() == "[]"


def test_the_forbidden_check_compares_whole_top_level_names(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "sequitr_tpu_torch_lookalike", sys)
    assert "sequitr_tpu" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_loaded() == ["jax"]
