"""The evaluation and parity jobs through the JAX ``ImageServer`` and the
port's ``ImageServer(device="cpu")`` on the same models and inputs.

The metrics JSON must agree (integers equal, floats within 1e-6 unless a
test states otherwise, ``per_frame`` series equal with their ``null``s),
saved labels equal on pixels whose top two JAX logits are clear of a tie,
and every JobError of the JAX jobs must carry the same message (job ids
aside). Models are small f32 networks carried across the way a user moves
one (``import-model`` of the exported arrays); the instance jobs use the
committed ``flows_cells`` / ``stars_cells`` fixtures at f32.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequitr_tpu.config import ServerConfiguration as JaxConfig
from sequitr_tpu.models import convert as jax_convert
from sequitr_tpu.models import fixtures as jax_fixtures
from sequitr_tpu.models import gan as jax_gan
from sequitr_tpu.models import unet as jax_unet
from sequitr_tpu.server import ImageServer as JaxServer
from sequitr_tpu.server import save_model as jax_save_model
from sequitr_tpu.server import submit_job as jax_submit
from sequitr_tpu_torch import __main__ as torch_main
from sequitr_tpu_torch.config import ServerConfiguration as TorchConfig
from sequitr_tpu_torch.data import synthetic
from sequitr_tpu_torch.data import tiff as torch_tiff
from sequitr_tpu_torch.models import convert as torch_convert
from sequitr_tpu_torch.server import ImageServer as TorchServer
from sequitr_tpu_torch.server import submit_job as torch_submit

FLOAT_TOL = 1e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _perturbed(init, cfg, seed):
    """``init``'s params with non-trivial biases and statistics (no ties)."""
    params, state = init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed + 1)
    params = jax.tree.map(lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32), params)
    state = jax.tree.map(lambda a: a + 0.1 * rng.random(a.shape).astype(np.float32), state)
    return params, state


def _register(tmp, jax_models, torch_models, name, kind, cfg, params, state):
    jax_save_model(jax_models, name, kind, cfg, params, state)
    npz = str(tmp / f"{name}.npz")
    np.savez(npz, **jax_convert.flatten_params(params),
             **{f"state/{k}": v for k, v in jax_convert.flatten_params(state).items()})
    assert torch_main.main([
        "import-model", "--models-dir", torch_models, "--npz", npz,
        "--arch", os.path.join(jax_models, name, "config.json"), name,
    ]) == 0


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Small f32 models of every evaluated kind in both stores, their
    inputs and truths as TIFF files."""
    tmp = tmp_path_factory.mktemp("evaluate")
    jax_models, torch_models = str(tmp / "jax_models"), str(tmp / "torch_models")
    f32 = jnp.float32
    models = {
        "seg": ("unet", jax_unet.UNetConfig(depth=2, base_features=8, compute_dtype=f32), jax_unet.init),
        "seg3d": ("unet", jax_unet.UNetConfig(dims=3, depth=2, base_features=8, compute_dtype=f32), jax_unet.init),
        "gan": ("gan", jax_gan.GANConfig(gen_depth=3, gen_base_features=4, disc_layers=2,
                                         disc_base_features=4, compute_dtype=f32), jax_gan.init),
        "n2v": ("n2v", jax_unet.UNetConfig(depth=2, base_features=4, num_classes=1, compute_dtype=f32), jax_unet.init),
        "n2v3d": ("n2v", jax_unet.UNetConfig(dims=3, depth=2, base_features=4, num_classes=1,
                                             compute_dtype=f32), jax_unet.init),
        "flows3d": ("flows", jax_unet.UNetConfig(dims=3, depth=2, base_features=8, num_classes=4,
                                                 compute_dtype=f32), jax_unet.init),
    }
    saved = {}
    for i, (name, (kind, cfg, init)) in enumerate(models.items()):
        params, state = _perturbed(init, cfg, 20 + i)
        _register(tmp, jax_models, torch_models, name, kind, cfg, params, state)
        saved[name] = (kind, cfg, params, state)
    for name in ("flows_cells", "stars_cells"):
        kind, cfg, params, state, _ = jax_fixtures.load(name)
        cfg = jax_unet.UNetConfig(**{**cfg.__dict__, "compute_dtype": f32})
        _register(tmp, jax_models, torch_models, name, kind, cfg, params, state)
    # a copy of "seg" with one kernel scaled by 1e4: the same weights on
    # both sides, but logits large enough that f32 round-off breaks 1e-3
    kind, cfg, params, state = saved["seg"]
    bad = jax.tree.map(lambda a: a, params)
    bad["enc"][0]["conv1"]["w"] = bad["enc"][0]["conv1"]["w"] * 1e4
    _register(tmp, jax_models, torch_models, "seg_corrupt", kind, cfg, bad, state)

    def write(name, arr):
        path = str(tmp / name)
        torch_tiff.write_stack(path, arr)
        return path

    scenes = [synthetic.cells_frame(424_500 + i, (64, 64)) for i in range(3)]
    frames = np.stack([img for img, _ in scenes]).clip(0, 65535).astype(np.uint16)
    truth = np.stack([lab for _, lab in scenes]).astype(np.uint16)
    # sparse truth: 255 marks unannotated pixels; frame 1 wholly unannotated
    sparse = truth.copy()
    sparse[:, ::2] = 255
    sparse[1] = 255
    vol, vlab = synthetic.cells_volume(31_900, (8, 32, 32))
    vsparse = vlab.astype(np.uint16).copy()
    vsparse[::2] = 255
    gan_frames = np.stack([synthetic.cells_frame(434_500 + i, (32, 32))[0] for i in range(3)])
    pairs = [synthetic.denoise_pair(515_500 + i, (32, 32)) for i in range(3)]
    inst = [synthetic.instances_frame(717_500 + i, (64, 64)) for i in range(2)]
    inst_vols = np.stack([synthetic.cells_volume(717_600 + t, (8, 32, 32))[0] for t in range(2)])
    inst_vlabs = np.stack([synthetic.cells_volume(717_600 + t, (8, 32, 32))[1] for t in range(2)])
    noisy_vols = np.stack([synthetic.cells_volume(515_700 + t, (8, 16, 16))[0] for t in range(2)]).astype(np.float32)
    rng = np.random.default_rng(5)
    clean_vols = noisy_vols + rng.normal(scale=20.0, size=noisy_vols.shape).astype(np.float32)
    return dict(
        tmp=tmp, jax_models=jax_models, torch_models=torch_models, saved=saved,
        frames=write("frames.tif", frames), truth=write("truth.tif", truth),
        sparse=write("sparse.tif", sparse),
        frames2=write("frames2.tif", frames[:, :, :48]),
        vol=write("vol.tif", vol.clip(0, 65535).astype(np.uint16)),
        vlab=write("vlab.tif", vlab.astype(np.uint16)), vsparse=write("vsparse.tif", vsparse),
        gan_raw=write("gan_raw.tif", gan_frames.clip(0, 65535).astype(np.uint16)),
        gan_target=write("gan_target.tif", gan_frames[:, ::-1].astype(np.float32)),
        noisy=write("noisy.tif", np.stack([n for _, n in pairs]).astype(np.float32)),
        clean=write("clean.tif", np.stack([c for c, _ in pairs]).astype(np.float32)),
        clean_short=write("clean_short.tif", np.stack([c for c, _ in pairs[:2]]).astype(np.float32)),
        noisy_vols=write("noisy_vols.tif", noisy_vols.reshape(16, 16, 16)),
        clean_vols=write("clean_vols.tif", clean_vols.reshape(16, 16, 16)),
        inst=write("inst.tif", np.stack([im for im, _ in inst]).clip(0, 65535).astype(np.uint16)),
        inst_truth=write("inst_truth.tif", np.stack([lab for _, lab in inst]).astype(np.uint16)),
        inst_vols=write("inst_vols.tif", inst_vols.clip(0, 65535).astype(np.uint16).reshape(16, 32, 32)),
        inst_vlabs=write("inst_vlabs.tif", inst_vlabs.astype(np.uint16).reshape(16, 32, 32)),
    )


def _serve(env, which, name, module, params, inputs):
    tmp = env["tmp"]
    out = str(tmp / f"{which}_{name}")
    jobs = str(tmp / f"{which}_jobs")
    spec = {"module": module, "params": params, "input": [env[k] for k in inputs], "output": out}
    if which == "jax":
        cfg = JaxConfig(jobs_dir=jobs, models_dir=env["jax_models"], compilation_cache_dir=None)
        jax_submit(jobs, spec)
        assert JaxServer(cfg).poll_once()
    else:
        cfg = TorchConfig(jobs_dir=jobs, models_dir=env["torch_models"], device="cpu")
        torch_submit(jobs, spec)
        assert TorchServer(cfg).poll_once()
    with open(os.path.join(out, "status.json")) as f:
        return json.load(f)


def _both(env, name, module, params, inputs):
    return tuple(_serve(env, w, name, module, params, inputs) for w in ("jax", "torch"))


def _same_metrics(mj, mt, tol=FLOAT_TOL, path="metrics"):
    """Integers (and strings) equal, floats within ``tol``, lists item by
    item with their ``None``s, dicts key by key."""
    if isinstance(mj, dict):
        assert set(mt) == set(mj), (path, sorted(mt), sorted(mj))
        for k in mj:
            _same_metrics(mj[k], mt[k], tol, f"{path}.{k}")
    elif isinstance(mj, list):
        assert len(mt) == len(mj), path
        for i, (a, b) in enumerate(zip(mj, mt)):
            _same_metrics(a, b, tol, f"{path}[{i}]")
    elif isinstance(mj, float) or isinstance(mt, float):
        assert mt is not None and abs(mt - mj) <= tol, (path, mt, mj)
    else:
        assert mt == mj, (path, mt, mj)


def _complete(sj, st):
    assert sj["state"] == "complete", sj.get("error")
    assert st["state"] == "complete", st.get("error")
    assert set(st["outputs"]) == set(sj["outputs"])
    return json.loads(sj["outputs"]["metrics"]), json.loads(st["outputs"]["metrics"])


def _job_error(status):
    assert status["state"] == "failed", status
    last = status["error"].strip().splitlines()[-1]
    assert "JobError: " in last, last
    return re.sub(r"job [0-9a-f-]+:", "job ID:", last.split("JobError: ", 1)[1])


def _clear_labels(env, frames, name="seg"):
    """Pixels whose top two JAX logits lie more than 1e-4 apart (labels
    there cannot flip between implementations)."""
    from sequitr_tpu.pipeline import infer as jax_infer

    _, cfg, params, state = env["saved"][name]
    spatial = frames.shape[1:] if cfg.dims == 2 else frames.shape
    tc = jax_infer.TileConfig(patch=spatial, overlap=(0,) * len(spatial))
    if cfg.dims == 2:
        x = jnp.stack([jax_infer._normalize(jnp.asarray(f)[..., None], tc) for f in frames])
    else:
        x = jax_infer._normalize(jnp.asarray(frames)[..., None], tc)[None]
    logits = np.asarray(jax_unet.apply(cfg, params, state, x)[0])
    top2 = np.sort(logits, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 1e-4
    return clear if cfg.dims == 2 else clear[0]


EVAL2D = {
    "default": ({}, "truth"),
    "per_frame_labels": ({"per_frame": True, "save_labels": True}, "truth"),
    "ignore_range": ({"ignore_label": 255, "per_frame": True, "frame_range": [1, 3]}, "sparse"),
    "ignore_all": ({"ignore_label": 255, "per_frame": True, "save_labels": True}, "sparse"),
}


@pytest.mark.parametrize("case", sorted(EVAL2D))
def test_evaluate_unet2d(env, case):
    params, truth = EVAL2D[case]
    sj, st = _both(env, f"eval2d_{case}", "evaluate_unet2d", dict(model="seg", **params), ["frames", truth])
    mj, mt = _complete(sj, st)
    _same_metrics(mj, mt)
    if "per_frame_miou" in mj and case == "ignore_all":
        assert mt["per_frame_miou"][1] is None  # the wholly ignored frame
    if "labels" in sj["outputs"]:
        lj = torch_tiff.read_stack(sj["outputs"]["labels"])
        lt = torch_tiff.read_stack(st["outputs"]["labels"])
        assert lt.dtype == np.uint16 and lt.shape == lj.shape == (3, 64, 64)
        frames = torch_tiff.read_stack(env["frames"])
        clear = _clear_labels(env, frames)
        np.testing.assert_array_equal(lt[clear], lj[clear])


@pytest.mark.parametrize("case", ["default", "ignore"])
def test_evaluate_unet3d(env, case):
    params = {"save_labels": True} if case == "default" else {"ignore_label": 255}
    truth = "vlab" if case == "default" else "vsparse"
    sj, st = _both(env, f"eval3d_{case}", "evaluate_unet3d", dict(model="seg3d", **params), ["vol", truth])
    mj, mt = _complete(sj, st)
    _same_metrics(mj, mt)
    assert "voxel_accuracy" in mt
    if case == "default":
        lj = torch_tiff.read_stack(sj["outputs"]["labels"])
        lt = torch_tiff.read_stack(st["outputs"]["labels"])
        clear = _clear_labels(env, torch_tiff.read_stack(env["vol"]), "seg3d")
        assert lt.shape == (8, 32, 32)
        np.testing.assert_array_equal(lt[clear], lj[clear])


PARITY = {
    "unet2d": {"model": "seg"},
    "unet3d": {"model": "seg3d", "spatial": [8, 16, 16], "n_probes": 2},
    "gan": {"model": "gan", "spatial": [32, 32], "n_probes": 2, "seed": 3},
    "n2v": {"model": "n2v", "spatial": [32, 32]},
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_parity_check_torch_reference(env, case):
    """Both servers pass on the same weights; the port's deltas are as
    small as the JAX package's (f32 against a CPU re-derivation)."""
    sj, st = _both(env, f"parity_{case}", "parity_check", PARITY[case], ["frames"])
    mj, mt = _complete(sj, st)
    assert set(mt) == set(mj)
    for k in ("reference", "n_probes", "spatial"):
        assert mt[k] == mj[k]
    if "label_agreement" in mj:
        assert mt["label_agreement"] == mj["label_agreement"] == 1.0
    for k in mt:
        if k.startswith("max_abs") or k.startswith("mean_abs"):
            assert mt[k] < 1e-4, (k, mt[k])


def test_parity_check_keras_reference(env):
    pytest.importorskip("tensorflow")
    sj, st = _both(env, "parity_keras", "parity_check",
                   {"model": "seg", "reference": "keras", "n_probes": 1}, ["frames"])
    mj, mt = _complete(sj, st)
    assert mt["reference"] == mj["reference"] == "keras"
    assert mt["max_abs_dlogits"] < 1e-4 and mt["label_agreement"] == 1.0


def test_parity_check_fails_on_corrupted_weights(env):
    sj, st = _both(env, "parity_corrupt", "parity_check", {"model": "seg_corrupt"}, ["frames"])
    pattern = r"parity FAILED: max \|dlogits\| \S+ > tolerance 1\.0e-03 vs the torch reference \(metrics: "
    assert re.match(pattern, _job_error(sj)) and re.match(pattern, _job_error(st))


def test_evaluate_gan(env):
    sj, st = _both(env, "eval_gan", "evaluate_gan", {"model": "gan"}, ["gan_raw", "gan_target"])
    mj, mt = _complete(sj, st)
    # PSNR is rounded to 1e-4 dB: two f32 implementations land on either
    # side of a rounding boundary at most one step apart
    _same_metrics(mj, mt, tol=1.5e-4)
    assert mt["n_frames"] == 3 and len(mt["per_frame_psnr"]) == 3


@pytest.mark.parametrize("normalize", ["none", "auto"])
def test_evaluate_denoise(env, normalize):
    sj, st = _both(env, f"eval_n2v_{normalize}", "evaluate_denoise",
                   {"model": "n2v", "normalize": normalize}, ["noisy", "clean"])
    mj, mt = _complete(sj, st)
    _same_metrics(mj, mt, tol=1.5e-4)
    assert "psnr_noisy_input" in mt


def test_evaluate_denoise_volumes(env):
    sj, st = _both(env, "eval_n2v3d", "evaluate_denoise", {"model": "n2v3d", "z": 8},
                   ["noisy_vols", "clean_vols"])
    mj, mt = _complete(sj, st)
    _same_metrics(mj, mt, tol=1.5e-4)
    assert mt["n_volumes"] == 2 and len(mt["per_volume_psnr"]) == 2


INSTANCES = {
    "flows": ("evaluate_flows", {"model": "flows_cells", "per_frame": True, "save_labels": True}),
    "flows_thresholds": ("evaluate_flows", {"model": "flows_cells", "thresholds": [0.3, 0.5]}),
    "stars": ("evaluate_stars", {"model": "stars_cells", "per_frame": True, "save_labels": True}),
}


@pytest.mark.parametrize("case", sorted(INSTANCES))
def test_evaluate_instances(env, case):
    module, params = INSTANCES[case]
    sj, st = _both(env, f"eval_{case}", module, params, ["inst", "inst_truth"])
    mj, mt = _complete(sj, st)
    _same_metrics(mj, mt)
    assert mt["n_gt"] > 0
    if "labels" in sj["outputs"]:
        np.testing.assert_array_equal(
            torch_tiff.read_stack(st["outputs"]["labels"]), torch_tiff.read_stack(sj["outputs"]["labels"])
        )


def test_evaluate_flows_volumes(env):
    sj, st = _both(env, "eval_flows3d", "evaluate_flows",
                   {"model": "flows3d", "z": 8, "per_frame": True, "min_area": 4},
                   ["inst_vols", "inst_vlabs"])
    mj, mt = _complete(sj, st)
    _same_metrics(mj, mt)
    assert mt["n_volumes"] == 2 and len(mt["per_volume_ap50"]) == 2


ERRORS = {
    "too_few_inputs": ("evaluate_unet2d", {"model": "seg"}, ["frames"]),
    "shape_mismatch": ("evaluate_unet2d", {"model": "seg"}, ["frames2", "truth"]),
    "wrong_dims": ("evaluate_unet2d", {"model": "seg3d"}, ["frames", "truth"]),
    "channel_mismatch": ("evaluate_unet2d", {"model": "seg"}, ["frames", "frames", "truth"]),
    "ignore_collision": ("evaluate_unet2d", {"model": "seg", "ignore_label": 1}, ["frames", "truth"]),
    "ignore_malformed": ("evaluate_unet3d", {"model": "seg3d", "ignore_label": "x"}, ["vol", "vlab"]),
    "eval3d_wrong_dims": ("evaluate_unet3d", {"model": "seg"}, ["vol", "vlab"]),
    "eval3d_shape": ("evaluate_unet3d", {"model": "seg3d"}, ["vol", "inst_vlabs"]),
    "eval3d_too_few": ("evaluate_unet3d", {"model": "seg3d"}, ["vol"]),
    "gan_paths": ("evaluate_gan", {"model": "gan"}, ["gan_raw"]),
    "gan_shape": ("evaluate_gan", {"model": "gan"}, ["gan_raw", "clean_short"]),
    "denoise_paths": ("evaluate_denoise", {"model": "n2v"}, ["noisy"]),
    "denoise_shape": ("evaluate_denoise", {"model": "n2v"}, ["noisy", "clean_short"]),
    "denoise3d_paths": ("evaluate_denoise", {"model": "n2v3d", "z": 8}, ["noisy_vols"]),
    "flows_too_few": ("evaluate_flows", {"model": "flows_cells"}, ["inst"]),
    "flows3d_entries": ("evaluate_flows", {"model": "flows3d", "z": 8}, ["inst_vols", "inst_vols", "inst_vlabs"]),
    "stars_shape": ("evaluate_stars", {"model": "stars_cells"}, ["inst", "frames2"]),
    "parity_axes": ("parity_check", {"model": "seg", "spatial": [8, 16, 16]}, ["frames"]),
    "parity_multiple": ("parity_check", {"model": "seg", "spatial": [31, 32]}, ["frames"]),
    "parity_probes": ("parity_check", {"model": "seg", "n_probes": 0}, ["frames"]),
    "parity_reference": ("parity_check", {"model": "seg", "reference": "onnx"}, ["frames"]),
    "parity_gan_axes": ("parity_check", {"model": "gan", "spatial": [8, 16, 16]}, ["frames"]),
    "parity_gan_reference": ("parity_check", {"model": "gan", "reference": "onnx"}, ["frames"]),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_job_errors_match_the_jax_server(env, case):
    module, params, inputs = ERRORS[case]
    sj, st = _both(env, f"err_{case}", module, params, inputs)
    assert _job_error(st) == _job_error(sj)


def test_nest_flat_is_the_jax_pytree(env):
    """The flat layout nested back is the JAX package's (params, state)."""
    _, cfg, params, state = env["saved"]["gan"]
    flat = dict(jax_convert.flatten_params(params),
                **{f"state/{k}": v for k, v in jax_convert.flatten_params(state).items()})
    p2, s2 = torch_convert.nest_flat(flat)
    assert jax.tree.structure(p2) == jax.tree.structure(jax.tree.map(np.asarray, params))
    assert jax.tree.structure(s2) == jax.tree.structure(jax.tree.map(np.asarray, state))
    for a, b in zip(jax.tree.leaves(p2), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
