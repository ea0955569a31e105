"""The same job JSON through the JAX ``ImageServer`` and the port's
``ImageServer(device="cpu")``: labels.tif, probs.tif and objects.h5 agree.

The model is carried across the way a user moves one: the arrays behind
``python -m sequitr_tpu export-model`` (``convert.flatten_params`` plus the
``state/`` statistics, saved as npz) go through the port's
``import-model`` command, in-process.
"""

import json
import os
import re

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequitr_tpu.config import ServerConfiguration as JaxConfig
from sequitr_tpu.data import tiff as jax_tiff
from sequitr_tpu.models import convert as jax_convert
from sequitr_tpu.models import unet as jax_unet
from sequitr_tpu.pipeline import infer as jax_infer
from sequitr_tpu.server import ImageServer as JaxServer
from sequitr_tpu.server import save_model as jax_save_model
from sequitr_tpu.server import submit_job as jax_submit
from sequitr_tpu_torch import __main__ as torch_main
from sequitr_tpu_torch.config import ServerConfiguration as TorchConfig
from sequitr_tpu_torch.data import synthetic
from sequitr_tpu_torch.data import tiff as torch_tiff
from sequitr_tpu_torch.server import ImageServer as TorchServer
from sequitr_tpu_torch.server import submit_job as torch_submit
from sequitr_tpu_torch.server.server import load_model


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """A small f32 U-Net registered with both servers, and a 3-frame
    64x64 uint16 stack (served through the frame-batch path)."""
    tmp = tmp_path_factory.mktemp("serve")
    cfg = jax_unet.UNetConfig(depth=2, base_features=8, compute_dtype=jnp.float32)
    params, state = jax_unet.init(jax.random.PRNGKey(0), cfg)
    # non-trivial biases and running statistics: no exact logit ties
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32), params)
    state = jax.tree.map(lambda a: a + 0.1 * rng.random(a.shape).astype(np.float32), state)
    jax_models, torch_models = str(tmp / "jax_models"), str(tmp / "torch_models")
    jax_save_model(jax_models, "seg", "unet", cfg, params, state)
    npz = str(tmp / "seg.npz")
    flat = jax_convert.flatten_params(params)
    np.savez(npz, **flat, **{f"state/{k}": v for k, v in jax_convert.flatten_params(state).items()})
    assert torch_main.main([
        "import-model", "--models-dir", torch_models, "--npz", npz,
        "--arch", os.path.join(jax_models, "seg", "config.json"), "seg",
    ]) == 0
    frames = np.stack(
        [synthetic.cells_frame(424_100 + i, (64, 64))[0] for i in range(3)]
    ).clip(0, 65535).astype(np.uint16)
    stack = str(tmp / "stack.tif")
    torch_tiff.write_stack(stack, frames)
    return dict(
        tmp=tmp, cfg=cfg, params=params, state=state, frames=frames, stack=stack,
        jax_models=jax_models, torch_models=torch_models,
    )


def _serve(env, which, name, params):
    tmp = env["tmp"]
    out = str(tmp / f"{which}_{name}")
    jobs = str(tmp / f"{which}_jobs")
    spec = {
        "module": "segmentation_unet2d", "params": dict(model="seg", **params),
        "input": [env["stack"]], "output": out,
    }
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


def _clear_pixels(env, frames):
    """Pixels whose top two JAX logits lie more than 1e-4 apart."""
    tc = jax_infer.TileConfig(patch=frames.shape[1:], overlap=(0, 0))
    x = jnp.stack([jax_infer._normalize(jnp.asarray(f)[..., None], tc) for f in frames])
    logits = np.asarray(jax_unet.apply(env["cfg"], env["params"], env["state"], x)[0])
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) > 1e-4


def _h5_arrays(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(
            lambda name, obj: out.__setitem__(name, obj[()]) if isinstance(obj, h5py.Dataset) else None
        )
    return out


JOBS = {
    "labels": {},
    "save_probs": {"save_probs": True, "save_entropy": True, "save_objects_csv": True},
    # frames 1-2, cropped to 56x48: the frame-range and ROI helpers
    "subset": {"frame_range": [1, 3], "roi": [4, 8, 60, 56]},
}


@pytest.mark.parametrize("job", sorted(JOBS))
def test_same_job_same_outputs(env, job):
    params = JOBS[job]
    sj = _serve(env, "jax", job, params)
    st = _serve(env, "torch", job, params)
    assert sj["state"] == "complete", sj.get("error")
    assert st["state"] == "complete", st.get("error")
    assert set(st["outputs"]) == set(sj["outputs"])
    frames = env["frames"]
    if job == "subset":
        frames = frames[1:3, 4:60, 8:56]
    assert json.loads(st["outputs"]["metrics"])["n_frames"] == len(frames)
    lj = jax_tiff.read_stack(sj["outputs"]["labels"])
    lt = torch_tiff.read_stack(st["outputs"]["labels"])
    assert lt.dtype == np.uint16 and lt.shape == lj.shape == frames.shape
    clear = _clear_pixels(env, frames)
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(lt[clear], lj[clear])
    # these frames have no near-tie pixel whose label flips, so the object
    # tables are held to the JAX server's on every job
    np.testing.assert_array_equal(lt, lj)
    hj, ht = _h5_arrays(sj["outputs"]["objects"]), _h5_arrays(st["outputs"]["objects"])
    assert set(ht) == set(hj) and hj
    for k in hj:
        np.testing.assert_allclose(ht[k], hj[k], atol=1e-9, err_msg=k)
    if job == "save_probs":
        pj = jax_tiff.read_stack(sj["outputs"]["probs"])
        pt = torch_tiff.read_stack(st["outputs"]["probs"])
        assert pt.shape == pj.shape == (9, 64, 64)
        np.testing.assert_allclose(pt, pj, atol=1e-4)
        ej = jax_tiff.read_stack(sj["outputs"]["entropy"])
        et = torch_tiff.read_stack(st["outputs"]["entropy"])
        np.testing.assert_allclose(et, ej, atol=1e-4)
        assert os.path.exists(st["outputs"]["objects_csv"])


def test_imported_model_is_folded_and_matches(env):
    kind, cfg, model = load_model(env["torch_models"], "seg", device="cpu")
    assert kind == "unet" and cfg.norm == "batch" and model.cfg.norm == "none"
    x = np.random.default_rng(3).random((1, 16, 16, 1)).astype(np.float32)
    want = np.asarray(jax_unet.apply(env["cfg"], env["params"], env["state"], jnp.asarray(x))[0])
    with torch.inference_mode():
        got = model(torch.from_numpy(x)).numpy()
    assert np.max(np.abs(got - want)) < 1e-4


def test_polyphase_is_a_job_error(env):
    """An odd patch axis under ``polyphase`` is the JAX server's JobError,
    word for word; an even one serves (tests/test_torch_polyphase.py)."""
    params = {"polyphase": True, "patch": [63, 64], "localize": False}
    st = _serve(env, "torch", "polyphase", params)
    sj = _serve(env, "jax", "polyphase", params)
    assert st["state"] == sj["state"] == "failed"
    message = "polyphase needs even H/W patch axes, got (63, 64)"
    assert "JobError" in st["error"] and message in st["error"]
    assert message in sj["error"]


def test_malformed_job_is_quarantined(env, tmp_path):
    jobs = str(tmp_path / "jobs")
    os.makedirs(jobs)
    path = os.path.join(jobs, "job_bad.json")
    with open(path, "w") as f:
        f.write("{not json")
    server = TorchServer(TorchConfig(jobs_dir=jobs, models_dir=env["torch_models"], device="cpu"))
    assert server.poll_once() is False
    assert os.path.exists(path + ".rejected") and not os.path.exists(path)


# ---------------------------------------------------------------------------
# 3D segmentation, GAN enhancement and Noise2Void denoising jobs
# ---------------------------------------------------------------------------


def _perturbed(init, cfg, seed):
    """``init``'s params with non-trivial biases and statistics (no ties)."""
    params, state = init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed + 1)
    params = jax.tree.map(lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32), params)
    state = jax.tree.map(lambda a: a + 0.1 * rng.random(a.shape).astype(np.float32), state)
    return params, state


@pytest.fixture(scope="module")
def env_more(tmp_path_factory):
    """Small f32 models of kinds unet (3D), gan and n2v (2D and 3D) in both
    model stores (the port's through ``import-model``, its kind read from
    the JAX model's config.json); a 2-timepoint uint16 volume sequence, as
    a directory and as one T*Z-page file; a 3-frame 32x32 stack."""
    from sequitr_tpu.models import gan as jax_gan

    tmp = tmp_path_factory.mktemp("serve_more")
    jax_models, torch_models = str(tmp / "jax_models"), str(tmp / "torch_models")
    models = {
        "seg3d": ("unet", jax_unet.UNetConfig(dims=3, depth=2, base_features=8, compute_dtype=jnp.float32), jax_unet.init),
        "gan": ("gan", jax_gan.GANConfig(gen_depth=3, gen_base_features=4, disc_layers=2, disc_base_features=4, compute_dtype=jnp.float32), jax_gan.init),
        "n2v": ("n2v", jax_unet.UNetConfig(depth=2, base_features=4, num_classes=1, compute_dtype=jnp.float32), jax_unet.init),
        "n2v3d": ("n2v", jax_unet.UNetConfig(dims=3, depth=2, base_features=4, num_classes=1, compute_dtype=jnp.float32), jax_unet.init),
    }
    for i, (name, (kind, cfg, init)) in enumerate(models.items()):
        params, state = _perturbed(init, cfg, 10 + i)
        jax_save_model(jax_models, name, kind, cfg, params, state)
        npz = str(tmp / f"{name}.npz")
        np.savez(npz, **jax_convert.flatten_params(params),
                 **{f"state/{k}": v for k, v in jax_convert.flatten_params(state).items()})
        assert torch_main.main([
            "import-model", "--models-dir", torch_models, "--npz", npz,
            "--arch", os.path.join(jax_models, name, "config.json"), name,
        ]) == 0
    vols = np.stack([
        synthetic.cells_volume(31_500 + t, (8, 16, 16))[0] for t in range(2)
    ]).clip(0, 65535).astype(np.uint16)
    seq_dir = tmp / "seq"
    seq_dir.mkdir()
    for t in range(2):
        torch_tiff.write_stack(str(seq_dir / f"t{t}.tif"), vols[t])
    paged = str(tmp / "paged.tif")
    torch_tiff.write_stack(paged, vols.reshape(16, 16, 16))
    frames = np.stack(
        [synthetic.cells_frame(424_300 + i, (32, 32))[0] for i in range(3)]
    ).clip(0, 65535).astype(np.uint16)
    stack = str(tmp / "stack32.tif")
    torch_tiff.write_stack(stack, frames)
    return dict(
        tmp=tmp, jax_models=jax_models, torch_models=torch_models, vols=vols,
        seq_dir=str(seq_dir), paged=paged, volume=str(seq_dir / "t0.tif"),
        stack=stack, frames=frames,
    )


def _serve_spec(env, which, name, spec):
    tmp = env["tmp"]
    out = str(tmp / f"{which}_{name}")
    jobs = str(tmp / f"{which}_jobs")
    spec = dict(spec, output=out)
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


def _both(env, name, spec):
    sj = _serve_spec(env, "jax", name, spec)
    st = _serve_spec(env, "torch", name, spec)
    assert sj["state"] == "complete", sj.get("error")
    assert st["state"] == "complete", st.get("error")
    assert set(st["outputs"]) == set(sj["outputs"])
    return sj["outputs"], st["outputs"]


def _same_objects(oj, ot):
    hj, ht = _h5_arrays(oj["objects"]), _h5_arrays(ot["objects"])
    assert set(ht) == set(hj) and hj
    for k in hj:
        np.testing.assert_allclose(ht[k], hj[k], atol=1e-9, err_msg=k)


def test_segmentation_unet3d_volume(env_more):
    """One volume: labels.tif (Z, H, W), plane-major probs.tif, entropy.tif,
    objects.h5 and objects.csv equal to the JAX server's."""
    spec = {
        "module": "segmentation_unet3d", "input": [env_more["volume"]],
        "params": {"model": "seg3d", "save_probs": True, "save_entropy": True,
                   "save_objects_csv": True},
    }
    oj, ot = _both(env_more, "seg3d", spec)
    lj, lt = jax_tiff.read_stack(oj["labels"]), torch_tiff.read_stack(ot["labels"])
    assert lt.dtype == np.uint16 and lt.shape == lj.shape == (8, 16, 16)
    assert len(np.unique(lj)) > 1
    np.testing.assert_array_equal(lt, lj)
    pj, pt = jax_tiff.read_stack(oj["probs"]), torch_tiff.read_stack(ot["probs"])
    assert pt.shape == pj.shape == (24, 16, 16)
    np.testing.assert_allclose(pt, pj, atol=1e-4)
    np.testing.assert_allclose(
        torch_tiff.read_stack(ot["entropy"]), jax_tiff.read_stack(oj["entropy"]), atol=1e-4
    )
    assert ot["probs_layout"] == oj["probs_layout"] and ot["n_objects"] == oj["n_objects"]
    _same_objects(oj, ot)
    metrics = json.loads(ot["metrics"])
    assert metrics["mvox_per_sec"] > 0 and metrics["volumes_per_sec"] > 0


@pytest.mark.parametrize("layout", ["z pages", "directory"])
def test_segmentation_unet3d_timelapse(env_more, layout):
    """A volume timelapse: labels_t{t:04d}.tif per timepoint and one
    objects.h5 over both, equal to the JAX server's."""
    if layout == "z pages":
        spec = {"module": "segmentation_unet3d", "input": [env_more["paged"]],
                "params": {"model": "seg3d", "z": 8, "save_probs": True}}
    else:
        spec = {"module": "segmentation_unet3d", "input": [env_more["seq_dir"]],
                "params": {"model": "seg3d", "frame_range": [1, 2]}}
    oj, ot = _both(env_more, f"seg3d_{layout.replace(' ', '_')}", spec)
    times = (0, 1) if layout == "z pages" else (1,)
    for t in times:
        lj = jax_tiff.read_stack(os.path.join(oj["labels"], f"labels_t{t:04d}.tif"))
        lt = torch_tiff.read_stack(os.path.join(ot["labels"], f"labels_t{t:04d}.tif"))
        assert lt.shape == (8, 16, 16)
        np.testing.assert_array_equal(lt, lj)
        if layout == "z pages":
            np.testing.assert_allclose(
                torch_tiff.read_stack(os.path.join(ot["probs"], f"probs_t{t:04d}.tif")),
                jax_tiff.read_stack(os.path.join(oj["probs"], f"probs_t{t:04d}.tif")),
                atol=1e-4,
            )
    _same_objects(oj, ot)
    metrics = json.loads(ot["metrics"])
    assert metrics["n_volumes"] == len(times) and metrics["volumes_per_sec"] > 0


def test_enhancement_gan_job(env_more):
    spec = {"module": "enhancement_gan", "input": [env_more["stack"]],
            "params": {"model": "gan", "frame_batch": 2, "tta": 2}}
    oj, ot = _both(env_more, "gan", spec)
    ej, et = jax_tiff.read_stack(oj["enhanced"]), torch_tiff.read_stack(ot["enhanced"])
    assert et.dtype == np.float32 and et.shape == ej.shape == (3, 32, 32)
    np.testing.assert_allclose(et, ej, atol=1e-4)
    assert json.loads(ot["metrics"])["n_frames"] == 3


@pytest.mark.parametrize("which", ["frames", "volumes"])
def test_denoise_job(env_more, which):
    """2D denoise over the frame stack (float16 output), and the volumetric
    branch over a volume sequence, equal to the JAX server's."""
    if which == "frames":
        spec = {"module": "denoise", "input": [env_more["stack"]],
                "params": {"model": "n2v", "out_dtype": "float16"}}
        shape, dtype = (3, 32, 32), np.float16
    else:
        spec = {"module": "denoise", "input": [env_more["seq_dir"]],
                "params": {"model": "n2v3d", "tta": 8}}
        shape, dtype = (16, 16, 16), np.float32
    oj, ot = _both(env_more, f"denoise_{which}", spec)
    dj, dt = jax_tiff.read_stack(oj["denoised"]), torch_tiff.read_stack(ot["denoised"])
    assert dt.dtype == dtype and dt.shape == dj.shape == shape
    np.testing.assert_allclose(dt.astype(np.float32), dj.astype(np.float32), atol=1e-3 if dtype == np.float16 else 1e-4)
    if which == "volumes":
        assert ot["denoised_layout"] == oj["denoised_layout"]


@pytest.mark.parametrize(
    "name,spec",
    [
        ("roi3d", {"module": "segmentation_unet3d", "params": {"model": "seg3d", "roi": [0, 0, 8, 8]}}),
        ("kind", {"module": "segmentation_unet3d", "params": {"model": "gan"}}),
        ("fb3d", {"module": "denoise", "params": {"model": "n2v3d", "frame_batch": 2}, "seq": True}),
        ("spatial", {"module": "denoise", "params": {"model": "n2v", "spatial_parallel": True}}),
    ],
)
def test_new_job_errors_match_jax(env_more, name, spec):
    spec = dict(spec)
    spec["input"] = [env_more["seq_dir"] if spec.pop("seq", False) else env_more["volume"]]
    sj = _serve_spec(env_more, "jax", f"err_{name}", spec)
    st = _serve_spec(env_more, "torch", f"err_{name}", spec)
    assert sj["state"] == st["state"] == "failed"
    # the message after the job's own id
    message = sj["error"].strip().splitlines()[-1].split("JobError: ", 1)[-1]
    message = re.sub(r"^job \w+: ", "", message)
    assert "JobError" in st["error"] and message in st["error"]
