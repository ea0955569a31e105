"""The multi-device job paths through both servers on the same job JSON:
the JAX ``ImageServer`` on the 8 virtual CPU devices of
``tests/conftest.py``, the port's ``ImageServer(device="cpu")`` inside
``parallel.virtual_devices(8)`` (an 8-device pool on the CPU).

* ``segmentation_unet2d`` with ``spatial_parallel: true`` (8-way halo
  exchange), ``2`` (hybrid: 2-way rows x 4 frames at once) and
  ``data_parallel``; ``segmentation_unet3d`` Z-sharded; ``enhancement_gan``
  spatial, hybrid and data-parallel; ``denoise`` data-parallel (frames and
  volumes); ``segment_flows`` / ``segment_stars`` data-parallel;
  ``localize_emitters`` 2D, 3D and astigmatic and ``deconvolve``
  data-parallel: every output against the JAX server's at the bars of the
  single-device serve tests (labels equal on pixels whose top two logits
  lie 1e-4 apart, probabilities and regression maps within 1e-4, flows and
  stars AP50 = 1 and probabilities within 1e-5, emitter CSVs within the
  localization goldens' bars plus one CSV unit, deconvolved frames within
  2e-6 of the frame's largest value), ``n_devices`` included;
* ``finetune_spatial``: both servers from the same registered weights, the
  ``metrics.jsonl`` train rows (loss rtol 1e-5, accuracy within 0.01,
  ``grad_norm`` rtol 1e-4) and the registered model (the sharded train
  step's bars of ``test_torch_spatial_train.py``); the port's resume
  against its uninterrupted run; every JobError with the JAX text;
* ``train_unet2d`` data-parallel against the port's single-device run from
  the same init (the JAX server draws its init from ``jax.random``).
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
from sequitr_tpu.pipeline import infer as jax_infer
from sequitr_tpu.server import ImageServer as JaxServer
from sequitr_tpu.server import save_model as jax_save_model
from sequitr_tpu.server import submit_job as jax_submit
from sequitr_tpu.server.server import load_model as jax_load_model
from sequitr_tpu_torch import parallel
from sequitr_tpu_torch.config import ServerConfiguration as TorchConfig
from sequitr_tpu_torch.data import synthetic
from sequitr_tpu_torch.data import tiff
from sequitr_tpu_torch.models import convert as torch_convert
from sequitr_tpu_torch.models import gan as torch_gan
from sequitr_tpu_torch.models import unet as torch_unet
from sequitr_tpu_torch.ops import flows as torch_flows
from sequitr_tpu_torch.server import ImageServer as TorchServer
from sequitr_tpu_torch.server import submit_job as torch_submit
from sequitr_tpu_torch.server.server import read_model as torch_read_model
from sequitr_tpu_torch.server.server import save_model as torch_save_model

WAYS = 8  # the JAX package's virtual device count
CSV_TOL = 1e-4 + 1e-4  # localization goldens' atol plus one %.4f unit
RL_REL = 2e-6


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _flat(params, state):
    flat = jax_convert.flatten_params(params)
    flat.update({f"state/{k}": v for k, v in jax_convert.flatten_params(state).items()})
    return {k: np.asarray(v) for k, v in flat.items()}


def _perturbed(params, state, seed):
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32), params)
    state = jax.tree.map(lambda a: a + 0.1 * rng.random(a.shape).astype(np.float32), state)
    return params, state


def _register(env, name, kind, cfg, params, state):
    jax_save_model(env["jax_models"], name, kind, cfg, params, state)
    tcfg = (torch_gan.GANConfig if kind == "gan" else torch_unet.UNetConfig)(
        **{**cfg.__dict__, "compute_dtype": "float32"})
    torch_save_model(env["torch_models"], name, kind, tcfg, torch_convert.load_flat(tcfg, _flat(params, state), "cpu"))


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """f32 models registered with both servers (a 2D and a 3D U-Net, a GAN,
    2D and 3D N2V denoisers, the trained flows and stars fixtures) and the
    stacks they serve."""
    tmp = tmp_path_factory.mktemp("parallel_jobs")
    env = dict(tmp=tmp, jax_models=str(tmp / "jax_models"), torch_models=str(tmp / "torch_models"))
    f32 = jnp.float32
    for i, (name, kind, cfg) in enumerate([
        ("seg", "unet", jax_unet.UNetConfig(depth=2, base_features=8, compute_dtype=f32)),
        ("seg3d", "unet", jax_unet.UNetConfig(dims=3, depth=2, base_features=4, compute_dtype=f32)),
        ("n2v", "n2v", jax_unet.UNetConfig(depth=2, base_features=4, num_classes=1, compute_dtype=f32)),
        ("n2v3d", "n2v", jax_unet.UNetConfig(dims=3, depth=2, base_features=4, num_classes=1, compute_dtype=f32)),
    ]):
        params, state = _perturbed(*jax_unet.init(jax.random.PRNGKey(i), cfg), seed=i)
        _register(env, name, kind, cfg, params, state)
        env[f"{name}_weights"] = (cfg, params, state)
    gcfg = jax_gan.GANConfig(gen_depth=2, gen_base_features=4, disc_layers=2, disc_base_features=4, compute_dtype=f32)
    _register(env, "gan", "gan", gcfg, *_perturbed(*jax_gan.init(jax.random.PRNGKey(7), gcfg), seed=7))
    for name in ("flows_cells", "stars_cells"):
        kind, cfg, params, state, _ = jax_fixtures.load(name)
        _register(env, name, kind, jax_unet.UNetConfig(**{**cfg.__dict__, "compute_dtype": f32}), params, state)

    def write(name, arr):
        path = str(tmp / name)
        tiff.write_stack(path, arr)
        return path

    cells = [synthetic.cells_frame(515_000 + i, (64, 64)) for i in range(4)]
    env["stack"] = write("stack.tif", np.stack([c[0] for c in cells]).clip(0, 65535).astype(np.uint16))
    env["labels"] = write("labels.tif", np.stack([c[1] for c in cells]).astype(np.uint16))
    env["weights"] = write("weights.tif", np.random.default_rng(3).random((4, 64, 64)).astype(np.float32) + 0.5)
    env["volume"] = write("volume.tif", synthetic.cells_volume(515_100, (16, 32, 32))[0].clip(0, 65535)
                          .astype(np.uint16))
    seq = tmp / "seq"
    seq.mkdir()
    for t in range(3):
        tiff.write_stack(str(seq / f"v_t{t:02d}.tif"),
                         np.random.default_rng(40 + t).gamma(2.0, 50.0, (8, 16, 16)).astype(np.float32))
    env["seq"] = str(seq)
    env["instances"] = write("instances.tif", np.stack(
        [synthetic.instances_frame(515_200 + i, (64, 64))[0] for i in range(3)]).clip(0, 65535).astype(np.uint16))
    rng = np.random.default_rng(8)
    yy, xx = np.mgrid[:48, :48]
    spots = rng.normal(10.0, 0.5, (5, 48, 48)).astype(np.float32)
    for t in range(5):
        for cy, cx in ((12.3 + 0.2 * t, 30.6), (35.8, 15.2 - 0.1 * t)):
            spots[t] += 80.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 1.5**2))
    env["spots"] = write("spots.tif", spots)

    def astig_frame(truth, seed):  # elliptical spots on the calibration's curve
        frame = np.full((64, 64), 20.0)
        yy, xx = np.mgrid[:64, :64]
        for cz, cy, cx in truth:
            sx = 1.3 * np.sqrt(1.0 + ((cz - 300.0) / 400.0) ** 2)
            sy = 1.3 * np.sqrt(1.0 + ((cz + 300.0) / 400.0) ** 2)
            frame += 3000.0 / (2 * np.pi * sx * sy) * np.exp(
                -((yy - cy) ** 2) / (2 * sy**2) - ((xx - cx) ** 2) / (2 * sx**2))
        return (frame + np.random.default_rng(seed).normal(0, 0.2, (64, 64))).astype(np.float32)

    env["astig"] = write("astig.tif", np.stack([
        astig_frame([(250.0 - 40 * t, 20.5, 40.2), (-380.0 + 30 * t, 45.1, 18.7)], 50 + t) for t in range(5)]))
    zz, yy3, xx3 = np.mgrid[:13, :40, :40]
    vdir = tmp / "spot_vols"
    vdir.mkdir()
    for t in range(3):
        v = np.full((13, 40, 40), 20.0) + rng.normal(0, 0.5, (13, 40, 40))
        v += 300.0 * np.exp(-((zz - 4.0 - 0.2 * t) ** 2 + (yy3 - 12.0) ** 2 + (xx3 - 25.0 - 0.5 * t) ** 2) / (2 * 1.4**2))
        tiff.write_stack(str(vdir / f"s_t{t:02d}.tif"), v.astype(np.float32))
    env["spot_vols"] = str(vdir)
    return env


def _serve(env, which, name, module, params, inputs, ways=WAYS):
    tmp = env["tmp"]
    out = str(tmp / f"{which}_{name}")
    jobs = str(tmp / f"{which}_jobs")
    spec = {"module": module, "params": dict(params), "input": [env.get(i, i) for i in inputs], "output": out}
    if which == "jax":
        jax_submit(jobs, spec)
        assert JaxServer(JaxConfig(jobs_dir=jobs, models_dir=env["jax_models"], compilation_cache_dir=None)).poll_once()
    else:
        torch_submit(jobs, spec)
        with parallel.virtual_devices(ways):
            assert TorchServer(TorchConfig(jobs_dir=jobs, models_dir=env["torch_models"], device="cpu")).poll_once()
    with open(os.path.join(out, "status.json")) as f:
        return json.load(f)


def _both(env, name, module, params, inputs):
    sj, st = (_serve(env, w, name, module, params, inputs) for w in ("jax", "torch"))
    assert sj["state"] == "complete", sj.get("error")
    assert st["state"] == "complete", st.get("error")
    assert set(st["outputs"]) == set(sj["outputs"])
    return sj["outputs"], st["outputs"]


def _job_error(status):
    assert status["state"] == "failed", status
    last = status["error"].strip().splitlines()[-1]
    assert "JobError: " in last, last
    return re.sub(r"job [0-9a-f-]+:", "job ID:", last.split("JobError: ", 1)[1])


def _clear(env, frames):
    """Pixels whose top two JAX logits of ``seg`` lie more than 1e-4 apart."""
    cfg, params, state = env["seg_weights"]
    tc = jax_infer.TileConfig(patch=frames.shape[1:], overlap=(0, 0))
    x = jnp.stack([jax_infer._normalize(jnp.asarray(f)[..., None], tc) for f in frames])
    logits = np.sort(np.asarray(jax_unet.apply(cfg, params, state, x)[0]), axis=-1)
    return (logits[..., -1] - logits[..., -2]) > 1e-4


SEG2D = {
    "spatial_true": {"spatial_parallel": True, "save_probs": True},
    "spatial_hybrid": {"spatial_parallel": 2, "save_probs": True},
    "data_parallel": {"data_parallel": True, "save_probs": True},
}


@pytest.mark.parametrize("case", sorted(SEG2D))
def test_segmentation_unet2d_sharded(env, case):
    oj, ot = _both(env, f"seg_{case}", "segmentation_unet2d", dict(model="seg", **SEG2D[case]), ["stack"])
    frames = tiff.read_stack(env["stack"])
    lj, lt = tiff.read_stack(oj["labels"]), tiff.read_stack(ot["labels"])
    assert lt.shape == lj.shape == frames.shape
    clear = _clear(env, frames)
    assert clear.mean() > 0.99
    np.testing.assert_array_equal(lt[clear], lj[clear])
    np.testing.assert_allclose(tiff.read_stack(ot["probs"]), tiff.read_stack(oj["probs"]), atol=1e-4)
    assert json.loads(ot["metrics"])["n_frames"] == 4


@pytest.mark.parametrize("value", ["x", 3, 16])
def test_malformed_spatial_parallel_is_the_jax_job_error(env, value):
    sj, st = (_serve(env, w, f"seg_bad_{value}", "segmentation_unet2d",
                     {"model": "seg", "spatial_parallel": value}, ["stack"]) for w in ("jax", "torch"))
    assert _job_error(st) == _job_error(sj)


def test_segmentation_unet3d_z_sharded(env):
    oj, ot = _both(env, "seg3d_spatial", "segmentation_unet3d",
                   {"model": "seg3d", "spatial_parallel": True, "save_probs": True}, ["volume"])
    lj, lt = tiff.read_stack(oj["labels"]), tiff.read_stack(ot["labels"])
    assert lt.shape == lj.shape == (16, 32, 32)
    assert np.mean(lt == lj) > 0.999
    np.testing.assert_allclose(tiff.read_stack(ot["probs"]), tiff.read_stack(oj["probs"]), atol=1e-4)


@pytest.mark.parametrize("case", ["spatial_true", "spatial_hybrid", "data_parallel"])
def test_enhancement_gan_sharded(env, case):
    params = {"model": "gan", **{k: v for k, v in SEG2D[case].items() if k != "save_probs"}}
    oj, ot = _both(env, f"gan_{case}", "enhancement_gan", params, ["stack"])
    ej, et = tiff.read_stack(oj["enhanced"]), tiff.read_stack(ot["enhanced"])
    assert et.shape == ej.shape == (4, 64, 64)
    np.testing.assert_allclose(et, ej, atol=1e-4)


@pytest.mark.parametrize("which", ["frames", "volumes"])
def test_denoise_data_parallel(env, which):
    model, src = ("n2v", "stack") if which == "frames" else ("n2v3d", "seq")
    oj, ot = _both(env, f"n2v_dp_{which}", "denoise", {"model": model, "data_parallel": True}, [src])
    dj, dt = tiff.read_stack(oj["denoised"]), tiff.read_stack(ot["denoised"])
    assert dt.shape == dj.shape == ((4, 64, 64) if which == "frames" else (24, 16, 16))
    np.testing.assert_allclose(dt, dj, atol=1e-4)


@pytest.mark.parametrize("module,model", [("segment_flows", "flows_cells"), ("segment_stars", "stars_cells")])
def test_instances_data_parallel(env, module, model):
    oj, ot = _both(env, f"dp_{model}", module, {"model": model, "data_parallel": True, "save_prob": True},
                   ["instances"])
    want, got = tiff.read_stack(oj["labels"]), tiff.read_stack(ot["labels"])
    assert got.shape == want.shape == (3, 64, 64)
    for w, g in zip(want, got):
        assert torch_flows.average_precision(w.astype(np.int64), g.astype(np.int64), thresholds=(0.5,))["ap50"] == 1.0
    assert got.max() > 0
    np.testing.assert_allclose(tiff.read_stack(ot["prob"]), tiff.read_stack(oj["prob"]), atol=1e-5)


def _csv(path):
    with open(path) as f:
        lines = f.read().strip().split("\n")
    return lines[0], np.asarray([[float(v) for v in r.split(",")] for r in lines[1:]])


CALIB = {"qx": [1.05625e-05, -0.0063375, 2.640625], "qy": [1.05625e-05, 0.0063375, 2.640625],
         "z_range": [-600.0, 600.0]}
LOCALIZE = {
    "2d": ({"threshold_sigmas": 8}, "spots"),
    "3d": ({"dims": 3, "threshold_sigmas": 6}, "spot_vols"),
    "astig": ({"threshold": 40, "astigmatism": CALIB}, "astig"),
}


@pytest.mark.parametrize("case", sorted(LOCALIZE))
def test_localize_data_parallel(env, case):
    params, src = LOCALIZE[case]
    oj, ot = _both(env, f"loc_{case}", "localize_emitters", dict(params, data_parallel=True), [src])
    assert ot["n_devices"] == oj["n_devices"] == str(WAYS)
    assert ot["n_emitters"] == oj["n_emitters"] and int(ot["n_emitters"]) > 0
    (hj, rj), (ht, rt) = _csv(oj["emitters"]), _csv(ot["emitters"])
    assert ht == hj and rt.shape == rj.shape
    np.testing.assert_array_equal(rt[:, 0], rj[:, 0])
    np.testing.assert_allclose(rt, rj, atol=CSV_TOL, rtol=1e-5)


def test_deconvolve_data_parallel(env):
    oj, ot = _both(env, "deconv_dp", "deconvolve", {"iterations": 5, "data_parallel": True}, ["spots"])
    assert json.loads(ot["metrics"])["n_devices"] == json.loads(oj["metrics"])["n_devices"] == WAYS
    dj, dt = tiff.read_stack(oj["deconvolved"]), tiff.read_stack(ot["deconvolved"])
    assert dt.shape == dj.shape == (5, 48, 48)
    for a, b in zip(dt, dj):
        assert np.abs(a - b).max() <= RL_REL * np.abs(b).max()


FINETUNE = {"model": "ft", "from_model": "seg", "steps": 3, "log_every": 1, "learning_rate": 1e-3,
            "checkpoint_every": 2, "seed": 4}


def test_finetune_spatial_matches_the_jax_server(env):
    params = dict(FINETUNE, weights_input=env["weights"])
    oj, ot = _both(env, "ft", "finetune_spatial", params, ["stack", "labels"])

    def rows(outputs):
        with open(outputs["metrics_file"]) as f:
            return [json.loads(line) for line in f if '"train"' in line]

    rj, rt = rows(oj), rows(ot)
    assert [r["step"] for r in rt] == [r["step"] for r in rj] == [1, 2, 3]
    for a, b in zip(rt, rj):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        assert a["accuracy"] == pytest.approx(b["accuracy"], abs=0.01)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-4)
    _, jcfg, jparams, jstate = jax_load_model(env["jax_models"], "ft")
    kind, tcfg, got = torch_read_model(env["torch_models"], "ft")
    assert kind == "unet" and tcfg.compute_dtype == "float32"
    want = _flat(jparams, jstate)
    assert set(got) == set(want)
    for k in sorted(want):
        if k.endswith(("conv1/b", "conv2/b", "/mean")):  # BN-nulled: round-off moved by Adam
            assert np.abs(got[k] - want[k]).max() <= 2 * 3 * 1e-3, k
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=1e-6, err_msg=k)


def test_finetune_spatial_resume_equals_one_run(env):
    """Two steps (checkpointed at 2), then the job again with 3 steps: the
    resumed run skips the batches already consumed and ends where one
    uninterrupted run of 3 steps ends."""
    whole = _serve(env, "torch", "ft_whole", "finetune_spatial", dict(FINETUNE, model="ft_whole"), ["stack", "labels"])
    assert whole["state"] == "complete", whole.get("error")
    part = _serve(env, "torch", "ft_part", "finetune_spatial", dict(FINETUNE, model="ft_part", steps=2),
                  ["stack", "labels"])
    assert part["state"] == "complete", part.get("error")
    again = _serve(env, "torch", "ft_part", "finetune_spatial", dict(FINETUNE, model="ft_part"), ["stack", "labels"])
    assert again["state"] == "complete", again.get("error")
    _, _, a = torch_read_model(env["torch_models"], "ft_whole")
    _, _, b = torch_read_model(env["torch_models"], "ft_part")
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


FT_ERRORS = {
    "h_divisible": ({"depth": 5, "base_features": 4, "steps": 1}, ["stack", "labels"]),
    "data_ways": ({"data_ways": 3, "steps": 1}, ["stack", "labels"]),
    "batch_split": ({"data_ways": 2, "batch_size": 3, "steps": 1}, ["stack", "labels"]),
    "batch_size": ({"batch_size": 9, "steps": 1}, ["stack", "labels"]),
    "inputs": ({"steps": 1}, ["stack"]),
    "shape": ({"steps": 1}, ["stack", "volume"]),
    "kind": ({"from_model": "gan", "steps": 1}, ["stack", "labels"]),
}


@pytest.mark.parametrize("case", sorted(FT_ERRORS))
def test_finetune_spatial_job_errors(env, case):
    params, inputs = FT_ERRORS[case]
    params = {"model": f"ft_err_{case}", **params}
    sj, st = (_serve(env, w, f"ft_err_{case}", "finetune_spatial", params, inputs) for w in ("jax", "torch"))
    assert _job_error(st) == _job_error(sj)


@pytest.fixture(scope="module")
def records(env):
    rec = _serve(env, "torch", "records", "build_records", {"weight_maps": False}, ["stack", "labels"])
    assert rec["state"] == "complete", rec.get("error")
    return rec["outputs"]["shards"]


def test_train_unet2d_data_parallel_equals_single_device(env, records):
    """4 ways, batch 4: one example a device."""
    common = {"depth": 2, "base_features": 4, "steps": 3, "batch_size": 4, "log_every": 1, "augment": False,
              "learning_rate": 1e-3, "seed": 2, "compute_dtype": "float32"}
    runs = {}
    for name, extra in (("dp", {"data_parallel": True}), ("one", {})):
        st = _serve(env, "torch", f"train_{name}", "train_unet2d", dict(common, model=f"tr_{name}", **extra),
                    [records], ways=4)
        assert st["state"] == "complete", st.get("error")
        with open(st["outputs"]["metrics_file"]) as f:
            runs[name] = [json.loads(line) for line in f if '"train"' in line]
    assert len(runs["dp"]) == len(runs["one"]) == 3
    for a, b in zip(runs["dp"], runs["one"]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-4)
    _, _, a = torch_read_model(env["torch_models"], "tr_dp")
    _, _, b = torch_read_model(env["torch_models"], "tr_one")
    for k in a:
        if k.endswith(("conv1/b", "conv2/b", "/mean")):
            assert np.abs(a[k] - b[k]).max() <= 2 * 3 * 1e-3, k
        else:
            np.testing.assert_allclose(a[k], b[k], rtol=2e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("module", ["train_unet2d", "train_unet2d_polyphase"])
def test_train_data_parallel_refusals(env, records, module):
    """A batch that does not split over the pool is the JAX server's
    JobError; polyphase does not train on a mesh in the port (a JobError
    where the JAX package trains it)."""
    params = {"model": "tr_bad", "steps": 1, "batch_size": 3, "data_parallel": True, "depth": 2,
              "base_features": 4}
    if module.endswith("polyphase"):
        st = _serve(env, "torch", "tr_poly", "train_unet2d", dict(params, batch_size=8, polyphase=True), [records])
        assert "polyphase training does not combine with data_parallel" in _job_error(st)
        return
    sj, st = (_serve(env, w, "tr_bad", module, params, [records]) for w in ("jax", "torch"))
    assert _job_error(st) == _job_error(sj)


def test_every_jax_job_is_registered():
    from sequitr_tpu.server.server import REGISTRY as JAX_REGISTRY
    from sequitr_tpu_torch.server.server import REGISTRY as TORCH_REGISTRY

    assert set(TORCH_REGISTRY.names()) == set(JAX_REGISTRY.names())
    assert "finetune_spatial" in TORCH_REGISTRY.names()
