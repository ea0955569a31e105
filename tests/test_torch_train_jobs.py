"""The training jobs through the port's ``ImageServer`` on the CPU:
``build_records`` writes the JAX server's shards byte for byte for the same
job JSON; ``train_unet2d`` trains and registers a model that
``segmentation_unet2d`` serves in the same server process, that loads in
the JAX server (through its ``import-model``) and that both servers serve
to equal labels at f32; ``train_unet3d``; the JobErrors; the architecture
fields the JAX server reads (no ``features_cap``, no ``upsample``;
``preset``), registered alike by both servers.
"""

import json
import os

import numpy as np
import pytest
import torch

from sequitr_tpu import __main__ as jax_main
from sequitr_tpu.config import ServerConfiguration as JaxConfig
from sequitr_tpu.server import ImageServer as JaxServer
from sequitr_tpu.server import submit_job as jax_submit
from sequitr_tpu.server.server import load_model as jax_load_model
from sequitr_tpu_torch.config import ServerConfiguration as TorchConfig
from sequitr_tpu_torch.data import synthetic, tiff
from sequitr_tpu_torch.server import ImageServer as TorchServer
from sequitr_tpu_torch.server import submit_job as torch_submit
from sequitr_tpu_torch.server.server import load_model


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("train_jobs")
    scenes = [synthetic.cells_frame(626_000 + i, (64, 64)) for i in range(3)]
    frames = np.stack([img for img, _ in scenes]).clip(0, 65535).astype(np.uint16)
    labels = np.stack([lab for _, lab in scenes]).astype(np.uint16)
    vol, vlab = synthetic.cells_volume(626_100, (8, 32, 32))
    paths = {}
    for name, arr in (
        ("frames", frames), ("labels", labels),
        ("volume", vol.clip(0, 65535).astype(np.uint16)), ("vlabels", vlab.astype(np.uint16)),
    ):
        paths[name] = str(tmp / f"{name}.tif")
        tiff.write_stack(paths[name], arr)
    return dict(tmp=tmp, frames=frames, paths=paths, models=str(tmp / "models"))


def _run(env, which, name, module, inputs, params, models=None):
    tmp = env["tmp"]
    out = str(tmp / f"{which}_{name}")
    jobs = str(tmp / f"{which}_jobs")
    spec = {"module": module, "params": params, "input": inputs, "output": out}
    if which == "jax":
        cfg = JaxConfig(jobs_dir=jobs, models_dir=models or str(tmp / "jax_models"), compilation_cache_dir=None)
        jax_submit(jobs, spec)
        assert JaxServer(cfg).poll_once()
    else:
        cfg = TorchConfig(jobs_dir=jobs, models_dir=models or env["models"], device="cpu")
        torch_submit(jobs, spec)
        assert TorchServer(cfg).poll_once()
    with open(os.path.join(out, "status.json")) as f:
        return json.load(f)


RECORDS = {"patch": [32, 32], "patches_per_example": 2, "seed": 3, "shard_size": 4, "num_classes": 3}
ARCH = {"depth": 2, "base_features": 8, "num_classes": 3, "compute_dtype": "float32"}


@pytest.fixture(scope="module")
def shards(env):
    """``build_records`` through both servers: the same shards, byte for byte."""
    p = env["paths"]
    st = _run(env, "torch", "records", "build_records", [p["frames"], p["labels"]], dict(RECORDS))
    sj = _run(env, "jax", "records", "build_records", [p["frames"], p["labels"]], dict(RECORDS))
    assert st["state"] == "complete", st.get("error")
    assert sj["state"] == "complete", sj.get("error")
    assert st["outputs"]["n_examples"] == sj["outputs"]["n_examples"] == "6"
    assert st["outputs"]["n_shards"] == sj["outputs"]["n_shards"] == "2"
    return st, sj


def test_build_records_writes_the_reference_shards(env, shards):
    st, sj = shards
    ours = sorted(f for f in os.listdir(env["tmp"] / "torch_records") if f.endswith(".tfrecord"))
    theirs = sorted(f for f in os.listdir(env["tmp"] / "jax_records") if f.endswith(".tfrecord"))
    assert ours == theirs and len(ours) == 2
    for name in ours:
        a = (env["tmp"] / "torch_records" / name).read_bytes()
        b = (env["tmp"] / "jax_records" / name).read_bytes()
        assert a == b, name


@pytest.fixture(scope="module")
def trained(env, shards):
    params = dict(
        ARCH, model="seg_trained", steps=4, batch_size=2, learning_rate=1e-3,
        holdout_every=3, eval_every=2, checkpoint_every=2, log_every=1,
        keep_best=True, ema_decay=0.5,
    )
    st = _run(env, "torch", "train2d", "train_unet2d", [str(env["tmp"] / "torch_records")], params)
    assert st["state"] == "complete", st.get("error")
    return st


def test_train_unet2d_registers_the_ema_of_the_best(env, trained):
    metrics = trained["outputs"]["metrics_file"]
    with open(metrics) as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows if r["kind"] == "train"] == [1, 2, 3, 4]
    assert any(r["kind"] == "best" for r in rows)
    ckpts = os.path.join(env["tmp"], "torch_train2d", "ckpts")
    assert {"best", "ema_best", "final", "ema_final"} <= set(os.listdir(ckpts))
    kind, cfg, model = load_model(env["models"], "seg_trained", device="cpu")
    assert kind == "unet" and cfg.depth == 2 and cfg.compute_dtype == "float32"
    ema = torch.load(os.path.join(ckpts, "ema_best", "state.pt"), weights_only=True)["tensors"]
    with np.load(os.path.join(env["models"], "seg_trained", "weights.npz")) as npz:
        np.testing.assert_array_equal(npz["enc/0/conv1/w"], np.transpose(ema[0].numpy(), (2, 3, 1, 0)))


def test_trained_model_serves_in_both_servers(env, trained):
    """``segmentation_unet2d`` on the registered model in the same port
    server process, and in the JAX server after its ``import-model`` of the
    port's files: equal labels at f32."""
    src = os.path.join(env["models"], "seg_trained")
    jax_models = str(env["tmp"] / "jax_models")
    assert jax_main.main([
        "import-model", "--models-dir", jax_models, "--npz", os.path.join(src, "weights.npz"),
        "--arch", os.path.join(src, "config.json"), "seg_trained",
    ]) == 0
    kind, jcfg, _, _ = jax_load_model(jax_models, "seg_trained")
    assert kind == "unet" and jcfg.depth == 2
    params = {"model": "seg_trained", "localize": False}
    inputs = [env["paths"]["frames"]]
    st = _run(env, "torch", "serve", "segmentation_unet2d", inputs, dict(params))
    sj = _run(env, "jax", "serve", "segmentation_unet2d", inputs, dict(params), models=jax_models)
    assert st["state"] == "complete", st.get("error")
    assert sj["state"] == "complete", sj.get("error")
    lt = tiff.read_stack(st["outputs"]["labels"])
    lj = tiff.read_stack(sj["outputs"]["labels"])
    assert lt.shape == env["frames"].shape
    np.testing.assert_array_equal(lt, lj)


def test_train_unet2d_distills_from_a_registered_model(env, trained):
    """``distill_from`` takes a registered port model as the teacher; the
    metric stream carries the CE and KD terms."""
    params = dict(
        ARCH, model="seg_student", steps=2, batch_size=2, log_every=1,
        distill_from="seg_trained", distill_alpha=0.5, distill_temperature=2.0,
    )
    st = _run(env, "torch", "distill", "train_unet2d", [str(env["tmp"] / "torch_records")], params)
    assert st["state"] == "complete", st.get("error")
    with open(st["outputs"]["metrics_file"]) as f:
        rows = [json.loads(line) for line in f if '"train"' in line]
    assert [r["step"] for r in rows] == [1, 2]
    assert all(r["kd"] >= 0 and np.isfinite(r["ce"]) for r in rows)


def test_train_unet3d(env):
    p = env["paths"]
    rec = _run(
        env, "torch", "records3d", "build_records", [p["volume"], p["vlabels"]],
        {"dims": 3, "patch": [4, 16, 16], "patches_per_example": 4, "num_classes": 3},
    )
    assert rec["state"] == "complete", rec.get("error")
    params = dict(ARCH, model="seg3d", steps=2, batch_size=2, log_every=1, elastic_alpha=2.0)
    st = _run(env, "torch", "train3d", "train_unet3d", [str(env["tmp"] / "torch_records3d")], params)
    assert st["state"] == "complete", st.get("error")
    kind, cfg, model = load_model(env["models"], "seg3d", device="cpu")
    assert cfg.dims == 3
    with torch.inference_mode():
        assert model(torch.zeros(1, 4, 16, 16, 1)).shape == (1, 4, 16, 16, 3)


@pytest.mark.parametrize("params,message", [
    ({"polyphase": True, "space_to_depth": 2}, "polyphase training requires"),
    # the JAX server reads no ``upsample``: the model is a transpose-upsample
    # one and the polyphase job trains (message None: the job completes)
    pytest.param({"polyphase": True, "upsample": "resize"}, None, id="params1-polyphase training requires"),
    ({"keep_best": True}, "requires holdout_every"),
    ({"ema_decay": 1.5}, "ema_decay"),
    ({"early_stop_patience": "x"}, "early_stop_patience"),
])
def test_train_job_errors(env, shards, params, message):
    spec = dict(ARCH, model="bad", steps=1, **params)
    st = _run(env, "torch", "bad_" + "_".join(sorted(params)), "train_unet2d", [str(env["tmp"] / "torch_records")], spec)
    if message is None:
        assert st["state"] == "complete", st.get("error")
        return
    assert st["state"] == "failed" and "JobError" in st["error"] and message in st["error"], st["error"]


def _registered(env, which, model):
    where = env["models"] if which == "torch" else str(env["tmp"] / "jax_models")
    with open(os.path.join(where, model, "config.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("case,params", [
    ("unread_fields", dict(ARCH, polyphase=True, upsample="resize", features_cap=16)),
    ("preset", {"preset": "unet2d_3class", "depth": 2, "compute_dtype": "float32"}),
])
def test_train_unet2d_reads_the_reference_arch_fields(env, shards, case, params):
    """The same job JSON through both servers registers the same config:
    ``features_cap`` and ``upsample`` are not read (512 and "transpose", so
    the polyphase job trains), and ``preset`` is the preset whole, every
    other field ignored."""
    spec = dict(params, model=f"arch_{case}", steps=1, batch_size=2)
    for which in ("torch", "jax"):
        st = _run(env, which, f"arch_{case}", "train_unet2d", [str(env["tmp"] / f"{which}_records")], dict(spec))
        assert st["state"] == "complete", (which, st.get("error"))
    ours, theirs = _registered(env, "torch", f"arch_{case}"), _registered(env, "jax", f"arch_{case}")
    assert ours == theirs
    if case == "unread_fields":
        assert (ours["features_cap"], ours["upsample"]) == (512, "transpose")
    else:
        assert (ours["depth"], ours["base_features"], ours["compute_dtype"]) == (4, 32, "bfloat16")
