"""Cellpose's CPnet in the port (``models.cpnet``, the model kind ``cpnet``
served by ``segment_flows``) against the benchmark's plain reference
(``portbench/reference/cpnet.py``, ``flows.py``) on seeded random weights
at ``nbase [2, 8, 16, 32, 64]`` on 64x64 inputs, in float32 on the CPU:

- the forward (stored and folded) and the per-tile style within 1e-4 of
  the reference's largest value;
- the parameter count and FLOPs of the published widths from the
  configuration alone (6,600,843; 617,920 a pixel, the benchmark's count);
- the model store's round trip of the kind;
- ``follow_flows`` and ``group_sinks`` against the plain Euler steps and
  grouping;
- a ``segment_flows`` job on 2 tiles in grayscale mode against the plain
  pipeline, its JobErrors, its spans and counters, and its writers' close
  inside the job's ``try``.
"""

import json
import os
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import scenes
from portbench.kinds import cpnet as cpnet_kind
from portbench.reference import cpnet as cpnet_ref
from portbench.reference import flows as flows_ref
from sequitr_tpu_torch import tracing
from sequitr_tpu_torch.config import ServerConfiguration
from sequitr_tpu_torch.data import tiff
from sequitr_tpu_torch.models import convert, cpnet
from sequitr_tpu_torch.ops import flows as flows_ops
from sequitr_tpu_torch.pipeline import infer
from sequitr_tpu_torch.server import ImageServer, jobs as jobs_lib
from sequitr_tpu_torch.server import server as server_lib

SMALL = cpnet.CPnetConfig(nbase=(2, 8, 16, 32, 64), compute_dtype="float32")
MODEL = {"nbase": list(SMALL.nbase), "nout": 3, "sz": 3}
# a segment_flows job on 64x64 frames: two 64x40 tiles, 16 columns shared
PARAMS = {"patch": [64, 40], "overlap": [0, 16], "p_lo": 1, "p_hi": 99, "channels": [0, 0],
          "normalize": "pallas", "n_iter": 200, "localize": False}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    tracing.disable()
    yield
    tracing.disable()


def _random_model(seed=0):
    """The small CPnet with random weights and batch-norm statistics, so no
    affine is the identity."""
    model = cpnet.init(SMALL, generator=torch.Generator().manual_seed(seed), device="cpu")
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, cpnet._BatchConv):
                c = m.bn.scale.numel()
                m.bn.scale.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, c).astype(np.float32)))
                m.bn.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)))
                m.bn.mean.copy_(torch.from_numpy(rng.normal(0, 0.1, c).astype(np.float32)))
                m.bn.var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32)))
    return model


@pytest.fixture(scope="module")
def pair():
    torch.set_num_threads(1)
    model = _random_model()
    flat = convert.to_flat(model)
    return model, flat, cpnet_ref.load(flat, MODEL, "cpu")


def _frames(n, shape=(64, 64), seed=5):
    return np.stack([scenes.cells_scene([seed, i], shape)[0] for i in range(n)]).clip(
        0, 65535).astype(np.uint16)


def test_the_forward_and_the_style_are_the_references(pair):
    model, _, ref = pair
    x = torch.from_numpy(np.random.default_rng(1).random((3, 64, 64, 2), dtype=np.float32))
    with torch.no_grad():
        want, want_style = ref(x.permute(0, 3, 1, 2))
    want = want.permute(0, 2, 3, 1)
    scale = float(want.abs().max())
    for net in (model, cpnet.fold(model)):
        got, style = net.forward_with_style(x)
        assert got.shape == (3, 64, 64, 3) and got.dtype == torch.float32
        assert float((got - want).abs().max()) < 1e-4 * scale
        torch.testing.assert_close(style, want_style, atol=1e-6, rtol=1e-5)
    # the style is a tile's own: a tile served beside others reads the same
    alone, _ = cpnet.fold(model).forward_with_style(x[1:2])
    assert float((alone[0] - want[1]).abs().max()) < 1e-4 * scale


def test_the_published_widths_count_6_6_m_parameters_and_the_benchmarks_flops():
    cfg = cpnet.CPnetConfig()
    assert cfg.nbase == (2, 32, 64, 128, 256) and cfg.nout == 3 and cfg.sz == 3
    assert cpnet.param_count(cfg) == 6_600_843
    assert cpnet.param_count(SMALL) == sum(p.numel() for p in cpnet.CPnet(SMALL, "cpu").parameters())
    assert cpnet_kind.cpnet_flops_per_voxel(
        {"nbase": list(cfg.nbase), "nout": cfg.nout, "sz": cfg.sz}) == 617_920


def test_the_model_store_round_trip(pair, tmp_path):
    model, flat, _ = pair
    server_lib.save_model(str(tmp_path), "cp", "cpnet", SMALL, model)
    kind, cfg, back = server_lib.read_model(str(tmp_path), "cp")
    assert kind == "cpnet" and cfg == SMALL
    assert sorted(back) == sorted(flat)
    assert all(np.array_equal(back[k], flat[k]) for k in flat)
    kind, cfg, served = server_lib.load_model(str(tmp_path), "cp", device="cpu")
    assert isinstance(served, cpnet.ServingCPnet)
    x = torch.rand(2, 32, 32, 2, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(served(x), cpnet.fold(model)(x))


def test_euler_and_the_sink_grouping_are_the_plain_ones():
    _, inst = scenes.cells_scene([9, 0], (192, 192))
    flow, _ = flows_ops.flow_targets(inst)
    rng = np.random.default_rng(4)
    flow = flow + rng.normal(0, 0.05, flow.shape).astype(np.float32)
    mask = inst > 0
    got = flows_ops.follow_flows(flow, mask, n_iter=200, device="cpu")
    want = flows_ref.euler(torch.from_numpy(np.moveaxis(flow, -1, 0).copy()),
                           torch.from_numpy(mask), 200)
    assert float((got - want).abs().max()) < 1e-3
    final = want.numpy()
    ours = flows_ops.group_sinks(final, mask)
    plain = flows_ref.group(final, mask)
    tp, n_a, n_b, partner = flows_ref.match(plain, ours)
    assert n_a > 3 and tp == n_a == n_b
    assert np.array_equal(partner[plain], np.where(plain > 0, ours, 0))


@pytest.fixture(scope="module")
def served(pair, tmp_path_factory):
    """The small model in a models directory and a 3-frame stack."""
    model, flat, ref = pair
    tmp = tmp_path_factory.mktemp("cpnet_jobs")
    server_lib.save_model(str(tmp / "models"), "cp", "cpnet", SMALL, model)
    frames = _frames(3)
    stack = str(tmp / "stack.tif")
    tiff.write_stack(stack, frames)
    return SimpleNamespace(tmp=tmp, ref=ref, frames=frames, stack=stack, models=str(tmp / "models"))


def _job(served, name, params, inputs=None, module="segment_flows", **config):
    out = str(served.tmp / name)
    jobs = str(served.tmp / f"jobs_{name}")
    cfg = ServerConfiguration(jobs_dir=jobs, models_dir=served.models, device="cpu", **config)
    jobs_lib.submit_job(jobs, {"module": module, "params": {"model": "cp", **params},
                               "input": inputs or [served.stack], "output": out})
    assert ImageServer(cfg).poll_once()
    with open(os.path.join(out, "status.json")) as f:
        return out, json.load(f)


def test_a_segment_flows_job_on_two_tiles_in_grayscale_mode(served):
    out, st = _job(served, "gray", {**PARAMS, "save_prob": True})
    assert st["state"] == "complete", st.get("error")
    assert not st.get("warnings"), st["warnings"]
    labels = tiff.read_stack(os.path.join(out, "labels.tif"))
    prob = tiff.read_stack(os.path.join(out, "prob.tif"))
    judge = cpnet_kind.Instances(served.ref, served.frames, PARAMS, "cpu")
    for i, frame in enumerate(served.frames):
        _, want = flows_ref.heads(served.ref, frame, PARAMS, "cpu")
        np.testing.assert_allclose(prob[i], want.numpy(), atol=1e-5)
        judge.compare(i, labels[i])
    readings = judge.readings()
    assert judge.n_ref > 0 and readings["instance_miss_share"] == 0.0, readings
    assert readings["pixel_mismatch_share"] < 1e-3, readings


def test_an_evaluate_flows_job_scores_the_cpnet_against_instances(served):
    truth = np.stack([scenes.cells_scene([5, i], (64, 64))[1] for i in range(3)]).astype(np.uint16)
    path = str(served.tmp / "truth.tif")
    tiff.write_stack(path, truth)
    _, st = _job(served, "evaluate", PARAMS, [served.stack, path], module="evaluate_flows")
    assert st["state"] == "complete", st.get("error")
    metrics = json.loads(st["outputs"]["metrics"])
    assert metrics["n_frames"] == 3 and metrics["n_gt"] == int(sum(
        np.unique(t[t > 0]).size for t in truth)), metrics


@pytest.mark.parametrize("params, inputs, message", [
    ({"channels": [1, 2]}, 1, "the one mode served is [0, 0]"),
    ({"channels": [0, 0]}, 2, "the one mode served is [0, 0]"),
    ({"channels": 0}, 1, "the one mode served is [0, 0]"),
    ({}, 1, "model expects 2 channel(s), got 1 input stack(s)"),
    ({"channels": [0, 0], "patch": None}, 1, "a cpnet model runs tile by tile; name a patch"),
], ids=["channels_1_2", "two_stacks", "not_a_list", "no_channels", "no_patch"])
def test_channels_and_stack_counts_that_do_not_fit_are_job_errors(served, params, inputs, message):
    spec = {k: v for k, v in PARAMS.items() if k != "channels"}
    out, st = _job(served, f"bad_{len(params)}_{inputs}_{params.get('channels')}",
                   {k: v for k, v in {**spec, **params}.items() if v is not None},
                   [served.stack] * inputs)
    assert st["state"] == "failed" and "JobError" in st["error"] and message in st["error"], st["error"]


def test_the_spans_and_counters_of_a_flows_frame(served):
    tracer = tracing.enable()
    out, st = _job(served, "traced", {**PARAMS, "save_prob": True})
    tracing.disable()
    assert st["state"] == "complete", st.get("error")
    spans = [s.name for s in tracer.spans()]
    assert spans.count("flows.forward") == spans.count("flows.integrate") == 3
    counts = {}
    for c in tracer.counts():
        counts.setdefault(c.name, []).append(c.n)
    assert counts["flows.tiles"] == [2, 2, 2]
    assert counts["flows.euler_steps"] == [200, 200, 200]
    labels = tiff.read_stack(os.path.join(out, "labels.tif"))
    assert counts["flows.instances"] == [int(lab.max()) for lab in labels]
    prob = tiff.read_stack(os.path.join(out, "prob.tif"))
    assert counts["flows.foreground"] == [int((p > 0.5).sum()) for p in prob]
    assert tracing.span("flows.forward") is tracing.NOOP


def test_a_deflate_failure_at_close_leaves_no_file_of_either_writer(served, monkeypatch):
    """The last label frame's deflate fails: the labels writer raises at
    ``close``, inside the job's ``try``, so the prob writer is aborted
    too."""
    import zlib

    lock, calls = threading.Lock(), [0]
    n = len(served.frames)

    def compress(data, level):
        with lock:
            i = calls[0]
            calls[0] += 1
        time.sleep(0.002)
        if i == 2 * (n - 1):  # labels and prob alternate, frame by frame
            raise RuntimeError("deflate failed")
        return zlib.compress(data, level)

    monkeypatch.setattr(tiff, "zlib", SimpleNamespace(compress=compress))
    out, st = _job(served, "deflate_fails", {**PARAMS, "save_prob": True, "compress_output": True},
                   max_retries=0)
    assert st["state"] == "failed" and "deflate failed" in st["error"], st
    left = sorted(f for f in os.listdir(out) if f.endswith(".tif") or f.endswith(".tmp"))
    assert left == [], left


def test_the_segmenter_counts_a_frames_tiles_and_steps_only_with_tracing_on(pair):
    model, _, _ = pair
    tc = infer.TileConfig(patch=(32, 32), overlap=(8, 8), normalize="pallas")
    seg = infer.make_flows_segmenter(SMALL, tc, (48, 48), n_iter=5, zero_channels=1, device="cpu")
    frame = torch.from_numpy(_frames(1, (48, 48))[0])
    final, prob = seg(model, frame)
    assert final.shape == (48, 48, 2) and prob.shape == (48, 48)
    tracer = tracing.enable()
    seg(model, frame)
    tracing.disable()
    assert [(c.name, c.n) for c in tracer.counts()] == [("flows.tiles", 4), ("flows.euler_steps", 5)]
