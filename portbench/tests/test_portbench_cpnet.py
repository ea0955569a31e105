"""The ``cpnet`` kind and the ``flows.euler`` cell's readers on the CPU:
the scene draw with instances equals ``inputs.cells_frame``; the judge's
two numbers; the FLOP count and the integrator's bound; the kernels put
under the bridged span their launch lies in; the weights' quality bar.
The float8 control is ``test_portbench_control.py``'s, for every cell."""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import inputs, launches, scenes, spec
from portbench.kinds import cpnet as cpnet_kind
from portbench.tests.conftest import ROOT

BENCH = spec.load_benchmark(ROOT)


@pytest.mark.parametrize("seed, shape", [
    (inputs.seed_words(7, 1, 0), (1024, 1024)),
    (inputs.seed_words(2**33 + 5, 1, 15), (1024, 1024)),
    ([0, 1, 3], (256, 192)),
    (11, (64, 64)),
])
def test_the_scene_is_cells_frames_bit_for_bit(seed, shape):
    img, inst = scenes.cells_scene(seed, shape)
    want = inputs.cells_frame(seed, shape)
    assert img.dtype == want.dtype and np.array_equal(img, want)
    assert inst.shape == shape and inst.dtype == np.int32 and inst.max() >= 3


def test_the_configuration_is_at_the_published_widths():
    cfg = spec.config_of(BENCH, ROOT, "cpnet_cellpose")
    assert cfg["model"]["nbase"] == [2, 32, 64, 128, 256]
    assert (cfg["model"]["nout"], cfg["model"]["sz"], cfg["reduced"]) == (3, 3, [])
    assert cpnet_kind.flops_per_voxel(cfg) == cfg["flops"]["per_pixel"] == 617_920
    assert len(cpnet_kind.make_flat(cfg, 1, "cpu", ROOT)) == len(cpnet_kind.make_flat(cfg, 2, "cpu", ROOT))


def test_the_judge_reads_instances_and_pixels():
    ref = np.zeros((1, 32, 32), np.int64)
    ref[0, 2:8, 2:8], ref[0, 20:30, 20:30], ref[0, 10:14, 20:24] = 1, 2, 3
    judge = cpnet_kind.Instances(None, ref, {}, "cpu")
    judge._maps[0] = ref[0]
    judge.compare(0, ref[0])
    assert judge.readings() == {"instance_miss_share": 0.0, "pixel_mismatch_share": 0.0}
    served = np.zeros((32, 32), np.int64)
    served[2:8, 2:8] = 2  # ids need not agree
    served[20:30, 20:29] = 1  # IoU 0.9: matched, 10 pixels differ
    judge.compare(0, served)  # instance 3 missing: 16 pixels differ
    r = judge.readings()
    assert r["instance_miss_share"] == pytest.approx(1 - 2 * 5 / (6 + 5))
    assert r["pixel_mismatch_share"] == pytest.approx(26 / (2 * 32 * 32))


def test_the_integrators_bound_is_the_foregrounds_work():
    bound = cpnet_kind.euler_bound_ms_per_mvox(200, 0.25)
    assert bound == pytest.approx(1e3 * 32 * 200 * 0.25e6 / 66.9e12)
    assert cpnet_kind.euler_bound_ms_per_mvox(1, 0.25) == pytest.approx(1e3 * 5e6 / 3.35e12)
    # no foreground: the mask is still read
    assert cpnet_kind.euler_bound_ms_per_mvox(200, 0.0) == pytest.approx(1e3 * 1e6 / 3.35e12)


def _trace(tmp_path, events, indent=None):
    run_dir = tmp_path / "run"
    (run_dir / "out" / "j0").mkdir(parents=True)
    (run_dir / "trace.json").write_text(json.dumps({"traceEvents": events}, indent=indent))
    return str(run_dir / "out" / "j0")


def _x(cat, name, ts, dur, tid=1, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": tid, "ts": ts, "dur": dur}
    if corr is not None:
        # as the exporter writes a kernel's: arrays, and the id among other keys
        ev["args"] = {"External id": corr, "stream": 7, "correlation": corr, "grid": [1, 2, 1]}
    return ev


# the kernels' seconds in the window, as traceio.reduce_trace sums them
_KERNELS = {"conv": 300e-6, "bn": 200e-6, "take": 500e-6, "other": 900e-6, "late": 500e-6}


@pytest.mark.parametrize("indent, kernels, how", [
    (None, _KERNELS, "scanned"),
    (2, _KERNELS, "scanned"),
    (None, {**_KERNELS, "missed": 1e-3}, "parsed whole"),
], ids=["one_line", "indented", "disagrees"])
def test_kernels_go_under_the_span_their_launch_lies_in(tmp_path, monkeypatch, capsys, indent,
                                                       kernels, how):
    events = [
        _x("user_annotation", "portbench.window", 1000.0, 10_000.0),
        _x("user_annotation", "flows.forward", 1100.0, 100.0),
        _x("user_annotation", "flows.integrate", 1300.0, 100.0),
        _x("cuda_runtime", "cudaLaunchKernel", 1150.0, 2.0, corr=1),
        _x("cuda_runtime", "cudaLaunchKernelExC", 1160.0, 2.0, corr=2),
        _x("cuda_runtime", "cudaLaunchKernel", 1350.0, 2.0, corr=3),
        _x("cuda_runtime", "cudaLaunchKernel", 1500.0, 2.0, corr=4),  # under neither
        _x("kernel", "conv", 2000.0, 300.0, tid=7, corr=1),
        _x("kernel", "bn", 2400.0, 200.0, tid=7, corr=2),
        _x("kernel", "take", 3000.0, 500.0, tid=7, corr=3),
        _x("kernel", "other", 4000.0, 900.0, tid=7, corr=4),
        _x("kernel", "late", 10_500.0, 1000.0, tid=7, corr=3),  # clipped to the window
    ]
    out = _trace(tmp_path, events, indent)
    run = SimpleNamespace(trace=SimpleNamespace(kernels=kernels),
                          ended=[SimpleNamespace(output=out)], window_s=0.01, done=[object()],
                          served_voxels=2 * 10**6, traffic={"input": {"shape": [1000, 1000]}})
    assert launches.kernel_seconds(run, "flows.forward") == pytest.approx(500e-6)
    assert launches.kernel_seconds(run, "flows.integrate") == pytest.approx(1000e-6)
    assert f"trace {how} for the kernels by span" in capsys.readouterr().err
    read = spec.reader(ROOT, "euler_device_ms_per_mvox")
    assert read(run) == pytest.approx(1e3 * 1000e-6 / 2)
    assert spec.reader(ROOT, "cpnet_forward_device_ms_per_mvox")(run) == pytest.approx(0.25)
    # the roofline: the bound at the counted steps over that time
    from portbench import spans

    host = spans.Host([("flows.integrate", 0.001, 0.002, 1)],
                      [("flows.euler_steps", 0.002, 200), ("flows.euler_steps", 0.02, 200),
                       ("flows.foreground", 0.003, 40_000), ("flows.foreground", 0.004, 60_000)],
                      0)
    monkeypatch.setattr(spans, "host", lambda r: host)
    roof = spec.reader(ROOT, "euler_roofline")(run)
    assert roof == pytest.approx(100 * cpnet_kind.euler_bound_ms_per_mvox(200, 0.05) / 0.5)
    # without the foreground counter (a program before it), nothing to read
    host = spans.Host(host.spans, host.counts[:2], 0)
    assert spec.reader(ROOT, "euler_roofline")(run) is None
    assert launches.kernel_seconds(SimpleNamespace(trace=None, ended=[]), "flows.forward") is None


def test_the_weights_meet_their_quality_bar():
    cfg = spec.config_of(BENCH, ROOT, "cpnet_cellpose")
    trained = cfg["weights"]["trained"]
    assert trained["holdout"]["ap50"] >= 0.8
    assert os.path.getsize(os.path.join(ROOT, cfg["weights"]["path"])) == trained["bytes"]
