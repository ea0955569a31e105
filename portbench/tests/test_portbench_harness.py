"""The harness on the CPU: BENCHMARK.json's rules, the data-driven lookup,
the refusal without a card, where inputs go, and ``correct`` coming out
false when the served answers are altered where they are produced (by the
fault each configuration's kind module plants, ``altered_answers``)."""

import contextlib
import copy
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from portbench import harness, inputs, spec, tiffio
from portbench.tests.conftest import ROOT

BENCH = spec.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_names_and_units_use_the_allowed_characters():
    assert spec.check_names(BENCH) == []
    for w in BENCH["workloads"] + BENCH["configs"]:
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]


def test_every_per_layer_metric_moves_an_end_to_end_metric_its_cells_report():
    for m in BENCH["per_layer"]:
        moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
        for cell in m["workloads"]:
            assert cell in CELLS
            assert "workloads" not in moved or cell in moved["workloads"], (m["name"], cell)


def test_every_cell_reports_setup_another_end_to_end_metric_and_a_per_layer_one():
    for cell in CELLS:
        e2e = {m["name"] for m in spec.metrics_of(BENCH, cell, trace=False)}
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert spec.metrics_of(BENCH, cell, trace=True), cell


KIND_FUNCTIONS = ("make_flat", "flops_per_voxel", "judge", "control_readings", "small_traffic",
                  "altered_answers")


def test_every_name_has_its_file():
    for w in BENCH["workloads"]:
        assert spec.traffic_of(ROOT, w["traffic"])["module"]
        limits = spec.limits_of(ROOT, w["name"])
        compared = [k for k in limits if k != "readings"]
        assert "missing" in compared and len(compared) >= 2, w["name"]
        assert all(isinstance(limits[k], (int, float)) for k in compared), w["name"]
        spec.config_of(BENCH, ROOT, w["config"])
    for c in BENCH["configs"]:
        kind = spec.kind_of(ROOT, spec.config_of(BENCH, ROOT, c["name"])["kind"])
        assert isinstance(kind.SERVER_KIND, str), c["name"]
        for name in KIND_FUNCTIONS:
            assert callable(getattr(kind, name, None)), (c["name"], name)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.reader(ROOT, m["name"]))


def test_a_new_configuration_traffic_and_metric_are_found_with_no_edit(tmp_path):
    """A copy of the benchmark with one file of each kind added, and the
    entries that name them, runs a new cell end to end on the CPU."""
    root = _checkout(tmp_path)
    bench = copy.deepcopy(BENCH)
    cfg = json.loads((root / BENCH["configs"][0]["file"]).read_text())
    cfg["name"] = "unet2d_tiny"
    cfg["model"] = {**cfg["weights"]["embed"]["model"], "norm": "none"}  # the trained net's widths
    (root / "portbench/configs/unet2d_tiny.json").write_text(json.dumps(cfg))
    bench["configs"].append({**bench["configs"][0], "name": "unet2d_tiny",
                             "file": "portbench/configs/unet2d_tiny.json"})
    traffic = _tiny("seg2d.timelapse")
    (root / "portbench/traffic/tiny.json").write_text(json.dumps(traffic))
    (root / "portbench/limits/seg2d.tiny.json").write_text(
        json.dumps({"missing": 0, "max_gap": 0.5, "mismatch_share": 0.01}))
    (root / "portbench/metrics/jobs_done.py").write_text(
        "def read(run):\n    return float(len(run.done))\n")
    bench["workloads"].append({"name": "seg2d.tiny", "config": "unet2d_tiny", "traffic": "tiny",
                               "chips": 1, "why": "a test cell"})
    bench["end_to_end"].append({"name": "jobs_done", "unit": "jobs", "better": "higher",
                                "bound": 0.1, "source": "host_clock", "workloads": ["seg2d.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    result = _run(str(root), "seg2d.tiny", 12345, 3.0, tmp_path)
    assert result["correct"] is True
    assert result["metrics"]["jobs_done"]["value"] >= 1
    assert set(result["metrics"]) == {"setup_s", "jobs_done"}


def test_without_a_card_the_command_exits_non_zero_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", CELLS[0], "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())
    assert "no CUDA card" in proc.stderr


def test_inputs_go_under_tmpdir_only(tmp_path, monkeypatch):
    import tempfile

    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(tempfile, "tempdir", None)
    roots = []
    real = inputs.build_inputs
    monkeypatch.setattr(inputs, "build_inputs", lambda s, seed, root: roots.append(root) or
                        real(s, seed, root))
    _run(ROOT, CELLS[0], 7, 3.0, tmp_path)
    assert roots and all(r.startswith(str(tmp_path) + os.sep) for r in roots)
    assert sorted(os.listdir(tmp_path)) == ["err.txt", "out.txt"]  # the run directory is gone
    for d, _, files in os.walk(os.path.join(ROOT, "portbench")):
        for f in files:
            if f.endswith(".py") and "tests" not in d:
                text = open(os.path.join(d, f)).read()
                assert "/dev/shm" not in text and "'/tmp" not in text and '"/tmp' not in text


def test_inputs_are_the_same_from_the_same_seed(tmp_path):
    spec_ = _tiny("seg2d.timelapse")["input"]
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir(), b.mkdir()
    items_a, ins_a, _ = inputs.build_inputs(spec_, 2**31 + 77, str(a))
    items_b, ins_b, _ = inputs.build_inputs(spec_, 2**31 + 77, str(b))
    np.testing.assert_array_equal(items_a, items_b)
    assert [i.items for i in ins_a] == [i.items for i in ins_b]
    np.testing.assert_array_equal(tiffio.read_stack(ins_a[0].path), items_a[ins_a[0].items])
    counts = np.bincount(np.concatenate([i.items for i in ins_a]), minlength=spec_["distinct"])
    assert counts.max() - counts.min() <= 1


def _checkout(tmp_path):
    """A copy of the benchmark's folder beside the trained nets."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "portbench"), root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "sequitr_tpu"), root / "sequitr_tpu")  # the trained nets
    return root


def _kind(cell, root=ROOT):
    """The kind module of a cell's configuration."""
    bench = spec.load_benchmark(root)
    cfg = spec.config_of(bench, root, spec.cell(bench, cell)["config"])
    return spec.kind_of(root, cfg["kind"])


def _tiny(cell, root=ROOT):
    """The cell's mix at a CPU test's size, as its kind sizes it."""
    bench = spec.load_benchmark(root)
    return _kind(cell, root).small_traffic(spec.traffic_of(root, spec.cell(bench, cell)["traffic"]))


def _run(root, cell, seed, seconds, tmp_path, traffic=None, rc=0):
    """One CPU run of ``cell``; its result line (None where it must print
    none, ``rc`` not 0)."""
    if traffic is None:
        traffic = _tiny(cell, root)
    out = tmp_path / "out.txt"
    with open(out, "w") as f, open(tmp_path / "err.txt", "w") as err:
        got = harness.run_cell(root, cell, seed, seconds, False, time.perf_counter(),
                               device="cpu", traffic_override=traffic, out=f, err=err)
    assert got == rc, (tmp_path / "err.txt").read_text()[-3000:]
    lines = out.read_text().splitlines()
    if rc:
        assert not any(line.startswith("{") for line in lines)
        return None
    return json.loads(lines[-1])


@pytest.mark.parametrize("broken", [False, True], ids=["sound", "answer_altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_correct_comes_out_false_when_an_answer_is_altered(cell, broken, tmp_path):
    with _kind(cell).altered_answers() if broken else contextlib.nullcontext():
        result = _run(ROOT, cell, 2**31 + 9, 3.0, tmp_path)
    assert result["correct"] is (not broken), result["check"]
    assert list(result)[-1] == "check"


def test_mfu_is_the_served_flops_over_the_kernels_device_time():
    """``mfu`` reads the trace: the served voxels' model FLOPs over the
    device time of every kernel (copies left out), of the bf16 peak; no
    trace, no reading."""
    from types import SimpleNamespace

    from portbench import counts, traceio

    read = spec.reader(ROOT, "mfu")
    run = SimpleNamespace(trace=None, done=[object()], served_voxels=2**20,
                          flops_per_voxel=1_467_904.0)
    assert read(run) is None
    run.trace = traceio.TraceSummary({"conv": 0.004, "minmax_kernel": 0.001}, {"Memcpy HtoD": 1.0},
                                     0.5, 1.0, [])
    expected = 100.0 * 2**20 * 1_467_904.0 / 0.005 / counts.PEAK_BF16_FLOPS
    assert abs(read(run) - expected) < 1e-9 * expected
