"""The readers of the program's spans and counter: each on a synthetic
run (a tracer holding hand-made records, an exported trace written by
hand) with hand-computed sums and idle intersections, each silent (None)
where the program kept no spans, as a program without a tracer leaves a
run; the trace reading keeps the device's busy intervals and the bridged
spans; a traced CPU run of the cell reads the spans the program kept."""

import json
import time
from types import SimpleNamespace

import pytest

from portbench import harness, spans, spec, traceio
from portbench.tests.conftest import ROOT
from portbench.tests.test_portbench_harness import _tiny
from sequitr_tpu_torch import tracing
from sequitr_tpu_torch.pipeline import infer

SPAN_READERS = (
    "deflate_ms_per_mvox", "job_turnover_ms_per_mvox", "launch_ms_per_mvox",
    "device_idle_in_launch.bulk", "device_idle_in_write.bulk", "device_idle_in_turnover.bulk",
)
READERS = SPAN_READERS + ("inferrer_builds",)

# the window starts 105 s into the host clock
T0 = 105.0

# host clock, seconds from the window's start: two frames of one job and
# the start of the next, which the window's end cuts
HOST_SPANS = [
    ("job.infer", 0.0, 2.0, 1), ("stream.launch", 0.5, 1.5, 1),
    ("job.write", 3.0, 5.0, 1), ("tiff.deflate", 3.5, 4.5, 1),
    ("server.poll", 5.2, 5.3, 0),
    ("job.infer", 6.0, 8.0, 1), ("stream.launch", 6.5, 7.5, 1),
    ("job.write", 9.5, 11.0, 1), ("tiff.deflate", 9.6, 10.6, 1),
    ("frame.read", 0.0, 3.0, 2),
]
COUNTS = [("inferrer.builds", -1.0, 1), ("inferrer.builds", 4.0, 2), ("other", 5.0, 7),
          ("inferrer.builds", 10.5, 1)]


def _tracer(host_spans=(), counts=()):
    """A tracer holding ``host_spans`` and ``counts`` (window seconds) as
    the program's tracer keeps them (``perf_counter_ns``)."""
    tracer = tracing.Tracer()
    ns = lambda s: int(round((T0 + s) * 1e9))  # noqa: E731
    for i, (name, a, b, tid) in enumerate(host_spans):
        tracer._keep(tracing.SpanRecord(i + 1, None, name, ns(a), ns(b), tid, "t", "j0", {}))
    for name, t, n in counts:
        tracer._keep(tracing.CountRecord(name, ns(t), n, n, 1, "j0"))
    return tracer


def _x(name, cat, ts, dur, tid=1):
    """A complete event, its keys in the order the profiler writes them."""
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": tid, "ts": ts, "dur": dur,
            "args": {"External id": 1}}


def _trace_file(tmp_path, bridged=True):
    """A 10 s window at 1 ms on the trace's clock; the device busy [1, 3],
    [4.5, 6], [7, 9] s: idle [0, 1], [3, 4.5], [6, 7], [9, 10], 4.5 s
    (45%)."""
    us = lambda s: 1000.0 + s * 1e6  # noqa: E731
    events = [_x(traceio.WINDOW_SPAN, "user_annotation", us(0), 10e6)]
    for a, b in [(1.0, 3.0), (4.5, 6.0), (7.0, 9.0)]:
        events.append(_x("conv", "kernel", us(a), (b - a) * 1e6, tid=7))
    if bridged:
        for name, a, b in [("job.infer", 0.0, 2.0), ("stream.launch", 0.5, 1.5),
                           ("job.write", 3.0, 5.0), ("job.infer", 6.0, 8.0),
                           ("stream.launch", 6.5, 7.5)]:
            events.append(_x(name, "user_annotation", us(a), (b - a) * 1e6, tid=5))
    (tmp_path / "out").mkdir(exist_ok=True)
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def _run(monkeypatch, tmp_path, tracer=None, trace=False, bridged=True):
    """A 10 s window that served 2 Mvox; the program's tracer ``tracer``
    (None: the program kept none); with ``trace``, the exported trace in
    the run's directory, as the harness leaves it."""
    monkeypatch.setattr(tracing, "latest", lambda: tracer, raising=False)
    summary = None
    if trace:
        summary = traceio.reduce_trace(_trace_file(tmp_path, bridged), clip_s=10.0)
    job = SimpleNamespace(output=str(tmp_path / "out" / "j00000"), phases={})
    return SimpleNamespace(process_start=100.0, setup_s=T0 - 100.0, window_s=10.0,
                           ended=[job], done=[job], served_voxels=2_000_000, trace=summary)


@pytest.mark.parametrize("name", READERS)
def test_each_reader_is_silent_without_the_programs_spans(name, monkeypatch, tmp_path):
    read = spec.reader(ROOT, name)
    assert read(_run(monkeypatch, tmp_path)) is None
    # a program without a tracer: no tracing.latest at all
    monkeypatch.delattr(tracing, "latest")
    assert spans.host(SimpleNamespace()) is None
    # a trace of a program without a tracer: busy time but no bridged span
    assert read(_run(monkeypatch, tmp_path, trace=True, bridged=False)) is None
    if name.startswith("device_idle"):
        # nor where a tracer kept spans that were not bridged
        run = _run(monkeypatch, tmp_path, tracer=_tracer(HOST_SPANS), trace=True, bridged=False)
        assert read(run) is None
    # a tracer left from before the run: nothing inside the window
    stale = _tracer([("job.infer", -50.0, -40.0, 1)], [("inferrer.builds", -45.0, 1)])
    assert read(_run(monkeypatch, tmp_path, tracer=stale)) is None


def test_the_host_readers_sum_the_windows_spans_per_mvox(monkeypatch, tmp_path):
    run = _run(monkeypatch, tmp_path, tracer=_tracer(HOST_SPANS, COUNTS))
    # deflate 1.0 + 0.4 (cut at 10 s), launches 1.0 + 1.0, over 2 Mvox
    assert spec.reader(ROOT, "deflate_ms_per_mvox")(run) == pytest.approx(700.0)
    assert spec.reader(ROOT, "launch_ms_per_mvox")(run) == pytest.approx(1000.0)
    # frame steps [0, 2] [3, 5] [6, 8] [9.5, 10]: 6.5 of 10 s; the poll
    # and the reader thread's spans are not frame steps
    assert spec.reader(ROOT, "job_turnover_ms_per_mvox")(run) == pytest.approx(1750.0)
    # two builds at 4 s; those before and after the window do not count
    assert spec.reader(ROOT, "inferrer_builds")(run) == 2
    run = _run(monkeypatch, tmp_path, tracer=_tracer(HOST_SPANS))
    assert spec.reader(ROOT, "inferrer_builds")(run) == 0


def test_the_idle_shares_lay_the_bridged_spans_on_the_idle_time(monkeypatch, tmp_path):
    run = _run(monkeypatch, tmp_path, tracer=_tracer(HOST_SPANS), trace=True)
    idle = spec.reader(ROOT, "device_idle.bulk")(run)
    launch = spec.reader(ROOT, "device_idle_in_launch.bulk")(run)
    write = spec.reader(ROOT, "device_idle_in_write.bulk")(run)
    turnover = spec.reader(ROOT, "device_idle_in_turnover.bulk")(run)
    assert idle == pytest.approx(45.0)
    assert launch == pytest.approx(10.0)  # [0.5, 1] and [6.5, 7]
    assert write == pytest.approx(15.0)  # [3, 4.5]
    assert turnover == pytest.approx(10.0)  # [9, 10]: no frame step open
    # the rest, 1 s, is idle inside job.infer but outside the launches
    assert idle - (launch + write + turnover) == pytest.approx(10.0)


def test_the_trace_keeps_busy_intervals_and_bridged_spans(tmp_path):
    events = [
        _x(traceio.WINDOW_SPAN, "user_annotation", 1000.0, 10000.0),
        _x("conv_kernel", "kernel", 2000.0, 2000.0, tid=7),
        _x("stream.launch", "user_annotation", 500.0, 1000.0, tid=5),
        _x("job.write", "user_annotation", 3000.0, 2000.0, tid=5),
        _x("job.infer", "user_annotation", 20000.0, 100.0, tid=5),
        _x("aten::add_", "cpu_op", 3100.0, 10.0, tid=5),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}, indent=2))
    # the scan of the text finds what parsing the whole file finds
    assert spans._scan(str(path)) == spans._parse(str(path))
    view = spans.read_trace(str(path))
    assert view.window_s == pytest.approx(0.01)
    assert view.busy == [pytest.approx((0.001, 0.003))]
    assert [(n, pytest.approx(a), pytest.approx(b), t) for n, a, b, t in view.spans] == [
        ("stream.launch", 0.0, 0.0005, 5), ("job.write", 0.002, 0.004, 5)]
    # cut as traceio cuts it, and its busy time the same
    cut = spans.read_trace(str(path), clip_s=0.0025)
    summary = traceio.reduce_trace(str(path), clip_s=0.0025)
    assert cut.window_s == pytest.approx(summary.window_s)
    assert spans.length(cut.busy) == pytest.approx(summary.busy_s)
    # the idle gaps' labels name the job thread's spans
    assert traceio.reduce_trace(str(path)).gaps[0][0] == "job.write"
    # keys in another order: the scan finds nothing, and the whole file is
    # parsed; a summary the scan disagrees with (a kernel it cannot see)
    # does the same
    shuffled = tmp_path / "shuffled.json"
    shuffled.write_text(json.dumps({"traceEvents": [dict(reversed(ev.items())) for ev in events]}))
    assert spans._scan(str(shuffled)) == []
    assert spans.read_trace(str(shuffled)) == view
    events.append({"ph": "X", "name": "hidden", "cat": "kernel", "ts": 6000.0, "dur": 1000.0})
    path.write_text(json.dumps({"traceEvents": events}))
    whole = spans.read_trace(str(path), expect=traceio.reduce_trace(str(path)))
    assert spans.length(whole.busy) == pytest.approx(0.003)


def test_a_traced_cpu_run_reads_the_spans_the_program_kept(tmp_path, capsys, monkeypatch):
    """The server keeps its spans while the harness's profiler runs and the
    readers find them; a CPU run has no device trace, so the idle shares
    stay out. The mix's ``trace_seconds``, below ``--seconds``, ends the
    traced window."""
    cell = "seg2d.timelapse"
    traffic = {**_tiny(cell), "trace_seconds": 3.0}
    runs = []

    class Kept(harness.Run):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            runs.append(self)

    monkeypatch.setattr(harness, "Run", Kept)
    # the inferrers cold, as in a run's own process, whatever ran before here
    infer.cached_frame_inferrer.cache_clear()
    infer.cached_batch_inferrer.cache_clear()
    out = tmp_path / "out.txt"
    with open(out, "w") as f, open(tmp_path / "err.txt", "w") as err:
        rc = harness.run_cell(ROOT, cell, 2**31 + 11, 6.0, True, time.perf_counter(),
                              device="cpu", traffic_override=traffic, out=f, err=err)
    errors = (tmp_path / "err.txt").read_text()
    assert rc == 0, errors[-3000:]
    assert tracing.active() is None
    (run,) = runs
    assert run.seconds == 3.0
    assert 0 < run.window_s <= 3.0
    assert "program spans:" in capsys.readouterr().err
    metrics = json.loads(out.read_text().splitlines()[-1])["metrics"]
    for name in ("deflate_ms_per_mvox", "job_turnover_ms_per_mvox", "launch_ms_per_mvox"):
        assert metrics[name]["value"] > 0, name
    # the window's 4-frame jobs run one 4-frame batch, the 2-frame warm-up a
    # 2-frame one: the window builds its inferrer once
    assert metrics["inferrer_builds"]["value"] == 1
    assert not any(name.startswith("device_idle") for name in metrics)
