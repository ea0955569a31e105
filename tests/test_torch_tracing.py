"""The port's in-process tracer (``sequitr_tpu_torch.tracing``): off, a
span is one shared no-op; on, spans carry their parent, thread and job id,
the buffer is bounded, ``PhaseTimer``'s sums do not change, the Chrome
export is well formed, a span lands in a running ``torch.profiler`` trace
around the ops it encloses, and a job served with ``trace_spans`` writes
``spans.json``."""

import itertools
import json
import os
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

from sequitr_tpu_torch import tracing, utils
from sequitr_tpu_torch.config import ServerConfiguration
from sequitr_tpu_torch.data import synthetic, tiff
from sequitr_tpu_torch.models import unet
from sequitr_tpu_torch.pipeline import infer
from sequitr_tpu_torch.server import ImageServer, save_model, submit_job


@pytest.fixture(autouse=True)
def _tracing_off():
    """Every test starts and ends with tracing off."""
    torch.set_num_threads(1)
    tracing.disable()
    yield
    tracing.disable()


def test_off_span_is_the_shared_noop_and_reads_no_clock(monkeypatch):
    def no_clock():
        raise AssertionError("the off path read the clock")

    monkeypatch.setattr(time, "perf_counter_ns", no_clock)
    assert tracing.span("stream.launch") is tracing.NOOP
    assert tracing.span("server.poll", found=None) is tracing.NOOP
    assert tracing.job("j") is tracing.NOOP
    with tracing.span("tiff.deflate") as s:
        s.set(found="j")
    tracing.count("inferrer.builds")

    def fn():
        return 1

    assert tracing.bind(fn) is fn
    assert tracing.active() is None


def test_off_span_allocates_nothing():
    """The off ``span(...)`` call leaves the traced peak where an empty loop
    leaves it (a new object a call would raise it); the ``with`` statement
    around it allocates as it does for any context manager."""

    def bare(n):
        for _ in itertools.repeat(None, n):
            pass

    def spans(n):
        for _ in itertools.repeat(None, n):
            tracing.span("stream.launch", frame=None)
            tracing.span("stream.launch")

    def peak(loop):
        loop(10)
        tracemalloc.start()
        try:
            tracemalloc.reset_peak()
            loop(10_000)
            return tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()

    # the least of three: another thread's allocation can only raise a peak
    assert min(peak(spans) for _ in range(3)) == min(peak(bare) for _ in range(3))


def test_spans_nest_under_their_parent_with_thread_and_job():
    tracer = tracing.enable()
    with tracing.job("j1"):
        with tracing.span("job.infer"):
            with tracing.span("stream.launch", frame=0):
                pass
        with tracing.span("job.write") as w:
            w.set(frames=1)
    with tracing.span("server.poll"):
        pass
    infer_, launch, write, poll = sorted(tracer.spans(), key=lambda r: r.start_ns)
    assert [r.name for r in (infer_, launch, write, poll)] == [
        "job.infer", "stream.launch", "job.write", "server.poll"]
    assert launch.parent == infer_.id and infer_.parent is None and write.parent is None
    assert infer_.start_ns <= launch.start_ns <= launch.end_ns <= infer_.end_ns
    assert launch.attrs == {"frame": 0} and write.attrs == {"frames": 1}
    assert {r.job for r in (infer_, launch, write)} == {"j1"} and poll.job is None
    assert {r.tid for r in tracer.spans()} == {threading.get_native_id()}


def test_the_job_id_reaches_the_frame_reader_thread():
    tracer = tracing.enable()
    with tracing.job("j7"):
        assert list(infer._iter_read_ahead(iter(range(3)), 2)) == [0, 1, 2]
    reads = [r for r in tracer.spans() if r.name == "frame.read"]
    waits = [r for r in tracer.spans() if r.name == "stream.read_wait"]
    assert len(reads) == 4 and len(waits) == 4  # three frames and the end
    assert {(r.job, r.thread) for r in reads} == {("j7", "frame-reader")}
    assert {r.job for r in waits} == {"j7"}
    assert {r.tid for r in reads}.isdisjoint({r.tid for r in waits})


def test_the_buffer_keeps_the_newest_and_counts_what_it_drops():
    tracer = tracing.enable(capacity=3)
    for i in range(5):
        with tracing.span(f"s{i}"):
            pass
    tracing.count("inferrer.builds", 2)
    assert [r.name for r in tracer.spans()] == ["s3", "s4"]
    assert [(c.name, c.n, c.total) for c in tracer.counts()] == [("inferrer.builds", 2, 2)]
    assert tracer.dropped == 3


def test_phase_timer_sums_are_the_same_on_and_off(monkeypatch):
    def timed():
        ticks = iter(range(100))
        monkeypatch.setattr(utils.time, "perf_counter", lambda: 0.25 * next(ticks))
        timer = utils.PhaseTimer()
        for _ in range(3):
            with timer.phase("infer"):
                pass
            with timer.phase("write"):
                pass
        return timer.summary(), timer.total("infer", "write"), timer.total("fetch")

    off = timed()
    tracer = tracing.enable()
    on = timed()
    assert on == off == ({"infer_s": 0.75, "write_s": 0.75}, 1.5, 0)
    assert [r.name for r in tracer.spans()] == ["job.infer", "job.write"] * 3


def test_the_chrome_export_is_well_formed(tmp_path):
    tracer = tracing.enable()
    with tracing.job("j3"), tracing.span("server.job"):
        with tracing.span("server.status"):
            pass
        tracing.count("inferrer.builds")
    path = str(tmp_path / "spans.json")
    tracer.write_chrome(path)
    with open(path) as f:
        trace = json.load(f)
    by_ph = {}
    for ev in trace["traceEvents"]:
        by_ph.setdefault(ev["ph"], []).append(ev)
    spans = {ev["name"]: ev for ev in by_ph["X"]}
    assert set(spans) == {"server.job", "server.status"}
    outer, inner = spans["server.job"], spans["server.status"]
    assert outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
    assert inner["args"]["parent"] == outer["args"]["id"] and inner["args"]["job"] == "j3"
    assert [ev["args"] for ev in by_ph["C"]] == [{"inferrer.builds": 1}]
    assert by_ph["M"][0]["args"]["name"] == threading.current_thread().name
    assert trace["otherData"]["dropped"] == 0


def test_a_span_lands_in_the_profilers_trace_around_its_ops(tmp_path):
    """One clock: under a CPU ``torch.profiler`` session the span is a
    ``user_annotation`` that contains its own aten op; a span that encloses
    a whole job stays out of the trace."""
    from torch.profiler import ProfilerActivity, profile

    tracing.enable()
    x = torch.ones(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.span("server.job"):
            with tracing.span("stream.launch"):
                x.add_(1)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [ev for ev in json.load(f)["traceEvents"] if ev.get("ph") == "X"]
    notes = [ev for ev in events if ev.get("cat") == "user_annotation"]
    assert [ev["name"] for ev in notes] == ["stream.launch"]
    note = notes[0]
    adds = [ev for ev in events if ev.get("cat") == "cpu_op" and ev["name"] == "aten::add_"]
    assert len(adds) == 1 and adds[0]["tid"] == note["tid"]
    assert note["ts"] <= adds[0]["ts"]
    assert adds[0]["ts"] + adds[0]["dur"] <= note["ts"] + note["dur"]


# every span a CPU job records; ``stream.fetch_wait`` waits on a CUDA
# event, which a CPU job has none of
SERVED_SPANS = {
    "server.poll", "server.job", "server.status", "server.ledger",
    "job.infer", "job.fetch", "job.write", "job.localize",
    "stream.read_wait", "stream.launch", "tiff.deflate", "frame.read",
}


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """``tests/test_torch_server.py``'s model and stack built in the port
    alone (its fixture draws them through the JAX package, ten seconds of
    set-up): a depth-2, 8-feature f32 U-Net and a 3-frame 64x64 uint16
    stack, served through the frame-batch path."""
    tmp = tmp_path_factory.mktemp("traced")
    cfg = unet.UNetConfig(depth=2, base_features=8, compute_dtype="float32")
    torch.manual_seed(0)
    models = str(tmp / "models")
    save_model(models, "seg", "unet", cfg, unet.init(cfg, device="cpu"))
    frames = np.stack(
        [synthetic.cells_frame(424_100 + i, (64, 64))[0] for i in range(3)]
    ).clip(0, 65535).astype(np.uint16)
    stack = str(tmp / "stack.tif")
    tiff.write_stack(stack, frames)
    return dict(torch_models=models, stack=stack)


@pytest.mark.parametrize("trace_spans", [True, False])
def test_a_served_job_writes_its_spans_only_when_asked(env, tmp_path, trace_spans):
    infer.cached_batch_inferrer.cache_clear()  # the job builds its inferrer
    cfg = ServerConfiguration(
        jobs_dir=str(tmp_path / "jobs"), models_dir=env["torch_models"],
        log_dir=str(tmp_path / "log"), device="cpu", trace_spans=trace_spans,
    )
    server = ImageServer(cfg)
    out = str(tmp_path / "out")
    job_id = submit_job(cfg.jobs_dir, {
        "module": "segmentation_unet2d",
        "params": {"model": "seg", "compress_output": True},
        "input": [env["stack"]], "output": out,
    })
    assert server.poll_once()
    server.close()
    with open(os.path.join(out, "status.json")) as f:
        assert json.load(f)["state"] == "complete"
    path = os.path.join(cfg.log_dir, "spans.json")
    assert tracing.active() is None
    if not trace_spans:
        assert not os.path.exists(path)
        return
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = [ev for ev in events if ev["ph"] == "X"]
    # the job thread waits on the deflate pool only where a frame's
    # deflate is still running when the writer needs it
    assert {ev["name"] for ev in spans} - {"tiff.deflate_wait"} == SERVED_SPANS
    poll = next(ev for ev in spans if ev["name"] == "server.poll")
    assert poll["args"]["found"] == job_id and poll["args"]["job"] is None
    assert {ev["args"]["job"] for ev in spans if ev["name"] != "server.poll"} == {job_id}
    counts = [ev for ev in events if ev["ph"] == "C"]
    assert [ev["args"][ev["name"]] for ev in counts if ev["name"] == "inferrer.builds"] == [1]
    # the 3 label frames, each handed to the deflate pool
    pooled = [ev["args"][ev["name"]] for ev in counts if ev["name"] == "tiff.deflate_pooled"]
    assert pooled == [1, 2, 3]
    assert {ev["name"] for ev in counts} == {"inferrer.builds", "tiff.deflate_pooled"}


def test_a_profiled_server_keeps_its_spans_while_the_profiler_runs(env, tmp_path):
    """Without ``trace_spans``, a claim made while a ``torch.profiler``
    session runs turns spans on: the job's spans stay in memory
    (``tracing.latest()``), land in the session's trace, and no
    ``spans.json`` is written; the first claim after the session ends turns
    them off."""
    from torch.profiler import ProfilerActivity, profile

    cfg = ServerConfiguration(
        jobs_dir=str(tmp_path / "jobs"), models_dir=env["torch_models"],
        log_dir=str(tmp_path / "log"), device="cpu",
    )
    server = ImageServer(cfg)

    def serve():
        out = str(tmp_path / f"out{len(os.listdir(cfg.jobs_dir))}")
        job_id = submit_job(cfg.jobs_dir, {
            "module": "segmentation_unet2d", "params": {"model": "seg"},
            "input": [env["stack"]], "output": out,
        })
        assert server.poll_once()
        return job_id

    # the job runs on a thread of its own, which a session sees only when
    # it profiles every thread
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU], experimental_config=config) as prof:
        job_id = serve()
    tracer = tracing.active()
    assert tracer is not None and tracing.latest() is tracer
    kept = tracer.spans()
    assert {r.job for r in kept if r.name != "server.poll"} == {job_id}
    assert {"server.job", "job.infer", "job.write", "stream.launch"} <= {r.name for r in kept}
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        notes = {ev["name"] for ev in json.load(f)["traceEvents"]
                 if ev.get("cat") == "user_annotation"}
    assert {"job.infer", "job.write", "stream.launch"} <= notes and "server.job" not in notes
    second = serve()
    assert tracing.active() is None and tracing.latest() is tracer
    # only the claim that found the session gone
    last = tracer.spans()[len(kept):]
    assert [(r.name, r.attrs["found"]) for r in last] == [("server.poll", second)]
    server.close()
    assert not os.path.exists(os.path.join(cfg.log_dir, "spans.json"))
