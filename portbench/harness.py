"""One run of one cell: set-up, the measured window, the check, the result.

The job server under test, ``sequitr_tpu_torch.server.ImageServer``, runs
its ``run_forever`` loop in this process's main thread, as ``python -m
sequitr_tpu_torch serve`` runs it, with its jobs, models, outputs and log
under a fresh directory in ``TMPDIR``. A client thread plays the clients:
it submits a warm-up job of the cell's own shape, then the window's jobs as
``submit`` files them, watches each job's ``status.json`` at the traffic
mix's fixed interval, and ends the run with the real drain, SIGUSR1 to this
process.

What the harness knows of the model comes from the configuration's kind,
``portbench/kinds/<kind>.py`` (``spec.kind_of``): the weights it draws from
the seed, which are laid out in the models directory as ``import-model``
lays one out; the FLOPs a served voxel; the judge of the jobs' outputs.
The harness itself draws the seed's sample of completed jobs to judge and
counts ``missing``; the numbers compared for ``correct`` are the keys of
the cell's limits file.

Traffic is a closed backlog (``loop.kind: "closed"``): ``loop.queued`` jobs
kept queued beyond the running one; the window runs from the first timed
submission to the last completion within ``--seconds``, or within the mix's
``trace_seconds`` where that is shorter and the run is traced (the
profiler's trace grows with the work it sees). The client thread reads one
``status.json`` a job an interval, so its polling takes little interpreter
time from the server it shares the process with.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback
from typing import Dict, List, Optional

import numpy as np

from portbench import check, counts, inputs, spec, traceio

__all__ = ["Job", "Run", "run_cell", "FORBIDDEN_MODULES", "forbidden_loaded"]

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "sequitr_tpu")


def forbidden_loaded() -> List[str]:
    """Top-level names in ``sys.modules`` that the port must not load,
    compared whole (``sequitr_tpu_torch`` is not ``sequitr_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN_MODULES))


class Job:
    """One submitted job, as the client sees it."""

    def __init__(self, job_id: str, job_input: inputs.JobInput, output: str, voxels: int):
        self.id, self.input, self.output = job_id, job_input, output
        self.voxels = voxels
        self.done: Optional[float] = None
        self.state = "queued"
        self.error = ""
        self.phases: Dict[str, float] = {}
        self._mtime = None

    def poll(self) -> bool:
        """Read ``status.json`` if it changed; True once the job has ended."""
        path = os.path.join(self.output, "status.json")
        try:
            mtime = os.stat(path).st_mtime_ns
        except FileNotFoundError:
            return False
        if mtime == self._mtime:
            return False
        try:
            with open(path) as f:
                status = json.load(f)
        except (OSError, json.JSONDecodeError):
            return False  # mid-rename: read it again next time
        self._mtime = mtime
        state = status.get("state")
        if state not in ("complete", "failed", "cancelled"):
            return False
        self.done, self.state = time.perf_counter(), state
        if state == "complete":
            metrics = json.loads(status.get("outputs", {}).get("metrics", "{}"))
            self.phases = {k: float(v) for k, v in metrics.items() if k.endswith("_s") and
                           isinstance(v, (int, float))}
        else:
            self.error = status.get("error", "")
        return True


class Run:
    """What a run measured; the metric readers (``metrics/<name>.py``)
    read it. ``seconds``: the longest the window may last; ``ended``: every
    job that ended inside the window; ``done``: those that completed, in
    completion order."""

    def __init__(self, cell: Dict, config: Dict, traffic: Dict, seed: int, seconds: float,
                 flops_per_voxel: float):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds = seed, seconds
        self.process_start = 0.0
        self.setup_s = 0.0
        self.window_s = 0.0
        self.ended: List[Job] = []
        self.trace: Optional[traceio.TraceSummary] = None
        self.flops_per_voxel = flops_per_voxel
        self.stored_bytes_per_voxel = counts.quantile_pass_bytes_per_voxel(
            traffic["input"]["dtype"])

    @property
    def done(self) -> List[Job]:
        return sorted((j for j in self.ended if j.state == "complete"), key=lambda j: j.done)

    @property
    def served_voxels(self) -> int:
        return sum(j.voxels for j in self.done)


class _Clients(threading.Thread):
    """The clients: warm-up, the window's traffic, the drain."""

    def __init__(self, run: Run, jobs_dir: str, run_dir: str, job_inputs, warmup, trace: bool,
                 trace_path: str, drained: Dict):
        super().__init__(name="portbench-clients", daemon=True)
        self.record, self.jobs_dir, self.run_dir = run, jobs_dir, run_dir
        self.job_inputs, self.warmup, self.trace = job_inputs, warmup, trace
        self.trace_path, self.drained = trace_path, drained
        self.error: Optional[str] = None
        self.export_s = 0.0
        t = run.traffic
        self.interval = float(t["watch_interval_s"])
        self.item_voxels = int(np.prod(t["input"]["shape"]))

    # -- jobs ---------------------------------------------------------------
    def _job(self, name: str, job_input: inputs.JobInput) -> Job:
        out = os.path.join(self.run_dir, "out", name)
        return Job(name, job_input, out, self.item_voxels * len(job_input.items))

    def _submit(self, job: Job) -> None:
        from sequitr_tpu_torch.server import jobs as jobs_lib

        t = self.record.traffic
        job_spec = {
            "module": t["module"],
            "params": {**t["params"], "model": self.record.config["name"]},
            "input": [job.input.path],
            "output": job.output,
        }
        jobs_lib.submit_job(self.jobs_dir, job_spec, job_id=job.id)

    def _wait(self, job: Job, timeout: float) -> None:
        deadline = time.perf_counter() + timeout
        while not job.poll():
            if time.perf_counter() > deadline:
                raise TimeoutError(f"job {job.id} did not end within {timeout} s")
            time.sleep(self.interval)
        if job.state != "complete":
            raise RuntimeError(f"job {job.id} ended {job.state}: {job.error}")

    # -- the run ------------------------------------------------------------
    def run(self) -> None:
        prof = None
        try:
            warm = self._job("warmup", self.warmup)
            self._submit(warm)
            self._wait(warm, timeout=1200.0)
            if self.trace:
                prof = _start_profiler()
            import torch

            t0 = time.perf_counter()
            self.record.setup_s = t0 - self.record.process_start
            kind = self.record.traffic["loop"]["kind"]
            if kind != "closed":
                raise ValueError(f"loop kind {kind!r}: the harness drives closed backlogs")
            with torch.profiler.record_function(traceio.WINDOW_SPAN):
                self._closed(t0)
            if prof is not None:
                t_export = time.perf_counter()
                prof.stop()
                prof.export_chrome_trace(self.trace_path)
                prof = None
                self.export_s = time.perf_counter() - t_export
        except BaseException:
            self.error = traceback.format_exc()
        finally:
            if prof is not None:
                try:
                    prof.stop()
                except Exception:
                    pass
            self.drained["drain"] = True
            os.kill(os.getpid(), signal.SIGUSR1)

    def _closed(self, t0: float) -> None:
        run = self.record
        depth = int(run.traffic["loop"]["queued"]) + 1
        end = t0 + run.seconds
        outstanding: List[Job] = []
        k = 0
        last = None
        while True:
            now = time.perf_counter()
            while now < end and len(outstanding) < depth:
                job = self._job(f"j{k:05d}", self.job_inputs[k % len(self.job_inputs)])
                self._submit(job)
                outstanding.append(job)
                k += 1
            for job in [j for j in outstanding if j.poll()]:
                outstanding.remove(job)
                if job.done <= end:
                    run.ended.append(job)
                    if job.state == "complete":
                        last = job.done
            if now >= end:
                break
            time.sleep(self.interval)
        if last is None:
            raise RuntimeError(f"no job completed within {run.seconds} s")
        run.window_s = last - t0


def _start_profiler():
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    try:
        config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
        prof = profile(activities=activities, experimental_config=config)
    except (AttributeError, TypeError):
        prof = profile(activities=activities)
    prof.start()
    return prof


def _install_model(cfg: Dict, server_kind: str, flat: Dict[str, np.ndarray],
                   models_dir: str) -> str:
    """Lay the model out in ``models_dir`` as the job server reads one and
    ``import-model`` writes one: ``<name>/config.json`` (the configuration's
    ``model`` block and the kind the server builds it as, ``__kind__``)
    beside ``<name>/weights.npz`` (the flat layout). ``import-model --arch``
    keeps the JAX command's fields, which leave out ``features_cap``, so the
    layout is written here. Returns the weight file, which the judge reads
    too."""
    model_dir = os.path.join(models_dir, cfg["name"])
    os.makedirs(model_dir)
    npz = os.path.join(model_dir, "weights.npz")
    np.savez(npz, **flat)
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump({**cfg["model"], "__kind__": server_kind}, f)
    return npz


def _card() -> Dict:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        ).stdout.strip().splitlines()
        name, limit = out[0].rsplit(",", 1)
        return {"name": name.strip(), "power_limit": limit.strip()}
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return {"name": "unread", "power_limit": "unread"}


def _io_written() -> Dict[str, int]:
    try:
        with open("/proc/self/io") as f:
            fields = dict(line.split(": ") for line in f.read().splitlines())
        return {k: int(fields[k]) for k in ("wchar", "write_bytes")}
    except (OSError, KeyError, ValueError):
        return {}


def run_cell(root: str, workload: str, seed: int, seconds: float, trace: bool,
             process_start: float, device: str = "cuda", traffic_override: Optional[Dict] = None,
             out=sys.stdout, err=sys.stderr) -> int:
    """One run; prints the result line on ``out``, the checks on ``err``.
    Returns the exit code. ``device="cpu"`` and ``traffic_override`` serve
    the CPU tests only."""
    import torch

    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, workload)
    cfg = spec.config_of(bench, root, cell["config"])
    traffic = traffic_override or spec.traffic_of(root, cell["traffic"])
    limits = spec.limits_of(root, workload)
    kind = spec.kind_of(root, cfg["kind"])
    window = min(seconds, float(traffic["trace_seconds"])) if trace else seconds
    run = Run(cell, cfg, traffic, seed, window, kind.flops_per_voxel(cfg))
    run.process_start = process_start

    from sequitr_tpu_torch.config import ServerConfiguration
    from sequitr_tpu_torch.server import ImageServer

    run_dir = tempfile.mkdtemp(prefix="portbench-")
    try:
        items, job_inputs, warmup = inputs.build_inputs(traffic["input"], seed, run_dir)
        models_dir = os.path.join(run_dir, "models")
        jobs_dir = os.path.join(run_dir, "jobs")
        npz = _install_model(cfg, kind.SERVER_KIND, kind.make_flat(cfg, seed, device, root),
                             models_dir)
        server = ImageServer(ServerConfiguration(
            jobs_dir=jobs_dir, models_dir=models_dir, log_dir=os.path.join(run_dir, "log"),
            poll_interval=float(traffic["server"]["poll_interval"]), device=device,
        ))
        drained: Dict = {}
        previous = signal.signal(signal.SIGUSR1, lambda *_: drained.update(drain=True))
        clients = _Clients(run, jobs_dir, run_dir, job_inputs, warmup, trace,
                         os.path.join(run_dir, "trace.json"), drained)
        clients.start()
        try:
            server.run_forever(early_drain=drained)
        finally:
            signal.signal(signal.SIGUSR1, previous)
        clients.join()
        if clients.error:
            print(f"portbench: the run failed:\n{clients.error}", file=err)
            return 1
        cuda = device == "cuda"
        peak = int(torch.cuda.max_memory_allocated(0)) if cuda else 0
        if trace:
            t_reduce = time.perf_counter()
            run.trace = traceio.reduce_trace(clients.trace_path, clip_s=run.window_s)
            print(f"portbench: trace of {os.path.getsize(clients.trace_path)} bytes exported in "
                  f"{clients.export_s:.3f} s, reduced in {time.perf_counter() - t_reduce:.3f} s",
                  file=err)
        metrics = {}
        for m in spec.metrics_of(bench, workload, trace):
            value = spec.reader(root, m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        del server
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        readings = _judge(run, kind, items, npz, device)
        found = forbidden_loaded()
        if found:
            print(f"portbench: modules that must not load were loaded: {found}", file=err)
            return 2
        compared = [name for name in limits if name != "readings"]
        absent = [name for name in compared if name not in readings]
        if absent:
            print(f"portbench: portbench/limits/{workload}.json names {absent}, which the "
                  f"{cfg['kind']!r} kind's judge does not give (it gives {sorted(readings)})",
                  file=err)
            return 4
        card = _card() if cuda else {"name": "cpu", "power_limit": "none"}
        written = _io_written()
        print(
            f"portbench: {workload} seed {seed}: {len(run.done)} jobs done of {len(run.ended)} ended, "
            f"window {run.window_s:.6f} s, set-up {run.setup_s:.6f} s, watch interval "
            f"{clients.interval} s; "
            f"memory_peak_bytes {peak}; written {written}; card {card}",
            file=err,
        )
        device_info = {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": int(cell["chips"]),
            "memory_peak_bytes": peak,
        }
        result = {
            "correct": None, "attempted": len(run.ended),
            "failed": sum(1 for j in run.ended if j.state != "complete"),
            "metrics": metrics, "device": device_info,
        }
        if trace and run.trace is not None:
            device_info["busy_s"] = run.trace.busy_s
            device_info["window_s"] = run.trace.window_s
            result["breakdown"] = {
                "device_ops": run.trace.device_ops(),
                "idle_gaps": [[name, s] for name, s in run.trace.gaps],
            }
        result["card"] = card
        numbers = {
            name: {"value": readings[name], "limit": limits[name]}
            for name in compared
        }
        result["correct"] = all(n["value"] <= n["limit"] for n in numbers.values())
        result["check"] = numbers
        print(f"portbench: written bytes {written}, memory_peak_bytes {peak}", file=out)
        print(json.dumps(result), file=out)
        for name, n in numbers.items():
            print(f"check {name} {n['value']!r} limit {n['limit']!r}", file=err)
        out.flush()
        return 0
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def _judge(run: Run, kind, items: np.ndarray, npz: str, device) -> Dict[str, float]:
    """``missing`` and the kind's judge's readings of a sample of the
    window's completed jobs, drawn from the seed, the last one always in it,
    on the weight file ``npz``."""
    missing = sum(1 for j in run.ended if j.state != "complete")
    done = run.done
    with np.load(npz) as z:
        flat = {k: z[k] for k in z.files}
    judge = kind.judge(run.config, run.traffic, items, flat, device)
    for i in check.sample_jobs(len(done), int(run.traffic["check_jobs"]), run.seed):
        judge.add(done[i].output, done[i].input.items)
    return {"missing": missing, **judge.readings()}
