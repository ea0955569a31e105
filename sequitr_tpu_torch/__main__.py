"""Command-line interface: ``python -m sequitr_tpu_torch <command>``.

The commands of ``python -m sequitr_tpu``, with the same arguments and the
same output lines (the program's name aside):
  serve        — run the watched-directory image server on ``--device``
                 (default ``cuda``; ``cpu`` must be asked for); ``--workers
                 N`` supervises one worker process per card
  submit       — file a job JSON (or a workflow list) into a jobs directory
  status       — print a job's status (+ live progress; --follow tails it)
  models       — list registered models
  queue        — show pending/running/failed/rejected jobs
  cancel       — withdraw a queued job, or stop a RUNNING one at its next
                 frame/step
  drain        — graceful rolling restart: finish running jobs, leave the
                 queue, exit
  retry        — re-queue a failed job
  stats        — summarize the server's jobs.jsonl ledger
  info         — version, torch/CUDA and devices, native status, pipelines
  doctor       — health report with BOUNDED device probes (a dead card is
                 a diagnosis, not a hang)
  import-model / export-model — weight interchange: the flat npz that
                 ``python -m sequitr_tpu export-model`` writes and
                 ``python -m sequitr_tpu import-model`` reads (TF and torch
                 kernel layouts by ``--layout``)

Nothing here imports torch before ``main`` has installed the early drain
handler, so a ``serve`` process that is still booting keeps a SIGUSR1.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import time

PROG = "sequitr_tpu_torch"


def _block_drain_signal() -> None:
    """``preexec_fn`` of a supervised worker: SIGUSR1 stays blocked across
    the exec until the worker's ``main`` has installed its handler (a drain
    forwarded while the worker's interpreter starts is held, not fatal);
    nothing else is (the supervisor holds SIGTERM while it spawns)."""
    signal.pthread_sigmask(signal.SIG_SETMASK, {signal.SIGUSR1})


def _serve_workers(args, early_drain) -> int:
    """Supervise N single-claimer worker processes over one jobs dir.

    The queue's atomic rename-claims make concurrent claimers safe, so
    scaling serving across cards is one process per card sharing the
    watched directory. Each worker gets SEQUITR_WORKER_ID=<i> and, with
    --pin-env VAR, VAR=<i> (e.g. CUDA_VISIBLE_DEVICES) so each binds one
    card; every worker gets the supervisor's --device. Crashed workers are
    restarted with a capped budget; SIGINT/SIGTERM tear everyone down.
    """
    import subprocess

    base = [
        sys.executable, "-m", PROG, "serve",
        "--jobs-dir", args.jobs_dir, "--models-dir", args.models_dir,
        "--poll-interval", str(args.poll_interval), "--workers", "1",
    ]
    if args.config:
        base += ["--config", args.config]
    if args.device:
        base += ["--device", args.device]
    if args.trace_spans:
        base += ["--trace-spans"]
    log = logging.getLogger(f"{PROG}.supervisor")

    def spawn(i):
        env = dict(os.environ, SEQUITR_WORKER_ID=str(i))
        if args.pin_env:
            env[args.pin_env] = str(i)
        return subprocess.Popen(base, env=env, preexec_fn=_block_drain_signal)

    # SIGTERM (systemd stop, subprocess .terminate(), docker stop) must tear
    # the workers down exactly like Ctrl-C — otherwise they outlive the
    # supervisor as orphans still claiming jobs. Installed BEFORE spawning
    # so there is no startup window where a TERM orphans fresh workers.
    def _term(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)

    # SIGUSR1 = graceful drain (rolling restart): forward it to every live
    # worker (each finishes its current job, then exits 0 — see
    # ImageServer.run_forever), stop respawning, and return once all have
    # left. The queue is untouched; a new supervisor picks it up.
    # procs/restarts are bound BEFORE the handler is installed (a signal
    # in the gap must not hit an unbound name), and spawn_tracked()
    # re-forwards the signal to any worker created while the drain was
    # already on (a respawn racing the handler would otherwise never hear
    # it). A drain that reached this process while it booted spawns none.
    procs = {}
    restarts = {}
    draining = {"on": False, "dirty": False}

    def spawn_tracked(i):
        # SIGTERM/SIGINT wait until the new worker is in procs: a teardown
        # that landed inside Popen would orphan it, still claiming jobs
        held = signal.pthread_sigmask(signal.SIG_BLOCK, {signal.SIGTERM, signal.SIGINT})
        try:
            procs[i] = p = spawn(i)
            if draining["on"]:
                try:
                    p.send_signal(signal.SIGUSR1)
                except OSError:
                    pass
        finally:
            signal.pthread_sigmask(signal.SIG_SETMASK, held)

    def _drain(signum, frame):
        draining["on"] = True
        log.info("drain requested: forwarding to workers, no respawns")
        for p in procs.values():
            if p.poll() is None:
                try:
                    p.send_signal(signal.SIGUSR1)
                except OSError:
                    pass

    try:
        signal.signal(signal.SIGUSR1, _drain)
    except (ValueError, OSError, AttributeError):
        pass
    if early_drain.get("drain"):
        draining["on"] = True
        log.info("drain requested while booting: spawning no workers")

    try:
        for i in range(args.workers):
            if draining["on"] and not procs:
                break
            restarts[i] = 0
            spawn_tracked(i)
        log.info("supervising %d workers on %s", len(procs), args.jobs_dir)
        while procs:
            for i, p in list(procs.items()):
                code = p.poll()
                if code is None:
                    continue
                if draining["on"]:
                    if code == 0:
                        log.info("worker %d drained (exit 0)", i)
                    else:
                        # a crash DURING the drain: its in-flight job was
                        # not finished (it awaits stale-claim reclaim) —
                        # the drain's exit code must not attest success
                        log.error(
                            "worker %d exited %s during drain; its job "
                            "(if any) awaits reclaim", i, code,
                        )
                        draining["dirty"] = True
                    del procs[i]
                    continue
                from sequitr_tpu_torch.server.server import EXIT_RECYCLE

                if code == EXIT_RECYCLE:
                    # deliberate post-watchdog recycle: the worker freed its
                    # card from a wedged job's abandoned thread. The job is
                    # already marked failed; respawn WITHOUT charging the
                    # crash budget (each recycle makes queue progress, so
                    # this cannot loop on one job).
                    log.warning("worker %d recycled after job timeout; respawning", i)
                    spawn_tracked(i)
                    continue
                if restarts[i] >= 3:
                    # budget spent: give this worker up for good instead of
                    # re-logging a dead Popen every tick
                    log.error("worker %d exited (%s); restart budget spent", i, code)
                    del procs[i]
                    continue
                restarts[i] += 1
                log.warning("worker %d exited (%s); restarting", i, code)
                spawn_tracked(i)
            time.sleep(0.2 if draining["on"] else 1.0)
        if draining["on"]:
            if draining["dirty"]:
                log.error("drain finished with crashed worker(s); exit 1")
                return 1
            log.info("all workers drained; supervisor exiting")
            return 0
        log.error("all workers dead; supervisor exiting")
        return 1
    except KeyboardInterrupt:
        # a second SIGTERM during teardown must not re-raise mid-loop and
        # skip terminate()/wait() for the remaining workers (orphans) —
        # ignore further TERMs once cleanup has begun
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        for p in procs.values():
            p.terminate()
        for p in procs.values():
            p.wait()
        return 0


def _follow_job(output_dir: str, poll: float, expect_id=None) -> int:
    """Live-tail a job: one line per progress update, final status, exit
    code from the terminal state. ``expect_id``: ignore status/progress rows
    of OTHER runs into the same output dir."""
    path = os.path.join(output_dir, "status.json")
    ppath = os.path.join(output_dir, "progress.json")
    last_update = None
    waiting_noted = False
    while True:
        try:
            with open(path) as f:
                status = json.load(f)
        except (OSError, ValueError):
            status = None  # not started yet (or mid-write)
        if (
            status is not None and expect_id is not None
            and status.get("id") != expect_id
        ):
            status = None  # a PREVIOUS run's marker: keep waiting
        if status is None and not waiting_noted:
            print(
                f"waiting for {path} (job not started yet, or wrong "
                "output dir?)", file=sys.stderr,
            )
            waiting_noted = True
        try:
            with open(ppath) as f:
                prog = json.load(f)
        except (OSError, ValueError):
            prog = None
        if prog and expect_id is not None and prog.get("id") != expect_id:
            prog = None
        if prog and prog.get("updated") != last_update:
            last_update = prog.get("updated")
            phase = prog.get("phase", "frames")
            line = f"{phase} {prog.get('done', 0)}"
            if prog.get("total") is not None:
                line += f"/{prog['total']}"
            rate = prog.get(f"{phase}_per_sec")
            if rate is not None:
                line += f"  ({rate}/s)"
            print(line, flush=True)
        state = (status or {}).get("state")
        if state in ("complete", "failed", "cancelled"):
            print(json.dumps(status, indent=2))
            return 0 if state == "complete" else 1
        time.sleep(poll)


def _proc_alive(pid: int) -> bool:
    """Zombie-aware process liveness (shared by drain and doctor).

    NOT bare os.kill(pid, 0): that succeeds on a ZOMBIE — an exited serve
    whose parent has not reaped it yet — and raises PermissionError for a
    LIVE process owned by someone else. /proc state Z means
    exited-for-our-purposes; kill(0) is only the no-/proc fallback.
    """
    try:
        with open(f"/proc/{pid}/stat") as f:
            state = f.read().rsplit(")", 1)[1].split()[0]
        return state != "Z"
    except (OSError, IndexError):
        pass  # no /proc (or racing exit): fall back to kill(0)
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False
    except PermissionError:
        return True  # exists, owned by someone else


def _count_models(models_dir: str) -> int:
    if not os.path.isdir(models_dir):
        return 0
    return sum(
        os.path.exists(os.path.join(models_dir, d, "config.json"))
        for d in os.listdir(models_dir)
    )


_DOCTOR_PROBE = """\
import json, sys, time
mode = sys.argv[1]
import torch
t0 = time.time()
if mode == "cpu":
    dev, n, kind = torch.device("cpu"), 1, "cpu"
else:
    torch.cuda.init()
    dev, n = torch.device("cuda"), torch.cuda.device_count()
    kind = torch.cuda.get_device_name(0)
init_s = time.time() - t0
t0 = time.time()
x = torch.ones((256, 256), dtype=torch.float32, device=dev)
float((x @ x).sum())
matmul_s = time.time() - t0
print(json.dumps({
    "backend": dev.type, "n_devices": n, "kind": kind,
    "init_s": round(init_s, 3), "matmul_s": round(matmul_s, 3),
}))
"""


def _cmd_doctor(args) -> int:
    """Environment/health report with BOUNDED device probes.

    CUDA initialization against a card in a bad state can block. Each doctor probe therefore runs in a subprocess under a
    timeout, so the report always completes and a dead card is a diagnosis,
    not a hang. Exit code 0 = all checks passed, 1 = at least one [FAIL]
    (on a host without a card the accelerator check fails).
    """
    import importlib.util
    import platform
    import subprocess
    import tempfile

    import numpy as np

    from sequitr_tpu_torch import __version__

    failed = []

    def emit(ok, name, detail, warn=False):
        tag = "ok  " if ok else ("warn" if warn else "FAIL")
        if not ok and not warn:
            failed.append(name)
        print(f"[{tag}] {name}: {detail}")

    print(f"{PROG} {__version__} | python {platform.python_version()} | "
          f"numpy {np.__version__}")

    def probe(mode):
        t0 = time.time()
        try:
            res = subprocess.run(
                [sys.executable, "-c", _DOCTOR_PROBE, mode],
                capture_output=True, text=True, timeout=args.timeout,
            )
        except subprocess.TimeoutExpired:
            return None, f"probe timed out after {args.timeout:.0f}s"
        if res.returncode != 0:
            tail = (res.stderr or "").strip().splitlines()
            return None, f"probe crashed: {tail[-1] if tail else '?'}"
        try:
            info = json.loads(res.stdout.strip().splitlines()[-1])
        except (ValueError, IndexError):
            return None, "probe produced no report"
        info["wall_s"] = round(time.time() - t0, 1)
        return info, None

    info, err = probe("cuda")
    if info is None:
        emit(False, "accelerator backend",
             f"UNREACHABLE ({err}) - no card, or the card is down? Serving jobs "
             "on the card would fail; --device cpu still serves on the CPU "
             "if the cpu check below passes")
    else:
        emit(True, "accelerator backend",
             f"{info['backend']} x{info['n_devices']} ({info['kind']}), "
             f"init_s {info['init_s']}, matmul_s {info['matmul_s']}")
    info, err = probe("cpu")
    if info is None:
        emit(False, "cpu", f"UNREACHABLE ({err})")
    else:
        emit(True, "cpu",
             f"{info['n_devices']} device(s), init_s {info['init_s']}, "
             f"matmul_s {info['matmul_s']}")

    from sequitr_tpu_torch import native

    native_ok = native.available()
    emit(native_ok, "native helpers",
         "C++ library built (ccl, label stats, crc32c, LZW)" if native_ok
         else "unavailable - scipy/python fallbacks active (slower "
              "localization + compressed ingest)", warn=True)

    for mod, why in [
        ("PIL", "exotic-TIFF ingest fallback"),
        ("h5py", "objects.h5 localization export"),
        ("tensorflow", "TFRecord interchange tests / keras parity"),
    ]:
        present = importlib.util.find_spec(mod) is not None
        emit(present, f"optional: {mod}",
             f"present ({why})" if present else f"absent - {why} disabled",
             warn=True)

    if args.jobs_dir:
        jd = args.jobs_dir
        if not os.path.isdir(jd):
            emit(False, "jobs dir", f"{jd} does not exist")
        else:
            try:
                with tempfile.NamedTemporaryFile(dir=jd, prefix=".doctor-"):
                    pass
                emit(True, "jobs dir", f"{jd} writable")
            except OSError as e:
                emit(False, "jobs dir", f"{jd} not writable: {e}")
            names = os.listdir(jd)
            queued = sum(
                n.startswith("job_") and n.endswith(".json") for n in names
            )
            running = sum(n.endswith(".running") for n in names)
            rejected = sum(n.endswith(".rejected") for n in names)
            emit(True, "queue",
                 f"{queued} queued, {running} running, {rejected} rejected")
            pidfile = os.path.join(jd, ".serve.pid")
            if os.path.exists(pidfile):
                try:
                    with open(pidfile) as f:
                        pid = int(f.read().strip())
                except (ValueError, OSError):
                    pid = None
                if pid is not None and _proc_alive(pid):
                    emit(True, "serve process", f"pid {pid} alive")
                else:
                    emit(False, "serve process",
                         f"stale pidfile {pidfile} (no such process)",
                         warn=True)
            else:
                emit(False, "serve process", "none (no pidfile)", warn=True)

    emit(True, "models",
         f"{_count_models(args.models_dir)} registered in {args.models_dir}")

    if failed:
        print(f"\n{len(failed)} check(s) failed: {', '.join(failed)}")
        return 1
    print("\nall checks passed")
    return 0


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog=PROG)
    sub = ap.add_subparsers(dest="cmd", required=True)

    ap_serve = sub.add_parser("serve", help="run the image server")
    ap_serve.add_argument("--config", help="ServerConfiguration JSON path")
    ap_serve.add_argument("--jobs-dir", default="./jobs")
    ap_serve.add_argument("--models-dir", default="./models")
    ap_serve.add_argument("--poll-interval", type=float, default=1.0)
    ap_serve.add_argument(
        "--device", default=None,
        help="torch device jobs run on: cuda (default) or cpu; overrides"
             " the --config file's device (forwarded to every worker)",
    )
    ap_serve.add_argument(
        "--workers", type=int, default=1,
        help="worker processes sharing the queue (claims are atomic, so one"
             " claimer per card scales serving across cards)",
    )
    ap_serve.add_argument(
        "--trace-spans", action="store_true",
        help="keep the server's and the jobs' spans in memory and write them"
             " as a Chrome trace, spans.json in the log dir (else the jobs"
             " dir), on exit (forwarded to every worker)",
    )
    ap_serve.add_argument(
        "--pin-env", default=None, metavar="VAR",
        help="env var set to the worker index in each worker, e.g."
             " CUDA_VISIBLE_DEVICES to pin one card per worker",
    )

    ap_submit = sub.add_parser(
        "submit",
        help="submit a job JSON — or a WORKFLOW (a JSON list of specs, "
             "each auto-chained on the previous step's output dir)",
    )
    ap_submit.add_argument("--jobs-dir", default="./jobs")
    ap_submit.add_argument(
        "spec",
        help="job spec JSON file (or '-' for stdin); a JSON LIST is a "
             "workflow: step k gets depends_on = step k-1's output unless "
             "it sets its own (use [] to opt out)",
    )
    ap_submit.add_argument(
        "--follow", action="store_true",
        help="after submitting, live-tail the job (status --follow on the"
             " spec's output dir); exit 0 = complete",
    )
    ap_submit.add_argument(
        "--after", action="append", metavar="OUTPUT_DIR",
        help="chain: run only after this output dir holds a complete"
             " status.json (repeatable; adds to the spec's depends_on —"
             " a failed/cancelled dependency fails this job)",
    )

    ap_status = sub.add_parser("status", help="read a job output status")
    ap_status.add_argument("output_dir")
    ap_status.add_argument(
        "--follow", action="store_true",
        help="live-tail the job: print each progress update until the job"
             " reaches a terminal state (exit 0 = complete, 1 otherwise)",
    )
    ap_status.add_argument(
        "--poll", type=float, default=1.0,
        help="seconds between --follow polls (default 1)",
    )

    ap_models = sub.add_parser("models", help="list registered models")
    ap_models.add_argument("--models-dir", default="./models")

    ap_queue = sub.add_parser("queue", help="show the job queue state")
    ap_queue.add_argument("--jobs-dir", default="./jobs")

    ap_cancel = sub.add_parser(
        "cancel",
        help="cancel a job: removes it from the queue, or — if already "
        "claimed — asks the running worker to stop at its next frame/step",
    )
    ap_cancel.add_argument("--jobs-dir", default="./jobs")
    ap_cancel.add_argument("job_id")

    ap_info = sub.add_parser(
        "info", help="print version, torch/CUDA and devices, native status,"
                     " registered pipelines"
    )
    ap_info.add_argument("--models-dir", default="./models")

    ap_doctor = sub.add_parser(
        "doctor",
        help="environment/health report: card reachability (bounded probes"
             " that cannot hang on a dead card), a small matmul's latency,"
             " native helpers, optional deps, queue health",
    )
    ap_doctor.add_argument("--jobs-dir", default=None)
    ap_doctor.add_argument("--models-dir", default="./models")
    ap_doctor.add_argument(
        "--timeout", type=float, default=120.0,
        help="seconds to allow each device probe (default 120)",
    )

    ap_stats = sub.add_parser(
        "stats", help="summarize a server's jobs.jsonl ledger (enable with"
                      " log_dir in the server config)"
    )
    ap_stats.add_argument("ledger", help="path to jobs.jsonl or its log dir")

    ap_drain = sub.add_parser(
        "drain",
        help="gracefully drain the serve process watching a jobs dir: it"
             " finishes running jobs, claims nothing further, and exits"
             " with the queue untouched (rolling restarts)",
    )
    ap_drain.add_argument("--jobs-dir", default="./jobs")
    ap_drain.add_argument(
        "--wait", action="store_true",
        help="block until the serve process has exited",
    )
    ap_drain.add_argument(
        "--timeout", type=float, default=None,
        help="give up after this many seconds (exit 1); implies --wait",
    )

    ap_retry = sub.add_parser(
        "retry", help="re-queue a FAILED job (moves its .failed marker back"
                      " into the queue)"
    )
    ap_retry.add_argument("--jobs-dir", default="./jobs")
    ap_retry.add_argument("job_id")

    ap_imp = sub.add_parser(
        "import-model",
        help="register a flat npz of weights (python -m sequitr_tpu"
             " export-model output, or a TF / torch export) as a served model",
    )
    ap_imp.add_argument("--models-dir", default="./models")
    ap_imp.add_argument("--npz", required=True, help="flat npz of weights")
    ap_imp.add_argument(
        "--arch", required=True,
        help="architecture JSON: num_classes/depth/base_features/... (a JAX"
             " model directory's config.json works as it is)",
    )
    ap_imp.add_argument(
        "--kind", default=None,
        help="model kind (unet, n2v, flows, stars, gan); default: the"
             " arch JSON's __kind__, else unet",
    )
    ap_imp.add_argument(
        "--layout", choices=["jax", "tf", "torch"], default="jax",
        help="source kernel layout; tf/torch kernels are transposed to the"
             " canonical HWIO / (k..,in,out) forms (models.convert maps)",
    )
    ap_imp.add_argument("name", help="model name to register")

    ap_exp = sub.add_parser(
        "export-model", help="dump a registered model's weights as flat npz"
    )
    ap_exp.add_argument("--models-dir", default="./models")
    ap_exp.add_argument("name")
    ap_exp.add_argument("out", help="output .npz path")
    return ap


def _cmd_serve(args, early_drain) -> int:
    from sequitr_tpu_torch.config import ServerConfiguration

    if args.config:
        cfg = ServerConfiguration.from_json(args.config)
    else:
        cfg = ServerConfiguration(
            jobs_dir=args.jobs_dir,
            models_dir=args.models_dir,
            poll_interval=args.poll_interval,
        )
    if args.device:
        cfg.device = args.device
    if args.trace_spans:
        cfg.trace_spans = True
    # pidfile: lets `drain` find this serve process without the operator
    # hunting pids. One serve entry (supervisor OR single worker) per jobs
    # dir is the deployment model; a stale file from a crashed serve is
    # overwritten here and tolerated by `drain`. Written into the EFFECTIVE
    # jobs dir (a --config file may point somewhere other than --jobs-dir).
    pidfile = os.path.join(cfg.jobs_dir, ".serve.pid")
    if os.environ.get("SEQUITR_WORKER_ID") is not None:
        pidfile = None  # a supervised worker: the supervisor owns it
    else:
        try:
            os.makedirs(cfg.jobs_dir, exist_ok=True)
            with open(pidfile, "w") as f:
                f.write(str(os.getpid()))
        except OSError:
            pidfile = None
    try:
        if args.workers > 1:
            return _serve_workers(args, early_drain)
        from sequitr_tpu_torch.server import ImageServer

        ImageServer(cfg).run_forever(early_drain=early_drain)
        return 0
    finally:
        if pidfile:
            try:
                # only remove our own pidfile (a replacement serve may
                # have already overwritten it)
                with open(pidfile) as f:
                    mine = f.read().strip() == str(os.getpid())
                if mine:
                    os.unlink(pidfile)
            except (OSError, ValueError):
                pass


def _cmd_submit(args) -> int:
    from sequitr_tpu_torch.server import submit_job

    if args.spec == "-":
        spec = json.load(sys.stdin)
    else:
        with open(args.spec) as f:
            spec = json.load(f)
    # a LIST is a WORKFLOW file: each spec auto-chains on the previous
    # job's output dir (override with an explicit depends_on, including []
    # for "independent")
    specs = spec if isinstance(spec, list) else [spec]
    if not specs or not all(isinstance(s, dict) for s in specs):
        print(
            "spec must be a JSON object or a non-empty list of them",
            file=sys.stderr,
        )
        return 1
    for i, s in enumerate(specs):
        if i > 0 and "depends_on" not in s:
            prev_out = specs[i - 1].get("output")
            if not prev_out:
                print(
                    f"workflow step {i - 1} needs an 'output' dir for "
                    f"step {i} to chain on (or give step {i} an "
                    f"explicit depends_on)",
                    file=sys.stderr,
                )
                return 1
            s["depends_on"] = str(prev_out)
    if args.after:
        deps = specs[0].get("depends_on") or []
        if isinstance(deps, str):
            deps = [deps]
        specs[0]["depends_on"] = list(deps) + list(args.after)
    if args.follow and not specs[-1].get("output"):
        print(
            "--follow needs an 'output' dir in the (last) spec to tail",
            file=sys.stderr,
        )
        return 1
    job_id = None
    for s in specs:
        job_id = submit_job(args.jobs_dir, s)
        print(job_id)
    if args.follow:
        # follows the LAST job of a workflow (its completion implies the
        # chain's); expect_id: a previous run's terminal status.json in the
        # same output dir must not be mistaken for THIS job's result
        return _follow_job(str(specs[-1]["output"]), 1.0, expect_id=job_id)
    return 0


def _cmd_status(args) -> int:
    if args.follow:
        return _follow_job(args.output_dir, args.poll)
    path = os.path.join(args.output_dir, "status.json")
    with open(path) as f:
        text = f.read()
    print(text)
    # a running job's live progress (progress.json updates every ~2 s while
    # frames/steps flow; status.json only at the end)
    ppath = os.path.join(args.output_dir, "progress.json")
    try:
        if json.loads(text).get("state") == "running" and os.path.exists(ppath):
            with open(ppath) as f:
                print(f.read())
    except ValueError:
        pass
    return 0


def _cmd_models(args) -> int:
    rows = []
    names = sorted(os.listdir(args.models_dir)) if os.path.isdir(args.models_dir) else []
    for name in names:
        cfg_path = os.path.join(args.models_dir, name, "config.json")
        if not os.path.exists(cfg_path):
            continue
        with open(cfg_path) as f:
            cfg = json.load(f)
        kind = cfg.get("__kind__", "?")
        desc = {
            k: cfg[k]
            for k in ("num_classes", "depth", "base_features", "dims",
                      "space_to_depth", "in_channels", "gen_depth")
            if k in cfg and cfg[k] is not None
        }
        rows.append((name, kind, desc))
    if not rows:
        print("(no models registered)")
    for name, kind, desc in rows:
        print(f"{name:24s} {kind:5s} " + " ".join(f"{k}={v}" for k, v in desc.items()))
    return 0


def _cmd_queue(args) -> int:
    from sequitr_tpu_torch.server import jobs as jobs_lib

    pending = jobs_lib.scan_jobs(args.jobs_dir)
    names = sorted(os.listdir(args.jobs_dir)) if os.path.isdir(args.jobs_dir) else []
    # .running.reclaim = a dead owner's claim mid-rescue: still "running"
    # from the operator's view (it requeues on the next worker tick)
    running = [
        n for n in names
        if n.endswith(".running") or n.endswith(".running.reclaim")
    ]
    failed = [n for n in names if n.endswith(".failed")]
    rejected = [n for n in names if n.endswith(".rejected")]
    print(f"pending:  {len(pending)}")
    for p in pending:
        state, detail = jobs_lib.check_dependencies(p)
        note = ""
        if state == "wait":
            note = f"  [waiting on {detail}]"
        elif state == "fail":
            note = f"  [will fail: {detail}]"
        print(f"  {os.path.basename(p)}{note}")
    print(f"running:  {len(running)}")
    for n in running:
        print(f"  {n}")
    print(f"failed:   {len(failed)}")
    for n in failed:
        print(f"  {n}")
    print(f"rejected: {len(rejected)}")
    for n in rejected:
        print(f"  {n}")
    return 0


def _cmd_info(args) -> int:
    import torch

    from sequitr_tpu_torch import __version__, native
    from sequitr_tpu_torch.server.server import REGISTRY

    print(f"{PROG} {__version__}")
    # device_count() and get_device_name() answer without a card (0
    # devices); nothing here falls back to the CPU or picks a device
    n = torch.cuda.device_count()
    names = sorted({torch.cuda.get_device_name(i) for i in range(n)})
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"backend={'cuda' if n else 'none'} devices={n}"
          + (f" ({', '.join(names)})" if names else ""))
    print(f"native helpers: {'available' if native.available() else 'scipy fallback'}")
    print(f"pipelines: {', '.join(REGISTRY.names())}")
    print(f"models in {args.models_dir}: {_count_models(args.models_dir)}")
    return 0


def _cmd_stats(args) -> int:
    from collections import Counter, defaultdict

    path = args.ledger
    if os.path.isdir(path):
        path = os.path.join(path, "jobs.jsonl")
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError as e:
        print(f"cannot read ledger: {e}", file=sys.stderr)
        return 1
    rows = []
    for line in lines:
        try:
            rows.append(json.loads(line))
        except ValueError:
            continue  # torn tail line from a live server
    if not rows:
        print("(empty ledger)")
        return 0
    by_state = Counter(r.get("state", "?") for r in rows)
    by_module = defaultdict(lambda: {"n": 0, "s": 0.0, "failed": 0})
    retried = sum(1 for r in rows if (r.get("attempts") or 1) > 1)
    workers = Counter(
        str(r.get("worker")) for r in rows if r.get("worker") is not None
    )
    for r in rows:
        m = by_module[r.get("module", "?")]
        m["n"] += 1
        m["s"] += float(r.get("elapsed_s") or 0.0)
        m["failed"] += r.get("state") == "failed"
    span = max(r.get("finished", 0.0) for r in rows) - min(
        r.get("finished", 0.0) for r in rows
    )
    print(f"jobs: {len(rows)} "
          + " ".join(f"{k}={v}" for k, v in sorted(by_state.items())))
    if span > 0:
        print(f"span: {span/3600:.2f} h ({len(rows)/span*3600:.1f} jobs/h)")
    if retried:
        print(f"retried: {retried}")
    if workers:
        print("workers: "
              + " ".join(f"{k}:{v}" for k, v in sorted(workers.items())))
    print(f"{'module':28s} {'n':>5s} {'failed':>6s} {'mean s':>8s} {'total h':>8s}")
    for name, m in sorted(by_module.items(), key=lambda kv: -kv[1]["s"]):
        print(
            f"{name:28s} {m['n']:5d} {m['failed']:6d} "
            f"{m['s']/m['n']:8.2f} {m['s']/3600:8.2f}"
        )
    return 0


def _cmd_drain(args) -> int:
    pidfile = os.path.join(args.jobs_dir, ".serve.pid")
    try:
        with open(pidfile) as f:
            pid = int(f.read().strip())
    except (OSError, ValueError):
        print(
            f"no serve process found for {args.jobs_dir} (no readable "
            f"{pidfile})", file=sys.stderr,
        )
        return 1

    def is_ours():
        # never signal a bystander: a SIGKILLed serve leaves its pidfile
        # behind and the pid can be recycled by an unrelated process —
        # whose default SIGUSR1 disposition is TERMINATE
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                return PROG.encode() in f.read()
        except OSError:
            return True  # no /proc: fall back to trusting the pidfile

    def remove_stale():
        # re-check content before unlinking: a replacement serve may have
        # overwritten the pidfile since we read it
        try:
            with open(pidfile) as f:
                if f.read().strip() == str(pid):
                    os.unlink(pidfile)
        except OSError:
            pass

    if not _proc_alive(pid):
        remove_stale()
        print(
            f"serve process {pid} is not running (stale pidfile "
            "removed)", file=sys.stderr,
        )
        return 1
    if not is_ours():
        remove_stale()
        print(
            f"pid {pid} is not a {PROG} serve process (recycled "
            "pid; stale pidfile removed)", file=sys.stderr,
        )
        return 1
    try:
        os.kill(pid, signal.SIGUSR1)
    except OSError as e:
        print(f"cannot signal serve process {pid}: {e}", file=sys.stderr)
        return 1
    print(
        f"drain requested (pid {pid}): running jobs finish, the queue "
        "is left untouched", flush=True,
    )
    if not args.wait and args.timeout is None:
        return 0
    # --timeout implies --wait (a bounded wait is still a wait)
    deadline = (
        time.monotonic() + args.timeout if args.timeout is not None else None
    )
    while _proc_alive(pid):
        if deadline is not None and time.monotonic() > deadline:
            print(
                f"serve process {pid} still draining after "
                f"{args.timeout:.0f}s", file=sys.stderr,
            )
            return 1
        time.sleep(0.1)
    print("drained")
    return 0


def _cmd_retry(args) -> int:
    from sequitr_tpu_torch.server import jobs as jobs_lib

    failed = os.path.join(
        args.jobs_dir,
        f"{jobs_lib.JOB_PREFIX}{args.job_id}{jobs_lib.CLAIMED_SUFFIX}.failed",
    )
    queued = os.path.join(
        args.jobs_dir, f"{jobs_lib.JOB_PREFIX}{args.job_id}{jobs_lib.JOB_SUFFIX}"
    )
    try:
        os.rename(failed, queued)
        print(f"re-queued {args.job_id}")
        return 0
    except FileNotFoundError:
        print(
            f"{args.job_id}: no failed marker in {args.jobs_dir}",
            file=sys.stderr,
        )
        return 1


def _cmd_import_model(args) -> int:
    import numpy as np

    from sequitr_tpu_torch.models import convert as convert_lib
    from sequitr_tpu_torch.server.server import config_from_arch, save_model

    with open(args.arch) as f:
        arch = json.load(f)
    kind = args.kind or arch.get("__kind__", "unet")
    cfg = config_from_arch(kind, arch)
    with np.load(args.npz) as npz:
        flat = convert_lib.from_layout({k: npz[k] for k in npz.files}, args.layout)
    if not any(k.startswith("state/") for k in flat):
        # batch-norm running statistics at the fresh module's mean 0 / var 1,
        # as the JAX CLI registers such an npz
        fresh = convert_lib.to_flat(convert_lib.build(cfg, device="cpu"))
        flat.update({k: v for k, v in fresh.items() if k.startswith("state/")})
        norm = cfg.gen_norm if kind == "gan" else cfg.norm
        if norm == "batch":
            print(
                "warning: npz carries no state/ entries — batch-norm "
                "running statistics default to mean=0/var=1, which will "
                "NOT match a trained checkpoint. Export with this CLI "
                "(which includes them) or add state/... keys.",
                file=sys.stderr,
            )
    model = convert_lib.load_flat(cfg, flat, device="cpu")
    print(save_model(args.models_dir, args.name, kind, cfg, model))
    return 0


def _cmd_export_model(args) -> int:
    import numpy as np

    from sequitr_tpu_torch.server.server import read_model

    kind, _, flat = read_model(args.models_dir, args.name)
    weights = {k: v for k, v in flat.items() if not k.startswith("state/")}
    state = {k: v for k, v in flat.items() if k.startswith("state/")}
    np.savez(args.out, **weights, **state)
    print(
        f"{args.out}: {len(weights)} weight + {len(state)} state "
        f"arrays ({kind})"
    )
    return 0


def _cmd_cancel(args) -> int:
    from sequitr_tpu_torch import client as client_lib

    got = client_lib.cancel_job(args.jobs_dir, args.job_id)
    if got == "cancelled":
        print(f"cancelled {args.job_id}")
        return 0
    if got == "requested":
        # already claimed: the worker polls the marker between
        # frames/steps; training checkpoints before stopping
        print(
            f"{args.job_id}: running — cancel requested; the worker "
            "will stop at its next frame/step"
        )
        return 0
    print(
        f"{args.job_id}: not in the queue or running (done, failed, "
        "or never submitted)", file=sys.stderr,
    )
    return 1


def main(argv=None) -> int:
    # install the drain-flag handler before anything slow (torch and the
    # pipelines take seconds to import): a SIGUSR1 arriving while the
    # process boots sets the flag instead of terminating it; the server's
    # run_forever (or the supervisor) takes the flag over. A supervised
    # worker starts with SIGUSR1 blocked (_block_drain_signal): unblocking
    # it here delivers a drain that arrived before this line.
    early_drain = {"drain": False}
    try:
        signal.signal(
            signal.SIGUSR1, lambda s, f: early_drain.update(drain=True)
        )
        signal.pthread_sigmask(signal.SIG_UNBLOCK, {signal.SIGUSR1})
    except (ValueError, OSError, AttributeError):
        pass  # non-main thread or platform without SIGUSR1

    args = _parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    commands = {
        "submit": _cmd_submit, "status": _cmd_status, "models": _cmd_models,
        "queue": _cmd_queue, "info": _cmd_info, "doctor": _cmd_doctor,
        "stats": _cmd_stats, "drain": _cmd_drain, "retry": _cmd_retry,
        "import-model": _cmd_import_model, "export-model": _cmd_export_model,
        "cancel": _cmd_cancel,
    }
    if args.cmd == "serve":
        return _cmd_serve(args, early_drain)
    return commands[args.cmd](args)


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        # downstream pipe closed early — exit quietly like unix tools
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        sys.exit(0)
