"""The port's job lifecycle end to end: drain, supervisor, reclaim, cancel,
recycle — the cases of ``tests/test_drain.py``, ``tests/test_multiworker.py``,
``tests/test_soak.py`` and the wedge -> recycle e2e of
``tests/test_server.py``, against real ``python -m sequitr_tpu_torch serve
--device cpu`` subprocesses, signals sent by exact pid; plus drains that
reach a worker while it is still booting (before torch is imported).

Every subprocess runs torch at one thread (``OMP_NUM_THREADS=1``). The
sleeps of the ``__test_slow__`` jobs are shorter than the JAX tests' (a
port worker boots in a few seconds, a JAX worker in tens): each still
outlasts the step it has to cover.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from sequitr_tpu_torch.config import ServerConfiguration
from sequitr_tpu_torch.data import tiff
from sequitr_tpu_torch.server import jobs as jobs_lib
from sequitr_tpu_torch.server import submit_job

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _state(out_dir):
    p = out_dir / "status.json"
    if not p.exists():
        return None
    try:
        return json.loads(p.read_text()).get("state")
    except ValueError:
        return None  # mid-write


def _env(**extra):
    return dict(os.environ, OMP_NUM_THREADS="1", **extra)


def _serve(tmp_path, jobs, *args, env=None, log="server.log"):
    log_f = open(tmp_path / log, "a")
    proc = subprocess.Popen(
        [sys.executable, "-m", "sequitr_tpu_torch", "serve", "--device", "cpu",
         "--jobs-dir", str(jobs), "--models-dir", str(tmp_path / "models"),
         "--poll-interval", "0.2", *args],
        env=env or _env(), cwd=REPO, stdout=log_f, stderr=log_f,
    )
    proc.log_f = log_f
    return proc


def _stop(proc):
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    proc.log_f.close()


def _wait(pred, timeout, step=0.1):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


def _log(tmp_path, name="server.log"):
    return (tmp_path / name).read_text()


def _slow(jobs, out, sleep, job_id):
    submit_job(str(jobs), {"module": "__test_slow__", "params": {"sleep": sleep},
                           "input": [], "output": str(out)}, job_id=job_id)


def _emitter_stack(tmp_path):
    stack = np.zeros((1, 16, 16), np.float32)
    stack[0, 8, 8] = 100.0
    path = str(tmp_path / "em.tif")
    tiff.write_stack(path, stack)
    return path


def _environ(pid):
    with open(f"/proc/{pid}/environ", "rb") as f:
        return dict(
            kv.decode().split("=", 1) for kv in f.read().split(b"\0") if b"=" in kv
        )


def _catches_sigusr1(pid):
    """True once ``pid`` has a SIGUSR1 handler (``/proc/<pid>/status``)."""
    try:
        with open(f"/proc/{pid}/status") as f:
            for line in f:
                if line.startswith("SigCgt:"):
                    return bool(int(line.split()[1], 16) & (1 << (signal.SIGUSR1 - 1)))
    except OSError:
        pass
    return False


class TestDrainUnits:
    def test_poll_once_never_claims_after_drain_flag(self, tmp_path):
        from sequitr_tpu_torch.server import ImageServer
        from sequitr_tpu_torch.server.server import PipelineRegistry

        cfg = ServerConfiguration(jobs_dir=str(tmp_path / "jobs"), models_dir=str(tmp_path / "models"),
                                  device="cpu")
        cfg.ensure_dirs()
        submit_job(cfg.jobs_dir, {"module": "m", "output": ""}, job_id="q1")
        srv = ImageServer(cfg, PipelineRegistry())
        srv._draining = True
        assert srv.poll_once() is False
        assert sorted(os.listdir(cfg.jobs_dir)) == ["job_q1.json"]


class TestDrainCLI:
    def test_drain_without_server_fails_cleanly(self, tmp_path, capsys):
        from sequitr_tpu_torch.__main__ import main

        jobs = tmp_path / "jobs"
        jobs.mkdir()
        assert main(["drain", "--jobs-dir", str(jobs)]) == 1
        assert "no serve process" in capsys.readouterr().err

    def test_drain_stale_pidfile_cleaned(self, tmp_path, capsys):
        from sequitr_tpu_torch.__main__ import main

        jobs = tmp_path / "jobs"
        jobs.mkdir()
        (jobs / ".serve.pid").write_text("99999999")  # beyond pid_max: a crashed serve
        assert main(["drain", "--jobs-dir", str(jobs)]) == 1
        assert "stale pidfile" in capsys.readouterr().err
        assert not (jobs / ".serve.pid").exists()

    def test_drain_never_signals_a_recycled_pid(self, tmp_path, capsys):
        """A pid owned by an unrelated live process (this test process is
        not a serve process) is refused, not signalled."""
        from sequitr_tpu_torch.__main__ import main

        jobs = tmp_path / "jobs"
        jobs.mkdir()
        (jobs / ".serve.pid").write_text(str(os.getpid()))
        assert main(["drain", "--jobs-dir", str(jobs)]) == 1
        assert "not a sequitr_tpu_torch serve" in capsys.readouterr().err
        assert not (jobs / ".serve.pid").exists()

    def test_drain_refuses_a_jax_serve_pid(self, tmp_path, capsys):
        """The recycled-pid guard names the port: a process whose command
        line names only ``sequitr_tpu`` is not the port's serve."""
        from sequitr_tpu_torch.__main__ import main

        jobs = tmp_path / "jobs"
        jobs.mkdir()
        bystander = subprocess.Popen(
            [sys.executable, "-c", "import time; time.sleep(30)", "sequitr_tpu", "serve"], env=_env(),
        )
        try:
            (jobs / ".serve.pid").write_text(str(bystander.pid))
            assert main(["drain", "--jobs-dir", str(jobs)]) == 1
            assert "not a sequitr_tpu_torch serve" in capsys.readouterr().err
            assert bystander.poll() is None  # never signalled
        finally:
            bystander.kill()
            bystander.wait()


class TestDrainE2E:
    def test_sigusr1_finishes_job_leaves_queue_exits_zero(self, tmp_path):
        jobs = tmp_path / "jobs"
        jobs.mkdir()
        slow_out, queued_out = tmp_path / "slow", tmp_path / "queued"
        _slow(jobs, slow_out, 5, "slowj")
        _slow(jobs, queued_out, 0.1, "afterj")
        proc = _serve(tmp_path, jobs, env=_env(SEQUITR_TEST_SLOW="1"))
        try:
            assert _wait((slow_out / "worker_pid.txt").exists, 120), _log(tmp_path)[-2000:]
            assert (jobs / ".serve.pid").read_text().strip() == str(proc.pid)
            cli = subprocess.run(
                [sys.executable, "-m", "sequitr_tpu_torch", "drain", "--jobs-dir", str(jobs),
                 "--wait", "--timeout", "120"],
                cwd=REPO, capture_output=True, text=True, timeout=150, env=_env(),
            )
            assert cli.returncode == 0, (cli.stdout, cli.stderr)
            assert "drain requested" in cli.stdout and "drained" in cli.stdout
            assert proc.wait(timeout=30) == 0
            assert not (jobs / ".serve.pid").exists()
            assert _state(slow_out) == "complete"
            assert _state(queued_out) is None
            assert sorted(os.listdir(jobs)) == ["job_afterj.json"]
            log_txt = _log(tmp_path)
            assert "drain requested" in log_txt and "drained" in log_txt
        finally:
            _stop(proc)

    def test_supervisor_forwards_drain_to_workers(self, tmp_path):
        jobs = tmp_path / "jobs"
        jobs.mkdir()
        slow_out = tmp_path / "slow"
        _slow(jobs, slow_out, 5, "slowj")
        proc = _serve(tmp_path, jobs, "--workers", "2", "--pin-env", "SEQUITR_TEST_PIN",
                      env=_env(SEQUITR_TEST_SLOW="1"))
        try:
            assert _wait((slow_out / "worker_pid.txt").exists, 120), _log(tmp_path)[-2000:]
            worker = int((slow_out / "worker_pid.txt").read_text())
            assert worker != proc.pid
            # --pin-env: the worker's variable is its index, as SEQUITR_WORKER_ID is
            env = _environ(worker)
            assert env["SEQUITR_TEST_PIN"] == env["SEQUITR_WORKER_ID"] in ("0", "1")
            proc.send_signal(signal.SIGUSR1)
            assert proc.wait(timeout=120) == 0, _log(tmp_path)[-2000:]
            assert _state(slow_out) == "complete"
            log_txt = _log(tmp_path)
            assert "all workers drained" in log_txt, log_txt[-2000:]
            assert [n for n in os.listdir(jobs) if not n.endswith(".json")] == []
        finally:
            _stop(proc)

    def test_drain_reaches_a_booting_serve(self, tmp_path):
        """SIGUSR1 as soon as the serve process has its early handler (it
        then goes on to import torch and the pipelines): it exits 0 without
        claiming the queued job."""
        jobs = tmp_path / "jobs"
        jobs.mkdir()
        queued_out = tmp_path / "queued"
        _slow(jobs, queued_out, 0.1, "afterj")
        proc = _serve(tmp_path, jobs, env=_env(SEQUITR_TEST_SLOW="1"))
        try:
            assert _wait(lambda: _catches_sigusr1(proc.pid), 60, step=0.002)
            proc.send_signal(signal.SIGUSR1)
            assert proc.wait(timeout=120) == 0, _log(tmp_path)[-2000:]
            assert _state(queued_out) is None
            assert sorted(os.listdir(jobs)) == ["job_afterj.json"]
            assert "drained: exiting cleanly" in _log(tmp_path)
        finally:
            _stop(proc)

    def test_drain_reaches_booting_workers(self, tmp_path):
        """A drain sent to the supervisor while its workers boot: each
        worker holds the forwarded SIGUSR1 until its handler is in place,
        exits 0 without claiming, and the supervisor exits 0."""
        jobs = tmp_path / "jobs"
        jobs.mkdir()
        queued_out = tmp_path / "queued"
        _slow(jobs, queued_out, 0.1, "afterj")
        proc = _serve(tmp_path, jobs, "--workers", "2", env=_env(SEQUITR_TEST_SLOW="1"))
        try:
            assert _wait(lambda: "supervising 2 workers" in _log(tmp_path), 60, step=0.01)
            proc.send_signal(signal.SIGUSR1)
            assert proc.wait(timeout=120) == 0, _log(tmp_path)[-3000:]
            log_txt = _log(tmp_path)
            assert log_txt.count("drained: exiting cleanly") == 2, log_txt[-3000:]
            assert "all workers drained" in log_txt
            assert _state(queued_out) is None
            assert sorted(os.listdir(jobs)) == ["job_afterj.json"]
        finally:
            _stop(proc)

    def test_drain_reaches_a_booting_supervisor(self, tmp_path):
        """A drain that reaches the supervisor before it spawns: no worker
        starts, the exit is 0 and the queue is untouched."""
        jobs = tmp_path / "jobs"
        jobs.mkdir()
        _slow(jobs, tmp_path / "queued", 0.1, "afterj")
        proc = _serve(tmp_path, jobs, "--workers", "2", env=_env(SEQUITR_TEST_SLOW="1"))
        try:
            assert _wait(lambda: _catches_sigusr1(proc.pid), 60, step=0.002)
            proc.send_signal(signal.SIGUSR1)
            assert proc.wait(timeout=60) == 0, _log(tmp_path)[-2000:]
            assert sorted(os.listdir(jobs)) == ["job_afterj.json"]
            assert "server watching" not in _log(tmp_path)
        finally:
            _stop(proc)


    def test_sigterm_tears_every_worker_down(self, tmp_path):
        jobs = tmp_path / "jobs"
        jobs.mkdir()
        slow_out = tmp_path / "slow"
        _slow(jobs, slow_out, 60, "slowj")
        proc = _serve(tmp_path, jobs, "--workers", "2", env=_env(SEQUITR_TEST_SLOW="1"))
        try:
            assert _wait((slow_out / "worker_pid.txt").exists, 120), _log(tmp_path)[-2000:]
            worker = int((slow_out / "worker_pid.txt").read_text())
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=60) == 0
            assert not (jobs / ".serve.pid").exists()
            assert _wait(lambda: not os.path.exists(f"/proc/{worker}"), 30), "an orphaned worker"
        finally:
            _stop(proc)


class TestMultiWorkerE2E:
    def test_shared_queue_drains_and_survives_sigkill(self, tmp_path):
        jobs, logs = tmp_path / "jobs", tmp_path / "logs"
        for d in (jobs, logs):
            d.mkdir()
        cfgp = tmp_path / "server.json"
        # stale_claim_timeout >> the heartbeat (min(5, 8/6) s), << the deadline
        ServerConfiguration(
            jobs_dir=str(jobs), models_dir=str(tmp_path / "models"), poll_interval=0.3,
            stale_claim_timeout=8.0, log_dir=str(logs), device="cpu",
        ).to_json(str(cfgp))
        victim_out = tmp_path / "victim"
        _slow(jobs, victim_out, 300, "victim")
        em = _emitter_stack(tmp_path)
        quick_ids = [f"quick{i}" for i in range(4)]
        for qid in quick_ids:
            submit_job(str(jobs), {"module": "localize_emitters", "params": {"threshold": 50},
                                   "input": [em], "output": str(tmp_path / qid)}, job_id=qid)
        proc = _serve(tmp_path, jobs, "--workers", "2", "--config", str(cfgp),
                      env=_env(SEQUITR_TEST_SLOW="1"))
        try:
            pid_file = victim_out / "worker_pid.txt"
            assert _wait(pid_file.exists, 120, step=0.2), _log(tmp_path)[-2000:]
            time.sleep(1.0)  # let the claim and its first heartbeat settle
            victim_pid = int(pid_file.read_text())
            assert victim_pid != proc.pid
            os.kill(victim_pid, signal.SIGKILL)
            want = [victim_out] + [tmp_path / q for q in quick_ids]
            assert _wait(lambda: all(_state(d) == "complete" for d in want), 120, step=0.5), (
                [_state(d) for d in want], _log(tmp_path)[-3000:],
            )
            log_txt = _log(tmp_path)
            assert "reclaimed stale job" in log_txt, log_txt[-3000:]
            vstatus = json.loads((victim_out / "status.json").read_text())
            assert vstatus["outputs"]["rerun"] == "True"
            rows = [json.loads(line) for line in (logs / "jobs.jsonl").read_text().splitlines()]
            done = [r["id"] for r in rows if r["state"] == "complete"]
            assert sorted(done) == sorted(["victim"] + quick_ids), rows
            assert [n for n in os.listdir(jobs) if n.endswith(".running")] == []
        finally:
            _stop(proc)

    def test_chain_order_under_contending_workers(self, tmp_path):
        """A -> B -> C (submitted in reverse) + fillers, drained by 2 real
        workers: dependents never start before their dependency completes."""
        jobs, logs = tmp_path / "jobs", tmp_path / "logs"
        for d in (jobs, logs):
            d.mkdir()
        cfgp = tmp_path / "server.json"
        ServerConfiguration(jobs_dir=str(jobs), models_dir=str(tmp_path / "models"), poll_interval=0.2,
                            log_dir=str(logs), device="cpu").to_json(str(cfgp))
        em = _emitter_stack(tmp_path)

        def spec(out, depends_on=None):
            s = {"module": "localize_emitters", "params": {"threshold": 50}, "input": [em],
                 "output": str(tmp_path / out)}
            if depends_on:
                s["depends_on"] = str(tmp_path / depends_on)
            return s

        submit_job(str(jobs), spec("c", depends_on="b"), job_id="c")
        submit_job(str(jobs), spec("b", depends_on="a"), job_id="b")
        for i in range(2):
            submit_job(str(jobs), spec(f"fill{i}"), job_id=f"fill{i}")
        submit_job(str(jobs), spec("a"), job_id="a")
        proc = _serve(tmp_path, jobs, "--workers", "2", "--config", str(cfgp))
        try:
            names = ["a", "b", "c", "fill0", "fill1"]
            assert _wait(lambda: all(_state(tmp_path / n) == "complete" for n in names), 120, step=0.3), (
                [(n, _state(tmp_path / n)) for n in names], _log(tmp_path)[-3000:],
            )
            a, b, c = (json.loads((tmp_path / n / "status.json").read_text()) for n in "abc")
            assert b["started"] >= a["updated"], (a, b)
            assert c["started"] >= b["updated"], (b, c)
        finally:
            _stop(proc)


class TestSupervisorRecycleE2E:
    def test_wedged_job_recycles_worker_and_queue_continues(self, tmp_path):
        """A worker wedged by a never-returning pipeline: the watchdog fails
        the job, the worker exits EXIT_RECYCLE, the supervisor respawns it
        (no restart budget charged) and the next job completes."""
        jobs = tmp_path / "jobs"
        jobs.mkdir()
        cfgp = tmp_path / "server.json"
        ServerConfiguration(jobs_dir=str(jobs), models_dir=str(tmp_path / "models"), poll_interval=0.3,
                            job_timeout=8.0, device="cpu").to_json(str(cfgp))
        out1, out2 = tmp_path / "o1", tmp_path / "o2"
        submit_job(str(jobs), {"module": "__test_wedge__", "input": [], "output": str(out1)}, job_id="wedge")
        em = _emitter_stack(tmp_path)
        submit_job(str(jobs), {"module": "localize_emitters", "params": {"threshold": 50},
                               "input": [em], "output": str(out2)}, job_id="after")
        proc = _serve(tmp_path, jobs, "--workers", "2", "--config", str(cfgp),
                      env=_env(SEQUITR_TEST_WEDGE="1"))
        try:
            def done():
                return (
                    _state(out1) == "failed" and _state(out2) == "complete"
                    and "recycled after job timeout" in _log(tmp_path)
                )

            assert _wait(done, 120, step=0.5), (_state(out1), _state(out2), _log(tmp_path)[-3000:])
            st1 = json.loads((out1 / "status.json").read_text())
            assert "job_timeout" in st1["error"]
            assert "restart budget" not in _log(tmp_path)
        finally:
            _stop(proc)


class TestLifecycleSoak:
    def test_kill_cancel_drain_and_recover(self, tmp_path):
        """SIGKILL of a worker mid-job, an in-flight cancel, a drain with
        jobs still queued, and a next supervisor that finishes them; then
        the ledger audit: one terminal row per job, states as the markers."""
        jobs, logs = tmp_path / "jobs", tmp_path / "logs"
        for d in (jobs, logs):
            d.mkdir()
        cfgp = tmp_path / "server.json"
        ServerConfiguration(
            jobs_dir=str(jobs), models_dir=str(tmp_path / "models"), poll_interval=0.2,
            stale_claim_timeout=8.0, log_dir=str(logs), device="cpu",
        ).to_json(str(cfgp))
        outs = {}

        def submit(jid, sleep):
            outs[jid] = tmp_path / jid
            _slow(jobs, outs[jid], sleep, jid)

        submit("victim", 300)
        submit("cancelme", 300)
        for i in range(3):
            submit(f"quick{i}", 0.1)
        env = _env(SEQUITR_TEST_SLOW="1")

        def start_supervisor():
            return _serve(tmp_path, jobs, "--workers", "2", "--config", str(cfgp), env=env)

        proc = start_supervisor()
        try:
            assert _wait(lambda: all((outs[j] / "worker_pid.txt").exists() for j in ("victim", "cancelme")),
                         120, step=0.2), _log(tmp_path)[-2000:]
            time.sleep(1.0)
            # 1) SIGKILL the victim's worker; 2) cancel the other running job
            os.kill(int((outs["victim"] / "worker_pid.txt").read_text()), signal.SIGKILL)
            jobs_lib.request_cancel(str(jobs), "cancelme")
            want_complete = ["victim"] + [f"quick{i}" for i in range(3)]
            assert _wait(lambda: _state(outs["cancelme"]) == "cancelled"
                         and all(_state(outs[j]) == "complete" for j in want_complete), 120, step=0.3), (
                {j: _state(o) for j, o in outs.items()}, _log(tmp_path)[-3000:],
            )
            vst = json.loads((outs["victim"] / "status.json").read_text())
            assert vst["outputs"]["rerun"] == "True"

            # 3) drain with fresh jobs queued, both workers busy first
            submit("hold0", 6)
            submit("hold1", 6)

            def both_holds_running():
                return all((outs[h] / "worker_pid.txt").exists() and _state(outs[h]) == "running"
                           for h in ("hold0", "hold1"))

            assert _wait(both_holds_running, 60, step=0.1), _log(tmp_path)[-2000:]
            submit("leftover0", 0.1)
            submit("leftover1", 0.1)
            proc.send_signal(signal.SIGUSR1)
            assert proc.wait(timeout=120) == 0, _log(tmp_path)[-3000:]
            for j in ("hold0", "hold1"):
                assert _state(outs[j]) == "complete", (j, _log(tmp_path)[-3000:])
            for j in ("leftover0", "leftover1"):
                assert _state(outs[j]) is None
            assert sorted(os.listdir(jobs)) == ["job_leftover0.json", "job_leftover1.json"]
            _stop(proc)

            # 4) a NEXT supervisor finishes what the drained one left
            proc = start_supervisor()
            assert _wait(lambda: all(_state(outs[j]) == "complete" for j in ("leftover0", "leftover1")),
                         120, step=0.3), _log(tmp_path)[-2000:]

            # 5) ledger audit
            rows = [json.loads(line) for line in (logs / "jobs.jsonl").read_text().splitlines()]
            terminal = {}
            for r in rows:
                terminal.setdefault(r["id"], []).append(r["state"])
            assert sorted(terminal) == sorted(outs), (terminal, sorted(outs))
            for jid, states in terminal.items():
                want = "cancelled" if jid == "cancelme" else "complete"
                assert states.count(want) == 1, (jid, states)
        finally:
            _stop(proc)
