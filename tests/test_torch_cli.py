"""The port's CLI (``python -m sequitr_tpu_torch``) against the JAX CLI.

The cases of ``tests/test_cli.py`` that apply to the port, run against
``sequitr_tpu_torch.__main__.main`` in-process; then parity cases that run
both ``main``s on identical directories: ``models``, ``queue``, ``stats``,
``retry`` and ``cancel`` print the same lines (the program name aside),
weights cross between the two CLIs bit for bit in both directions (with
and without ``state/`` entries, and from TF and torch kernel layouts), and
the ``profile`` job param writes a trace beside the same labels.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequitr_tpu.__main__ import main as jax_main
from sequitr_tpu.models import convert as jax_convert
from sequitr_tpu.models import unet as jax_unet
from sequitr_tpu.server.server import load_model as jax_load_model
from sequitr_tpu.server.server import save_model as jax_save_model
from sequitr_tpu_torch.__main__ import main
from sequitr_tpu_torch.models import convert
from sequitr_tpu_torch.server import jobs as jobs_lib
from sequitr_tpu_torch.server import claim_job, scan_jobs, submit_job

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _arch(path, **kw):
    arch = dict(in_channels=1, num_classes=2, depth=2, base_features=4,
                norm="batch", compute_dtype="float32")
    arch.update(kw)
    with open(path, "w") as f:
        json.dump(arch, f)
    return str(path)


def _jax_weights(seed, norm="batch"):
    cfg = jax_unet.UNetConfig(
        in_channels=1, num_classes=2, depth=2, base_features=4, norm=norm,
        compute_dtype=jnp.float32,
    )
    params, state = jax_unet.init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32), params)
    state = jax.tree.map(lambda a: a + 0.3 * rng.random(a.shape).astype(np.float32), state)
    return cfg, params, state


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _assert_bit_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def _out(capsys):
    got = capsys.readouterr()
    return got.out, got.err


class TestCLI:
    def test_submit_and_status(self, tmp_path, capsys):
        jobs_dir = str(tmp_path / "jobs")
        os.makedirs(jobs_dir)
        spec_path = str(tmp_path / "spec.json")
        out_dir = str(tmp_path / "out")
        with open(spec_path, "w") as f:
            json.dump({"module": "m", "input": [], "output": out_dir}, f)
        assert main(["submit", "--jobs-dir", jobs_dir, spec_path]) == 0
        assert capsys.readouterr().out.strip()
        assert len(scan_jobs(jobs_dir)) == 1
        os.makedirs(out_dir)
        with open(os.path.join(out_dir, "status.json"), "w") as f:
            json.dump({"state": "complete"}, f)
        assert main(["status", out_dir]) == 0
        assert "complete" in capsys.readouterr().out

    def test_submit_workflow_file_auto_chains(self, tmp_path, capsys):
        jobs_dir = str(tmp_path / "jobs")
        os.makedirs(jobs_dir)
        spec_path = str(tmp_path / "wf.json")
        with open(spec_path, "w") as f:
            json.dump([
                {"module": "a", "input": [], "output": str(tmp_path / "oa")},
                {"module": "b", "input": [], "output": str(tmp_path / "ob")},
                {"module": "c", "input": [], "depends_on": [], "output": str(tmp_path / "oc")},
            ], f)
        assert main(["submit", "--jobs-dir", jobs_dir, spec_path]) == 0
        ids = capsys.readouterr().out.split()
        assert len(ids) == 3
        paths = {p.split("job_")[-1][:-5]: p for p in scan_jobs(jobs_dir)}
        assert jobs_lib.Job.from_file(paths[ids[1]]).depends_on == [str(tmp_path / "oa")]
        assert jobs_lib.Job.from_file(paths[ids[2]]).depends_on == []

    def test_submit_workflow_needs_output_to_chain(self, tmp_path, capsys):
        jobs_dir = str(tmp_path / "jobs")
        os.makedirs(jobs_dir)
        spec_path = str(tmp_path / "wf.json")
        with open(spec_path, "w") as f:
            json.dump([{"module": "a", "input": []}, {"module": "b", "input": []}], f)
        assert main(["submit", "--jobs-dir", jobs_dir, spec_path]) == 1
        assert len(scan_jobs(jobs_dir)) == 0

    def test_submit_after_flag_and_queue_annotation(self, tmp_path, capsys):
        jobs_dir = str(tmp_path / "jobs")
        os.makedirs(jobs_dir)
        dep_dir = str(tmp_path / "dep")
        spec_path = str(tmp_path / "spec.json")
        with open(spec_path, "w") as f:
            json.dump({"module": "m", "input": [], "output": str(tmp_path / "o")}, f)
        assert main(["submit", "--jobs-dir", jobs_dir, "--after", dep_dir, spec_path]) == 0
        capsys.readouterr()
        assert main(["queue", "--jobs-dir", jobs_dir]) == 0
        assert f"[waiting on {dep_dir}]" in capsys.readouterr().out
        os.makedirs(dep_dir)
        with open(os.path.join(dep_dir, "status.json"), "w") as f:
            json.dump({"state": "complete"}, f)
        main(["queue", "--jobs-dir", jobs_dir])
        assert "waiting on" not in capsys.readouterr().out

    def test_submit_from_stdin(self, tmp_path, monkeypatch):
        import io

        jobs_dir = str(tmp_path / "jobs")
        os.makedirs(jobs_dir)
        monkeypatch.setattr("sys.stdin", io.StringIO(json.dumps({"module": "m", "output": "o"})))
        assert main(["submit", "--jobs-dir", jobs_dir, "-"]) == 0
        assert len(scan_jobs(jobs_dir)) == 1


def test_host_commands_load_no_torch(tmp_path):
    """submit, queue, cancel, retry, drain and stats start without torch
    (``sequitr_tpu_torch.server`` loads its server module on first use)."""
    jobs = tmp_path / "jobs"
    spec = tmp_path / "spec.json"
    spec.write_text(json.dumps({"module": "m", "output": str(tmp_path / "o")}))
    _ledger(tmp_path / "jobs.jsonl")
    probe = f"""
import sys
from sequitr_tpu_torch.__main__ import main
jobs = {str(jobs)!r}
assert main(["submit", "--jobs-dir", jobs, {str(spec)!r}]) == 0
assert main(["queue", "--jobs-dir", jobs]) == 0
assert main(["retry", "--jobs-dir", jobs, "nope"]) == 1
assert main(["drain", "--jobs-dir", jobs]) == 1
assert main(["stats", {str(tmp_path)!r}]) == 0
jid = [n for n in __import__("os").listdir(jobs) if n.endswith(".json")][0][4:-5]
assert main(["cancel", "--jobs-dir", jobs, jid]) == 0
assert "torch" not in sys.modules, "torch loaded"
"""
    res = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert res.returncode == 0, res.stderr[-3000:]


class TestMultiWorkerServe:
    def test_two_workers_share_the_queue(self, tmp_path):
        """`serve --workers 2 --device cpu`: concurrent claimers drain one
        jobs dir — every job completes exactly once (atomic rename claims)."""
        from sequitr_tpu_torch.data import tiff

        jobs = str(tmp_path / "jobs")
        models = str(tmp_path / "models")
        os.makedirs(jobs)
        rng = np.random.default_rng(0)
        img_p, lab_p = str(tmp_path / "i.tif"), str(tmp_path / "l.tif")
        images = rng.random((2, 8, 8)).astype(np.float32)
        tiff.write_stack(img_p, images)
        tiff.write_stack(lab_p, (images > 0.5).astype(np.uint16))
        outs = []
        for i in range(4):
            out = str(tmp_path / f"out{i}")
            outs.append(out)
            submit_job(jobs, {
                "module": "build_records", "params": {"num_classes": 2, "weight_maps": False},
                "input": [img_p, lab_p], "output": out,
            }, job_id=f"j{i}")
        proc = subprocess.Popen(
            [sys.executable, "-m", "sequitr_tpu_torch", "serve", "--device", "cpu",
             "--jobs-dir", jobs, "--models-dir", models, "--poll-interval", "0.2", "--workers", "2"],
            env=dict(os.environ, OMP_NUM_THREADS="1"), cwd=REPO,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
        try:
            deadline = time.time() + 120
            done = set()
            while time.time() < deadline and len(done) < 4:
                for out in outs:
                    p = os.path.join(out, "status.json")
                    if out not in done and os.path.exists(p):
                        try:
                            with open(p) as f:
                                st = json.load(f)
                        except json.JSONDecodeError:
                            continue
                        if st.get("state") in ("complete", "failed"):
                            assert st["state"] == "complete", st.get("error")
                            done.add(out)
                time.sleep(0.2)
            assert len(done) == 4, f"only {len(done)}/4 jobs completed"
            assert scan_jobs(jobs) == []
        finally:
            proc.terminate()
            proc.wait(timeout=30)


class TestModelsQueueCommands:
    def test_models_lists_registered(self, tmp_path, capsys):
        from sequitr_tpu_torch.models import unet
        from sequitr_tpu_torch.server.server import save_model

        cfg = unet.UNetConfig(in_channels=1, num_classes=2, depth=2, base_features=2,
                              norm="none", compute_dtype="float32")
        md = str(tmp_path / "models")
        save_model(md, "demo", "unet", cfg, unet.init(cfg, device="cpu"))
        assert main(["models", "--models-dir", md]) == 0
        out = capsys.readouterr().out
        assert "demo" in out and "unet" in out and "num_classes=2" in out

    def test_models_empty(self, tmp_path, capsys):
        assert main(["models", "--models-dir", str(tmp_path / "none")]) == 0
        assert "no models" in capsys.readouterr().out

    def test_queue_states(self, tmp_path, capsys):
        jobs = str(tmp_path / "jobs")
        os.makedirs(jobs)
        submit_job(jobs, {"module": "m", "input": [], "output": ""}, job_id="p1")
        for name, text in (("job_r1.running", "{}"), ("job_f1.running.failed", "{}"),
                           ("job_x.json.rejected", "junk")):
            with open(os.path.join(jobs, name), "w") as f:
                f.write(text)
        assert main(["queue", "--jobs-dir", jobs]) == 0
        out = capsys.readouterr().out
        assert "pending:  1" in out and "job_p1.json" in out
        assert "running:  1" in out and "failed:   1" in out
        assert "rejected: 1" in out


class TestStatusFollow:
    def test_follow_prints_updates_until_terminal(self, tmp_path, capsys):
        out = tmp_path / "out"
        out.mkdir()
        (out / "status.json").write_text(json.dumps({"state": "running"}))
        (out / "progress.json").write_text(json.dumps(
            {"phase": "frames", "done": 3, "total": 10, "frames_per_sec": 2.5, "updated": time.time()}
        ))

        def writer():
            time.sleep(1.0)
            (out / "progress.json").write_text(json.dumps(
                {"phase": "frames", "done": 7, "total": 10, "frames_per_sec": 2.5, "updated": time.time()}
            ))
            time.sleep(1.0)
            (out / "status.json").write_text(json.dumps({"state": "complete", "outputs": {}}))

        t = threading.Thread(target=writer)
        t.start()
        try:
            rc = main(["status", str(out), "--follow", "--poll", "0.05"])
        finally:
            t.join()
        assert rc == 0
        got = capsys.readouterr().out
        assert "frames 3/10" in got and "frames 7/10" in got
        assert '"state": "complete"' in got

    def test_submit_follow_waits_for_ITS_job_not_a_stale_status(self, tmp_path, capsys):
        out = tmp_path / "out"
        out.mkdir()
        (out / "status.json").write_text(json.dumps({"id": "oldrun", "state": "failed", "error": "boom"}))
        spec = tmp_path / "job.json"
        spec.write_text(json.dumps({"module": "m", "params": {}, "input": [], "output": str(out)}))
        jobs = tmp_path / "jobs"
        jobs.mkdir()

        def fake_server():
            deadline = time.time() + 30
            jid = None
            while time.time() < deadline and jid is None:
                for n in os.listdir(jobs):
                    if n.startswith("job_") and n.endswith(".json"):
                        jid = n[len("job_"):-len(".json")]
                time.sleep(0.05)
            time.sleep(0.3)
            (out / "status.json").write_text(json.dumps({"id": jid, "state": "complete", "outputs": {}}))

        t = threading.Thread(target=fake_server)
        t.start()
        try:
            rc = main(["submit", "--jobs-dir", str(jobs), str(spec), "--follow"])
        finally:
            t.join()
        assert rc == 0
        got = capsys.readouterr().out
        assert '"state": "complete"' in got and "oldrun" not in got

    def test_submit_follow_requires_output(self, tmp_path, capsys):
        spec = tmp_path / "job.json"
        spec.write_text(json.dumps({"module": "m", "params": {}}))
        assert main(["submit", "--jobs-dir", str(tmp_path / "jobs"), str(spec), "--follow"]) == 1
        assert "needs an 'output'" in capsys.readouterr().err

    def test_follow_failed_job_exits_nonzero(self, tmp_path, capsys):
        out = tmp_path / "out"
        out.mkdir()
        (out / "status.json").write_text(json.dumps({"state": "failed", "error": "boom"}))
        assert main(["status", str(out), "--follow", "--poll", "0.05"]) == 1
        assert '"state": "failed"' in capsys.readouterr().out


def _ledger(path):
    now = time.time()
    rows = [
        {"id": "a", "module": "segmentation_unet2d", "state": "complete", "elapsed_s": 10.0,
         "attempts": 1, "finished": now - 3600, "worker": "0"},
        {"id": "b", "module": "segmentation_unet2d", "state": "failed", "elapsed_s": 2.0,
         "attempts": 2, "finished": now - 1800, "worker": "1"},
        {"id": "c", "module": "train_unet2d", "state": "complete", "elapsed_s": 100.0,
         "attempts": 1, "finished": now, "worker": "0"},
    ]
    with open(path, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
        f.write('{"torn tail')  # live server mid-write: must be skipped


class TestStatsCommand:
    def test_stats_summarizes_ledger(self, tmp_path, capsys):
        logd = tmp_path / "logs"
        logd.mkdir()
        _ledger(logd / "jobs.jsonl")
        assert main(["stats", str(logd)]) == 0
        out = capsys.readouterr().out
        assert "jobs: 3" in out and "complete=2" in out and "failed=1" in out
        assert "retried: 1" in out
        assert "0:2" in out and "1:1" in out
        assert "train_unet2d" in out and "segmentation_unet2d" in out
        assert main(["stats", str(logd / "jobs.jsonl")]) == 0

    def test_stats_missing_ledger(self, tmp_path, capsys):
        assert main(["stats", str(tmp_path / "nope")]) == 1
        assert "cannot read ledger" in capsys.readouterr().err

    def test_stats_empty_ledger(self, tmp_path, capsys):
        p = tmp_path / "jobs.jsonl"
        p.write_text("")
        assert main(["stats", str(p)]) == 0
        assert "empty ledger" in capsys.readouterr().out


class TestInfoCommand:
    def test_info_prints_surface(self, tmp_path, capsys):
        assert main(["info", "--models-dir", str(tmp_path / "m")]) == 0
        out = capsys.readouterr().out
        assert "sequitr_tpu_torch" in out and "pipelines:" in out
        assert "segmentation_unet2d" in out and "deconvolve" in out
        assert f"torch {torch.__version__}" in out and "backend=" in out
        assert f"devices={torch.cuda.device_count()}" in out
        assert f"models in {tmp_path / 'm'}: 0" in out


class TestRetryCommand:
    def test_retry_requeues_failed_job(self, tmp_path):
        jobs = str(tmp_path / "jobs")
        os.makedirs(jobs)
        spec = {"module": "m", "input": [], "output": str(tmp_path / "o")}
        with open(os.path.join(jobs, "job_x1.running.failed"), "w") as f:
            json.dump(dict(spec, id="x1"), f)
        assert main(["retry", "--jobs-dir", jobs, "x1"]) == 0
        paths = scan_jobs(jobs)
        assert len(paths) == 1
        job = claim_job(paths[0])
        assert job is not None and job.module == "m"

    def test_retry_unknown_job_fails(self, tmp_path, capsys):
        jobs = str(tmp_path / "jobs")
        os.makedirs(jobs)
        assert main(["retry", "--jobs-dir", jobs, "nope"]) == 1
        assert "no failed marker" in capsys.readouterr().err


class TestModelInterchange:
    def test_export_then_import_roundtrip(self, tmp_path, capsys):
        """export-model -> import-model reproduces identical weights AND
        batch-norm running statistics."""
        from sequitr_tpu_torch.models import unet
        from sequitr_tpu_torch.server.server import read_model, save_model

        models = str(tmp_path / "models")
        cfg = unet.UNetConfig(in_channels=1, num_classes=2, depth=2, base_features=4,
                              norm="batch", compute_dtype="float32")
        model = unet.init(cfg, torch.Generator().manual_seed(3), device="cpu")
        with torch.no_grad():
            for name, buf in model.named_buffers():
                buf.add_(0.3 * torch.rand(buf.shape, generator=torch.Generator().manual_seed(5)))
        save_model(models, "orig", "unet", cfg, model)
        npz = str(tmp_path / "w.npz")
        assert main(["export-model", "--models-dir", models, "orig", npz]) == 0
        assert main(["import-model", "--models-dir", models, "--npz", npz,
                     "--arch", _arch(tmp_path / "arch.json"), "imported"]) == 0
        _assert_bit_equal(read_model(models, "orig")[2], read_model(models, "imported")[2])

    def test_import_without_state_warns_for_bn(self, tmp_path, capsys):
        """The repair: an npz without state/ entries for a batch-norm model
        warns on stderr and registers mean 0 / variance 1, as the JAX CLI
        does; the two CLIs' exports of what they registered are equal key
        for key and bit for bit."""
        _, params, _ = _jax_weights(6)
        npz = str(tmp_path / "nostate.npz")
        np.savez(npz, **jax_convert.flatten_params(params))
        arch = _arch(tmp_path / "arch.json")
        jm, tm = str(tmp_path / "jax_models"), str(tmp_path / "torch_models")
        assert jax_main(["import-model", "--models-dir", jm, "--npz", npz, "--arch", arch, "nostate"]) == 0
        jax_err = capsys.readouterr().err
        assert main(["import-model", "--models-dir", tm, "--npz", npz, "--arch", arch, "nostate"]) == 0
        out, err = _out(capsys)
        assert "running statistics" in err
        assert err.strip().splitlines()[-1] == jax_err.strip().splitlines()[-1]
        assert out.strip() == os.path.join(tm, "nostate")
        assert jax_main(["export-model", "--models-dir", jm, "nostate", str(tmp_path / "j.npz")]) == 0
        assert main(["export-model", "--models-dir", tm, "nostate", str(tmp_path / "t.npz")]) == 0
        got = _npz(tmp_path / "t.npz")
        _assert_bit_equal(got, _npz(tmp_path / "j.npz"))
        state = [k for k in got if k.startswith("state/")]
        assert state and all(
            (got[k] == (1.0 if k.endswith("/var") else 0.0)).all() for k in state
        )

    def test_import_without_state_no_warning_without_bn(self, tmp_path, capsys):
        _, params, _ = _jax_weights(7, norm="none")
        npz = str(tmp_path / "nobn.npz")
        np.savez(npz, **jax_convert.flatten_params(params))
        assert main(["import-model", "--models-dir", str(tmp_path / "m"), "--npz", npz,
                     "--arch", _arch(tmp_path / "arch.json", norm="none"), "nobn"]) == 0
        assert "running statistics" not in capsys.readouterr().err

    def test_import_tf_layout_transposes_up_kernels(self, tmp_path):
        """--layout tf applies the transposed-conv kernel map on up/*
        kernels only, so a TF-exported checkpoint lands correctly."""
        from sequitr_tpu_torch.server.server import read_model

        _, params, _ = _jax_weights(4, norm="none")
        flat = jax_convert.flatten_params(params)
        tf_flat = {
            k: (jax_convert.tf_transpose_kernel_to_jax(v)
                if "/up/" in f"/{k}/" and k.endswith("/w") and v.ndim >= 4 else v)
            for k, v in flat.items()
        }
        npz = str(tmp_path / "tf.npz")
        np.savez(npz, **tf_flat)
        models = str(tmp_path / "models")
        assert main(["import-model", "--models-dir", models, "--npz", npz,
                     "--arch", _arch(tmp_path / "arch.json", norm="none"), "--layout", "tf", "fromtf"]) == 0
        _assert_bit_equal(read_model(models, "fromtf")[2], {k: np.asarray(v) for k, v in flat.items()})


class TestCancelCommand:
    def test_cancel_queued_job(self, tmp_path, capsys):
        jobs = str(tmp_path / "jobs")
        jid = submit_job(jobs, {"module": "m", "output": str(tmp_path / "o")})
        assert len(scan_jobs(jobs)) == 1
        assert main(["cancel", "--jobs-dir", jobs, jid]) == 0
        assert "cancelled" in capsys.readouterr().out
        assert scan_jobs(jobs) == []
        assert not (tmp_path / "jobs" / f"job_{jid}.json.cancelled").exists()
        assert not (tmp_path / "jobs" / f"job_{jid}.json").exists()
        with open(tmp_path / "o" / "status.json") as f:
            assert json.load(f)["state"] == "cancelled"

    def test_cancel_unknown_job_fails(self, tmp_path, capsys):
        jobs = str(tmp_path / "jobs")
        os.makedirs(jobs)
        assert main(["cancel", "--jobs-dir", jobs, "deadbeef"]) == 1
        assert "not in the queue" in capsys.readouterr().err


class TestDoctorCommand:
    @pytest.fixture(autouse=True)
    def _one_thread_probes(self, monkeypatch):
        monkeypatch.setenv("OMP_NUM_THREADS", "1")  # the probes' subprocesses

    def test_doctor_reports_and_exit_code(self, tmp_path, capsys):
        """doctor completes (bounded probes) even when the device is
        unreachable; a ~0 timeout forces that path deterministically."""
        jobs = str(tmp_path / "jobs")
        submit_job(jobs, {"module": "m", "output": str(tmp_path / "o")})
        rc = main(["doctor", "--jobs-dir", jobs, "--models-dir", str(tmp_path / "models"),
                   "--timeout", "0.05"])
        out = capsys.readouterr().out
        assert rc == 1
        assert "accelerator backend" in out and "UNREACHABLE" in out
        assert "1 queued, 0 running, 0 rejected" in out
        assert "native helpers" in out
        assert "check(s) failed" in out

    def test_doctor_missing_jobs_dir_fails(self, tmp_path, capsys):
        rc = main(["doctor", "--jobs-dir", str(tmp_path / "nope"), "--timeout", "0.05"])
        out = capsys.readouterr().out
        assert rc == 1
        assert "does not exist" in out

    def test_doctor_healthy_path_exit_zero(self, tmp_path, capsys, monkeypatch):
        import sequitr_tpu_torch.__main__ as main_mod

        monkeypatch.setattr(
            main_mod, "_DOCTOR_PROBE",
            "import json, sys; print(json.dumps({'backend': 'cuda',"
            " 'n_devices': 1, 'kind': 'FakeDevice', 'init_s': 0.1,"
            " 'matmul_s': 0.2}))",
        )
        jobs = tmp_path / "jobs"
        jobs.mkdir()
        (jobs / ".serve.pid").write_text(str(os.getpid()))  # alive: us
        rc = main_mod.main(["doctor", "--jobs-dir", str(jobs), "--models-dir",
                            str(tmp_path / "models"), "--timeout", "30"])
        out = capsys.readouterr().out
        assert rc == 0, out
        assert "all checks passed" in out
        assert "cuda x1 (FakeDevice), init_s 0.1, matmul_s 0.2" in out
        assert f"pid {os.getpid()} alive" in out

    def test_doctor_without_a_card_fails_the_accelerator_check(self, tmp_path, capsys):
        """The real probes: on a host without a card the accelerator probe
        fails fast (no hang) and the exit is 1; the cpu probe passes."""
        if torch.cuda.is_available():
            pytest.skip("a CUDA card is visible: the accelerator check passes here")
        rc = main(["doctor", "--models-dir", str(tmp_path / "models"), "--timeout", "120"])
        out = capsys.readouterr().out
        assert rc == 1
        assert "[FAIL] accelerator backend: UNREACHABLE (probe crashed" in out
        assert "[ok  ] cpu: 1 device(s)" in out
        assert "1 check(s) failed: accelerator backend" in out


# ---------------------------------------------------------------------------
# parity with the JAX CLI on identical directories
# ---------------------------------------------------------------------------


def _both(capsys, argv_jax, argv_torch):
    """Run the JAX CLI then the port's; returns ((rc, out, err), ...) with
    the program names masked."""
    got = []
    for fn, argv in ((jax_main, argv_jax), (main, argv_torch)):
        rc = fn(argv)
        out, err = _out(capsys)
        got.append((rc, out.replace("sequitr_tpu_torch", "PROG").replace("sequitr_tpu", "PROG"),
                    err.replace("sequitr_tpu_torch", "PROG").replace("sequitr_tpu", "PROG")))
    return got


def _twin_dirs(tmp_path, build):
    """Two identical directories made by ``build(dir)``."""
    a, b = tmp_path / "jax_side", tmp_path / "torch_side"
    build(a)
    shutil.copytree(a, b)
    return str(a), str(b)


class TestParity:
    def test_models_prints_the_same_lines(self, tmp_path, capsys):
        cfg, params, state = _jax_weights(11)
        jm, tm = str(tmp_path / "jm"), str(tmp_path / "tm")
        jax_save_model(jm, "seg", "unet", cfg, params, state)
        npz = str(tmp_path / "seg.npz")
        assert jax_main(["export-model", "--models-dir", jm, "seg", npz]) == 0
        assert main(["import-model", "--models-dir", tm, "--npz", npz, "--arch",
                     os.path.join(jm, "seg", "config.json"), "seg"]) == 0
        capsys.readouterr()
        (j, t) = _both(capsys, ["models", "--models-dir", jm], ["models", "--models-dir", tm])
        assert j == t and "seg" in j[1]
        (j, t) = _both(capsys, ["models", "--models-dir", str(tmp_path / "none")],
                       ["models", "--models-dir", str(tmp_path / "none")])
        assert j == t

    def test_queue_prints_the_same_lines(self, tmp_path, capsys):
        dep = str(tmp_path / "dep")
        failed_dep = tmp_path / "failed_dep"
        failed_dep.mkdir()
        (failed_dep / "status.json").write_text(json.dumps({"state": "failed"}))

        def build(d):
            jobs = str(d)
            submit_job(jobs, {"module": "m", "output": str(tmp_path / "o1")}, job_id="p1")
            submit_job(jobs, {"module": "m", "output": str(tmp_path / "o2"), "depends_on": dep}, job_id="p2")
            submit_job(jobs, {"module": "m", "output": str(tmp_path / "o3"),
                              "depends_on": str(failed_dep)}, job_id="p3")
            for name in ("job_r1.running", "job_r2.running.reclaim", "job_f1.running.failed",
                         "job_x.json.rejected"):
                (d / name).write_text("{}")

        ja, tb = _twin_dirs(tmp_path, build)
        (j, t) = _both(capsys, ["queue", "--jobs-dir", ja], ["queue", "--jobs-dir", tb])
        assert j == t and "[waiting on" in j[1] and "[will fail:" in j[1]

    def test_stats_prints_the_same_lines(self, tmp_path, capsys):
        _ledger(tmp_path / "jobs.jsonl")
        (j, t) = _both(capsys, ["stats", str(tmp_path)], ["stats", str(tmp_path)])
        assert j == t and j[0] == 0
        (j, t) = _both(capsys, ["stats", str(tmp_path / "none")], ["stats", str(tmp_path / "none")])
        assert j[0] == t[0] == 1 and j[1] == t[1] == ""
        assert j[2].split(":")[0] == t[2].split(":")[0] == "cannot read ledger"

    def test_retry_prints_the_same_lines(self, tmp_path, capsys):
        def build(d):
            d.mkdir()
            (d / "job_x1.running.failed").write_text(json.dumps({"module": "m", "id": "x1"}))

        ja, tb = _twin_dirs(tmp_path, build)
        for argv in (["retry", "--jobs-dir"], ["retry", "--jobs-dir"]):  # re-queued, then gone
            (j, t) = _both(capsys, argv + [ja, "x1"], argv + [tb, "x1"])
            assert (j[0], j[1]) == (t[0], t[1])
            assert j[2].replace(ja, "D") == t[2].replace(tb, "D")
        assert sorted(os.listdir(ja)) == sorted(os.listdir(tb)) == ["job_x1.json"]

    def test_cancel_prints_the_same_lines(self, tmp_path, capsys):
        def build(d):
            jobs = str(d)
            submit_job(jobs, {"module": "m", "output": ""}, job_id="queued")
            submit_job(jobs, {"module": "m", "output": ""}, job_id="running")
            os.rename(d / "job_running.json", d / "job_running.running")

        ja, tb = _twin_dirs(tmp_path, build)
        for jid in ("queued", "running", "nope"):
            (j, t) = _both(capsys, ["cancel", "--jobs-dir", ja, jid], ["cancel", "--jobs-dir", tb, jid])
            assert j == t, jid
        assert sorted(os.listdir(ja)) == sorted(os.listdir(tb))

    def test_weights_cross_both_ways_bit_equal(self, tmp_path, capsys):
        """JAX export-model -> port import-model -> port export-model -> JAX
        import-model -> JAX export-model: every array bit-equal; and the
        other way round from a model the port registered."""
        from sequitr_tpu_torch.models import unet
        from sequitr_tpu_torch.server.server import save_model

        cfg, params, state = _jax_weights(12)
        jm, tm = str(tmp_path / "jm"), str(tmp_path / "tm")
        arch = _arch(tmp_path / "arch.json")
        jax_save_model(jm, "a", "unet", cfg, params, state)
        p = {k: str(tmp_path / f"{k}.npz") for k in ("j1", "t1", "j2", "t2", "j3")}
        assert jax_main(["export-model", "--models-dir", jm, "a", p["j1"]]) == 0
        assert main(["import-model", "--models-dir", tm, "--npz", p["j1"], "--arch", arch, "a"]) == 0
        assert main(["export-model", "--models-dir", tm, "a", p["t1"]]) == 0
        assert jax_main(["import-model", "--models-dir", jm, "--npz", p["t1"], "--arch", arch, "b"]) == 0
        assert jax_main(["export-model", "--models-dir", jm, "b", p["j2"]]) == 0
        first = _npz(p["j1"])
        assert any(k.startswith("state/") for k in first)
        _assert_bit_equal(_npz(p["t1"]), first)
        _assert_bit_equal(_npz(p["j2"]), first)
        # the other way: a model the port made
        tcfg = unet.UNetConfig(in_channels=1, num_classes=2, depth=2, base_features=4,
                               norm="batch", compute_dtype="float32")
        model = unet.init(tcfg, torch.Generator().manual_seed(13), device="cpu")
        with torch.no_grad():
            for buf in model.buffers():
                buf.add_(torch.rand(buf.shape, generator=torch.Generator().manual_seed(14)))
        save_model(tm, "c", "unet", tcfg, model)
        assert main(["export-model", "--models-dir", tm, "c", p["t2"]]) == 0
        assert jax_main(["import-model", "--models-dir", jm, "--npz", p["t2"], "--arch", arch, "c"]) == 0
        assert jax_main(["export-model", "--models-dir", jm, "c", p["j3"]]) == 0
        _assert_bit_equal(_npz(p["j3"]), _npz(p["t2"]))
        # the two export lines agree but for the path
        capsys.readouterr()
        (j, t) = _both(capsys, ["export-model", "--models-dir", jm, "c", p["j3"]],
                       ["export-model", "--models-dir", tm, "c", p["t2"]])
        assert j[1].replace(p["j3"], "OUT") == t[1].replace(p["t2"], "OUT")

    @pytest.mark.parametrize("layout", ["tf", "torch"])
    def test_layouts_register_the_same_weights(self, tmp_path, capsys, layout):
        """The same TF- or torch-layout npz through both CLIs' import-model
        --layout: the registered weights export bit-equal."""
        cfg, params, state = _jax_weights(15)
        flat = jax_convert.flatten_params(params)

        def to_layout(k, v):
            if not (k.endswith("/w") and v.ndim >= 4):
                return v
            if "/up/" in f"/{k}/":
                # both maps are their own inverses' transposes: invert explicitly
                if layout == "tf":
                    return jax_convert.tf_transpose_kernel_to_jax(v)
                nd = v.ndim
                return np.transpose(v, (nd - 2, nd - 1) + tuple(range(nd - 2)))
            if layout == "torch":
                nd = v.ndim
                return np.transpose(v, (nd - 1, nd - 2) + tuple(range(nd - 2)))
            return v

        src = {k: to_layout(k, v) for k, v in flat.items()}
        src.update({f"state/{k}": v for k, v in jax_convert.flatten_params(state).items()})
        npz = str(tmp_path / "src.npz")
        np.savez(npz, **src)
        arch = _arch(tmp_path / "arch.json")
        jm, tm = str(tmp_path / "jm"), str(tmp_path / "tm")
        assert jax_main(["import-model", "--models-dir", jm, "--npz", npz, "--arch", arch,
                         "--layout", layout, "m"]) == 0
        assert main(["import-model", "--models-dir", tm, "--npz", npz, "--arch", arch,
                     "--layout", layout, "m"]) == 0
        assert jax_main(["export-model", "--models-dir", jm, "m", str(tmp_path / "j.npz")]) == 0
        assert main(["export-model", "--models-dir", tm, "m", str(tmp_path / "t.npz")]) == 0
        got = _npz(tmp_path / "t.npz")
        _assert_bit_equal(got, _npz(tmp_path / "j.npz"))
        _assert_bit_equal({k: v for k, v in got.items() if not k.startswith("state/")},
                          {k: np.asarray(v) for k, v in flat.items()})
        _, _, p2, _ = jax_load_model(jm, "m")
        assert len(jax.tree_util.tree_leaves(p2)) == len(flat)


class TestProfileParam:
    @pytest.fixture(scope="class")
    def served(self, tmp_path_factory):
        from sequitr_tpu_torch.data import synthetic, tiff
        from sequitr_tpu_torch.models import unet
        from sequitr_tpu_torch.server.server import save_model

        tmp = tmp_path_factory.mktemp("profile")
        cfg = unet.UNetConfig(depth=2, base_features=4, num_classes=3, compute_dtype="float32")
        models = str(tmp / "models")
        save_model(models, "seg", "unet", cfg, unet.init(cfg, torch.Generator().manual_seed(2), device="cpu"))
        frames = np.stack([synthetic.cells_frame(424_300 + i, (32, 32))[0] for i in range(2)])
        stack = str(tmp / "stack.tif")
        tiff.write_stack(stack, frames.clip(0, 65535).astype(np.uint16))
        return tmp, models, stack

    def _run(self, served, name, profile):
        from sequitr_tpu_torch.config import ServerConfiguration
        from sequitr_tpu_torch.server import ImageServer

        tmp, models, stack = served
        jobs = str(tmp / f"jobs_{name}")
        params = {"model": "seg", "localize": False}
        if profile:
            params["profile"] = True
        out = str(tmp / name)
        submit_job(jobs, {"module": "segmentation_unet2d", "params": params, "input": [stack], "output": out})
        assert ImageServer(ServerConfiguration(jobs_dir=jobs, models_dir=models, device="cpu")).poll_once()
        with open(os.path.join(out, "status.json")) as f:
            status = json.load(f)
        assert status["state"] == "complete", status.get("error")
        return out, status

    def test_profiled_job_writes_a_trace_and_the_same_labels(self, served):
        from sequitr_tpu_torch.data import tiff

        plain, st_plain = self._run(served, "plain", False)
        prof, st_prof = self._run(served, "prof", True)
        assert "profile" not in st_plain["outputs"] and not st_plain.get("warnings")
        assert st_prof["outputs"]["profile"] == os.path.join(prof, "profile")
        assert not st_prof.get("warnings")  # the param is read
        trace = os.path.join(prof, "profile", "trace.json")
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        assert any("conv" in str(e.get("name", "")) for e in events)
        assert np.array_equal(tiff.read_stack(os.path.join(plain, "labels.tif")),
                              tiff.read_stack(os.path.join(prof, "labels.tif")))

    def test_a_stale_trace_does_not_fail_the_next_profiled_job(self, served):
        """A profiled job the watchdog abandoned leaves its trace running on
        a thread nobody joins: the next profiled job still completes with
        its trace."""
        from sequitr_tpu_torch import utils

        started, release = threading.Event(), threading.Event()

        def abandoned():
            with utils.trace(str(served[0] / "stale_profile")):
                started.set()
                release.wait(60)

        t = threading.Thread(target=abandoned, daemon=True)
        t.start()
        assert started.wait(30)
        try:
            out, status = self._run(served, "after_stale", True)
            with open(os.path.join(out, "profile", "trace.json")) as f:
                events = json.load(f)["traceEvents"]
            assert any("conv" in str(e.get("name", "")) for e in events)
            # the stale trace was stopped when the new one took over, into its own directory
            assert os.path.getsize(served[0] / "stale_profile" / "trace.json") > 0
        finally:
            release.set()
            t.join(30)
        assert not t.is_alive()
