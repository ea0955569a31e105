"""The image server: watched-dir loop, pipeline registry, model store.

Port of ``sequitr_tpu.server.server``, the part the segmentation (2D and
3D), GAN enhancement, denoising, instance segmentation (flows and stars
serving), evaluation and parity, U-Net and GAN training jobs need. A single-process loop scans
the jobs directory, atomically claims each job, dispatches to the
registered pipeline and writes results plus a status marker into the job's
output directory — the same filesystem contract, job JSON and outputs as
the JAX server.

Model store: ``models_dir/<name>/config.json`` (the architecture, with
``__kind__``, the same file the JAX server writes) plus ``weights.npz`` in
the flat interchange layout (``models.convert``) in place of the JAX
server's orbax checkpoint. ``python -m sequitr_tpu export-model`` output
imports with ``python -m sequitr_tpu_torch import-model``.

Jobs run on ``config.device`` (default the CUDA card), training jobs too.
The job param ``profile: true`` traces a job with ``torch.profiler``
(``utils.trace``) into ``<output>/profile``.
``data_parallel`` and ``spatial_parallel`` shard over the devices of
``parallel.device_pool(config.device)`` (every card; on a pool of one
device the jobs stream single-device, as the JAX server does on one chip).
``config.trace_spans`` (``serve --trace-spans``) keeps the process's spans
(``tracing``) from start to drain and writes them to ``spans.json`` in
``log_dir`` (else ``jobs_dir``) on exit: this thread's ``server.poll``,
``server.job``, ``server.status`` and ``server.ledger``, and the jobs'.
Without it, the server keeps them in memory only while a ``torch.profiler``
session runs in its process (one started around ``run_forever``), so that
session's trace carries them.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
import traceback
from typing import Callable, Dict

import numpy as np

from sequitr_tpu_torch import tracing
from sequitr_tpu_torch.config import ServerConfiguration
from sequitr_tpu_torch.server import jobs as jobs_lib
from sequitr_tpu_torch.server.jobs import Job
from sequitr_tpu_torch.utils import resolve_device

log = logging.getLogger("sequitr_tpu_torch.server")

__all__ = [
    "PipelineRegistry", "ImageServer", "REGISTRY", "register", "JobTimeout",
    "save_model", "read_model", "load_model", "load_model_cached",
]


class JobTimeout(RuntimeError):
    """A job exceeded the server's per-job wall-clock budget."""


# process exit code for a deliberate post-timeout worker recycle
EXIT_RECYCLE = 43


class PipelineRegistry:
    """(module, func) -> pipeline callable(job, config) registry.

    Jobs name a module plus an optional sub-operation ``func``. Unknown
    module or func is a deterministic JobError listing what exists.
    """

    def __init__(self):
        self._pipelines: Dict[str, Dict[str, Callable]] = {}

    def register(self, name: str, func: str = "run"):
        def deco(fn):
            self._pipelines.setdefault(name, {})[func] = fn
            return fn

        return deco

    def get(self, name: str, func: str = "run") -> Callable:
        if name not in self._pipelines:
            raise jobs_lib.JobError(
                f"unknown pipeline {name!r}; available: {sorted(self._pipelines)}"
            )
        funcs = self._pipelines[name]
        if func not in funcs:
            raise jobs_lib.JobError(
                f"pipeline {name!r} has no func {func!r}; available: {sorted(funcs)}"
            )
        return funcs[func]

    def names(self):
        return sorted(self._pipelines)


REGISTRY = PipelineRegistry()
register = REGISTRY.register


class ImageServer:
    """Long-lived job server. Refuses to start on ``device="cuda"`` without
    a CUDA card (pass ``device="cpu"`` in the configuration to serve on the
    CPU)."""

    def __init__(self, config: ServerConfiguration, registry: PipelineRegistry = REGISTRY):
        self.config = config
        self.registry = registry
        self.device = resolve_device(config.device)
        config.ensure_dirs()
        # the tracer this server turned on: for its whole life with
        # ``trace_spans``, else while a profiler session runs (``_follow_profiler``)
        self._tracer = tracing.enable() if config.trace_spans else None

    def _spans_path(self) -> str:
        """Where ``close`` writes the spans (``trace_spans``): ``spans.json``
        in ``log_dir`` (else ``jobs_dir``); a supervised worker's carries
        its id, ``spans.w<id>.json``."""
        worker = os.environ.get("SEQUITR_WORKER_ID")
        name = "spans.json" if worker is None else f"spans.w{worker}.json"
        return os.path.join(self.config.log_dir or self.config.jobs_dir, name)

    def _follow_profiler(self) -> None:
        """Without ``trace_spans``, keep spans while a ``torch.profiler``
        session runs in this process, so a profiled server's device trace
        carries them (each bridged span is a ``user_annotation``); checked
        at each claim, before the job's spans open. The records stay in
        memory (``tracing.latest()``); nothing is written."""
        if self.config.trace_spans:
            return
        if tracing.profiling():
            if tracing.active() is None:
                self._tracer = tracing.enable()
        elif self._tracer is not None and tracing.active() is self._tracer:
            tracing.disable()

    def close(self) -> None:
        """Stop keeping spans, and write them with ``trace_spans``.
        ``run_forever`` calls it on its way out."""
        tracer, self._tracer = self._tracer, None
        if tracer is None:
            return
        if tracing.active() is tracer:
            tracing.disable()
        if not self.config.trace_spans:
            return
        try:
            tracer.write_chrome(self._spans_path())
        except OSError:
            log.warning("could not write the spans", exc_info=True)

    def run_forever(self, early_drain=None) -> None:  # pragma: no cover - interactive loop
        """Poll loop with graceful drain.

        SIGUSR1 = drain: finish the job currently running, then exit 0
        leaving the queue untouched. ``early_drain``: optional
        ``{"drain": bool}`` populated by a boot-time handler, so a signal
        that arrived while the process was still starting is not lost.
        """
        import signal

        def _drain(signum, frame):
            self._draining = True
            log.info("drain requested: finishing the current job, then exiting")

        self._draining = False
        try:
            signal.signal(signal.SIGUSR1, _drain)
        except (ValueError, OSError, AttributeError):
            pass  # non-main thread or platform without SIGUSR1
        if early_drain and early_drain.get("drain"):
            self._draining = True
        log.info(
            "server watching %s on %s (pipelines: %s)",
            self.config.jobs_dir, self.device, self.registry.names(),
        )
        try:
            while not self._draining:
                ran = self.poll_once()
                if self._draining:
                    break
                if not ran:
                    deadline = time.monotonic() + self.config.poll_interval
                    while not self._draining:
                        left = deadline - time.monotonic()
                        if left <= 0:
                            break
                        time.sleep(min(left, 0.2))
        finally:
            self.close()
        log.info("drained: exiting cleanly")

    def poll_once(self) -> bool:
        """Claim and run at most one queued job. Returns True if one ran.

        A job file that cannot be parsed (invalid JSON, missing ``module``)
        is quarantined as ``<name>.rejected`` instead of crashing the loop.
        Spans: the scan and claim are ``server.poll`` (``found``: the id of
        the job claimed, or None), the job from claim to ledger row
        ``server.job``.
        """
        with tracing.span("server.poll") as poll:
            job = self._claim_next()
            poll.set(found=None if job is None else job.id)
        if job is None:
            return False
        self._follow_profiler()
        with tracing.job(job.id), tracing.span("server.job"):
            self._execute(job)
        return True

    def _claim_next(self):
        """Claim the first runnable queued job (failing those whose
        dependencies failed on the way); None when there is none."""
        if self.config.stale_claim_timeout:
            jobs_lib.reclaim_stale_claims(
                self.config.jobs_dir, self.config.stale_claim_timeout
            )
        for path in jobs_lib.scan_jobs(self.config.jobs_dir):
            if getattr(self, "_draining", False):
                return None
            dep_state, dep_detail = jobs_lib.check_dependencies(path)
            if dep_state == "wait":
                continue
            try:
                job = jobs_lib.claim_job(path)
            except (jobs_lib.JobError, ValueError) as e:
                claimed = path[: -len(jobs_lib.JOB_SUFFIX)] + jobs_lib.CLAIMED_SUFFIX
                rejected = path + ".rejected"
                for cand in (claimed, path):
                    if os.path.exists(cand):
                        os.replace(cand, rejected)
                        break
                log.error("rejected malformed job %s: %s", path, e)
                continue
            if job is None:
                continue
            if dep_state == "fail":
                started = time.time()
                self._fail(job, started, f"job {job.id}: {dep_detail}")
                self._ledger(job, "failed", started, 0)
                continue
            return job
        return None

    def _execute(self, job: Job) -> None:
        started = time.time()
        # track which params the pipeline actually reads so misspelled
        # ones surface as warnings instead of silently running with defaults
        job.params = jobs_lib.ParamTracker(job.params)
        os.makedirs(job.output or ".", exist_ok=True)
        try:
            os.unlink(
                os.path.join(
                    job.output or os.path.dirname(job.path), "progress.json"
                )
            )
        except OSError:
            pass
        jobs_lib.write_status(job, "running", started)
        attempts = 0
        while True:
            attempts += 1
            try:
                pipeline = self.registry.get(job.module, job.func)
                if job.params.get("profile"):
                    pipeline = _profiled(pipeline)
                outputs = self._run_with_watchdog(pipeline, job) or {}
                unread = job.params.unread_keys()
                warnings = list(job.runtime_warnings) or None
                if unread:
                    warnings = (warnings or []) + [
                        f"unknown param {k!r}: never read by "
                        f"{job.module!r} (misspelled?)" for k in unread
                    ]
                    log.warning(
                        "job %s: params never read by %s: %s",
                        job.id, job.module, ", ".join(unread),
                    )
                jobs_lib.write_status(
                    job, "complete", started, outputs=outputs,
                    warnings=warnings,
                )
                if jobs_lib.owns_claim(job):
                    try:
                        os.unlink(job.path)
                    except OSError:
                        pass
                    jobs_lib.clear_cancel(job)
                else:
                    log.warning(
                        "job %s finished but its claim was reclaimed "
                        "(heartbeat starved?); the job may run again", job.id,
                    )
                log.info("job %s complete in %.2fs", job.id, time.time() - started)
                self._ledger(job, "complete", started, attempts)
                return
            except jobs_lib.JobCancelled as e:
                jobs_lib.write_status(job, "cancelled", started, error=str(e))
                if jobs_lib.owns_claim(job):
                    try:
                        os.unlink(job.path)
                    except OSError:
                        pass
                    jobs_lib.clear_cancel(job)
                log.info("job %s cancelled in %.2fs", job.id, time.time() - started)
                self._ledger(job, "cancelled", started, attempts)
                return
            except Exception as e:
                err = traceback.format_exc()
                # deterministic failures (bad module/func/params/inputs) and
                # watchdog timeouts never retry: re-running cannot succeed
                final = (
                    attempts > self.config.max_retries
                    or isinstance(e, (jobs_lib.JobError, JobTimeout))
                )
                if final:
                    self._fail(job, started, err)
                    self._ledger(job, "failed", started, attempts)
                    if isinstance(e, JobTimeout) and self._recycle_on_timeout():
                        log.error(
                            "job %s timed out; recycling worker (exit %d)",
                            job.id, EXIT_RECYCLE,
                        )
                        os._exit(EXIT_RECYCLE)
                    return
                log.warning("job %s attempt %d failed, retrying", job.id, attempts)
                time.sleep(self.config.retry_backoff * attempts)

    def _ledger(self, job: Job, state: str, started: float, attempts: int) -> None:
        """Append one JSONL row per finished job to ``log_dir/jobs.jsonl``
        (the span ``server.ledger``)."""
        if not self.config.log_dir:
            return
        row = {
            "id": job.id,
            "module": job.module,
            "func": job.func,
            "state": state,
            "elapsed_s": round(time.time() - started, 3),
            "attempts": attempts,
            "finished": time.time(),
            "worker": os.environ.get("SEQUITR_WORKER_ID"),
        }
        try:
            with tracing.span("server.ledger"), open(
                os.path.join(self.config.log_dir, "jobs.jsonl"), "a"
            ) as f:
                f.write(json.dumps(row) + "\n")
        except OSError:
            log.warning("could not append to the jobs ledger", exc_info=True)

    def _recycle_on_timeout(self) -> bool:
        cfg = self.config.recycle_on_timeout
        if cfg is not None:
            return bool(cfg)
        return os.environ.get("SEQUITR_WORKER_ID") is not None

    def _fail(self, job: Job, started: float, err: str) -> None:
        jobs_lib.write_status(job, "failed", started, error=err)
        if jobs_lib.owns_claim(job):
            jobs_lib.clear_cancel(job)
            try:
                os.replace(job.path, job.path + ".failed")
            except OSError:
                pass
        log.error("job %s failed:\n%s", job.id, err)

    def _run_with_watchdog(self, pipeline, job: Job):
        """Run the pipeline on a worker thread, bounded by
        ``config.job_timeout`` wall seconds, heartbeating the claimed file's
        mtime (the liveness signal stale-claim reclaim keys on)."""
        timeout = self.config.job_timeout
        import threading

        result: list = []
        error: list = []

        def work():
            try:
                with tracing.job(job.id):
                    result.append(pipeline(job, self.config))
            except BaseException as e:  # propagated below
                error.append(e)

        t = threading.Thread(target=work, daemon=True, name=f"job-{job.id}")
        t.start()
        hb = 5.0
        if self.config.stale_claim_timeout:
            hb = min(hb, self.config.stale_claim_timeout / 6.0)
        deadline = time.monotonic() + timeout if timeout else None
        while True:
            wait = hb
            if deadline is not None:
                wait = min(hb, max(deadline - time.monotonic(), 0.0))
            t.join(wait)
            if not t.is_alive():
                break
            jobs_lib.heartbeat(job)
            if deadline is not None and time.monotonic() >= deadline:
                raise JobTimeout(
                    f"job {job.id} exceeded job_timeout={timeout}s; "
                    "abandoning worker thread and failing the job"
                )
        if error:
            raise error[0]
        return result[0]


def _profiled(pipeline):
    """Wrap a pipeline in a ``torch.profiler`` trace (job param ``profile:
    true``): the Chrome trace lands in ``<job output>/profile`` and the
    path is added to the job outputs, as the JAX server adds its trace's."""

    def run(job, config):
        from sequitr_tpu_torch import utils

        pdir = os.path.join(job.output or ".", "profile")
        with utils.trace(pdir):
            outputs = pipeline(job, config) or {}
        outputs.setdefault("profile", pdir)
        return outputs

    return run


# ---------------------------------------------------------------------------
# model store
# ---------------------------------------------------------------------------

_WEIGHTS = "weights.npz"


def save_model(models_dir: str, name: str, kind: str, cfg, model) -> str:
    """Persist a model (``config.json`` + ``weights.npz``) for server use."""
    from sequitr_tpu_torch.models import convert as convert_lib

    model_dir = os.path.join(models_dir, name)
    os.makedirs(model_dir, exist_ok=True)
    cfg_dict = dataclasses.asdict(cfg)
    cfg_dict["__kind__"] = kind
    np.savez(os.path.join(model_dir, _WEIGHTS), **convert_lib.to_flat(model))
    with open(os.path.join(model_dir, "config.json"), "w") as f:
        json.dump(cfg_dict, f, indent=2)
    return model_dir


def read_model(models_dir: str, name: str):
    """``(kind, cfg, flat)`` of a model saved by ``save_model``: its stored
    configuration (a ``GANConfig`` for kind ``gan``, a ``CPnetConfig`` for
    ``cpnet``, else a ``UNetConfig``)
    and its weights in the flat interchange layout, unfolded."""
    from sequitr_tpu_torch.models import fixtures

    model_dir = os.path.join(models_dir, name)
    with open(os.path.join(model_dir, "config.json")) as f:
        cfg_dict = json.load(f)
    kind = cfg_dict.pop("__kind__")
    cfg_cls = fixtures.config_class(kind)
    known = {f.name for f in dataclasses.fields(cfg_cls)}
    unknown = sorted(set(cfg_dict) - known)
    if unknown:
        log.warning(
            "model %s: ignoring unknown config fields %s "
            "(saved by a newer version?)", name, unknown
        )
        cfg_dict = {k: v for k, v in cfg_dict.items() if k in known}
    cfg = cfg_cls(**cfg_dict)
    with np.load(os.path.join(model_dir, _WEIGHTS)) as npz:
        flat = {k: npz[k] for k in npz.files}
    return kind, cfg, flat


def load_model(models_dir: str, name: str, device=None):
    """Load ``(kind, cfg, model)`` saved by ``save_model``.

    ``cfg`` is the stored configuration (``read_model``); ``model`` has its
    batch norm folded into the convs (once, here, in f32:
    ``unet.fold_batchnorm``, ``gan.fold_generator``; a CPnet's
    ``cpnet.fold``, which keeps the batch norms before a ReLU as affines)
    and lives on ``device``.
    """
    from sequitr_tpu_torch.models import convert as convert_lib
    from sequitr_tpu_torch.models import cpnet, gan, unet

    kind, cfg, flat = read_model(models_dir, name)
    model = convert_lib.load_flat(cfg, flat, device=device)
    fold = {"gan": gan.fold_generator, "cpnet": cpnet.fold}.get(kind, unet.fold_batchnorm)
    return kind, cfg, fold(model)


# (stamp, loaded) per (model dir, device): a warm server shares one loaded
# copy across jobs; config.json + weights mtimes invalidate it
_MODEL_CACHE: Dict[tuple, tuple] = {}
_MODEL_CACHE_MAX = 8


def _model_stamp(model_dir: str):
    try:
        cfg_ns = os.stat(os.path.join(model_dir, "config.json")).st_mtime_ns
        w_ns = os.stat(os.path.join(model_dir, _WEIGHTS)).st_mtime_ns
    except OSError:
        return None
    return (cfg_ns, w_ns)


def load_model_cached(models_dir: str, name: str, device=None):
    """``load_model`` with a cross-job cache (stale entries re-load)."""
    device = resolve_device(device)
    model_dir = os.path.abspath(os.path.join(models_dir, name))
    key = (model_dir, str(device))
    stamp = _model_stamp(model_dir)
    entry = _MODEL_CACHE.get(key)
    if entry is not None and stamp is not None and entry[0] == stamp:
        return entry[1]
    loaded = load_model(models_dir, name, device=device)
    if stamp is not None:
        if len(_MODEL_CACHE) >= _MODEL_CACHE_MAX:
            _MODEL_CACHE.pop(next(iter(_MODEL_CACHE)))
        _MODEL_CACHE[key] = (stamp, loaded)
    return loaded


def _require_model(job: Job, config: ServerConfiguration, expect_kind=None, unfolded=False):
    """Load the job's model on ``config.device``, raising deterministic
    JobErrors for a missing param, an unregistered name or the wrong kind.
    Returns ``(cfg, model)`` (``(kind, cfg, model)`` for
    ``expect_kind=None``). ``unfolded``: ``model`` is the stored weights in
    the flat layout (``read_model``), not a loaded module."""
    name = job.params.get("model")
    if not name:
        raise jobs_lib.JobError(f"job {job.id}: missing required param 'model'")
    try:
        if unfolded:
            kind, cfg, model = read_model(config.models_dir, name)
        else:
            kind, cfg, model = load_model_cached(
                config.models_dir, name, device=config.device
            )
    except (FileNotFoundError, KeyError, NotImplementedError) as e:
        raise jobs_lib.JobError(f"job {job.id}: model {name!r} not loadable: {e!r}")
    if expect_kind is None:
        return kind, cfg, model
    if kind != expect_kind:
        raise jobs_lib.JobError(
            f"job {job.id}: model {name!r} is kind {kind!r}, expected {expect_kind!r}"
        )
    return cfg, model


# ---------------------------------------------------------------------------
# shared pipeline helpers
# ---------------------------------------------------------------------------


def _reject_low_confidence(resp, min_response: float, stats: dict) -> bool:
    """The registration confidence gate, shared by the 2D and volumetric
    estimators so the hold policy cannot drift apart: True = reject this
    estimate (counted in ``stats``) — the caller yields the held
    trajectory and skips the anchor update. Reading a device response
    waits for it."""
    if min_response and float(resp) < min_response:
        stats["n"] += 1
        return True
    return False


def _expand_inputs_entry(path: str):
    """Ordered file list for one input entry (dir/glob expansion) — [path]
    for a plain file; never raises (callers decide what emptiness means)."""
    from sequitr_tpu_torch.data.source import _expand_channel

    try:
        return _expand_channel(path)
    except ValueError:
        return [path]


def _parse_z_pages(job: Job):
    """The ``z`` (pages-per-volume) param as int or None; a bad value is a
    deterministic JobError (shared by every volume-timelapse pipeline)."""
    z_param = job.params.get("z")
    try:
        return None if z_param is None else int(z_param)
    except (TypeError, ValueError):
        raise jobs_lib.JobError(
            f"z={z_param!r} must be an integer (pages per volume)"
        )


def _read_stack_or_fail(job: Job, path: str) -> np.ndarray:
    """Read a TIFF stack in its stored dtype; unreadable input is
    deterministic — fail fast."""
    from sequitr_tpu_torch.data import tiff

    try:
        return np.asarray(tiff.read_stack(path))
    except ValueError as e:
        raise jobs_lib.JobError(f"job {job.id}: cannot read {path}: {e}")


def _robust_threshold(arr: np.ndarray, thr_abs, k_sig: float) -> float:
    """Absolute threshold if given, else robust per-frame median + k*MAD
    (host numpy, the JAX server's)."""
    if thr_abs is not None:
        return float(thr_abs)
    med = float(np.median(arr))
    mad = float(np.median(np.abs(arr - med))) * 1.4826
    return med + k_sig * max(mad, 1e-12)


def _volume_chunks(seq, n: int):
    """float32 view of ``VolumeSequence.chunks``: the feed of the
    timepoint-sharded data-parallel jobs (3D localization, 3D denoise)."""
    for c in seq.chunks(n):
        yield np.asarray(c, np.float32)


def _dp_chunk_stream(job: Job, chunks_iter, n_items: int, chunk_n: int, phase: str = "chunks"):
    """Yield ``(chunk, n_real)`` over a padded chunk stream: the shared
    scaffolding of the chunked data-parallel loops (localization,
    deconvolution, 3D denoise): disk reads two chunks ahead, progress and
    cancellation a chunk, fail-fast reads, and the count of real (unpadded)
    items in each chunk."""
    from sequitr_tpu_torch.pipeline import infer as infer_lib

    n_chunks = (n_items + chunk_n - 1) // chunk_n
    it = jobs_lib.track(
        job, infer_lib._iter_read_ahead(chunks_iter, 2), total=n_chunks, phase=phase,
    )
    left = n_items
    for chunk in _reads_fail_fast(job, iter(it)):
        yield chunk, min(chunk_n, left)
        left -= chunk_n


def _n_devices(device) -> int:
    """How many devices a job on ``device`` may shard over
    (``parallel.device_pool``)."""
    from sequitr_tpu_torch.parallel import device_pool

    return len(device_pool(device))


def _require_param(job: Job, key: str):
    val = job.params.get(key)
    if not val:
        raise jobs_lib.JobError(f"job {job.id}: missing required param {key!r}")
    return val


def _parse_ignore_label(job: Job):
    """``ignore_label`` as int or None; malformed is a deterministic JobError."""
    ig = job.params.get("ignore_label")
    if ig is None:
        return None
    try:
        return int(ig)
    except (TypeError, ValueError):
        raise jobs_lib.JobError(f"ignore_label={ig!r} must be an int")


def _check_ignore_collision(ignore_label, num_classes: int) -> None:
    if ignore_label is not None and 0 <= ignore_label < num_classes:
        raise jobs_lib.JobError(
            f"ignore_label={ignore_label} collides with the class range "
            f"[0, {num_classes}) — use a value outside it (e.g. 255)"
        )


def _parse_eval_ignore(job: Job, k: int):
    """The evaluate family's ``ignore_label``: ground truth carrying this
    value is excluded from every metric (score only where a human
    annotated). Deterministic errors on malformed or colliding values."""
    ig = _parse_ignore_label(job)
    _check_ignore_collision(ig, k)
    return ig


def _parse_patience(p: dict) -> int:
    """Validated ``early_stop_patience`` (a JobError, never a retried
    ValueError)."""
    raw = p.get("early_stop_patience", 0)
    try:
        v = int(raw or 0)
    except (TypeError, ValueError):
        raise jobs_lib.JobError(f"early_stop_patience={raw!r} must be an integer >= 0")
    if v < 0:
        raise jobs_lib.JobError(f"early_stop_patience={v} must be >= 0 (0 = off)")
    return v


def _parse_ema_decay(p: dict) -> float:
    raw = p.get("ema_decay", 0.0)
    try:
        v = float(raw or 0.0)
    except (TypeError, ValueError):
        raise jobs_lib.JobError(f"ema_decay={raw!r} must be a number in [0, 1)")
    if not 0.0 <= v < 1.0:
        raise jobs_lib.JobError(f"ema_decay={v} must be in [0, 1)")
    return v


def _ema_or_raw_params(ckpt_dir: str, fc, state, used_best: bool, subtree=None):
    """The module a finished train job registers: with ``ema_decay``, the
    EMA twin of the checkpoint being registered (``ema_best`` when
    keep_best chose it, else ``ema_final``) as parameters beside the
    state's batch-norm statistics; else the state's own module.
    ``subtree``: the submodule the EMA covers (a GAN's ``"gen"``); the
    rest keeps its raw weights."""
    from sequitr_tpu_torch.models import convert as convert_lib
    from sequitr_tpu_torch.pipeline import train as train_lib

    if not fc.ema_decay:
        return state.model
    # pair like with like: keep_best's state takes only its own ema_best
    name = "ema_best" if used_best else "ema_final"
    path = os.path.join(ckpt_dir, name)
    if not os.path.isdir(path):
        log.warning(
            "ema_decay set but %s missing (checkpoint predates EMA?); "
            "registering raw weights", path,
        )
        return state.model
    device = next(state.model.parameters()).device
    model = convert_lib.build(state.model.cfg, device=device)
    model.load_state_dict(state.model.state_dict())
    target = getattr(model, subtree) if subtree else model
    train_lib.restore_checkpoint(path, list(target.parameters()))
    return model


def _resolve_globs(job: Job):
    """Record-shard input entries: globs pass through, a directory means
    its ``*.tfrecord`` members (a build_records output directory)."""
    if not job.input:
        raise jobs_lib.JobError(f"job {job.id}: no input paths")
    return [
        os.path.join(p, "*.tfrecord") if os.path.isdir(p) else p
        for p in job.input
    ]


def _resolve_inputs(job: Job):
    import glob as glob_lib

    if not job.input:
        raise jobs_lib.JobError(f"job {job.id}: no input paths")
    for p in job.input:
        if os.path.exists(p):
            continue
        # a glob pattern that matches at least one file is a valid entry
        if any(ch in p for ch in "*?[") and glob_lib.glob(p):
            continue
        raise jobs_lib.JobError(f"job {job.id}: input not found: {p}")
    return job.input


def _truth_reader(job: Job, path: str):
    """``(shape, read_truth, close)`` of a ground-truth label stack: frames
    read lazily as int64 (``read_truth(t)``), or the eager read for layouts
    the lazy reader cannot parse."""
    from sequitr_tpu_torch.data import tiff

    try:
        reader = tiff.TiffReader(path)
    except ValueError:
        arr = _read_stack_or_fail(job, path).astype(np.int64)
        if arr.ndim == 2:
            arr = arr[None]
        return arr.shape, lambda i: arr[i], lambda: None
    return (
        reader.shape,
        lambda i: np.asarray(reader.read_frame(i), dtype=np.int64),
        reader.close,
    )


def _check_truth_shape(source, t_shape) -> None:
    """The truth must cover the UNDERLYING stack: comparisons index it at
    absolute frame positions (``frame_range`` offsets apply)."""
    shape = (source.frame_offset + len(source),) + tuple(source.spatial)
    if tuple(t_shape)[1:] != tuple(source.spatial) or t_shape[0] < shape[0]:
        raise jobs_lib.JobError(
            f"image/label shape mismatch: need >= {shape}, got {tuple(t_shape)}"
        )


def _normalized_entropy(probs: np.ndarray, n_classes: int) -> np.ndarray:
    """-sum(p log p)/log(K) over the trailing class axis, float32 in [0,1]."""
    p32 = probs.astype(np.float32, copy=False)
    ent = -(p32 * np.log(np.maximum(p32, 1e-12))).sum(axis=-1) / np.log(
        n_classes
    )
    return ent.astype(np.float32)


def _out_compression(job: Job) -> str:
    """'deflate' when the job sets ``compress_output`` (label maps shrink
    ~50x); uncompressed by default."""
    return "deflate" if job.params.get("compress_output") else "none"


def _append_writer(path: str, est_bytes: float, compression: str = "none"):
    """Page-append writer, BigTIFF when the estimated output could brush
    the classic 4 GiB offset limit."""
    from sequitr_tpu_torch.data import tiff

    return tiff.TiffAppendWriter(
        path, bigtiff=est_bytes > 0xD0000000, compression=compression
    )


# frames up to this many pixels run whole-frame when the client did not
# request a tiling (the JAX package's budget, kept so the same job JSON
# tiles the same way on both servers: a 1024^2 frame is one patch)
_WHOLE_FRAME_BUDGET = 4_400_000


def _tile_config(
    params: dict,
    dims: int = 2,
    frame_spatial=None,
    min_multiple: int = 1,
    exact_only: bool = False,
    allow_polyphase: bool = False,
):
    """Tiling policy for a job.

    Explicit ``patch``/``overlap`` params always win. Otherwise, frames
    within the whole-frame budget run as ONE patch (rounded up to the
    model's pooling multiple — the inferrer mirror-pads and crops); larger
    frames fall back to the default sliding-window grid.
    """
    from sequitr_tpu_torch.pipeline import infer as infer_lib

    default_patch = (256, 256) if dims == 2 else (16, 128, 128)
    default_overlap = (64, 64) if dims == 2 else (4, 32, 32)
    patch = params.get("patch")
    overlap = params.get("overlap")
    if patch is None and frame_spatial is not None:
        rounded = tuple(
            -(-s // min_multiple) * min_multiple for s in frame_spatial
        )
        fits = np.prod(rounded) <= _WHOLE_FRAME_BUDGET
        if fits and (not exact_only or rounded == tuple(frame_spatial)):
            patch = rounded
            overlap = overlap or (0,) * dims
    patch = tuple(patch) if patch is not None else default_patch
    overlap = tuple(overlap) if overlap is not None else default_overlap
    if (
        int(params.get("tta", 1)) == 8
        and dims == 2
        and frame_spatial is not None
    ):
        padded = tuple(max(s, p) for s, p in zip(frame_spatial, patch))
        if padded[0] != padded[1]:
            raise jobs_lib.JobError(
                f"tta=8 needs a square frame in 2D (transpose variant); "
                f"frame is {tuple(frame_spatial)} -> padded {padded}. "
                "Use tta=4 or a square crop."
            )
    pb = params.get("patch_batch")
    if pb is not None:
        pb = int(pb)
        if pb < 1:
            raise jobs_lib.JobError(
                f"patch_batch must be >= 1 (omit it for auto), got {pb}"
            )
    # polyphase serving forward (models.polyphase): only the pipelines that
    # honor it read the param; elsewhere it stays unread and the completion
    # status carries the unknown-param warning
    poly = bool(params.get("polyphase", False)) if allow_polyphase else False
    # 2D phases all axes; 3D phases (H, W) only
    if poly and any(p % 2 for p in patch[-2:]):
        raise jobs_lib.JobError(
            f"polyphase needs even H/W patch axes, got {tuple(patch)}"
        )
    try:
        return infer_lib.TileConfig(
            patch=patch,
            overlap=overlap,
            window=params.get("window", "hann"),
            normalize=params.get("normalize", "auto"),
            p_lo=float(params.get("p_lo", 5.0)),
            p_hi=float(params.get("p_hi", 99.5)),
            patch_batch=pb,
            # labels leave the device as uint16, the on-disk format
            labels_dtype="uint16",
            probs_dtype=str(params.get("probs_dtype", "float32")),
            tta=int(params.get("tta", 1)),
            polyphase=poly,
        )
    except ValueError as e:
        # bad tiling/dtype params are deterministic — fail fast, never retry
        raise jobs_lib.JobError(str(e))


def _require_polyphase_model(cfg) -> None:
    """Deterministic rejection for models the polyphase serve can't cover
    (``cfg``: the serving model's ``UNetConfig``); shared by every pipeline
    with a ``polyphase`` param."""
    if cfg.space_to_depth != 1 or cfg.upsample != "transpose" or cfg.depth < 2:
        raise jobs_lib.JobError(
            "polyphase serving requires a space_to_depth=1 "
            "transpose-upsample model of depth >= 2; this model has "
            f"s2d={cfg.space_to_depth}, upsample={cfg.upsample!r}, "
            f"depth={cfg.depth}"
        )


def _run_frames(cfg, tc, model, source, job: Job, device):
    """Stream a frame source through tiled inference; yields results in order.

    A GENERATOR: each yielded ``InferenceResult`` holds the frame's outputs
    on their way to the host, so neither host memory nor the card ever holds
    the whole stack's outputs. Frames run ``frame_batch`` at a time (auto:
    ~1M pixels per batch, at most 8) or one at a time, two ahead.

    On a pool of more than one device (``parallel.device_pool``):
    ``spatial_parallel: true`` splits every frame's rows over all of them
    (halo exchange, the whole-frame result), an integer S splits rows S
    ways and runs n/S frames at once (hybrid), and ``data_parallel: true``
    gives each device its own frame. On a single device both serve
    streaming, as the JAX server does on one chip.
    """
    from sequitr_tpu_torch.pipeline import infer as infer_lib

    job_params = job.params
    spatial = tuple(source.spatial)
    n_frames = len(source)
    want_probs = bool(
        job_params.get("save_probs") or job_params.get("save_entropy")
    )
    # labels-only jobs run the labels-only graph (no softmax maps)
    tc = dataclasses.replace(tc, emit_probs=want_probs)

    def _host_prefetch(out):
        probs, labels = out
        if want_probs:
            probs = infer_lib._copy_to_host_async(probs)
        return (probs if want_probs else None), infer_lib._copy_to_host_async(labels)

    def _batched(fn, chunk_n):
        n_left = n_frames
        for probs, labels in infer_lib.stream_frames(
            fn, _reads_fail_fast(job, source.chunks(chunk_n)),
            prefetch_host=_host_prefetch, device=device,
        ):
            for k in range(min(chunk_n, n_left)):
                yield infer_lib.InferenceResult(
                    probs=None if probs is None else probs[k], labels=labels[k],
                )
            n_left -= chunk_n

    n_dev = _n_devices(device)
    sp = job_params.get("spatial_parallel")
    if sp and n_dev > 1:
        # huge frames split over the devices (halo exchange, the exact
        # whole-frame result); each frame normalizes whole, then shards
        from sequitr_tpu_torch import parallel
        from sequitr_tpu_torch.parallel import spatial as spatial_lib

        s_ways = _spatial_ways(sp, n_dev, tc=tc)
        d_ways = n_dev // s_ways

        def norm(frames):  # (B, H, W[, C]) on the device
            x = frames if frames.ndim == 4 else frames[..., None]
            return infer_lib._normalize(x, tc)

        if d_ways > 1 and n_frames > 1:
            mesh2 = parallel.make_mesh2d((d_ways, s_ways), device=device)
            try:
                hy_fn = spatial_lib.hybrid_unet2d_infer(
                    cfg, mesh2, spatial, batch=d_ways,
                    probs_dtype=tc.probs_dtype, labels_dtype=tc.labels_dtype,
                )
            except (ValueError, NotImplementedError) as e:
                # bad shape/config for sharding is deterministic — no retry
                raise jobs_lib.JobError(str(e))
            # one quantile pass normalizes the whole chunk (per-frame
            # percentiles)
            yield from _batched(lambda c: hy_fn(model, norm(c)), d_ways)
            return
        mesh = parallel.make_mesh(s_ways, device=device)
        try:
            sp_fn = spatial_lib.spatial_unet2d_infer(
                cfg, mesh, spatial,
                probs_dtype=tc.probs_dtype, labels_dtype=tc.labels_dtype,
            )
        except (ValueError, NotImplementedError) as e:
            raise jobs_lib.JobError(str(e))
        for probs, labels in infer_lib.stream_frames(
            lambda f: sp_fn(model, norm(f[None])[0]),
            _reads_fail_fast(job, source.frames()),
            prefetch_host=_host_prefetch, device=device,
        ):
            yield infer_lib.InferenceResult(probs=probs, labels=labels)
        return
    if job_params.get("data_parallel") and n_dev > 1:
        # one frame a device a dispatch, weights copied to each device
        from sequitr_tpu_torch import parallel

        mesh = parallel.make_mesh(device=device)
        dp = parallel.make_dp_frame_inferrer(
            lambda d: infer_lib.cached_batch_inferrer(cfg, tc, spatial, 1, d), mesh
        )
        yield from _batched(lambda c: dp(model, c), n_dev)
        return
    fb = job_params.get("frame_batch")
    fb = int(fb) if fb else _auto_frame_batch(spatial)
    fb = max(1, min(fb, n_frames))  # never compute padded frames nobody asked for
    if fb > 1:
        bfn = infer_lib.cached_batch_inferrer(cfg, tc, spatial, fb, device)
        yield from _batched(lambda c: bfn(model, c), fb)
        return
    fn = infer_lib.cached_frame_inferrer(cfg, tc, spatial, device)
    yield from infer_lib.infer_stack(
        fn, model, _reads_fail_fast(job, source.frames()),
        fetch_probs=want_probs, device=device,
    )


def _apply_roi(job: Job, source):
    """Restrict a FrameSource to the job's ``roi: [y0, x0, y1, x1]``
    (end-exclusive). All outputs are ROI-local."""
    roi = job.params.get("roi")
    if roi is None:
        return source
    y0, x0, y1, x1 = _parse_roi_values(roi, "roi")
    try:
        return source.crop(y0, x0, y1, x1)
    except ValueError as e:
        raise jobs_lib.JobError(f"bad roi: {e}")


def _parse_roi_values(roi, param: str):
    """Validated [y0, x0, y1, x1] ints (bounds checked by crop())."""
    if not isinstance(roi, (list, tuple)) or len(roi) != 4:
        raise jobs_lib.JobError(
            f"{param}={roi!r} must be [y0, x0, y1, x1] (end-exclusive)"
        )
    try:
        return tuple(int(v) for v in roi)
    except (TypeError, ValueError):
        raise jobs_lib.JobError(
            f"{param}={roi!r} must be [y0, x0, y1, x1] (end-exclusive)"
        )


def _apply_frame_range(job: Job, source):
    """Restrict a FrameSource to the job's ``frame_range: [start, stop]``
    (stop exclusive). Localization keeps ABSOLUTE frame indices."""
    fr = job.params.get("frame_range")
    if fr is None:
        return source
    if not isinstance(fr, (list, tuple)) or not 1 <= len(fr) <= 2:
        raise jobs_lib.JobError(
            f"frame_range={fr!r} must be [start, stop] (stop exclusive)"
        )
    try:
        start = int(fr[0])
        stop = int(fr[1]) if len(fr) > 1 and fr[1] is not None else None
    except (TypeError, ValueError):
        raise jobs_lib.JobError(
            f"frame_range={fr!r} must be [start, stop] (stop exclusive)"
        )
    try:
        return source.select(start, stop)
    except ValueError as e:
        raise jobs_lib.JobError(str(e))


def _auto_frame_batch(spatial) -> int:
    """Frames per batch: ~1M pixels in flight, capped at 8."""
    px = int(np.prod(spatial))
    return int(max(1, min(8, 1_000_000 // max(px, 1))))


def _spatial_ways(sp, n_dev: int, divide: bool = True, tc=None) -> int:
    """Parse the ``spatial_parallel`` job param into a shard count.

    Malformed values (non-integer strings, counts that don't fit the
    device pool) are deterministic JobErrors, never retried. ``tc``:
    refuse combinations the halo-exchange forward does not implement
    (tta) instead of silently ignoring them."""
    if tc is not None and tc.tta != 1:
        raise jobs_lib.JobError(
            "tta is not supported with spatial_parallel (the halo-exchange "
            "graph runs whole frames; use data_parallel or single-chip)"
        )
    if sp is True:
        return n_dev
    try:
        s_ways = int(sp)
    except (TypeError, ValueError):
        raise jobs_lib.JobError(
            f"spatial_parallel={sp!r} must be true or an integer"
        )
    if s_ways < 2 or (divide and n_dev % s_ways) or s_ways > n_dev:
        raise jobs_lib.JobError(
            f"spatial_parallel={sp!r} must be >=2 and "
            + ("divide" if divide else "fit")
            + f" the {n_dev} available devices"
        )
    return s_ways


def _train_mesh(p: dict, batch_size: int, device):
    """The mesh of a ``data_parallel: true`` training job: the batch split
    over every device of the pool; None (single-device) when the pool has
    one device. The batch must divide evenly over the mesh: refused up
    front, not mid-job."""
    if not p.get("data_parallel"):
        return None
    if _n_devices(device) <= 1:
        return None
    from sequitr_tpu_torch import parallel

    mesh = parallel.make_mesh(device=device)
    n = mesh.size
    if batch_size % n:
        raise jobs_lib.JobError(
            f"data_parallel: batch_size {batch_size} not divisible by {n} devices"
        )
    return mesh


def _reads_fail_fast(job: Job, it):
    """Re-raise a source read ValueError as a deterministic JobError."""
    while True:
        try:
            item = next(it)
        except StopIteration:
            return
        except ValueError as e:
            raise jobs_lib.JobError(f"job {job.id}: {e}")
        yield item


def config_from_arch(kind: str, p: dict):
    """The configuration of a ``kind`` model from its architecture JSON, as
    the JAX package's ``import-model`` builds it: for ``gan`` a
    ``GANConfig`` of its seven keys (the rest at their defaults, every
    other key ignored), else ``unet_config_from_params``."""
    from sequitr_tpu_torch.models import gan

    if kind != "gan":
        return unet_config_from_params(p)
    return gan.GANConfig(
        in_channels=int(p.get("in_channels", 1)),
        out_channels=int(p.get("out_channels", 1)),
        gen_depth=int(p.get("gen_depth", 4)),
        gen_base_features=int(p.get("gen_base_features", 32)),
        disc_layers=int(p.get("disc_layers", 3)),
        disc_base_features=int(p.get("disc_base_features", 64)),
        compute_dtype=p.get("compute_dtype", "bfloat16"),
    )


def unet_config_from_params(p: dict):
    """A ``UNetConfig`` from architecture params: the JAX server's fields
    and defaults, and nothing else (``features_cap`` and ``upsample`` stay
    at 512 and ``"transpose"``); ``preset`` returns ``zoo.get(preset)``
    and ignores every other field."""
    from sequitr_tpu_torch.models import unet, zoo

    if "preset" in p:
        return zoo.get(p["preset"])
    return unet.UNetConfig(
        in_channels=int(p.get("in_channels", 1)),
        num_classes=int(p.get("num_classes", 3)),
        depth=int(p.get("depth", 4)),
        base_features=int(p.get("base_features", 32)),
        dims=int(p.get("dims", 2)),
        norm=p.get("norm", "batch"),
        compute_dtype=p.get("compute_dtype", "bfloat16"),
        space_to_depth=int(p.get("space_to_depth", 1)),
    )


# ---------------------------------------------------------------------------
# built-in pipelines (importing the module registers its jobs)
# ---------------------------------------------------------------------------

from sequitr_tpu_torch.server.pipelines import (  # noqa: E402,F401
    gan_denoise as _pipelines_gan_denoise,
    geometry as _pipelines_geometry,
    instances as _pipelines_instances,
    interop as _pipelines_interop,
    optics as _pipelines_optics,
    quantify as _pipelines_quantify,
    segmentation as _pipelines_segmentation,
    training as _pipelines_training,
)
