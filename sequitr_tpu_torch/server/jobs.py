"""Filesystem job queue: schema, atomic claim/complete/fail transitions.

The reference's public contract is a watched job directory: clients drop a
JSON job description; the server picks it up, runs the named pipeline and
writes results + a completion marker back (SURVEY.md §1 L6, §3.1). The
reference schema is unavailable, so the rebuild's documented job schema is:

    {
      "module": "segmentation_unet2d",   # pipeline registry key (required)
      "func":   "infer",                  # optional sub-operation
      "params": {...},                    # pipeline-specific parameters
      "input":  ["relative/or/abs.tif"],  # input data paths
      "output": "results/"                # output directory
    }

filed as ``<jobs_dir>/job_<id>.json``. Lifecycle markers inside the job's
output directory: ``status.json`` with state running/complete/failed (+
timing, error traceback). All queue transitions are atomic
write-temp-then-rename so a crashed server never leaves half-parsed jobs
(SURVEY.md §5 'Race detection': atomic fs ops replace the reference's
single-threaded assumption).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

from sequitr_tpu_torch import tracing

log = logging.getLogger("sequitr_tpu_torch.jobs")

__all__ = [
    "Job", "JobError", "JobCancelled", "scan_jobs", "claim_job",
    "write_status", "submit_job", "request_cancel", "cancel_requested",
    "clear_cancel", "track", "ProgressReporter", "heartbeat",
    "reclaim_stale_claims", "owns_claim", "check_dependencies",
]

JOB_PREFIX = "job_"
JOB_SUFFIX = ".json"
CLAIMED_SUFFIX = ".running"
CANCEL_SUFFIX = ".cancel"
# intermediate suffix used by reclaim_stale_claims so the rename race among
# multiple reclaimers has one winner AND requeueing never clobbers a freshly
# re-submitted same-id spec (link(2) is exclusive; rename is not)
RECLAIM_SUFFIX = CLAIMED_SUFFIX + ".reclaim"


class JobError(RuntimeError):
    pass


class JobCancelled(RuntimeError):
    """Raised inside a pipeline when the job's cancel marker appears.

    The server maps it to a terminal ``cancelled`` state — no retry, no
    worker recycle (the device stays warm for the next job). Round-4 verdict
    item 4: before this, ``cancel`` could only withdraw *queued* jobs; a
    running multi-hour serve or training was unstoppable short of killing
    the worker.
    """


@dataclasses.dataclass
class Job:
    id: str
    module: str
    func: str
    params: Dict[str, Any]
    input: List[str]
    output: str
    priority: int = 0  # higher runs first; ties oldest-first
    # output DIRECTORIES this job waits on: it stays queued until each
    # holds a status.json with state "complete"; a failed/cancelled
    # dependency fails this job deterministically (see check_dependencies)
    depends_on: List[str] = dataclasses.field(default_factory=list)
    dep_timeout: Optional[float] = None  # max seconds to wait on deps
    path: str = ""  # queue file path once claimed
    # wall time of this worker's last successful heartbeat on the claim.
    # ``owns_claim`` compares it against the file's mtime to detect that a
    # heartbeat-starved claim was reclaimed and re-claimed by someone else.
    last_beat: float = 0.0
    # non-fatal pipeline-surfaced issues; merged with the unknown-param
    # warnings into the completed status.json's ``warnings`` list
    runtime_warnings: List[str] = dataclasses.field(default_factory=list)

    @classmethod
    def from_file(cls, path: str) -> "Job":
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, dict):
            raise JobError(f"job {path}: spec must be a JSON object")
        if "module" not in data:
            raise JobError(f"job {path} missing required field 'module'")
        stem = os.path.basename(path)
        for suffix in (CLAIMED_SUFFIX, JOB_SUFFIX):
            if stem.endswith(suffix):
                stem = stem[: -len(suffix)]
        if stem.startswith(JOB_PREFIX):
            stem = stem[len(JOB_PREFIX) :]
        try:
            # any malformed field (priority: null, input: 5, ...) must
            # surface as JobError so the server quarantines instead of
            # crashing its poll loop
            # the id is ALWAYS the queue filename's stem — the string
            # submit_job returned to the client and the key every marker
            # file (.cancel, .failed) derives from. A spec-level "id" field
            # must not override it or the cancel/clear paths would key on
            # different names than the CLI/client use.
            return cls(
                id=stem,
                module=str(data["module"]),
                func=str(data.get("func") or "run"),
                params=dict(data.get("params") or {}),
                input=list(data.get("input") or []),
                output=str(data.get("output") or ""),
                priority=int(data.get("priority") or 0),
                depends_on=_parse_depends_on(data.get("depends_on")),
                dep_timeout=(
                    None
                    if data.get("dep_timeout") is None
                    else float(data["dep_timeout"])
                ),
                path=path,
            )
        except (TypeError, ValueError) as e:
            raise JobError(f"job {path}: malformed field: {e}")


def _parse_depends_on(raw) -> List[str]:
    """``depends_on`` is one output dir or a list of them; anything else
    is malformed (claim-time quarantine surfaces it)."""
    if raw is None:
        return []
    if isinstance(raw, str):
        return [raw]
    items = list(raw)
    if not all(isinstance(d, str) and d for d in items):
        raise ValueError(f"depends_on entries must be paths: {raw!r}")
    return items


class ParamTracker(dict):
    """A params dict that records which keys the pipeline actually read.

    Misspelled job parameters (``lerning_rate``, ``spatial_ways`` on a
    pipeline that has ``data_ways``) were silently ignored — the job ran
    with defaults and the client never learned why. The server wraps
    ``job.params`` in this before dispatch and reports never-read keys as
    a ``warnings`` list in the final status. Whole-dict operations
    (iteration, items, copy) conservatively mark everything read — a
    pipeline that copies its params gets no warnings rather than false
    ones.
    """

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.accessed = set()
        self.all_accessed = False

    def __getitem__(self, key):
        self.accessed.add(key)
        return super().__getitem__(key)

    def get(self, key, default=None):
        self.accessed.add(key)
        return super().get(key, default)

    def __contains__(self, key):
        self.accessed.add(key)
        return super().__contains__(key)

    def setdefault(self, key, default=None):
        # a setdefault is semantically a read (+ a possible server-side
        # write); either way the key must not be blamed on the client
        self.accessed.add(key)
        return super().setdefault(key, default)

    def pop(self, key, *default):
        self.accessed.add(key)
        return super().pop(key, *default)

    def update(self, *a, **kw):
        # server-injected keys are not client typos
        tmp = dict(*a, **kw)
        self.accessed.update(tmp)
        return super().update(tmp)

    def popitem(self):
        self._mark_all()
        return super().popitem()

    def _mark_all(self):
        self.all_accessed = True

    def __iter__(self):
        self._mark_all()
        return super().__iter__()

    def keys(self):
        self._mark_all()
        return super().keys()

    def items(self):
        self._mark_all()
        return super().items()

    def values(self):
        self._mark_all()
        return super().values()

    def copy(self):
        self._mark_all()
        return dict(self)

    def unread_keys(self):
        if self.all_accessed:
            return []
        return sorted(set(super().keys()) - self.accessed)


def _atomic_write(path: str, text: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def submit_job(jobs_dir: str, spec: Dict[str, Any], job_id: Optional[str] = None) -> str:
    """Client-side: atomically file a job JSON into the queue; returns its id.

    Auto-generated ids are timestamp-based; two submissions in the same
    millisecond (or from two clients) must not overwrite each other, so the
    queue file is created with link(2) — atomic and exclusive — retrying
    with a suffix on collision.
    """
    text = json.dumps(spec, indent=2)
    if job_id is not None:
        path = os.path.join(jobs_dir, f"{JOB_PREFIX}{job_id}{JOB_SUFFIX}")
        _atomic_write(path, text)
        return job_id
    os.makedirs(jobs_dir, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=jobs_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        base = int(time.time() * 1000)
        for n in range(10000):
            job_id = f"{base:x}" if n == 0 else f"{base:x}-{n:x}"
            path = os.path.join(jobs_dir, f"{JOB_PREFIX}{job_id}{JOB_SUFFIX}")
            try:
                os.link(tmp, path)  # atomic exclusive create
                return job_id
            except FileExistsError:
                continue
        raise JobError(f"could not find a free job id in {jobs_dir}")
    finally:
        os.unlink(tmp)


# spec-summary cache for scan_jobs/check_dependencies:
# path -> (mtime, priority, depends_on, dep_timeout, output). Queued files
# are immutable once submitted (atomic create), so one parse per file
# suffices; without this a long backlog would be re-opened and
# re-JSON-parsed on every poll tick.
_scan_cache: Dict[
    str, Tuple[float, int, Tuple[str, ...], Optional[float], str]
] = {}


def _spec_summary(
    path: str, mtime: Optional[float] = None
) -> Tuple[int, Tuple[str, ...], Optional[float], str]:
    """(priority, depends_on, dep_timeout, output) of a queued file,
    cached by mtime. Malformed specs summarize as (0, (), None, ""):
    scheduling treats them as ordinary claimable jobs and claim-time
    quarantine rejects them with the real parse error."""
    if mtime is None:
        try:
            mtime = os.stat(path).st_mtime
        except OSError:
            return 0, (), None, ""
    cached = _scan_cache.get(path)
    if cached is not None and cached[0] == mtime:
        return cached[1], cached[2], cached[3], cached[4]
    # parse into locals and assign ALL-or-nothing: a malformed spec must
    # summarize fully as (0, (), None, "") — honoring a half-parsed
    # depends_on while dropping its dep_timeout would wait unbounded on
    # a job that claim-time quarantine is supposed to reject
    prio, deps, dep_timeout, output = 0, (), None, ""
    try:
        with open(path) as f:
            data = json.load(f)
        p = int(data.get("priority") or 0)
        d = tuple(_parse_depends_on(data.get("depends_on")))
        t = (
            None
            if data.get("dep_timeout") is None
            else float(data["dep_timeout"])
        )
        o = str(data.get("output") or "")
    except (OSError, ValueError, TypeError, AttributeError):
        pass  # malformed: claim-time quarantine handles it
    else:
        prio, deps, dep_timeout, output = p, d, t, o
    _scan_cache[path] = (mtime, prio, deps, dep_timeout, output)
    return prio, deps, dep_timeout, output


def scan_jobs(jobs_dir: str) -> List[str]:
    """Unclaimed job files: highest priority first, oldest first within a
    priority level (priority is the job JSON's optional ``priority`` int,
    default 0 — an unparseable file sorts as 0 and is quarantined at claim
    time).

    A concurrent claimer (or a client withdrawing a job) may rename/delete a
    file between the directory scan and the stat — such entries are skipped
    rather than letting FileNotFoundError kill the server poll loop.
    """
    entries = []
    seen = set()
    try:
        with os.scandir(jobs_dir) as it:
            for e in it:
                if not (e.name.startswith(JOB_PREFIX) and e.name.endswith(JOB_SUFFIX)):
                    continue
                try:
                    mtime = e.stat().st_mtime
                except FileNotFoundError:
                    continue  # vanished mid-scan: someone else claimed it
                seen.add(e.path)
                prio = _spec_summary(e.path, mtime)[0]
                entries.append((-prio, mtime, e.path))
    except FileNotFoundError:
        return []
    # drop cache entries for files no longer queued (claimed/removed)
    for stale in set(_scan_cache) - seen:
        _scan_cache.pop(stale, None)
    return [p for _, _, p in sorted(entries)]


def check_dependencies(path: str) -> Tuple[str, Optional[str]]:
    """Scheduling gate for a queued job's ``depends_on`` output dirs.

    Returns ``("ready", None)`` (claimable now — also the answer for jobs
    with no dependencies), ``("wait", dir)`` (a dependency has not
    completed yet; leave the job queued), or ``("fail", reason)`` (a
    dependency terminally failed/cancelled, or ``dep_timeout`` seconds
    passed since submission without the dependencies completing — claim
    the job and fail it deterministically).

    A dependency is an OUTPUT DIRECTORY: satisfied when it holds a
    ``status.json`` with state ``complete`` — the same filesystem contract
    clients poll. The check is content-based, not run-based: a dir holding
    a previous run's complete result satisfies immediately (re-runs into
    reused dirs should chain via fresh output dirs). The wait clock is the
    queue file's mtime, which reclaim-requeue resets (the wait legitimately
    restarts when a job is rescued).

    A job depending on its own output dir can never become ready and fails
    immediately. Mutual cycles across jobs (A waits on B's dir, B on A's)
    are not statically detected — they look identical to waiting on a job
    someone will submit later, which is legal; bound them with
    ``dep_timeout`` (the ``queue`` CLI shows what each job waits on).
    """
    _, deps, dep_timeout, output = _spec_summary(path)
    if not deps:
        return "ready", None
    if output:
        own = os.path.abspath(output)
        for d in deps:
            if os.path.abspath(d) == own:
                return "fail", f"job depends on its own output dir {d}"
    waiting_on = None
    for d in deps:
        try:
            with open(os.path.join(d, "status.json")) as f:
                state = json.load(f).get("state")
        except (OSError, ValueError, AttributeError):
            state = None  # missing/unreadable/garbage: not finished yet
        if state == "complete":
            continue
        if state in ("failed", "cancelled"):
            return "fail", f"dependency {d} is {state}"
        waiting_on = d
    if waiting_on is None:
        return "ready", None
    if dep_timeout is not None:
        try:
            queued_at = os.stat(path).st_mtime
        except OSError:
            return "wait", waiting_on  # claimed mid-check: moot
        if time.time() - queued_at > dep_timeout:
            return (
                "fail",
                f"dependency {waiting_on} did not complete within "
                f"dep_timeout={dep_timeout:g}s",
            )
    return "wait", waiting_on


def claim_job(path: str) -> Optional[Job]:
    """Atomically claim a queued job by renaming it; None if already taken.

    Only FileNotFoundError is the benign claim-race case. Any other OSError
    (e.g. EACCES on the queue dir) is logged loudly — swallowing it silently
    would make every job invisible while the server rescans the same file
    forever.
    """
    claimed = path[: -len(JOB_SUFFIX)] + CLAIMED_SUFFIX
    # the queue file's mtime before we touch it: the submit time (or, for
    # a reclaimed job, the dead owner's last heartbeat). Cancel markers
    # OLDER than this moment target a previous run of the id and are
    # dropped below; newer ones are genuine requests for THIS job.
    try:
        queued_mtime = os.stat(path).st_mtime
    except OSError:
        queued_mtime = None
    # stamp the heartbeat clock BEFORE the rename (rename preserves mtime,
    # so the fresh stamp travels with it): a job queued longer than
    # stale_claim_timeout must never exist as an instantly-stale .running
    # file, or a concurrent reclaimer could yank it back mid-claim
    try:
        os.utime(path)
    except OSError:
        pass  # racing claimer already took it; the rename below settles it
    try:
        os.rename(path, claimed)
    except FileNotFoundError:
        return None
    except OSError as e:
        log.error("cannot claim job %s: %s", path, e)
        return None
    now = time.time()
    try:
        os.utime(claimed)
    except OSError:
        pass
    try:
        job = Job.from_file(claimed)
    except FileNotFoundError:
        # only possible under a sub-second stale_claim_timeout: a reclaimer
        # decided the freshly-stamped claim was already stale. Benign — the
        # requeued job will be claimed on a later tick.
        return None
    job.path = claimed
    job.last_beat = now
    # a cancel marker left over from a PREVIOUS run of this id (written in
    # the race window after that run's terminal clear) must not instantly
    # cancel the fresh claim; a marker NEWER than the queue file is a
    # genuine request for this job and is kept.
    _clear_stale_cancel(job, queued_mtime)
    return job


def heartbeat(job: Job) -> None:
    """Refresh the claimed file's mtime — the owner-is-alive signal.

    Called every few seconds by the server's job-supervision loop while a
    pipeline runs. Cheap (one utimensat) and atomic; failure is harmless
    (the job merely looks staler than it is). A worker that starved past
    ``stale_claim_timeout`` must NOT resume beating: the claim file may be
    another worker's by now (reclaim + re-claim), and re-stamping it would
    both corrupt the new owner's liveness signal and flip this worker's
    own ``owns_claim`` back to True — ``owns_claim`` is therefore checked
    first, making a lost claim stay lost.
    """
    if not owns_claim(job):
        return
    try:
        os.utime(job.path)
    except OSError:
        return  # claim gone (reclaimed/finished): not a fresh beat
    job.last_beat = time.time()


def owns_claim(job: Job) -> bool:
    """Best-effort: is the ``.running`` file still THIS worker's claim?

    A worker that starves its heartbeat past ``stale_claim_timeout``
    (SIGSTOP, VM pause, a minutes-long host stall) may have had its job
    reclaimed and re-claimed by another worker. Rename preserves the inode,
    so the discriminator is time: the new owner's claim stamp/heartbeats
    set the file's mtime far NEWER than this worker's own last beat.
    Terminal transitions consult this before unlinking/renaming the claim —
    deleting someone else's live claim marker would make their job
    unreclaimable if THEY then die.

    Jobs not claimed through ``claim_job`` (``last_beat`` == 0, e.g. tests
    constructing Jobs directly) are always considered owned.
    """
    if not job.last_beat:
        return True
    try:
        mtime = os.stat(job.path).st_mtime
    except OSError:
        return False  # claim vanished: reclaimed (and maybe re-running)
    # 1 s of grace covers filesystem timestamp granularity vs time.time();
    # a genuine new owner stamps at least stale_claim_timeout later
    return mtime <= job.last_beat + 1.0


def _requeue_exclusive(tmp_path: str, target: str) -> bool:
    """Move a reclaim-tmp file back into the queue without clobbering.

    link(2) is exclusive where rename is not: if a client re-submitted a
    fresh spec under the same id while the stale claim sat orphaned, the
    fresh spec wins and the stale claim is dropped (returns False).
    """
    requeued = True
    try:
        os.link(tmp_path, target)
    except FileExistsError:
        requeued = False  # superseded by a freshly queued same-id spec
    except OSError:
        return False  # leave the tmp for a later sweep
    try:
        os.unlink(tmp_path)
    except OSError:
        pass
    return requeued


def _finish_cancelled_reclaim(tmp_path: str, jobs_dir: str) -> bool:
    """Terminal-cancel a reclaimed job whose owner died with a cancel
    pending, instead of re-queueing it.

    The user's cancel was acknowledged ("the worker will stop at its next
    frame/step") before the owner was killed; re-running the job to
    completion would silently override that. Returns True if the pending
    cancel was honored (tmp + marker consumed, status written when the
    spec is readable)."""
    stem = os.path.basename(tmp_path)[len(JOB_PREFIX):-len(RECLAIM_SUFFIX)]
    marker = _cancel_marker(jobs_dir, stem)
    if not os.path.exists(marker):
        return False
    try:
        job = Job.from_file(tmp_path)
        job.id = stem  # from_file cannot strip the .reclaim suffix
        job.path = tmp_path
        write_status(
            job, "cancelled", time.time(),
            error=f"job {stem} cancelled (owner died before stopping; "
                  "honored at reclaim)",
        )
    except (JobError, ValueError, OSError):
        pass  # unreadable spec: still consume the claim + marker below
    for path in (tmp_path, marker):
        try:
            os.unlink(path)
        except OSError:
            pass
    log.warning(
        "reclaimed job %s had a pending cancel: honored (terminal "
        "cancelled, not re-queued)", stem,
    )
    return True


def reclaim_stale_claims(jobs_dir: str, timeout: float) -> List[str]:
    """Re-queue ``.running`` jobs whose owner stopped heartbeating.

    A worker killed hard (SIGKILL, OOM, host crash) leaves its claimed job
    as ``.running`` litter no scan ever revisits — the queue would silently
    lose it (SURVEY.md §5 failure detection). Any live worker calls this on
    its poll tick. Two-step transition: the stale claim is first renamed to
    a ``.reclaim`` tmp (one winner among concurrent reclaimers), then
    link(2)-moved back into the queue so a freshly re-submitted same-id
    spec is never overwritten. The re-queued job re-runs from scratch —
    every pipeline's outputs are write-temp-rename atomic, so a partial
    first attempt cannot corrupt the re-run.
    """
    reclaimed: List[str] = []
    now = time.time()
    try:
        with os.scandir(jobs_dir) as it:
            entries = list(it)
    except FileNotFoundError:
        return reclaimed
    for e in entries:
        if not e.name.startswith(JOB_PREFIX):
            continue
        try:
            mtime = e.stat().st_mtime
        except FileNotFoundError:
            continue  # finished mid-scan
        if now - mtime <= timeout:
            continue
        if e.name.endswith(RECLAIM_SUFFIX):
            # a reclaimer crashed between its rename and requeue: finish
            # the transition it started
            if _finish_cancelled_reclaim(e.path, jobs_dir):
                continue
            target = e.path[: -len(RECLAIM_SUFFIX)] + JOB_SUFFIX
            if _requeue_exclusive(e.path, target):
                log.warning("requeued orphaned reclaim tmp %s", e.name)
                reclaimed.append(target)
            continue
        if not e.name.endswith(CLAIMED_SUFFIX):
            continue
        target = e.path[: -len(CLAIMED_SUFFIX)] + JOB_SUFFIX
        tmp = e.path[: -len(CLAIMED_SUFFIX)] + RECLAIM_SUFFIX
        try:
            os.rename(e.path, tmp)
        except OSError:
            continue  # another reclaimer won, or the owner just finished
        if _finish_cancelled_reclaim(tmp, jobs_dir):
            # owner died with an acknowledged cancel pending: terminal
            # 'cancelled', not a re-run
            continue
        if not _requeue_exclusive(tmp, target):
            continue
        log.warning(
            "reclaimed stale job %s (no heartbeat for > %.0f s; owner "
            "presumed dead)", e.name, timeout,
        )
        reclaimed.append(target)
    return reclaimed


def write_status(
    job: Job,
    state: str,
    started: float,
    error: Optional[str] = None,
    outputs: Optional[Dict[str, str]] = None,
    warnings: Optional[List[str]] = None,
) -> None:
    """Atomically write the job's status marker into its output directory
    (the span ``server.status``)."""
    status = {
        "id": job.id,
        "module": job.module,
        "func": job.func,
        "state": state,
        "started": started,
        "updated": time.time(),
        "elapsed_s": round(time.time() - started, 3),
    }
    if error is not None:
        status["error"] = error
    if outputs is not None:
        status["outputs"] = outputs
    if warnings:
        status["warnings"] = list(warnings)
    out_dir = job.output or os.path.dirname(job.path)
    with tracing.span("server.status"):
        _atomic_write(os.path.join(out_dir, "status.json"), json.dumps(status, indent=2))


# ---------------------------------------------------------------------------
# in-flight cancellation + live progress (round-4 verdict items 4/5)
# ---------------------------------------------------------------------------


def _cancel_marker(jobs_dir: str, job_id: str) -> str:
    return os.path.join(jobs_dir, f"{JOB_PREFIX}{job_id}{CANCEL_SUFFIX}")


def request_cancel(jobs_dir: str, job_id: str) -> str:
    """Client-side: ask a RUNNING job to stop at its next safe point.

    Drops an atomic marker file the worker polls between frames/steps.
    Idempotent; returns the marker path. (Queued jobs are cancelled by
    renaming the queue file instead — see the ``cancel`` CLI.)
    """
    path = _cancel_marker(jobs_dir, job_id)
    _atomic_write(path, json.dumps({"requested": time.time()}))
    return path


def _clear_stale_cancel(job: Job, queued_mtime, slack: float = 1.0) -> None:
    """Drop a cancel marker that PREDATES this job's queue entry.

    ``queued_mtime`` is the queue file's mtime before the claim touched it
    (submit time; for a reclaimed job, the dead owner's last heartbeat). A
    marker requested before that moment targets a previous run of the same
    id — a leftover from the race window after that run's terminal clear —
    and honoring it would instantly cancel the fresh claim (the documented
    resume-by-resubmitting workflow). A marker requested after it is a
    genuine request for THIS job (racing the claim, or filed against the
    crashed run a reclaim rescued) and is kept.
    """
    marker = _cancel_marker(os.path.dirname(job.path), job.id)
    try:
        with open(marker) as f:
            requested = float(json.load(f).get("requested") or 0.0)
    except (OSError, ValueError, TypeError, AttributeError):
        # unreadable/hand-written marker (valid JSON need not be an
        # object): treat as fresh — honoring a cancel is the safe default,
        # and crashing the claim path on a malformed marker is not
        return
    if queued_mtime is None or requested >= queued_mtime - slack:
        return
    try:
        os.unlink(marker)
    except OSError:
        pass
    log.warning(
        "job %s: dropped a cancel marker from a previous run of this id "
        "(requested %.0f s before this submission)",
        job.id, queued_mtime - requested,
    )


def cancel_requested(job: Job) -> bool:
    """Worker-side poll: has anyone asked this job to stop?"""
    if not job.path:
        return False
    return os.path.exists(_cancel_marker(os.path.dirname(job.path), job.id))


def clear_cancel(job: Job) -> None:
    """Remove the job's cancel marker (terminal transitions), if any."""
    if not job.path:
        return
    try:
        os.unlink(_cancel_marker(os.path.dirname(job.path), job.id))
    except OSError:
        pass


class ProgressReporter:
    """Rate-limited ``progress.json`` writer + cancellation checkpoint.

    Serving jobs used to be a black box until completion (status.json is
    written at job end); this gives a 10k-frame streaming serve a live,
    atomically-updated ``{done, total, rate}`` file at bounded write cost
    (at most one write per ``every_s`` seconds, plus the final one).
    ``step()`` doubles as the cancellation poll so every pipeline that
    reports progress is cancellable for free.
    """

    def __init__(self, job: Job, total: Optional[int], phase: str = "frames",
                 every_s: float = 2.0, raise_on_cancel: bool = True):
        self.job = job
        self.total = total
        self.phase = phase
        self.every_s = every_s
        # False when another layer owns the cancel poll (e.g. the fit
        # loop's should_stop, which checkpoints before raising) — this
        # reporter then only writes progress
        self.raise_on_cancel = raise_on_cancel
        self.started = time.time()
        self._last_write = 0.0
        self._done = 0

    def step(self, done: Optional[int] = None) -> None:
        """Record one unit done; raises JobCancelled on a cancel marker."""
        self._done = self._done + 1 if done is None else done
        if self.raise_on_cancel and cancel_requested(self.job):
            self.write()  # leave an accurate last progress line behind
            raise JobCancelled(
                f"job {self.job.id} cancelled after {self._done} {self.phase}"
            )
        now = time.time()
        if now - self._last_write >= self.every_s:
            self.write(now)

    def write(self, now: Optional[float] = None) -> None:
        now = now or time.time()
        self._last_write = now
        elapsed = now - self.started
        row = {
            "id": self.job.id,
            "phase": self.phase,
            "done": self._done,
            "elapsed_s": round(elapsed, 3),
            "updated": now,
        }
        if self.total is not None:
            row["total"] = self.total
        if elapsed > 0 and self._done:
            row[f"{self.phase}_per_sec"] = round(self._done / elapsed, 3)
        worker = os.environ.get("SEQUITR_WORKER_ID")
        if worker is not None:
            row["worker"] = worker  # which worker is serving this job
        out_dir = self.job.output or os.path.dirname(self.job.path)
        try:
            _atomic_write(os.path.join(out_dir, "progress.json"), json.dumps(row, indent=2))
        except OSError:
            log.warning("could not write progress.json", exc_info=True)

    def finish(self) -> None:
        self.write()


def track(job: Job, iterable, total: Optional[int] = None,
          phase: str = "frames", every_s: float = 2.0):
    """Wrap a per-frame result iterator with progress + cancellation.

    The cancel poll runs once per item, BETWEEN items: after an item is
    produced and before it is yielded. A marker can therefore never flip a
    job whose final item already completed into ``cancelled`` (the loop
    exits via StopIteration without a further poll), while a mid-stack
    cancel stops the job before the next frame is consumed. The reporter
    runs in non-raising mode — this loop owns the single poll.
    """
    rep = ProgressReporter(
        job, total, phase=phase, every_s=every_s, raise_on_cancel=False
    )
    for item in iterable:
        if cancel_requested(job):
            rep.write()  # leave an accurate last progress line behind
            raise JobCancelled(
                f"job {job.id} cancelled after {rep._done} {phase}"
            )
        yield item
        rep.step()
    rep.finish()
