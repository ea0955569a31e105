"""Client-side helpers for the filesystem job API.

A copy of ``sequitr_tpu.client`` on the port's ``server.jobs``: clients
(notebooks, ImageJ/napari-side scripts) talk to the server purely through
the filesystem — write a job JSON, poll for the status marker. This module
wraps that contract; it runs on the host and touches no device.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

from sequitr_tpu_torch.server import jobs as jobs_lib

__all__ = [
    "run_job", "wait_for_job", "cancel_job", "read_progress",
    "JobFailed", "JobCancelled", "JobTimeout",
]


class JobFailed(RuntimeError):
    def __init__(self, status: Dict[str, Any]):
        super().__init__(status.get("error", "job failed"))
        self.status = status


class JobCancelled(RuntimeError):
    """The awaited job reached the terminal ``cancelled`` state."""

    def __init__(self, status: Dict[str, Any]):
        super().__init__(status.get("error", "job cancelled"))
        self.status = status


class JobTimeout(TimeoutError):
    pass


def wait_for_job(
    output_dir: str, timeout: float = 3600.0, poll: float = 0.5
) -> Dict[str, Any]:
    """Poll ``output_dir/status.json`` until complete/failed; return status."""
    deadline = time.time() + timeout
    path = os.path.join(output_dir, "status.json")
    while time.time() < deadline:
        if os.path.exists(path):
            try:
                with open(path) as f:
                    status = json.load(f)
            except (json.JSONDecodeError, OSError):
                status = None  # mid-rename; retry
            if status and status.get("state") == "complete":
                return status
            if status and status.get("state") == "failed":
                raise JobFailed(status)
            if status and status.get("state") == "cancelled":
                raise JobCancelled(status)
        time.sleep(poll)
    raise JobTimeout(f"job did not finish within {timeout}s ({output_dir})")


def cancel_job(jobs_dir: str, job_id: str) -> Optional[str]:
    """Cancel a job: withdraw it from the queue, or — if already claimed —
    request a cooperative stop from the running worker (the job then lands
    in the terminal ``cancelled`` state).

    Returns ``"cancelled"`` (withdrawn before any server claimed it),
    ``"requested"`` (running; the worker stops at its next frame/step), or
    None if the job is neither queued nor running. Cancellation uses the
    same atomicity as claiming: whoever renames the queued file first wins,
    so this can never yank a job out from under a server that already
    claimed it.
    """
    path = os.path.join(
        jobs_dir, f"{jobs_lib.JOB_PREFIX}{job_id}{jobs_lib.JOB_SUFFIX}"
    )
    stem = path[: -len(jobs_lib.JOB_SUFFIX)]
    # two attempts bridge the microsecond windows of the queue's two-step
    # transitions (claim rename -> stamp; reclaim rename -> requeue link):
    # a live job must never be told "not found" because it was mid-rename
    for attempt in (0, 1):
        if attempt:
            time.sleep(0.05)
        try:
            os.rename(path, path + ".cancelled")
            # the rename won the race, so no server holds this job. Leave
            # the SAME terminal record a running-then-cancelled job leaves
            # — a cancelled status.json in the output dir — so dependents
            # chained on it via depends_on cascade-fail instead of waiting
            # forever; then delete the marker (no .cancelled litter).
            try:
                job = jobs_lib.Job.from_file(path + ".cancelled")
                # from_file derives ids from queue-file stems; this file
                # carries the .cancelled suffix, so stamp the real id
                job.id = job_id
                if job.output:
                    jobs_lib.write_status(
                        job,
                        "cancelled",
                        time.time(),
                        error="cancelled while queued",
                    )
            except (jobs_lib.JobError, OSError, ValueError):
                pass  # malformed/outputless spec: nothing to record
            os.remove(path + ".cancelled")
            return "cancelled"
        except FileNotFoundError:
            pass
        # claimed, or mid-reclaim (a .reclaim tmp is a dead owner's claim
        # being rescued; the marker survives the requeue and the re-claim
        # honors it — jobs.reclaim_stale_claims/_clear_stale_cancel)
        if os.path.exists(stem + jobs_lib.CLAIMED_SUFFIX) or os.path.exists(
            stem + jobs_lib.RECLAIM_SUFFIX
        ):
            jobs_lib.request_cancel(jobs_dir, job_id)
            return "requested"
    return None


def read_progress(output_dir: str) -> Optional[Dict[str, Any]]:
    """The job's live ``progress.json`` (None before the first update)."""
    try:
        with open(os.path.join(output_dir, "progress.json")) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def run_job(
    jobs_dir: str,
    spec: Dict[str, Any],
    timeout: float = 3600.0,
    job_id: Optional[str] = None,
) -> Dict[str, Any]:
    """Submit a job spec and block until it finishes. Returns the status.

    ``spec`` must include ``module`` and ``output`` (the polled directory).
    """
    if "output" not in spec:
        raise ValueError("job spec needs an 'output' directory to poll")
    jobs_lib.submit_job(jobs_dir, spec, job_id=job_id)
    return wait_for_job(spec["output"], timeout=timeout)
