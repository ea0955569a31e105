"""Server configuration dataclass (copy of ``sequitr_tpu.config`` plus ``device``).

The reference has a ``ServerConfiguration`` (paths, GPU id) plus per-job
JSON params (SURVEY.md §5 'Config / flags'). The schema is the JAX
package's, with a ``device`` field and without its XLA compilation cache.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Optional

__all__ = ["ServerConfiguration"]


@dataclasses.dataclass
class ServerConfiguration:
    """Long-lived image-server configuration.

    ``jobs_dir``: watched directory clients drop job JSON files into.
    ``models_dir``: root for named models (``config.json`` + ``weights.npz``).
    ``poll_interval``: seconds between job-directory scans.
    ``max_retries``: per-job retry budget before a failure marker is written
    (malformed-job ``JobError``s never retry — they are deterministic).
    ``retry_backoff``: seconds slept before retry attempt N is N*backoff.
    ``job_timeout``: wall-clock seconds a single job may run before the
    server marks it failed and moves on (None = unlimited). The timed-out
    work runs on a daemon thread that cannot be force-killed in-process; the
    watchdog guarantees the QUEUE keeps moving, not that the stuck
    computation stops consuming the device.
    ``recycle_on_timeout``: after a watchdog timeout, exit the process with
    code 43 (``EXIT_RECYCLE``) once the failure marker is written, so a
    supervisor (systemd Restart=) replaces the worker with a clean process
    and the card is actually freed from the abandoned thread. None (default)
    = auto: recycle exactly when running under a supervisor
    (``SEQUITR_WORKER_ID`` set).
    ``stale_claim_timeout``: seconds without a heartbeat after which another
    worker may reclaim a ``.running`` job whose owner died (SIGKILL, OOM,
    host crash) by renaming it back into the queue. Workers heartbeat their
    claimed file's mtime every few seconds while the job runs, so the
    default 300 s means ~60 missed beats — a dead owner, not a slow one.
    None disables reclaim (a crashed worker's job stays claimed forever).
    ``device``: the torch device jobs run on. ``"cuda"`` (default) needs a
    CUDA card and the server refuses to start without one; ``"cpu"`` must
    be asked for explicitly.
    ``trace_spans``: keep the process's spans (``tracing``) in memory from
    start to drain and write them as a Chrome trace, ``spans.json`` in
    ``log_dir`` (else ``jobs_dir``), on exit. No trace per job (the job
    param ``profile: true`` exports one).
    """

    jobs_dir: str = "./jobs"
    models_dir: str = "./models"
    poll_interval: float = 1.0
    max_retries: int = 1
    retry_backoff: float = 1.0
    job_timeout: Optional[float] = None
    recycle_on_timeout: Optional[bool] = None
    stale_claim_timeout: Optional[float] = 300.0
    log_dir: Optional[str] = None
    device: str = "cuda"
    trace_spans: bool = False

    @classmethod
    def from_json(cls, path: str) -> "ServerConfiguration":
        with open(path) as f:
            data = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in data.items() if k in known})

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    def ensure_dirs(self) -> None:
        os.makedirs(self.jobs_dir, exist_ok=True)
        os.makedirs(self.models_dir, exist_ok=True)
        if self.log_dir:
            os.makedirs(self.log_dir, exist_ok=True)
