"""Filesystem job API: watched-dir server, job schema, pipeline registry.

The job schema and queue (``jobs``) import no torch, so the host commands
of the CLI (``submit``, ``queue``, ``cancel``, ``retry``, ``drain``) and
``client`` start in a fraction of a second; the server, its registry and
model store (``server``, which loads torch and every pipeline) import on
first use.
"""

from sequitr_tpu_torch.server.jobs import (  # noqa: F401
    Job,
    JobError,
    submit_job,
    scan_jobs,
    claim_job,
)

_SERVER = ("ImageServer", "PipelineRegistry", "REGISTRY", "register", "save_model", "load_model")


def __getattr__(name):
    if name in _SERVER:
        from sequitr_tpu_torch.server import server

        return getattr(server, name)
    raise AttributeError(f"module 'sequitr_tpu_torch.server' has no attribute {name!r}")
