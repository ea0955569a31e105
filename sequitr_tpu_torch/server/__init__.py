"""Filesystem job API: watched-dir server, job schema, pipeline registry."""

from sequitr_tpu_torch.server.jobs import (  # noqa: F401
    Job,
    JobError,
    submit_job,
    scan_jobs,
    claim_job,
)
from sequitr_tpu_torch.server.server import (  # noqa: F401
    ImageServer,
    PipelineRegistry,
    REGISTRY,
    register,
    save_model,
    load_model,
)
