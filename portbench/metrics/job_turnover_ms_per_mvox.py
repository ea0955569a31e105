"""job_turnover_ms_per_mvox (job server): the traced window less the union
of the job threads' frame steps (the program's ``job.infer``,
``job.fetch``, ``job.write`` and ``job.localize`` spans): the server's
poll, claim, status writes and ledger row and each job's set-up and close,
per million voxels served."""

from portbench import spans


def read(run):
    kept = spans.host(run)
    if kept is None or not run.done:
        return None
    steps = spans.named(kept.spans, spans.FRAME_STEPS, run.window_s)
    if not steps:
        return None
    turnover = run.window_s - spans.length(spans.union(steps))
    return 1e3 * turnover / (run.served_voxels / 1e6)
