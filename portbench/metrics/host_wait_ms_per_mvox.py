"""host_wait_ms_per_mvox (streaming): the jobs' ``infer_s + fetch_s``, the
job thread queueing work and waiting for the card's results, summed over
the window's completed jobs, per million voxels served."""


def read(run):
    if not run.done:
        return None
    s = sum(j.phases.get("infer_s", 0.0) + j.phases.get("fetch_s", 0.0) for j in run.done)
    return 1e3 * s / (run.served_voxels / 1e6)
