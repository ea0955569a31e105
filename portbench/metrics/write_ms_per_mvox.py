"""write_ms_per_mvox (job server): the jobs' own ``write_s`` (the TIFF
writer and its deflate, on the job thread) summed over the window's
completed jobs, per million voxels served."""


def read(run):
    if not run.done:
        return None
    return 1e3 * sum(j.phases.get("write_s", 0.0) for j in run.done) / (run.served_voxels / 1e6)
