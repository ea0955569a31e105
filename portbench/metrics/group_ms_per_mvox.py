"""group_ms_per_mvox (job server): the program's ``job.group`` spans (the
host's sink grouping of each frame's converged positions, on the job
thread) in the traced window, clipped to it, per million voxels served."""

from portbench import spans


def read(run):
    return spans.ms_per_mvox(run, ("job.group",))
