"""served_mvox_per_s: input voxels (a 2D pixel counts as one) of the jobs
completed in the window, over the window's length (first timed submission
to the last completion within it). No job counts in part."""


def read(run):
    if not run.done or run.window_s <= 0:
        return None
    return run.served_voxels / 1e6 / run.window_s
