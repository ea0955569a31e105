"""deflate_wait_ms_per_mvox (job server): the program's
``tiff.deflate_wait`` spans (the job thread blocked on the oldest frame its
TIFF writer has in the deflate pool: the writer's fill of frames in flight,
or the drain at close) in the traced window, clipped to it, per million
voxels served; 0 where the pool took frames in the window (the counter
``tiff.deflate_pooled``) and no writer waited; None where the program has
no deflate pool."""

from portbench import spans


def read(run):
    waited = spans.ms_per_mvox(run, ("tiff.deflate_wait",))
    if waited is not None:
        return waited
    kept = spans.host(run)
    if kept is None or not run.done:
        return None
    pooled = any(name == "tiff.deflate_pooled" and 0.0 <= t <= run.window_s
                 for name, t, _ in kept.counts)
    return 0.0 if pooled else None
