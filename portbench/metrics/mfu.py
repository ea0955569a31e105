"""mfu (network): the model's FLOPs over the voxels served in the traced
window (the kind's ``flops_per_voxel``, once over the served volume) over
the device time of every kernel the window ran (the forward's, the
quantile pass's and the glue's; copies and sets left out), as a share of
the card's bf16 dense peak: the whole step's share of the peak."""

from portbench import counts


def read(run):
    if run.trace is None or not run.done:
        return None
    s = sum(run.trace.kernels.values())
    if s <= 0:
        return None
    return 100.0 * run.served_voxels * run.flops_per_voxel / s / counts.PEAK_BF16_FLOPS
