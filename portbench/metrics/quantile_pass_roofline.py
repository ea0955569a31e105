"""quantile_pass_roofline (kernel): the least time the percentile pass can
take, each served voxel read once at its stored width at the card's HBM
bandwidth, over the device time of ``minmax_kernel`` and ``count_kernel``
in the traced window."""

from portbench import counts

QUANTILE_PASS = ("minmax_kernel", "count_kernel")


def read(run):
    if run.trace is None or not run.done:
        return None
    s = sum(t for name, t in run.trace.kernels.items()
            if any(q in name for q in QUANTILE_PASS))
    if s <= 0:
        return None
    bound = run.served_voxels * run.stored_bytes_per_voxel / counts.PEAK_HBM_BYTES_PER_S
    return 100.0 * bound / s
