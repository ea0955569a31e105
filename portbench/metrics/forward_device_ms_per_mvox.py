"""forward_device_ms_per_mvox (network): device time of every kernel in the
traced window except the quantile pass's (``minmax_kernel``,
``count_kernel``), copies and sets left out, per million voxels served."""

QUANTILE_PASS = ("minmax_kernel", "count_kernel")


def read(run):
    if run.trace is None or not run.done:
        return None
    s = sum(t for name, t in run.trace.kernels.items()
            if not any(q in name for q in QUANTILE_PASS))
    if s <= 0:
        return None
    return 1e3 * s / (run.served_voxels / 1e6)
