"""device_idle.bulk (device): the share of the traced window's wall time in which no kernel, copy or
set ran on the device (the union of the device's intervals)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
