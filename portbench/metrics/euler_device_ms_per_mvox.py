"""euler_device_ms_per_mvox (integrator): device time of the kernels
launched inside the program's ``flows.integrate`` spans (a frame's Euler
or doubling loop) in the traced window, per million voxels served."""

from portbench import launches


def read(run):
    s = launches.kernel_seconds(run, "flows.integrate")
    if s is None or not run.done or s <= 0:
        return None
    return 1e3 * s / (run.served_voxels / 1e6)
