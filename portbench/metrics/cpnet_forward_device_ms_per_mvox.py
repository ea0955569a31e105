"""cpnet_forward_device_ms_per_mvox (network): device time of the kernels
launched inside the program's ``flows.forward`` spans (a frame's normalize,
tiled CPnet forward, Hann stitch and flow and probability maps) in the
traced window, per million voxels served."""

from portbench import launches


def read(run):
    s = launches.kernel_seconds(run, "flows.forward")
    if s is None or not run.done or s <= 0:
        return None
    return 1e3 * s / (run.served_voxels / 1e6)
