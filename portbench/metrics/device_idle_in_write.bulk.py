"""device_idle_in_write.bulk (device): the share of the traced window in
which the device is idle while a job thread is inside ``job.write`` (the
TIFF writer and its deflate; the program's span, bridged into the
trace)."""

from portbench import spans


def read(run):
    return spans.idle_share(run, ("job.write",))
