"""device_idle_in_turnover.bulk (device): the share of the traced window in
which the device is idle while no job thread is in a frame step (none of
the program's ``job.infer``, ``job.fetch``, ``job.write`` and
``job.localize`` spans is open): the turnover between jobs."""

from portbench import spans


def read(run):
    return spans.idle_share(run, spans.FRAME_STEPS, outside=True)
