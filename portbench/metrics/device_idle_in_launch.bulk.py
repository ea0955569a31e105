"""device_idle_in_launch.bulk (device): the share of the traced window in
which no kernel, copy or set runs on the device while a job thread is
inside ``stream.launch`` (the program's span, bridged into the trace):
idle the launches do not cover."""

from portbench import spans


def read(run):
    return spans.idle_share(run, ("stream.launch",))
