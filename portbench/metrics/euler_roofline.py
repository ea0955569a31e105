"""euler_roofline (kernel): the Euler integrator's share of its bound. The
bound, per million pixels served, is the longer of two times
(``kinds/cpnet.py``): the FLOPs of the foreground's pixel-steps (32 a
pixel-step, counted from the reference's code; the steps a frame, the
program's counter ``flows.euler_steps``; the foreground pixels a frame,
its counter ``flows.foreground``, the only pixels whose final positions
are read) at the card's float32 peak, and the bytes any integrator moves
once a frame (the mask at every pixel, the flow in and the position out
at each foreground pixel) at its HBM bandwidth. The share is the bound
over the time ``euler_device_ms_per_mvox`` reads; an integrator that
steps the foreground alone does that work and no less, so the share stays
under 100%."""

import math

from portbench import launches, spans
from portbench.kinds import cpnet


def read(run):
    s = launches.kernel_seconds(run, "flows.integrate")
    kept = spans.host(run)
    if s is None or s <= 0 or kept is None or not run.done:
        return None
    counted = {"flows.euler_steps": [], "flows.foreground": []}
    for name, t, n in kept.counts:
        if name in counted and 0.0 <= t <= run.window_s:
            counted[name].append(n)
    steps, foreground = counted["flows.euler_steps"], counted["flows.foreground"]
    if not steps or not foreground:
        return None
    share = sum(foreground) / len(foreground) / math.prod(run.traffic["input"]["shape"])
    measured = 1e3 * s / (run.served_voxels / 1e6)
    return 100.0 * cpnet.euler_bound_ms_per_mvox(sum(steps) / len(steps), share) / measured
