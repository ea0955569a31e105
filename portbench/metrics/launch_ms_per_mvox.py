"""launch_ms_per_mvox (streaming): the program's ``stream.launch`` spans
(one frame queued on the card: the host->card copy issued, the quantile
pass and every kernel of the forward launched, the card->host copy issued)
in the traced window, clipped to it, per million voxels served."""

from portbench import spans


def read(run):
    return spans.ms_per_mvox(run, ("stream.launch",))
