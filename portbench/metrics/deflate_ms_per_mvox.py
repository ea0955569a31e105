"""deflate_ms_per_mvox (job server): the program's ``tiff.deflate`` spans
(``zlib.compress`` of each label frame in the TIFF writer, on the job
thread inside ``job.write``) in the traced window, clipped to it, per
million voxels served."""

from portbench import spans


def read(run):
    return spans.ms_per_mvox(run, ("tiff.deflate",))
