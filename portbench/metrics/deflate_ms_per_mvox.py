"""deflate_ms_per_mvox (job server): the program's ``tiff.deflate`` spans
(``zlib.compress`` of each label frame in the TIFF writer, on the threads
of its deflate pool, outside the job thread's ``job.write``) in the traced
window, clipped to it, per million voxels served: the deflate's own time,
which runs beside the launches and the writes rather than inside them."""

from portbench import spans


def read(run):
    return spans.ms_per_mvox(run, ("tiff.deflate",))
