"""inferrer_builds (network): additions to the program's counter
``inferrer.builds`` inside the traced window: frame inferrers built
(misses of the program's inferrer caches) while the window ran."""

from portbench import spans


def read(run):
    kept = spans.host(run)
    if kept is None:
        return None
    return sum(n for name, t, n in kept.counts
               if name == "inferrer.builds" and 0.0 <= t <= run.window_s)
