"""setup_s: process start to the window's first submission: imports, input
generation, model import, kernel builds on a checkout's first run, the
warm-up job."""


def read(run):
    return run.setup_s
