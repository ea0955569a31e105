"""The reader of the deflate pool's waits (``deflate_wait_ms_per_mvox``) on
a synthetic run (a tracer holding hand-made records): it sums the window's
``tiff.deflate_wait`` spans per Mvox, reads 0 where the pool took frames and
no writer waited, and is silent where the program has no deflate pool."""

import pytest

from portbench import spec
from portbench.tests.conftest import ROOT
from portbench.tests.test_portbench_spans import HOST_SPANS, _run, _tracer


def test_the_wait_reader_sums_the_waits_and_is_silent_without_a_pool(monkeypatch, tmp_path):
    read = spec.reader(ROOT, "deflate_wait_ms_per_mvox")
    waits = [("tiff.deflate_wait", 4.5, 4.75, 1), ("tiff.deflate_wait", 9.9, 10.4, 1),
             ("tiff.deflate_wait", -3.0, -2.0, 1)]
    pooled = [("tiff.deflate_pooled", 3.2, 1), ("tiff.deflate_pooled", 9.4, 1)]
    # 0.25 + 0.1 (cut at 10 s) over 2 Mvox; the wait before the window is out
    run = _run(monkeypatch, tmp_path, tracer=_tracer(HOST_SPANS + waits, pooled))
    assert read(run) == pytest.approx(175.0)
    # the pool took frames and nobody waited
    assert read(_run(monkeypatch, tmp_path, tracer=_tracer(HOST_SPANS, pooled))) == 0.0
    # frames pooled only before the window: nothing to read in it
    early = [("tiff.deflate_pooled", -1.0, 1)]
    assert read(_run(monkeypatch, tmp_path, tracer=_tracer(HOST_SPANS, early))) is None
    # a program without the pool (the synchronous deflate) or without a tracer
    assert read(_run(monkeypatch, tmp_path, tracer=_tracer(HOST_SPANS))) is None
    assert read(_run(monkeypatch, tmp_path)) is None
