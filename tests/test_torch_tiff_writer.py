"""The port's TIFF append writer with its deflate pool
(``sequitr_tpu_torch.data.tiff.TiffAppendWriter``): its files are the JAX
package's writer's, byte for byte, for every frame count, dtype, layout and
compression; frames land in order when the pool finishes them out of
order; the frame's bytes are taken before ``append`` returns; a failed
deflate or the 4 GiB limit aborts the file from the next ``append`` or from
``close``; ``abort`` drops the temporary file; the pool is made again in a
forked child; and the spans and counter say how often the pool engaged."""

import hashlib
import os
import sys
import threading
import time
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

from sequitr_tpu.data import tiff as jax_tiff
from sequitr_tpu_torch import tracing
from sequitr_tpu_torch.data import tiff


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.disable()
    yield
    tracing.disable()


def _stack(n, dtype, seed=0, shape=(48, 40)):
    """``n`` label-like frames: mostly background, a few blobs, so deflate
    compresses them as it does label maps."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    out = np.zeros((n,) + shape, np.float64)
    for t in range(n):
        for k in range(1, 4):
            cy, cx = rng.uniform(0, shape[0]), rng.uniform(0, shape[1])
            out[t][(yy - cy) ** 2 + (xx - cx) ** 2 < rng.uniform(9, 49)] = k + t % 7
    if np.dtype(dtype).kind == "f":
        out = out + rng.random(out.shape) * 0.25
    return out.astype(dtype)


def _write(mod, path, stack, bigtiff, compression):
    with mod.TiffAppendWriter(path, bigtiff=bigtiff, compression=compression) as w:
        for frame in stack:
            w.append(frame)
    with open(path, "rb") as f:
        return f.read()


def _slow_zlib(monkeypatch, seed, record=None, fail_at=None):
    """Stand ``tiff.zlib`` in with a ``compress`` that sleeps a seeded
    0-8 ms first (so the pool finishes frames out of order), notes the
    order in which frames finish in ``record``, and raises on the
    ``fail_at``-th call."""
    import zlib

    rng = np.random.default_rng(seed)
    lock = threading.Lock()
    calls = [0]

    def compress(data, level):
        with lock:
            i = calls[0]
            calls[0] += 1
            pause = float(rng.uniform(0.0, 0.008))
        time.sleep(pause)
        if i == fail_at:
            raise RuntimeError(f"deflate of call {i} failed")
        out = zlib.compress(data, level)
        if record is not None:
            with lock:
                record.append(i)
        return out

    monkeypatch.setattr(tiff, "zlib", SimpleNamespace(compress=compress))


@pytest.mark.parametrize("compression", ["deflate", "none"])
@pytest.mark.parametrize("bigtiff", [False, True], ids=["classic", "bigtiff"])
@pytest.mark.parametrize("dtype", ["uint8", "uint16", "float32"])
@pytest.mark.parametrize("n", [1, 2, 5, 64])
def test_the_file_is_the_jax_writers_byte_for_byte(tmp_path, n, dtype, bigtiff, compression):
    stack = _stack(n, dtype, seed=n)
    ours = _write(tiff, str(tmp_path / "port.tif"), stack, bigtiff, compression)
    ref = _write(jax_tiff, str(tmp_path / "jax.tif"), stack, bigtiff, compression)
    assert hashlib.sha256(ours).hexdigest() == hashlib.sha256(ref).hexdigest()
    assert not os.path.exists(str(tmp_path / "port.tif.tmp"))
    back = tiff.read_stack(str(tmp_path / "port.tif"))
    np.testing.assert_array_equal(back, stack[0] if n == 1 else stack)


def test_write_stack_deflate_is_the_jax_packages(tmp_path):
    stack = _stack(9, "uint16", seed=3)
    tiff.write_stack(str(tmp_path / "a.tif"), stack, compression="deflate")
    jax_tiff.write_stack(str(tmp_path / "b.tif"), stack, compression="deflate")
    assert (tmp_path / "a.tif").read_bytes() == (tmp_path / "b.tif").read_bytes()


def test_frames_land_in_order_when_the_pool_finishes_them_out_of_order(monkeypatch, tmp_path):
    stack = _stack(24, "uint16", seed=5)
    ref = _write(jax_tiff, str(tmp_path / "jax.tif"), stack, False, "deflate")
    finished = []
    _slow_zlib(monkeypatch, seed=11, record=finished)
    ours = _write(tiff, str(tmp_path / "port.tif"), stack, False, "deflate")
    assert sorted(finished) == list(range(24))
    assert finished != sorted(finished)  # the pool did finish out of order
    assert ours == ref


def test_the_frame_is_taken_before_append_returns(monkeypatch, tmp_path):
    stack = _stack(6, "uint16", seed=7)
    ref = _write(jax_tiff, str(tmp_path / "jax.tif"), stack, False, "deflate")
    _slow_zlib(monkeypatch, seed=2)
    buf = np.empty_like(stack[0])  # one buffer reused for every frame
    path = str(tmp_path / "port.tif")
    with tiff.TiffAppendWriter(path, compression="deflate") as w:
        for frame in stack:
            buf[...] = frame
            w.append(buf)
            buf[...] = 65535  # overwritten while the deflate is in flight
        assert w.n_frames == 6
    with open(path, "rb") as f:
        assert f.read() == ref


def test_writers_on_many_threads_share_the_pool(tmp_path):
    """Twelve writers on their own threads, more than this host's pool
    and cores, with the interpreter switching threads often: each file is
    the JAX writer's."""
    stacks = [_stack(7, "uint16", seed=100 + i) for i in range(12)]
    refs = [_write(jax_tiff, str(tmp_path / f"jax{i}.tif"), s, False, "deflate")
            for i, s in enumerate(stacks)]
    got, errors = {}, []

    def run(i):
        try:
            got[i] = _write(tiff, str(tmp_path / f"port{i}.tif"), stacks[i], False, "deflate")
        except BaseException as e:  # noqa: BLE001 (reported below)
            errors.append(e)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(i,)) for i in range(12)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert [got[i] for i in range(12)] == refs


def _pool_serves():
    """The deflate pool still takes work: no worker is left blocked."""
    return tiff._deflate_pool().submit(lambda: 7).result(timeout=10) == 7


@pytest.mark.parametrize("fail_at", [0, 3, 7])
def test_a_failed_deflate_fails_the_next_append_or_close(monkeypatch, tmp_path, fail_at):
    _slow_zlib(monkeypatch, seed=fail_at, fail_at=fail_at)
    path = str(tmp_path / "port.tif")
    w = tiff.TiffAppendWriter(path, compression="deflate")
    with pytest.raises(RuntimeError, match=f"call {fail_at} failed"):
        for frame in _stack(8, "uint16", seed=1):
            w.append(frame)
        w.close()
    assert not os.path.exists(path) and not os.path.exists(path + ".tmp")
    # the file stays refused: a later close does not pass for success
    with pytest.raises(ValueError, match="a frame failed"):
        w.close()
    with pytest.raises(ValueError, match="after close or abort"):
        w.append(np.zeros((4, 4), np.uint16))
    assert _pool_serves()


def test_a_failure_inside_a_with_block_leaves_nothing(monkeypatch, tmp_path):
    _slow_zlib(monkeypatch, seed=4, fail_at=2)
    path = str(tmp_path / "port.tif")
    with pytest.raises(RuntimeError):
        with tiff.TiffAppendWriter(path, compression="deflate") as w:
            for frame in _stack(3, "uint8", seed=1):
                w.append(frame)
    assert not os.path.exists(path) and not os.path.exists(path + ".tmp")
    assert _pool_serves()


def test_the_4gib_limit_surfaces_at_the_in_order_write(tmp_path):
    """The classic-TIFF limit needs the compressed length, so a deflate
    writer checks it when the frame is written: by the next ``append`` or
    by ``close``, which then aborts the file."""
    path = str(tmp_path / "big.tif")
    w = tiff.TiffAppendWriter(path, compression="deflate")
    w._offset = 0xFFFFFFF0  # simulate ~4 GiB written
    w.append(np.zeros((4, 4), np.uint16))  # returns: the check waits for the strip
    with pytest.raises(ValueError, match="4 GiB"):
        w.close()
    assert not os.path.exists(path) and not os.path.exists(path + ".tmp")


def test_abort_mid_stream_removes_the_temporary_file(monkeypatch, tmp_path):
    _slow_zlib(monkeypatch, seed=9)
    path = str(tmp_path / "port.tif")
    w = tiff.TiffAppendWriter(path, compression="deflate")
    for frame in _stack(6, "uint16", seed=2):
        w.append(frame)
    assert os.path.exists(path + ".tmp")
    w.abort()
    assert not os.path.exists(path + ".tmp") and not os.path.exists(path)
    assert _pool_serves()
    w.close()  # an aborted writer's close writes nothing, as before
    assert not os.path.exists(path)


def test_an_empty_deflate_writer_refuses_to_close(tmp_path):
    path = str(tmp_path / "empty.tif")
    w = tiff.TiffAppendWriter(path, compression="deflate")
    with pytest.raises(ValueError, match="no frames appended"):
        w.close()
    assert not os.path.exists(path) and not os.path.exists(path + ".tmp")


def test_the_pool_is_made_again_in_a_forked_child(tmp_path):
    stack = _stack(5, "uint16", seed=8)
    ref = _write(tiff, str(tmp_path / "parent.tif"), stack, False, "deflate")
    parent_pool = tiff._deflate_pool()
    child_path = str(tmp_path / "child.tif")
    with warnings.catch_warnings():
        # fork with threads: the child touches only the writer and the pool
        warnings.simplefilter("ignore", DeprecationWarning)
        warnings.simplefilter("ignore", RuntimeWarning)
        pid = os.fork()
    if pid == 0:
        code = 1
        try:
            if tiff._deflate_pool() is not parent_pool:
                _write(tiff, child_path, stack, False, "deflate")
                code = 0
        finally:
            os._exit(code)
    deadline = time.monotonic() + 30
    while True:
        done, status = os.waitpid(pid, os.WNOHANG)
        if done:
            break
        if time.monotonic() > deadline:
            os.kill(pid, 9)
            os.waitpid(pid, 0)
            pytest.fail("the forked child did not finish its file")
        time.sleep(0.01)
    assert os.waitstatus_to_exitcode(status) == 0
    with open(child_path, "rb") as f:
        assert f.read() == ref


def test_the_spans_and_counter_say_how_often_the_pool_engaged(monkeypatch, tmp_path):
    _slow_zlib(monkeypatch, seed=6)
    tracer = tracing.enable()
    with tracing.job("j42"):
        _write(tiff, str(tmp_path / "port.tif"), _stack(10, "uint16", seed=4), False, "deflate")
        _write(tiff, str(tmp_path / "raw.tif"), _stack(3, "uint16", seed=4), False, "none")
    tracing.disable()
    spans = tracer.spans()
    deflates = [s for s in spans if s.name == "tiff.deflate"]
    assert len(deflates) == 10
    assert {s.job for s in deflates} == {"j42"}
    assert all(s.thread.startswith("tiff-deflate") for s in deflates)
    waits = [s for s in spans if s.name == "tiff.deflate_wait"]
    assert waits and {s.job for s in waits} == {"j42"}
    assert all(s.thread == threading.current_thread().name for s in waits)
    pooled = [c for c in tracer.counts() if c.name == "tiff.deflate_pooled"]
    assert [c.total for c in pooled] == list(range(1, 11))  # the raw writer adds none
