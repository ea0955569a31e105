"""Runtime utilities: device resolution, f32 precision, derived-module
caches and phase timing.

``resolve_device`` is the one place that turns a ``device`` argument into a
``torch.device``: the default is the CUDA card, and asking for it without
one raises — the port never falls back to the CPU on its own.
``ieee_f32`` keeps f32 convs and matmuls at IEEE f32 (PyTorch runs cuDNN's
f32 convs in TF32 by default); ``derived`` caches a module built from
another (a folded copy, a polyphase module) for as long as the source
module's tensors stay as they were.
``PhaseTimer`` is the JAX package's structured phase timer, copied; with
tracing on (``tracing``, re-exported here: ``span``, ``count``) each phase
is also a span ``job.<name>``.
``trace`` captures a ``torch.profiler`` trace around a block (the job
param ``profile: true``). ``device_median_ms`` times calls on the card.
"""

from __future__ import annotations

import contextlib
import functools
import os
import queue
import threading
import time
from typing import Callable, Dict, Iterator, Union

import torch

from sequitr_tpu_torch import tracing
from sequitr_tpu_torch.tracing import count, span

__all__ = [
    "DEFAULT_DEVICE", "resolve_device", "ieee_f32", "f32_entry", "derived",
    "PhaseTimer", "trace", "device_median_ms", "span", "count",
]

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``.

    Raises RuntimeError for a CUDA device when no card is visible: callers
    that want the CPU pass ``device="cpu"``.
    """
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}: use 'cuda' or 'cpu'")
    return dev


def _set_tf32(matmul: bool, cudnn: bool) -> None:
    """PyTorch's two TF32 switches: cuBLAS matmuls and cuDNN convs."""
    torch.backends.cuda.matmul.allow_tf32 = matmul
    torch.backends.cudnn.allow_tf32 = cudnn


@contextlib.contextmanager
def ieee_f32(enabled: bool = True) -> Iterator[None]:
    """Run f32 convs and matmuls at IEEE f32 inside the block.

    The port's ``compute_dtype: "float32"`` is the JAX package's CPU f32,
    held to it at 1e-4; TF32 keeps a 10-bit mantissa. The previous switches
    are restored on exit. ``enabled=False`` leaves them alone (bf16 paths:
    the switches touch no bf16 product).
    """
    if not enabled:
        yield
        return
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    _set_tf32(False, False)
    try:
        yield
    finally:
        _set_tf32(*prev)


def f32_entry(method: Callable) -> Callable:
    """Decorate a module's ``forward`` to run inside ``ieee_f32`` when its
    ``cfg.compute_dtype`` is ``"float32"``."""

    @functools.wraps(method)
    def wrapper(self, *args, **kwargs):
        with ieee_f32(self.cfg.compute_dtype == "float32"):
            return method(self, *args, **kwargs)

    return wrapper


def _tensor_stamp(module: torch.nn.Module) -> tuple:
    """Identity, storage and in-place version of each of ``module``'s
    tensors: any in-place update (an optimizer step, ``copy_``,
    ``load_state_dict``) or replacement changes it."""
    stamp = []
    for t in list(module.parameters()) + list(module.buffers()):
        version = None if t.is_inference() else t._version
        stamp.append((id(t), t.data_ptr(), version))
    return tuple(stamp)


def derived(source: torch.nn.Module, name: str, build: Callable) -> torch.nn.Module:
    """``build(source)``, built once per state of ``source``'s tensors.

    The result is held on ``source`` itself (so it is freed with it, and a
    retired model takes its folded copy with it) and rebuilt when any of
    ``source``'s parameters or buffers changed since (``_tensor_stamp``).
    Tensors changed in place inside ``torch.inference_mode`` carry no
    version counter, so such a change goes unseen.
    """
    cache = source.__dict__.setdefault("_derived", {})
    stamp = _tensor_stamp(source)
    hit = cache.get(name)
    if hit is None or hit[0] != stamp:
        hit = (stamp, build(source))
        cache[name] = hit
    return hit[1]


@functools.lru_cache(maxsize=None)
def _phase_span(name: str) -> str:
    return "job." + name


class PhaseTimer:
    """Accumulate wall-clock per named phase; render a compact dict.

    With tracing on, each phase is also the span ``job.<name>``; the sums
    are the same either way.

    >>> t = PhaseTimer()
    >>> with t.phase("normalize"): ...
    >>> t.summary()  # {"normalize_s": 0.12, ...}
    """

    def __init__(self) -> None:
        self._acc: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        with tracing.span(_phase_span(name)):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                self._acc[name] = self._acc.get(name, 0.0) + dt

    def total(self, *names: str) -> float:
        """Seconds summed over the phases ``names`` (a phase never entered
        adds 0)."""
        return sum(self._acc.get(k, 0.0) for k in names)

    def summary(self) -> Dict[str, float]:
        return {f"{k}_s": round(v, 4) for k, v in self._acc.items()}


class _ProfilerThread:
    """The one thread that starts and stops every ``trace`` of the process.

    PyTorch's profiler session is per process (CUPTI), while its start and
    stop are bound to the thread that made them: a trace started on a job's
    thread can be stopped only there. Run on this thread, a new trace can
    stop the one a watchdog-abandoned job left running and take its place.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._queue = None
        self.active = None  # (profile, owner token, log_dir)

    def call(self, fn):
        """Run ``fn()`` on the profiler thread; return or raise its result."""
        with self._lock:
            if self._queue is None:
                self._queue = queue.Queue()
                threading.Thread(target=self._loop, daemon=True, name="sequitr-profiler").start()
        done = queue.Queue(maxsize=1)
        self._queue.put((fn, done))
        ok, value = done.get()
        if not ok:
            raise value
        return value

    def _loop(self):
        while True:
            fn, done = self._queue.get()
            try:
                done.put((True, fn()))
            except BaseException as e:  # handed to the caller
                done.put((False, e))


_PROFILER = _ProfilerThread()


def _stop_and_export(active) -> None:
    prof, _, log_dir = active
    try:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    except Exception:
        pass


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace (CPU ops of every thread, and CUDA
    kernels, copies and runtime calls where a card is visible) around a
    block; the Chrome trace lands in ``log_dir/trace.json`` (Perfetto and
    ``chrome://tracing`` read it).

    Robust to a stale trace left running by an abandoned thread (a
    watchdog-timed-out profiled job): the new trace stops the stale one
    (whose trace lands in its own directory) and takes the profiler over,
    as the JAX package's ``trace`` does; a failed start runs the block
    untraced, and a failed stop or export never masks the block's own
    result.
    """
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    token = object()

    def start():
        if _PROFILER.active is not None:
            stale, _PROFILER.active = _PROFILER.active, None
            _stop_and_export(stale)
        try:
            config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
            prof = profile(activities=activities, experimental_config=config)
        except (AttributeError, TypeError):  # a PyTorch without the option
            prof = profile(activities=activities)
        prof.start()
        _PROFILER.active = (prof, token, log_dir)

    def stop():
        # a trace that a later one took over was stopped and exported then
        if _PROFILER.active is not None and _PROFILER.active[1] is token:
            active, _PROFILER.active = _PROFILER.active, None
            _stop_and_export(active)

    try:
        _PROFILER.call(start)
        started = True
    except Exception:
        started = False
    try:
        yield
    finally:
        if started:
            try:
                _PROFILER.call(stop)
            except Exception:
                pass


def device_median_ms(fn: Callable[[], object], n: int = 100) -> float:
    """Median device time of ``fn()`` in ms over ``n`` calls, from CUDA events.

    A sleep kernel first holds the stream for twice the time the host takes
    to queue all ``n`` calls, so the events see back-to-back device time,
    not launch overhead.
    """
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    events = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(n)
    ]
    # cycles at up to 2 GHz: a slower clock only sleeps longer
    torch.cuda._sleep(int(2e9 * (2 * n * enqueue_s + 0.01)))
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return times[n // 2]
