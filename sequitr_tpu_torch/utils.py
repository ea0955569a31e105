"""Runtime utilities: device resolution, f32 precision, derived-module
caches and phase timing.

``resolve_device`` is the one place that turns a ``device`` argument into a
``torch.device``: the default is the CUDA card, and asking for it without
one raises — the port never falls back to the CPU on its own.
``ieee_f32`` keeps f32 convs and matmuls at IEEE f32 (PyTorch runs cuDNN's
f32 convs in TF32 by default); ``derived`` caches a module built from
another (a folded copy, a polyphase module) for as long as the source
module's tensors stay as they were.
``PhaseTimer`` is the JAX package's structured phase timer, copied.
``device_median_ms`` times calls on the card.
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Callable, Dict, Iterator, Union

import torch

__all__ = [
    "DEFAULT_DEVICE", "resolve_device", "ieee_f32", "f32_entry", "derived",
    "PhaseTimer", "device_median_ms",
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


class PhaseTimer:
    """Accumulate wall-clock per named phase; render a compact dict.

    >>> t = PhaseTimer()
    >>> with t.phase("normalize"): ...
    >>> t.summary()  # {"normalize_s": 0.12, ...}
    """

    def __init__(self) -> None:
        self._acc: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self._acc[name] = self._acc.get(name, 0.0) + dt

    def summary(self) -> Dict[str, float]:
        return {f"{k}_s": round(v, 4) for k, v in self._acc.items()}


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
