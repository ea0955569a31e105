"""Quantile pass of the percentile normalize: CUDA kernel and plain version.

Counterpart of ``sequitr_tpu/ops/pallas/histogram.py``. ``quantile_pass``
does for each slice of an (S, n) f32 array what ``pallas_quantiles`` does
for a frame: min and max, ``scale = (bins - 1) / max(hi - lo, 1e-20)``, a
count histogram with ``bucket = int(clip((x - lo) * scale, 0, bins - 1))``,
and for each q the first bin whose CDF reaches q, at its midpoint-corrected
upper edge. Every division is one correctly rounded f32 division, as jnp's
is, so lo, scale, counts and quantiles are bit-equal to the JAX package's.
``histogram_2d`` counts with lo and scale given (the TPU ``histogram_2d``).

For a CUDA tensor both launch the hand-written kernels of
``csrc/histogram.cu`` (the quantile pass: two launches for all slices, no
zero fill, no host sync) or raise; for a CPU tensor they run the plain
PyTorch versions (``quantile_pass_reference``, ``histogram_2d_reference``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence, Tuple

import torch

from sequitr_tpu_torch.ops.kernels import build as build_lib
from sequitr_tpu_torch.ops.kernels import on_device

__all__ = [
    "histogram_2d",
    "histogram_2d_reference",
    "invert_cdf",
    "kernel_quantiles",
    "quantile_pass",
    "quantile_pass_reference",
    "scale_of",
]

MAX_BINS = 8192  # the block's counts in shared memory (csrc: kMaxBins)
MAX_QS = 8  # values of q a pass takes (csrc: kMaxQs)

_lib = None
# per (device index, stream): the kernels' accumulator, tickets and min/max
# keys, zero between calls (the kernels' last blocks zero them again)
_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}


def _library() -> ctypes.CDLL:
    """The kernels' library, built and bound at first use."""
    global _lib
    if _lib is None:
        lib = build_lib.load("histogram")
        _bind(lib)
        _lib = lib
    return _lib


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.seq_quantile_pass.restype = i32
    # x, n, slices, bins, qs, nq, counts, lo, scale, quantiles, scratch, blocks, stream
    lib.seq_quantile_pass.argtypes = [ptr, i64, i32, i32, ptr, i32, ptr, ptr, ptr, ptr, ptr, i32, ptr]
    lib.seq_histogram_f32.restype = i32
    # x, n, slices, lo, scale, bins, counts, scratch, blocks, stream
    lib.seq_histogram_f32.argtypes = [ptr, i64, i32, ptr, ptr, i32, ptr, ptr, i32, ptr]
    lib.seq_histogram_blocks.restype = i32
    lib.seq_histogram_blocks.argtypes = [i64, i32, i32]
    lib.seq_histogram_scratch_words.restype = i64
    lib.seq_histogram_scratch_words.argtypes = [i32, i32]


def _check_x(x: torch.Tensor, bins: int) -> None:
    if x.ndim != 2 or x.shape[1] == 0:
        raise ValueError(f"expected (slices, n>0), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"expected float32, got {x.dtype}")
    if not 1 <= bins <= MAX_BINS:
        raise ValueError(f"bins must be in [1, {MAX_BINS}], got {bins}")


def _check(x: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor, bins: int):
    _check_x(x, bins)
    for name, t in (("lo", lo), ("scale", scale)):
        if t.shape != (x.shape[0],) or t.dtype != torch.float32:
            raise ValueError(
                f"{name} must be float32 of shape ({x.shape[0]},), got "
                f"{t.dtype} {tuple(t.shape)}"
            )
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _check_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"runs on cuda or cpu, got {x.device}")
    slices, n = x.shape
    if slices > 65535 or n >= 2**31:
        raise ValueError(f"at most 65535 slices of < 2^31 values a launch, got {tuple(x.shape)}")


def _scratch(device: torch.device, stream: int, slices: int, bins: int) -> torch.Tensor:
    """The zeroed scratch of ``stream`` on ``device``: as many words as the
    kernels ask for (accumulators, tickets, min and max keys)."""
    key = (device.index, stream)
    need = _lib.seq_histogram_scratch_words(slices, bins)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < need:
        buf = torch.zeros(need, dtype=torch.int32, device=device)
        _SCRATCH[key] = buf
    return buf


def _q32(qs: Sequence[float]) -> tuple:
    """q as the f32 values the JAX package compares with (host floats)."""
    return _f32(tuple(float(q) for q in qs))


@functools.lru_cache(maxsize=64)
def _f32(qs: tuple) -> tuple:
    return tuple(torch.tensor(qs, dtype=torch.float32).tolist())


def scale_of(lo: torch.Tensor, hi: torch.Tensor, bins: int) -> torch.Tensor:
    """``(bins - 1) / max(hi - lo, 1e-20)`` as one correctly rounded f32
    division, as jnp divides: a Python number over a tensor would multiply
    by the tensor's reciprocal (two roundings, an ulp off in about a
    quarter of frames)."""
    d = torch.clamp_min(hi - lo, 1e-20)
    return torch.full_like(d, bins - 1) / d


def histogram_2d_reference(
    x: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor, bins: int = 1024
) -> torch.Tensor:
    """Plain PyTorch version of the counting: (slices, bins) int32 counts."""
    _check(x, lo, scale, bins)
    idx = ((x - lo[:, None]) * scale[:, None]).clamp(0.0, float(bins - 1))
    idx = idx.to(torch.int32)
    offsets = torch.arange(x.shape[0], device=x.device, dtype=torch.int32) * bins
    hist = torch.bincount(
        (idx + offsets[:, None]).reshape(-1), minlength=x.shape[0] * bins
    )
    return hist.reshape(x.shape[0], bins).to(torch.int32)


def histogram_2d(
    x: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor, bins: int = 1024
) -> torch.Tensor:
    """(slices, n) f32 -> (slices, bins) int32 counts, per-slice lo/scale.

    CUDA tensors run the counting kernel, one launch (``histogram_2d.launches``
    counts every launch of it, from this entry point and from
    ``quantile_pass``); CPU tensors run ``histogram_2d_reference``.
    """
    if x.device.type == "cpu":
        return histogram_2d_reference(x, lo, scale, bins)
    _check(x, lo, scale, bins)
    _check_cuda(x)
    x, lo, scale = x.contiguous(), lo.contiguous(), scale.contiguous()
    slices, n = x.shape
    out = torch.empty((slices, bins), dtype=torch.int32, device=x.device)
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with on_device(x.device):
        rc = lib.seq_histogram_f32(
            x.data_ptr(), n, slices, lo.data_ptr(), scale.data_ptr(), bins,
            out.data_ptr(), _scratch(x.device, stream, slices, bins).data_ptr(), 0, stream,
        )
    if rc != 0:
        raise RuntimeError(f"histogram kernel launch failed: CUDA error {rc}")
    histogram_2d.launches += 1
    return out


histogram_2d.launches = 0


def invert_cdf(
    hist: torch.Tensor, n: int, lo: torch.Tensor, scale: torch.Tensor,
    qs: Sequence[float],
) -> torch.Tensor:
    """(slices, bins) counts of ``n`` values each -> (slices, len(qs)).

    For each q, the first bin whose CDF reaches q (bin 0 if none does), at
    the bin's midpoint-corrected upper edge ``lo + (k + 1) / scale - 0.5 /
    scale``: the rule of both ``pallas_quantiles`` and the XLA
    ``histogram_quantiles``, rounded where they round.
    """
    bins = hist.shape[1]
    cum = hist.cumsum(dim=1).to(torch.float32)
    # divided by n as an f32 tensor: on the card a host scalar divisor is
    # multiplied in as its reciprocal, and 5 * f32(1/100) < f32(0.05)
    cdf = cum / torch.full((), float(n), dtype=torch.float32, device=hist.device)
    ramp = torch.arange(1, bins + 1, dtype=torch.float32, device=hist.device)
    # 0.5 / scale runs as scale.reciprocal() * 0.5: halving is exact, so it
    # is the correctly rounded quotient, as jnp's
    edges = lo[:, None] + ramp[None, :] / scale[:, None] - 0.5 / scale[:, None]
    # first bin with cdf >= q (argmax returns the first maximum)
    first = torch.stack(
        [(cdf >= q).to(torch.uint8).argmax(dim=1) for q in _q32(qs)], dim=1
    )
    return torch.gather(edges, 1, first)


def quantile_pass_reference(
    x: torch.Tensor, qs: Sequence[float], bins: int = 1024
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the quantile pass: lo, scale (slices,),
    counts (slices, bins) int32, quantiles (slices, len(qs)) f32."""
    _check_x(x, bins)
    lo, hi = torch.aminmax(x, dim=1)
    scale = scale_of(lo, hi, bins)
    counts = histogram_2d_reference(x, lo, scale, bins)
    return lo, scale, counts, invert_cdf(counts, x.shape[1], lo, scale, qs)


def quantile_pass(
    x: torch.Tensor, qs: Sequence[float], bins: int = 1024
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """lo, scale, counts and quantiles of each slice of ``x`` (slices, n).

    CUDA tensors run the two kernels of ``csrc/histogram.cu`` and nothing
    else (``quantile_pass.launches`` counts calls, ``histogram_2d.launches``
    the counting launch); CPU tensors run ``quantile_pass_reference``.
    """
    x = x.to(torch.float32)
    if x.device.type == "cpu":
        return quantile_pass_reference(x, qs, bins)
    _check_x(x, bins)
    _check_cuda(x)
    q32 = _q32(qs)
    if not 1 <= len(q32) <= MAX_QS:
        raise ValueError(f"1 to {MAX_QS} values of q a pass, got {len(q32)}")
    x = x.contiguous()
    slices, n = x.shape
    dev = x.device
    counts = torch.empty((slices, bins), dtype=torch.int32, device=dev)
    lo_scale = torch.empty((2, slices), dtype=torch.float32, device=dev)
    quantiles = torch.empty((slices, len(q32)), dtype=torch.float32, device=dev)
    lib = _library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with on_device(dev):
        rc = lib.seq_quantile_pass(
            x.data_ptr(), n, slices, bins, (ctypes.c_float * len(q32))(*q32), len(q32),
            counts.data_ptr(), lo_scale[0].data_ptr(), lo_scale[1].data_ptr(),
            quantiles.data_ptr(), _scratch(dev, stream, slices, bins).data_ptr(), 0, stream,
        )
    if rc != 0:
        raise RuntimeError(f"quantile pass launch failed: CUDA error {rc}")
    quantile_pass.launches += 1
    histogram_2d.launches += 1
    return lo_scale[0], lo_scale[1], counts, quantiles


quantile_pass.launches = 0


def blocks_per_slice(n: int, slices: int) -> int:
    """The kernels' grid for (slices, n) on the current card: blocks per
    slice (one block an SM over all slices). Launches nothing."""
    return int(_library().seq_histogram_blocks(n, slices, 0))


def kernel_quantiles(
    x: torch.Tensor, qs: Sequence[float], bins: int = 1024
) -> torch.Tensor:
    """Approximate per-slice quantiles of ``x`` (slices, n): (slices,
    len(qs)) float32, within about one bin of the slice's value range, by
    ``quantile_pass``."""
    return quantile_pass(x, qs, bins)[3]
