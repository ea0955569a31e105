"""Streaming intensity histogram: CUDA kernel, plain version, quantiles.

Counterpart of ``sequitr_tpu/ops/pallas/histogram.py``. ``histogram_2d``
counts each slice's pixels into ``bins`` buckets with
``bucket = int(clip((x - lo) * scale, 0, bins - 1))``, the TPU kernel's
bucket, computed in f32 the same way. For a CUDA tensor it launches the
hand-written kernel ``csrc/histogram.cu`` (one launch for all slices) or
raises; for a CPU tensor it runs ``histogram_2d_reference``, the plain
PyTorch version of the same function.

``kernel_quantiles`` (the counterpart of ``pallas_quantiles``) inverts the
histogram's CDF on the device: no padding (the kernel masks the ragged
edge), no host sync (lo and scale stay device tensors).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from sequitr_tpu_torch.ops.kernels import build as build_lib

__all__ = ["histogram_2d", "histogram_2d_reference", "invert_cdf", "kernel_quantiles"]

THREADS = 512
# shared memory holds one int32 per bin: at most 48 KB without opt-in
MAX_BINS = 12 * 1024


_lib = None


def _library() -> ctypes.CDLL:
    """The kernel's library, built and bound at first use."""
    global _lib
    if _lib is None:
        lib = build_lib.load("histogram")
        _bind(lib)
        _lib = lib
    return _lib


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.seq_histogram_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [
        ctypes.c_void_p,   # x
        ctypes.c_longlong,  # n per slice
        ctypes.c_int,      # slices
        ctypes.c_void_p,   # lo
        ctypes.c_void_p,   # scale
        ctypes.c_int,      # bins
        ctypes.c_void_p,   # out
        ctypes.c_int,      # blocks per slice
        ctypes.c_int,      # threads
        ctypes.c_void_p,   # stream
    ]


def _check(x: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor, bins: int):
    if x.ndim != 2 or x.shape[1] == 0:
        raise ValueError(f"histogram_2d expects (slices, n>0), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"histogram_2d expects float32, got {x.dtype}")
    for name, t in (("lo", lo), ("scale", scale)):
        if t.shape != (x.shape[0],) or t.dtype != torch.float32:
            raise ValueError(
                f"{name} must be float32 of shape ({x.shape[0]},), got "
                f"{t.dtype} {tuple(t.shape)}"
            )
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if not 1 <= bins <= MAX_BINS:
        raise ValueError(f"bins must be in [1, {MAX_BINS}], got {bins}")


def histogram_2d_reference(
    x: torch.Tensor, lo: torch.Tensor, scale: torch.Tensor, bins: int = 1024
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (slices, bins) int32 counts."""
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

    CUDA tensors run the kernel (``histogram_2d.launches`` counts each
    launch); CPU tensors run ``histogram_2d_reference``.
    """
    if x.device.type == "cpu":
        return histogram_2d_reference(x, lo, scale, bins)
    if x.device.type != "cuda":
        raise ValueError(f"histogram_2d runs on cuda or cpu, got {x.device}")
    _check(x, lo, scale, bins)
    if x.shape[0] > 65535:
        raise ValueError(f"at most 65535 slices per launch, got {x.shape[0]}")
    x = x.contiguous()
    lo = lo.contiguous()
    scale = scale.contiguous()
    slices, n = x.shape
    out = torch.zeros((slices, bins), dtype=torch.int32, device=x.device)
    lib = _library()
    # enough blocks to fill the card twice over, each thread >= 16 pixels
    n_sm = torch.cuda.get_device_properties(x.device).multi_processor_count
    per_slice = max(1, min(-(-n // (THREADS * 16)), -(-2 * n_sm // slices)))
    rc = lib.seq_histogram_f32(
        x.data_ptr(), n, slices, lo.data_ptr(), scale.data_ptr(), bins,
        out.data_ptr(), per_slice, THREADS,
        torch.cuda.current_stream(x.device).cuda_stream,
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

    For each q, the first bin whose CDF reaches q, at the bin's
    midpoint-corrected upper edge ``lo + (k + 1) / scale - 0.5 / scale``:
    the rule of both ``pallas_quantiles`` and the XLA ``histogram_quantiles``.
    """
    bins = hist.shape[1]
    cdf = hist.cumsum(dim=1).to(torch.float32) / n
    ramp = torch.arange(1, bins + 1, dtype=torch.float32, device=hist.device)
    edges = lo[:, None] + ramp[None, :] / scale[:, None] - 0.5 / scale[:, None]
    # q as the f32 value the JAX package compares with, kept a host scalar:
    # a device tensor built from a host list would sync the stream
    q32 = torch.tensor(list(qs), dtype=torch.float32).tolist()
    # first bin with cdf >= q (argmax returns the first maximum)
    first = torch.stack(
        [(cdf >= q).to(torch.uint8).argmax(dim=1) for q in q32], dim=1
    )
    return torch.gather(edges, 1, first)


def kernel_quantiles(
    x: torch.Tensor, qs: Sequence[float], bins: int = 1024
) -> torch.Tensor:
    """Approximate per-slice quantiles of ``x`` (slices, n) via the histogram
    kernel: (slices, len(qs)) float32, within about one bin of the slice's
    value range (``invert_cdf``)."""
    x = x.to(torch.float32)
    lo, hi = torch.aminmax(x, dim=1)
    scale = (bins - 1) / torch.clamp_min(hi - lo, 1e-20)
    hist = histogram_2d(x.contiguous(), lo, scale, bins=bins)
    return invert_cdf(hist, x.shape[1], lo, scale, qs)
