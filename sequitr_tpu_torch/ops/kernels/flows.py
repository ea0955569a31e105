"""Euler integration of a flow field: the CUDA kernel's wrapper.

``euler(flow, mask, n_iter, step)`` launches ``csrc/flows.cu`` once on the
current stream of the field's device: every foreground pixel of an (H, W, 2)
or (Z, H, W, 3) f32 field follows it for ``n_iter`` steps in registers, each
background pixel keeps its own coordinate. The positions are bit-equal to
the plain version's, ``ops.flows.follow_flows_reference`` (the eager loop),
for every finite field; ``ops.flows.follow_flows`` takes this kernel for a
CUDA tensor and the plain version for a CPU tensor. ``euler.launches``
counts the launches, and each launch adds 1 to the trace counter
``flows.euler_kernel``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from sequitr_tpu_torch import tracing
from sequitr_tpu_torch.ops.kernels import build as build_lib
from sequitr_tpu_torch.ops.kernels import on_device

__all__ = ["euler"]

_lib = None


def _library() -> ctypes.CDLL:
    """The kernel's library, built and bound at first use."""
    global _lib
    if _lib is None:
        lib = build_lib.load("flows")
        bind(lib)
        _lib = lib
    return _lib


def bind(lib: ctypes.CDLL) -> None:
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.seq_follow_flows.restype = i32
    # flow, mask, nd, z, h, w, n_iter, step, out, stream
    lib.seq_follow_flows.argtypes = [ptr, ptr, i32, i32, i32, i32, i32, ctypes.c_float, ptr, ptr]


def _check(flow: torch.Tensor, mask: Optional[torch.Tensor]) -> None:
    if flow.device.type != "cuda":
        raise ValueError(f"the Euler kernel runs on cuda, got {flow.device}")
    if flow.dtype != torch.float32:
        raise TypeError(f"expected a float32 field, got {flow.dtype}")
    nd = flow.ndim - 1
    if nd not in (2, 3) or flow.shape[-1] != nd:
        raise ValueError(f"expected (H, W, 2) or (Z, H, W, 3), got {tuple(flow.shape)}")
    if not flow.is_contiguous() or flow.data_ptr() % 8:
        raise ValueError("the field must be contiguous and 8-byte aligned")
    if mask is not None:
        if mask.dtype != torch.bool or tuple(mask.shape) != tuple(flow.shape[:-1]):
            raise ValueError(
                f"expected a bool mask of shape {tuple(flow.shape[:-1])}, got "
                f"{mask.dtype} {tuple(mask.shape)}"
            )
        if not mask.is_contiguous() or mask.device != flow.device:
            raise ValueError("the mask must be contiguous and on the field's device")


def euler(
    flow: torch.Tensor, mask: Optional[torch.Tensor], n_iter: int, step: float
) -> torch.Tensor:
    """(*spatial, nd) f32 final positions of ``n_iter`` Euler steps of the
    CUDA field ``flow`` (contiguous, 8-byte aligned), the pixels outside the
    bool ``mask`` (None: none) left at their coordinates. One launch, no
    host sync."""
    _check(flow, mask)
    spatial = tuple(flow.shape[:-1])
    z, h, w = (1,) * (3 - len(spatial)) + spatial
    out = torch.empty_like(flow)
    lib = _library()
    with on_device(flow.device):
        rc = lib.seq_follow_flows(
            flow.data_ptr(), None if mask is None else mask.data_ptr(), len(spatial), z, h, w,
            int(n_iter), float(step), out.data_ptr(),
            torch.cuda.current_stream(flow.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"Euler kernel launch failed: CUDA error {rc}")
    euler.launches += 1
    tracing.count("flows.euler_kernel", 1)
    return out


euler.launches = 0
