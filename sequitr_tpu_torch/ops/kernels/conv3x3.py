"""SAME 3x3 stride-1 conv + bias + activation: CUDA kernels and plain versions.

Two layouts of one function, both in ``csrc/conv3x3.cu``:

``conv3x3_nhwc``
    ``x (H, W, C_in)`` -> ``(H, W, C_out)``: the function of the TPU study
    kernel ``sequitr_tpu/studies/pallas_conv2d.py``.
``conv3x3_flat_chw``
    the flat channel-major layout with a zero ring of the TPU study kernels
    ``pallas_conv2d_gemm.py`` and ``pallas_conv2d_gemm2.py``:
    ``x_flat (C_in, margin + (H+16)*Wb)`` -> ``(C_out, H*Wb)``. Output flat
    index ``n`` is padded row ``1 + n // Wb``, column ``n % Wb``; columns 0
    and > W are written as zero, the others hold the conv of pixel
    ``(n // Wb, n % Wb - 1)``, read at flat offsets
    ``margin + Wb + n + dy*Wb + dx``. The row stride ``Wb`` and the front
    margin are arguments.

Weights come packed as ``(9*C_in, C_out)`` (the HWIO kernel reshaped:
tap-major, ``dy`` outer) in the input's dtype, the bias as f32
(``pack_weights``). Operands multiply into f32; the f32 bias and the
activation are applied to the f32 sum, which is rounded once, to
``out_dtype``.

For a CUDA tensor each entry point launches its kernel (counted in
``.launches``) or raises; for a CPU tensor it runs the plain PyTorch version
beside it (``*_reference``), which no card path calls.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from sequitr_tpu_torch.ops.kernels import build as build_lib

__all__ = [
    "ACTIVATIONS",
    "pack_weights",
    "conv3x3_nhwc",
    "conv3x3_nhwc_reference",
    "conv3x3_flat_chw",
    "conv3x3_flat_chw_reference",
]

ACTIVATIONS = ("relu", "none")
_TYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# rows the flat layout carries beyond H (1 ring row above, 15 below)
FLAT_EXTRA_ROWS = 16

_lib = None


def _library() -> ctypes.CDLL:
    """The kernels' library, built and bound at first use."""
    global _lib
    if _lib is None:
        lib = build_lib.load("conv3x3")
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.seq_conv3x3_nhwc.restype = i32
        lib.seq_conv3x3_nhwc.argtypes = [
            ptr, ptr, ptr, ptr,  # x, w, bias, y
            i32, i32, i32, i32,  # H, W, C_in, C_out
            i32, i32, i32,  # relu, in type, out type
            ptr,  # stream
        ]
        lib.seq_conv3x3_flat_chw.restype = i32
        lib.seq_conv3x3_flat_chw.argtypes = [
            ptr, ptr, ptr, ptr,  # x, w, bias, y
            i32, i32, i32, i32,  # H, W, Wb, margin
            i32, i32,  # C_in, C_out
            i32, i32, i32,  # relu, in type, out type
            ptr,  # stream
        ]
        _lib = lib
    return _lib


def pack_weights(
    w: torch.Tensor, b: torch.Tensor, dtype: torch.dtype
) -> Tuple[torch.Tensor, torch.Tensor]:
    """HWIO ``(3, 3, C_in, C_out)`` weights and ``(C_out,)`` bias -> the
    kernels' packing: ``(9*C_in, C_out)`` in ``dtype``, bias f32."""
    if w.ndim != 4 or tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"expected (3, 3, C_in, C_out) weights, got {tuple(w.shape)}")
    c_in, c_out = int(w.shape[2]), int(w.shape[3])
    if tuple(b.shape) != (c_out,):
        raise ValueError(f"expected ({c_out},) bias, got {tuple(b.shape)}")
    return (
        w.reshape(9 * c_in, c_out).to(dtype).contiguous(),
        b.to(torch.float32).contiguous(),
    )


def _check(x, wk, bk, c_in: int, act: str, out_dtype) -> torch.dtype:
    if x.dtype not in _TYPE_CODES:
        raise TypeError(f"conv3x3 takes float32 or bfloat16, got {x.dtype}")
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _TYPE_CODES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if act not in ACTIVATIONS:
        raise ValueError(f"act must be one of {ACTIVATIONS}, got {act!r}")
    if wk.ndim != 2 or wk.shape[0] != 9 * c_in or wk.dtype != x.dtype:
        raise ValueError(
            f"packed weights must be ({9 * c_in}, C_out) {x.dtype}, got "
            f"{tuple(wk.shape)} {wk.dtype}"
        )
    if tuple(bk.shape) != (wk.shape[1],) or bk.dtype != torch.float32:
        raise ValueError(
            f"bias must be ({wk.shape[1]},) float32, got {tuple(bk.shape)} {bk.dtype}"
        )
    for name, t in (("weights", wk), ("bias", bk)):
        if t.device != x.device:
            raise ValueError(f"{name} are on {t.device}, x on {x.device}")
    return out_dtype


def _act(y: torch.Tensor, act: str) -> torch.Tensor:
    return torch.relu(y) if act == "relu" else y


def _raise_on(rc: int, what: str, sizes: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} ({sizes})")


def _require_cuda(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, got {x.device}")


# ---------------------------------------------------------------------------
# NHWC
# ---------------------------------------------------------------------------


def conv3x3_nhwc_reference(
    x: torch.Tensor, wk: torch.Tensor, bk: torch.Tensor,
    act: str = "relu", out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain PyTorch version of ``conv3x3_nhwc``: operands cast to f32,
    ``F.conv2d`` with ``padding=1``, bias, activation, one rounding."""
    if x.ndim != 3:
        raise ValueError(f"expected x (H, W, C_in), got {tuple(x.shape)}")
    c_in = x.shape[2]
    out_dtype = _check(x, wk, bk, c_in, act, out_dtype)
    w = wk.to(torch.float32).reshape(3, 3, c_in, -1).permute(3, 2, 0, 1)
    y = F.conv2d(x.to(torch.float32).permute(2, 0, 1)[None], w, padding=1)[0]
    y = _act(y + bk[:, None, None], act)
    return y.permute(1, 2, 0).contiguous().to(out_dtype)


def conv3x3_nhwc(
    x: torch.Tensor, wk: torch.Tensor, bk: torch.Tensor,
    act: str = "relu", out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``x (H, W, C_in)``, packed weights and bias (``pack_weights``) ->
    ``(H, W, C_out)`` in ``out_dtype`` (default ``x.dtype``).

    Any H, W, C_in, C_out >= 1: the kernel masks the ragged edge and reads
    the image border as zero, no padded copy is made.
    """
    if x.device.type == "cpu":
        return conv3x3_nhwc_reference(x, wk, bk, act, out_dtype)
    _require_cuda(x, "conv3x3_nhwc")
    if x.ndim != 3:
        raise ValueError(f"expected x (H, W, C_in), got {tuple(x.shape)}")
    h, w_img, c_in = (int(d) for d in x.shape)
    out_dtype = _check(x, wk, bk, c_in, act, out_dtype)
    c_out = int(wk.shape[1])
    x, wk, bk = x.contiguous(), wk.contiguous(), bk.contiguous()
    y = torch.empty((h, w_img, c_out), dtype=out_dtype, device=x.device)
    rc = _library().seq_conv3x3_nhwc(
        x.data_ptr(), wk.data_ptr(), bk.data_ptr(), y.data_ptr(),
        h, w_img, c_in, c_out, int(act == "relu"),
        _TYPE_CODES[x.dtype], _TYPE_CODES[out_dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _raise_on(rc, "conv3x3_nhwc", f"H={h} W={w_img} C_in={c_in} C_out={c_out}")
    conv3x3_nhwc.launches += 1
    return y


conv3x3_nhwc.launches = 0


# ---------------------------------------------------------------------------
# flat channel-major layout
# ---------------------------------------------------------------------------


def _flat_len(h: int, wb: int, margin: int) -> int:
    return margin + (h + FLAT_EXTRA_ROWS) * wb


def _check_flat(x_flat, h: int, w_img: int, wb: int, margin: int) -> None:
    if h < 1 or w_img < 1:
        raise ValueError(f"h and w_img must be >= 1, got {h}, {w_img}")
    if wb < w_img + 2 or margin < 1:
        raise ValueError(
            f"row stride {wb} must be >= w_img + 2 = {w_img + 2} and the "
            f"margin {margin} >= 1"
        )
    if x_flat.ndim != 2 or x_flat.shape[1] != _flat_len(h, wb, margin):
        raise ValueError(
            f"expected x_flat (C_in, {_flat_len(h, wb, margin)}) for h={h}, "
            f"row stride {wb}, margin {margin}; got {tuple(x_flat.shape)}"
        )


def conv3x3_flat_chw_reference(
    x_flat: torch.Tensor, wk: torch.Tensor, bk: torch.Tensor,
    h: int, w_img: int, wb: int, margin: int,
    act: str = "relu", out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """Plain PyTorch version of ``conv3x3_flat_chw``, on the flat layout
    itself: nine shifted slices of ``x_flat`` stacked tap-major, one
    ``(C_out, 9*C_in) @ (9*C_in, H*Wb)`` product in f32, bias, activation,
    the column mask. A wrong ring or margin shows in its result."""
    _check_flat(x_flat, h, w_img, wb, margin)
    c_in = x_flat.shape[0]
    out_dtype = _check(x_flat, wk, bk, c_in, act, out_dtype)
    n = h * wb
    base = margin + wb
    x32 = x_flat.to(torch.float32)
    taps = [
        x32[:, base + dy * wb + dx : base + dy * wb + dx + n]
        for dy in (-1, 0, 1)
        for dx in (-1, 0, 1)
    ]
    xcol = torch.cat(taps, dim=0)  # (9*C_in, H*Wb), rows tap-major like wk
    y = _act(wk.to(torch.float32).T @ xcol + bk[:, None], act)
    col = torch.arange(n, device=x_flat.device) % wb
    y = torch.where((col >= 1) & (col <= w_img), y, torch.zeros((), device=y.device))
    return y.to(out_dtype)


def conv3x3_flat_chw(
    x_flat: torch.Tensor, wk: torch.Tensor, bk: torch.Tensor,
    h: int, w_img: int, wb: int, margin: int,
    act: str = "relu", out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """``x_flat (C_in, margin + (h+16)*wb)`` with a zero ring, packed weights
    and bias -> ``(C_out, h*wb)`` in ``out_dtype`` (default ``x_flat.dtype``),
    pad columns (0 and > w_img) zero."""
    if x_flat.device.type == "cpu":
        return conv3x3_flat_chw_reference(
            x_flat, wk, bk, h, w_img, wb, margin, act, out_dtype
        )
    _require_cuda(x_flat, "conv3x3_flat_chw")
    _check_flat(x_flat, h, w_img, wb, margin)
    c_in = int(x_flat.shape[0])
    out_dtype = _check(x_flat, wk, bk, c_in, act, out_dtype)
    c_out = int(wk.shape[1])
    x_flat, wk, bk = x_flat.contiguous(), wk.contiguous(), bk.contiguous()
    y = torch.empty((c_out, h * wb), dtype=out_dtype, device=x_flat.device)
    rc = _library().seq_conv3x3_flat_chw(
        x_flat.data_ptr(), wk.data_ptr(), bk.data_ptr(), y.data_ptr(),
        h, w_img, wb, margin, c_in, c_out, int(act == "relu"),
        _TYPE_CODES[x_flat.dtype], _TYPE_CODES[out_dtype],
        torch.cuda.current_stream(x_flat.device).cuda_stream,
    )
    _raise_on(
        rc, "conv3x3_flat_chw",
        f"H={h} W={w_img} Wb={wb} margin={margin} C_in={c_in} C_out={c_out}",
    )
    conv3x3_flat_chw.launches += 1
    return y


conv3x3_flat_chw.launches = 0
