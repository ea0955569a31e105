"""Int8 convolution with int32 accumulation: CUDA kernel and plain version.

The convs of the quantized U-Net forward (``studies.ptq_unet``) and of the
int8 conv study (``studies.int8_conv``), which the JAX package leaves to XLA
(``conv_general_dilated`` / ``conv_transpose`` with
``preferred_element_type=int32``); PyTorch has no int8 convolution on CUDA.

``qconv(x, w)``: ``x`` int8 channels-last (N, [D,] H, W, C_in), ``w`` int8
in the JAX package's layout ([k,] k, k, C_in, C_out). ``k`` = 3 is the SAME
stride-1 conv, ``k`` = 1 the 1x1 conv, and ``transpose=True`` with ``k`` = 2
the stride-2 VALID transposed conv of ``ptq_unet._qconv``
(``conv_transpose(x, swapaxes(w, -1, -2), transpose_kernel=True)``: output
pixel 2i + a is ``sum_c x[i, c] * w[a, c, o]``). Epilogues:

* ``"raw"``: the int32 sums;
* ``"dequant"``: f32 ``acc * scale + bias`` per output channel, the product
  and the sum each rounded (``ptq_unet._qconv``'s points), ReLU if asked;
* ``"requant"``: the dequant value (ReLU if asked) times ``inv_next``,
  rounded half to even and clipped to [-127, 127], as int8.

For a CUDA tensor ``qconv`` launches ``csrc/qconv.cu`` once (counted in
``qconv.launches``) or raises. The kernel reads the weights packed in
32-bit words of four input channels (``pack_weights``: a layout change in
torch ops, made once a weight tensor and kept with it, again only after an
in-place change). For a CPU tensor it runs the plain version
``qconv_reference``: the conv in float64, whose sums of integer products are
exact below 2^53 (an f32 conv is not: sums reach 9 * 256 * 127^2 > 2^24),
then the same epilogue in f32 tensor ops.
"""

from __future__ import annotations

import ctypes
import math
import weakref
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sequitr_tpu_torch.ops.kernels import build as build_lib

__all__ = ["EPILOGUES", "qconv", "qconv_reference", "out_spatial", "pack_weights"]

EPILOGUES = ("raw", "dequant", "requant")
_OUT_DTYPES = {"raw": torch.int32, "dequant": torch.float32, "requant": torch.int8}
# mode codes of csrc/qconv.cu by (kernel size, transposed)
_MODES = {(3, False): 0, (1, False): 1, (2, True): 2}
_OUT_TILE = 16  # output channels a thread (csrc/qconv.cu kOutTile): the packed rows' padding

_lib = None


def _library() -> ctypes.CDLL:
    """The kernel's library, built and bound at first use."""
    global _lib
    if _lib is None:
        lib = build_lib.load("qconv")
        bind(lib)
        _lib = lib
    return _lib


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a build of ``csrc/qconv.cu`` on ``lib``."""
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.seq_qconv_packed_words.restype = i64
    lib.seq_qconv_packed_words.argtypes = [i32, i32, i32, i32]  # mode, dims, c_in, c_out
    lib.seq_qconv.restype = i32
    lib.seq_qconv.argtypes = [
        ptr, ptr, ptr, ptr, ptr,  # x, packed w, scale, bias, y
        i32, i32, i32, i32, i32, i32,  # n, d, h, w, c_in, c_out
        i32, i32, i32, i32, f32,  # dims, mode, epilogue, relu, inv_next
        ptr,  # stream
    ]
    return lib


def _check(x, w, transpose, epilogue, scale, bias, inv_next) -> int:
    """Validate the arguments; returns the kernel's mode code."""
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"qconv takes int8 x and w, got {x.dtype} and {w.dtype}")
    dims = x.ndim - 2
    if dims not in (2, 3) or w.ndim != dims + 2:
        raise ValueError(
            f"expected x (N, [D,] H, W, C_in) and w ([k,] k, k, C_in, C_out), got "
            f"{tuple(x.shape)} and {tuple(w.shape)}"
        )
    k = int(w.shape[0])
    if tuple(w.shape[:dims]) != (k,) * dims or (k, bool(transpose)) not in _MODES:
        raise ValueError(
            f"w must be a 3^d or 1^d conv kernel, or 2^d with transpose=True; got "
            f"{tuple(w.shape)} transpose={transpose}"
        )
    if w.shape[-2] != x.shape[-1]:
        raise ValueError(f"w takes {w.shape[-2]} input channels, x has {x.shape[-1]}")
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {EPILOGUES}, got {epilogue!r}")
    if epilogue != "raw":
        c_out = int(w.shape[-1])
        for name, t in (("scale", scale), ("bias", bias)):
            if t is None or t.dtype != torch.float32 or tuple(t.shape) != (c_out,):
                raise ValueError(f"{epilogue} needs a ({c_out},) float32 {name}")
            if t.device != x.device:
                raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if epilogue == "requant" and inv_next is None:
        raise ValueError("requant needs inv_next")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    return _MODES[(k, bool(transpose))]


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """``w`` ([k,] k, k, C_in, C_out) int8 as ``csrc/qconv.cu`` reads it:
    int32 words of four input channels, channel 4g in the low byte, laid out
    [tap][ceil(C_in / 4)][C_out rounded up to 16], zero beyond C_in and
    C_out. Flat, on ``w``'s device."""
    dims = w.ndim - 2
    taps = math.prod(int(s) for s in w.shape[:dims])
    c_in, c_out = int(w.shape[-2]), int(w.shape[-1])
    groups, c_pad = -(-c_in // 4), -(-c_out // _OUT_TILE) * _OUT_TILE
    wp = torch.zeros((taps, 4 * groups, c_pad), dtype=torch.int8, device=w.device)
    wp[:, :c_in, :c_out] = w.reshape(taps, c_in, c_out)
    # (tap, group, channel of four, output) -> (tap, group, output, channel of
    # four): four bytes in a row, one little-endian int32
    wp = wp.view(taps, groups, 4, c_pad).transpose(2, 3).contiguous()
    return wp.view(torch.int32).reshape(-1)


# id(w) -> (a weak reference to w, w's version, pack_weights(w))
_PACKED: Dict[int, Tuple[weakref.ref, int, torch.Tensor]] = {}


def _packed(w: torch.Tensor) -> torch.Tensor:
    """``pack_weights(w)``, made once a weight tensor and again after an
    in-place change. Not kept for an inference tensor (no version counter)
    or while a CUDA graph is captured (its memory is the graph's)."""
    if w.is_inference() or (w.is_cuda and torch.cuda.is_current_stream_capturing()):
        return pack_weights(w)
    hit = _PACKED.get(id(w))
    if hit is not None and hit[0]() is w and hit[1] == w._version:
        return hit[2]
    if hit is None or hit[0]() is not w:
        weakref.finalize(w, _PACKED.pop, id(w), None)
    wp = pack_weights(w)
    _PACKED[id(w)] = (weakref.ref(w), w._version, wp)
    return wp


def out_spatial(x_spatial, transpose: bool = False):
    """The output's spatial shape for an input's: doubled by the transposed conv."""
    return tuple(2 * s for s in x_spatial) if transpose else tuple(x_spatial)


def _epilogue(acc, epilogue, scale, bias, relu, inv_next):
    if epilogue == "raw":
        return acc
    y = acc.to(torch.float32) * scale + bias
    if relu:
        y = torch.relu(y)
    if epilogue == "dequant":
        return y
    q = torch.clamp(torch.round(y * float(np.float32(inv_next))), -127, 127)
    return q.to(torch.int8)


def qconv_reference(
    x: torch.Tensor, w: torch.Tensor, transpose: bool = False, epilogue: str = "raw",
    scale: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
    relu: bool = False, inv_next: Optional[float] = None,
) -> torch.Tensor:
    """Plain PyTorch version of ``qconv``: the conv of the int8 values in
    float64 (exact), its sums as int32, the epilogue in f32 tensor ops."""
    _check(x, w, transpose, epilogue, scale, bias, inv_next)
    dims = x.ndim - 2
    xd = torch.movedim(x, -1, 1).to(torch.float64)
    lead = tuple(range(dims))
    if transpose:  # (k.., I, O) -> (I, O, k..): out[2i + a] = x[i] . w[a]
        wd = w.permute((dims, dims + 1) + lead).to(torch.float64)
        acc = (F.conv_transpose3d if dims == 3 else F.conv_transpose2d)(xd, wd, stride=2)
    else:  # (k.., I, O) -> (O, I, k..)
        wd = w.permute((dims + 1, dims) + lead).to(torch.float64)
        acc = (F.conv3d if dims == 3 else F.conv2d)(xd, wd, padding=int(w.shape[0]) // 2)
    acc = torch.movedim(acc, 1, -1).to(torch.int32).contiguous()
    return _epilogue(acc, epilogue, scale, bias, relu, inv_next)


def qconv(
    x: torch.Tensor, w: torch.Tensor, transpose: bool = False, epilogue: str = "raw",
    scale: Optional[torch.Tensor] = None, bias: Optional[torch.Tensor] = None,
    relu: bool = False, inv_next: Optional[float] = None,
) -> torch.Tensor:
    """The int8 conv of ``x`` by ``w`` with the ``epilogue``'s output:
    (N, [D,] H', W', C_out) int32, f32 or int8 (H' = 2H for the transposed
    conv). ``scale``, ``bias``: (C_out,) f32 on ``x``'s device, for
    ``dequant`` and ``requant``; ``inv_next``: the next layer's f32
    reciprocal scale, for ``requant``."""
    if x.device.type == "cpu":
        return qconv_reference(x, w, transpose, epilogue, scale, bias, relu, inv_next)
    if x.device.type != "cuda":
        raise ValueError(f"qconv runs on cuda or cpu, got {x.device}")
    mode = _check(x, w, transpose, epilogue, scale, bias, inv_next)
    dims = x.ndim - 2
    x = x.contiguous()
    if x.data_ptr() % 4:
        x = x.clone()
    n, *spatial, c_in = (int(s) for s in x.shape)
    c_out = int(w.shape[-1])
    d, h, wd = ([1] + spatial) if dims == 2 else spatial
    lib = _library()
    wp = _packed(w)
    if wp.numel() != lib.seq_qconv_packed_words(mode, dims, c_in, c_out):
        raise RuntimeError(f"packed weights of {wp.numel()} words, the kernel reads "
                           f"{lib.seq_qconv_packed_words(mode, dims, c_in, c_out)}")
    y = torch.empty(
        (n, *out_spatial(spatial, transpose), c_out), dtype=_OUT_DTYPES[epilogue], device=x.device
    )
    if epilogue != "raw":
        scale, bias = scale.contiguous(), bias.contiguous()
    rc = lib.seq_qconv(
        x.data_ptr(), wp.data_ptr(),
        None if scale is None else scale.data_ptr(),
        None if bias is None else bias.data_ptr(),
        y.data_ptr(),
        n, d, h, wd, c_in, c_out, dims, mode, EPILOGUES.index(epilogue), int(bool(relu)),
        float(np.float32(inv_next)) if epilogue == "requant" else 0.0,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            f"qconv kernel launch failed: CUDA error {rc} (x {tuple(x.shape)}, w {tuple(w.shape)}, "
            f"transpose={transpose}, {epilogue})"
        )
    qconv.launches += 1
    return y


qconv.launches = 0
