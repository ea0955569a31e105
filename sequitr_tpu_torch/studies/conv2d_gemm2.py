"""3x3 conv + bias + activation in the flat channel-major layout, row stride a
multiple of 128.

Counterpart of ``sequitr_tpu/studies/pallas_conv2d_gemm2.py``: the same layout
contract and arguments. On the TPU the aligned stride made every tap slice
start on a 128-lane boundary and the ``dx`` shifts were made once per band,
which is what separated that kernel from ``pallas_conv2d_gemm.py``. On a CUDA
card the 128-lane alignment is only a row stride: this entry point launches
the same kernel as ``conv2d_gemm.conv3x3_gemm``
(``conv3x3_flat_chw_kernel``, ``csrc/conv3x3.cu``) with ``Wb = wb2(W)``, and
differs from it in the bytes of padding it moves and nothing else.

Not wired into the model, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from sequitr_tpu_torch.ops.kernels import conv3x3 as kernels
from sequitr_tpu_torch.studies.conv2d_gemm import (
    MARGIN,
    flatten_rows,
    repad_rows,
    unflatten_rows,
)

__all__ = ["conv3x3_gemm2", "flatten_chw2", "unflatten_chw2", "repad_chw2", "wb2", "MARGIN"]


def wb2(w_img: int) -> int:
    """Flat row stride: smallest multiple of 128 >= w_img + 2."""
    return ((w_img + 2 + 127) // 128) * 128


def flatten_chw2(x: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> (C, MARGIN + (H+16) * Wb), Wb = wb2(W), zero ring."""
    return flatten_rows(x, wb2(x.shape[1]))


def unflatten_chw2(y_flat: torch.Tensor, h: int, w_img: int) -> torch.Tensor:
    """Kernel output (C, h*Wb) -> (H, W, C)."""
    return unflatten_rows(y_flat, h, w_img, wb2(w_img))


def repad_chw2(y_flat: torch.Tensor, w_img: int) -> torch.Tensor:
    """``conv3x3_gemm2`` output -> ``conv3x3_gemm2`` input for the next layer."""
    return repad_rows(y_flat, wb2(w_img))


def conv3x3_gemm2(
    x_flat: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    h: int,
    w_img: int,
    act: str = "relu",
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """SAME 3x3 stride-1 conv + bias + activation, 128-aligned row stride.

    ``x_flat``: output of ``flatten_chw2``; ``w``: (3, 3, C_in, C_out);
    ``b``: (C_out,). Returns (C_out, H*Wb).
    """
    wk, bk = kernels.pack_weights(w, b, x_flat.dtype)
    return kernels.conv3x3_flat_chw(
        x_flat, wk, bk, h, w_img, wb2(w_img), MARGIN, act, out_dtype
    )
