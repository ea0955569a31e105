"""3x3 conv + bias + activation in the flat channel-major layout, row stride W+8.

Counterpart of ``sequitr_tpu/studies/pallas_conv2d_gemm.py``: the same layout
contract and arguments, on the hand-written CUDA kernel
``conv3x3_flat_chw_kernel`` (``csrc/conv3x3.cu``).

Layout contract (``flatten_chw`` / ``unflatten_chw``):
    x_flat: (C, MARGIN + (H+16) * Wb), Wb = W + 8, zero ring,
    pixel (r, c) of the padded image at flat index MARGIN + r*Wb + c.
Every conv tap is a constant flat shift ``dy*Wb + dx``; the one-column ring
absorbs the row wrap of flat shifting, and the kernel writes the pad columns
of its output as zero so the output can be re-padded for a following layer.
The paddings (H+16, W+8, MARGIN=128) are the TPU kernel's DMA alignment
rules, kept so that both packages exchange the same arrays; the CUDA kernel
needs only the ring and one element of margin.

Not wired into the model, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from sequitr_tpu_torch.ops.kernels import conv3x3 as kernels

__all__ = ["conv3x3_gemm", "flatten_chw", "unflatten_chw", "repad_chw", "MARGIN"]

MARGIN = 128  # front pad: the (-Wb-1) tap of the first pixel stays in bounds


def _wb(w_img: int) -> int:
    return w_img + 8


def flatten_rows(x: torch.Tensor, wb: int) -> torch.Tensor:
    """(H, W, C) -> (C, MARGIN + (H+16)*wb): one ring row above and 15 zero
    rows below, one ring column left and ``wb - W - 1`` zero columns right."""
    h, w_img, c = x.shape
    xt = F.pad(x.permute(2, 0, 1), (1, wb - w_img - 1, 1, 15))
    return F.pad(xt.reshape(c, (h + 16) * wb), (MARGIN, 0))


def unflatten_rows(y_flat: torch.Tensor, h: int, w_img: int, wb: int) -> torch.Tensor:
    """Kernel output (C, h*wb) -> (H, W, C)."""
    c = y_flat.shape[0]
    return y_flat.reshape(c, h, wb)[:, :, 1 : 1 + w_img].permute(1, 2, 0)


def repad_rows(y_flat: torch.Tensor, wb: int) -> torch.Tensor:
    """Kernel output (C, h*wb), pad columns zero -> the input layout of a
    following layer: the margin and the ring row in front, 15 zero rows
    behind. No pixel moves."""
    return F.pad(y_flat, (MARGIN + wb, 15 * wb))


def flatten_chw(x: torch.Tensor) -> torch.Tensor:
    """(H, W, C) -> the kernel's flat layout (C, MARGIN + (H+16)*Wb)."""
    return flatten_rows(x, _wb(x.shape[1]))


def unflatten_chw(y_flat: torch.Tensor, h: int, w_img: int) -> torch.Tensor:
    """Kernel output (C, h*Wb) -> (H, W, C)."""
    return unflatten_rows(y_flat, h, w_img, _wb(w_img))


def repad_chw(y_flat: torch.Tensor, w_img: int) -> torch.Tensor:
    """``conv3x3_gemm`` output -> ``conv3x3_gemm`` input for the next layer."""
    return repad_rows(y_flat, _wb(w_img))


def conv3x3_gemm(
    x_flat: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    h: int,
    w_img: int,
    act: str = "relu",
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """SAME 3x3 stride-1 conv + bias + activation in the flat CHW layout.

    ``x_flat``: output of ``flatten_chw`` (C_in, MARGIN + (H+16)*Wb);
    ``w``: (3, 3, C_in, C_out); ``b``: (C_out,). Returns (C_out, H*Wb) — feed
    it through ``unflatten_chw`` or re-pad it for a following layer. Any
    H >= 1 (the TPU kernel's row-tile rule does not apply).
    """
    wk, bk = kernels.pack_weights(w, b, x_flat.dtype)
    return kernels.conv3x3_flat_chw(
        x_flat, wk, bk, h, w_img, _wb(w_img), MARGIN, act, out_dtype
    )
