"""Fused 3x3 conv + bias + activation on NHWC input.

Counterpart of ``sequitr_tpu/studies/pallas_conv2d.py``: the same function
with the same arguments, on the hand-written CUDA kernel
``conv3x3_nhwc_kernel`` (``csrc/conv3x3.cu``). The TPU kernel needed a padded
copy of the input, H and W divisible by its tiles and ``(W+8)*C_in`` a
multiple of 128; none of that applies here: any H, W, C_in, C_out >= 1 runs.

Not wired into the model, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import torch

from sequitr_tpu_torch.ops.kernels import conv3x3 as kernels

__all__ = ["conv3x3_bias_act"]


def conv3x3_bias_act(
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    act: str = "relu",
    out_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """SAME 3x3 stride-1 conv + bias + activation.

    ``x``: (H, W, C_in); ``w``: (3, 3, C_in, C_out), cast to ``x.dtype``;
    ``b``: (C_out,), added in f32. Returns (H, W, C_out) in ``out_dtype``
    (default ``x.dtype``). A CUDA ``x`` launches the kernel or raises; a CPU
    ``x`` runs the plain version.
    """
    wk, bk = kernels.pack_weights(w, b, x.dtype)
    return kernels.conv3x3_nhwc(x, wk, bk, act, out_dtype)
