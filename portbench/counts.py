"""The yardstick's arithmetic: model FLOPs, the quantile pass's bytes, the
card's published peaks.

FLOPs follow the convention of ``sequitr_tpu_torch/studies/roofline.py``: a
multiply-add is 2 FLOP; a KxK(xK) conv costs ``2 * K^d * C_in * C_out`` an
output voxel and a kernel-2 stride-2 transposed conv ``2 * 2^d * C_in *
C_out`` an input voxel. The U-Net is counted once over the served volume,
whatever tiling or phase layout the program computes it in (tile overlap and
padding are the program's extra work, not the model's).
"""

from __future__ import annotations

from typing import Dict

__all__ = [
    "PEAK_BF16_FLOPS", "PEAK_HBM_BYTES_PER_S", "unet_flops_per_voxel",
    "quantile_pass_bytes_per_voxel",
]

# NVIDIA H100 SXM data sheet, dense: bf16 tensor-core rate, HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12

_STORED_BYTES = {"uint16": 2, "uint8": 1, "float32": 4}


def unet_flops_per_voxel(model: Dict) -> float:
    """FLOPs of one voxel (a 2D pixel counts as a voxel) through the U-Net
    of a configuration's ``model`` block (``sequitr_tpu``'s ``UNetConfig``
    keys: transpose upsampling, space-to-depth 1)."""
    if model.get("upsample", "transpose") != "transpose" or model.get("space_to_depth", 1) != 1:
        raise ValueError("counted for transpose upsampling without space-to-depth")
    d = int(model["dims"])
    k3, k2 = 3 ** d, 2 ** d

    def feat(level: int) -> int:
        return min(int(model["base_features"]) * 2 ** level, int(model["features_cap"]))

    def share(level: int) -> float:  # voxels at a level per input voxel
        return 1.0 / k2 ** level

    macs = 0.0
    c_prev = int(model["in_channels"])
    for lvl in range(int(model["depth"])):
        c = feat(lvl)
        macs += share(lvl) * k3 * (c_prev * c + c * c)
        c_prev = c
    for lvl in reversed(range(int(model["depth"]) - 1)):
        c = feat(lvl)
        macs += share(lvl + 1) * k2 * c_prev * c  # the transposed conv's inputs
        macs += share(lvl) * k3 * (2 * c * c + c * c)
        c_prev = c
    macs += c_prev * int(model["num_classes"])  # the 1x1 head
    return 2.0 * macs


def quantile_pass_bytes_per_voxel(stored_dtype: str) -> int:
    """The least the percentile pass can move: each voxel read once at the
    width it is stored at."""
    return _STORED_BYTES[stored_dtype]
