"""The plain reference the served labels are judged against.

Plain PyTorch and numpy in float32 (TF32 off): the percentile normalize,
the U-Net with batch norm folded here, the sliding-window tiling with the
Hann stitch, the softmax. It imports nothing of the program and takes only
the weight file and the input items the benchmark hands both sides.
``class_scores`` gives the stitched class probabilities of one item; the
served label of a voxel is judged by how far its probability lies below
the best class's there.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import normalize as norm_ref
from portbench.reference import tiling as tiling_ref
from portbench.reference import unet as unet_ref

__all__ = ["tiling_of", "class_scores", "load_weights"]

load_weights = unet_ref.load_weights

# the job server's tiling policy when a job names none: whole items up to
# this many voxels, else its default grid
WHOLE_ITEM_BUDGET = 4_400_000
DEFAULT_TILING = {2: ((256, 256), (64, 64)), 3: ((16, 128, 128), (4, 32, 32))}


def tiling_of(params: Dict, shape: Sequence[int]) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(patch, overlap) a job with ``params`` serves an item of ``shape`` at."""
    if params.get("patch") is not None:
        patch = tuple(params["patch"])
        return patch, tuple(params.get("overlap") or DEFAULT_TILING[len(shape)][1])
    if int(np.prod(shape)) <= WHOLE_ITEM_BUDGET:
        return tuple(shape), (0,) * len(shape)
    return DEFAULT_TILING[len(shape)]


def class_scores(
    wts: unet_ref.Weights, item: np.ndarray, patch, overlap, device,
    fp8: bool = False, tile_batch: int = 8, x: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(K, *shape) stitched float32 class probabilities of one stored item.
    ``x``: the normalized item, when the caller has it already."""
    shape = tuple(item.shape)
    if any(p > s for p, s in zip(patch, shape)):
        raise ValueError(f"patch {tuple(patch)} exceeds the item {shape}")
    if x is None:
        x = torch.from_numpy(norm_ref.normalize(item)).to(device)
    origins = tiling_ref.grid(shape, patch, overlap)
    probs = []
    with torch.no_grad(), unet_ref.float32_exact():
        for i in range(0, len(origins), tile_batch):
            tiles = torch.stack([
                x[tuple(slice(a, a + p) for a, p in zip(o, patch))]
                for o in origins[i:i + tile_batch]
            ])[:, None]
            probs.append(torch.softmax(unet_ref.forward(wts, tiles, fp8=fp8), dim=1))
        return tiling_ref.stitch(torch.cat(probs), origins, shape, overlap)
