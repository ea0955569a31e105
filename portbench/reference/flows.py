"""Plain Cellpose-style instance segmentation of one frame, the judge's
reference for a flows model (``kinds/cpnet.py``).

1. Normalize: the frame's ``p_lo`` / ``p_hi`` percentiles from a 1024-bin
   histogram (``normalize.histogram_percentiles``), ``clip((x - lo) / (hi -
   lo + 1e-8), 0, 1)``.
2. Grayscale mode (Cellpose's ``channels = [0, 0]``): the normalized frame
   is channel 0 and zeros are channel 1, added after the normalize.
3. Tiles of ``patch`` every ``patch - overlap`` (``tiling.grid``), each
   through the plain CPnet (``reference/cpnet.py``, float32) with its own
   style vector, the raw head stitched with the Hann window
   (``tiling.stitch``).
4. ``flow = head[:2] / 5`` (the flows were trained at 5x the unit flows),
   ``prob = sigmoid(head[2])``, foreground ``prob > cellprob_threshold``.
5. ``n_iter`` Euler steps of every pixel through the foreground's flow:
   the flow bilinearly sampled at the position (clamped to the frame, the
   cell's lower corner to one short of the last row and column), added,
   and the position clamped to the frame.
6. Sink grouping: each foreground pixel's final position rounded to a
   pixel; pixels reached by at least ``min_sink`` pixels are sinks; sinks
   dilated by one pixel (3x3) and labelled as 4-connected clusters; each
   foreground pixel takes the cluster at its final pixel; pixels that land
   on none take, up to ``snap_radius`` times, the largest cluster id
   within one more pixel (the clusters grown by a 3x3 maximum filter each
   time); instances under ``min_area`` pixels dropped, ids renumbered 1..N
   in order.

Departures from Cellpose (``cellpose/models.py``, ``dynamics.py``): the
Hann stitch in place of Cellpose's tile taper mask; the percentiles from a
1024-bin histogram in place of ``np.percentile``; no diameter rescale; the
grouping of step 6 in place of ``get_masks`` (Cellpose histograms the
final positions, takes local maxima above 10 as seeds and grows them
through the histogram, then drops masks by flow error and area).

``match`` pairs the instances of two label maps one to one at IoU >= 0.5
(the Hungarian assignment over IoU), for the judge and the weights' AP.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
from scipy import ndimage
from scipy.optimize import linear_sum_assignment

from portbench.reference import cpnet as cpnet_ref
from portbench.reference import normalize as norm_ref
from portbench.reference import tiling as tiling_ref
from portbench.reference.unet import float32_exact

__all__ = ["FLOW_SCALE", "normalize", "heads", "euler", "group", "instances", "match"]

FLOW_SCALE = 5.0


def normalize(item: np.ndarray, p_lo: float, p_hi: float) -> np.ndarray:
    lo, hi = norm_ref.histogram_percentiles(item, qs=(p_lo / 100.0, p_hi / 100.0))
    v = np.asarray(item, np.float32)
    return np.clip((v - lo) / (hi - lo + np.float32(1e-8)), 0.0, 1.0).astype(np.float32)


def heads(net: cpnet_ref.CPnet, item: np.ndarray, params: Dict, device, fp8: bool = False,
          tile_batch: int = 8) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(flow (2, H, W), prob (H, W))`` float32 of one stored frame
    served by the params of a ``segment_flows`` job (``patch``,
    ``overlap``, ``p_lo``, ``p_hi``; grayscale mode)."""
    shape = tuple(item.shape)
    patch, overlap = tuple(params["patch"]), tuple(params["overlap"])
    x = torch.from_numpy(normalize(item, float(params["p_lo"]), float(params["p_hi"]))).to(device)
    origins = tiling_ref.grid(shape, patch, overlap)
    out = []
    for i in range(0, len(origins), tile_batch):
        tiles = torch.stack([x[o[0]:o[0] + patch[0], o[1]:o[1] + patch[1]]
                             for o in origins[i:i + tile_batch]])[:, None]
        tiles = torch.cat([tiles, torch.zeros_like(tiles)], dim=1)
        out.append(cpnet_ref.head(net, tiles, fp8=fp8))
    with torch.no_grad():
        head = tiling_ref.stitch(torch.cat(out), origins, shape, overlap)
    return head[:2] / FLOW_SCALE, torch.sigmoid(head[2])


def euler(flow: torch.Tensor, mask: torch.Tensor, n_iter: int, step: float = 1.0) -> torch.Tensor:
    """(H, W, 2) final positions of every pixel after ``n_iter`` Euler steps
    through ``flow`` (2, H, W) zeroed outside ``mask`` (H, W)."""
    with torch.no_grad(), float32_exact():
        f = flow * mask.to(flow.dtype)
        h, w = mask.shape
        yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=flow.device),
                                torch.arange(w, dtype=torch.float32, device=flow.device),
                                indexing="ij")
        y, x = yy.reshape(-1), xx.reshape(-1)
        for _ in range(int(n_iter)):
            yc, xc = y.clamp(0, h - 1), x.clamp(0, w - 1)
            y0, x0 = yc.floor().clamp(0, h - 2), xc.floor().clamp(0, w - 2)
            fy, fx = yc - y0, xc - x0
            i0, j0 = y0.long(), x0.long()
            v = (f[:, i0, j0] * (1 - fy) * (1 - fx) + f[:, i0, j0 + 1] * (1 - fy) * fx
                 + f[:, i0 + 1, j0] * fy * (1 - fx) + f[:, i0 + 1, j0 + 1] * fy * fx)
            y = (y + step * v[0]).clamp(0, h - 1)
            x = (x + step * v[1]).clamp(0, w - 1)
        return torch.stack([y, x], dim=-1).reshape(h, w, 2)


def group(final: np.ndarray, mask: np.ndarray, min_sink: int = 3, min_area: int = 15,
          snap_radius: int = 3) -> np.ndarray:
    """(H, W) int32 instance map of the final positions (step 6)."""
    h, w = mask.shape
    fy = np.clip(np.rint(final[..., 0]).astype(np.int64), 0, h - 1)
    fx = np.clip(np.rint(final[..., 1]).astype(np.int64), 0, w - 1)
    counts = np.bincount((fy * w + fx)[mask], minlength=h * w).reshape(h, w)
    sinks = counts >= min_sink
    if not sinks.any():
        return np.zeros((h, w), np.int32)
    clusters, _ = ndimage.label(ndimage.binary_dilation(sinks, structure=np.ones((3, 3), bool)))
    lab = np.zeros((h, w), np.int64)
    lab[mask] = clusters[fy[mask], fx[mask]]
    for _ in range(int(snap_radius)):
        stray = mask & (lab == 0)
        if not stray.any():
            break
        clusters = ndimage.maximum_filter(clusters, size=3, mode="constant", cval=0)
        lab[stray] = clusters[fy[stray], fx[stray]]
    sizes = np.bincount(lab.ravel())
    small = np.nonzero(sizes < min_area)[0]
    lab[np.isin(lab, small[small > 0])] = 0
    ids = np.unique(lab[lab > 0])
    remap = np.zeros(int(lab.max()) + 1, np.int32)
    remap[ids] = np.arange(1, ids.size + 1, dtype=np.int32)
    return remap[lab]


def instances(net: cpnet_ref.CPnet, item: np.ndarray, params: Dict, device,
              fp8: bool = False) -> np.ndarray:
    """The reference's (H, W) instance map of one stored frame under a
    ``segment_flows`` job's params (``n_iter``, ``step_size``,
    ``cellprob_threshold``, ``min_sink``, ``min_area``, ``snap_radius``
    with the job's defaults)."""
    flow, prob = heads(net, item, params, device, fp8=fp8)
    mask = prob > float(params.get("cellprob_threshold", 0.5))
    final = euler(flow, mask, int(params.get("n_iter", 200)), float(params.get("step_size", 1.0)))
    return group(final.cpu().numpy(), mask.cpu().numpy(), int(params.get("min_sink", 3)),
                 int(params.get("min_area", 15)), int(params.get("snap_radius", 3)))


def match(a: np.ndarray, b: np.ndarray, iou: float = 0.5) -> Tuple[int, int, int, np.ndarray]:
    """``(tp, n_a, n_b, partner)`` of two instance maps with ids 1..N:
    ``tp`` pairs of IoU >= ``iou`` in the assignment that maximises the
    summed IoU; ``partner[i]`` the id in ``b`` matched to id ``i`` of
    ``a`` (0: none; ``partner[0] == 0``)."""
    a, b = np.asarray(a, np.int64).ravel(), np.asarray(b, np.int64).ravel()
    n_a, n_b = int(a.max(initial=0)), int(b.max(initial=0))
    partner = np.zeros(n_a + 1, np.int64)
    if n_a == 0 or n_b == 0:
        return 0, n_a, n_b, partner
    inter = np.bincount(a * (n_b + 1) + b, minlength=(n_a + 1) * (n_b + 1))
    inter = inter.reshape(n_a + 1, n_b + 1)[1:, 1:]
    area_a = np.bincount(a, minlength=n_a + 1)[1:]
    area_b = np.bincount(b, minlength=n_b + 1)[1:]
    ious = inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1)
    rows, cols = linear_sum_assignment(-ious)
    good = ious[rows, cols] >= iou
    partner[rows[good] + 1] = cols[good] + 1
    return int(good.sum()), n_a, n_b, partner

