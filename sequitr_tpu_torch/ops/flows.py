"""Flow-field instance segmentation (Cellpose-style): port of
``sequitr_tpu.ops.flows``.

* **Training targets** (host numpy, record-build time, copied): for every
  instance, heat diffuses from the instance's medoid and the normalized
  gradient of its log gives a unit vector pointing along a within-mask path
  toward the cell center; vectors on the two sides of a cell-cell boundary
  point in opposite directions.
* **The network** is the U-Net with a ``dims + 1``-channel regression head:
  the flow components (dy, dx[, dz]) scaled by ``FLOW_SCALE`` and a
  cell-probability logit.
* **Serving** integrates the predicted flow on the device: every foreground
  pixel follows the field for a fixed number of Euler steps
  (``follow_flows``), or by pointer doubling on the rounded successor map
  (``follow_flows_doubling``), and a host pass groups the converged
  positions into instances (``group_sinks``, copied).

The integrators run on the field's device (the card unless the caller
passes a CPU tensor or ``device="cpu"``), with no host sync. On the card the
Euler integrator is one launch of a hand-written kernel
(``ops/kernels/flows.py``, ``csrc/flows.cu``) that steps the foreground
alone, each position in registers; on the CPU it is the plain version,
``follow_flows_reference``: torch steps over every pixel that repeat the JAX
package's operations in its order (the same clamps, the bilinear
(trilinear) weights formed as products in corner order and summed in corner
order), with the corner neighbourhood of every pixel packed once into one
``2^nd * nd``-wide row, so a step is one flat gather plus the combine. The
two give bit-equal positions for every finite field. Dimension-generic:
(H, W, 2) frames and (Z, H, W, 3) volumes.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from sequitr_tpu_torch import localize as loc_lib
from sequitr_tpu_torch.ops.kernels import flows as flow_kernels
from sequitr_tpu_torch.utils import resolve_device

__all__ = [
    "FLOW_SCALE",
    "flow_targets",
    "follow_flows",
    "follow_flows_doubling",
    "follow_flows_reference",
    "group_sinks",
    "masks_from_flows",
    "match_instances",
    "average_precision",
]

# Network flow channels are trained against FLOW_SCALE * unit-flow (the
# Cellpose loss balance: unit vectors would be dominated by the prob BCE
# term); serving divides the prediction back down before integrating.
FLOW_SCALE = 5.0


# ---------------------------------------------------------------------------
# training targets (host, record-build time)
# ---------------------------------------------------------------------------


def _instance_stats(
    labels: np.ndarray, ids: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-instance (medoids, bbox extents) in one sorted-coords pass.

    Medoid = the mask pixel closest to the centroid — the diffusion
    source must lie INSIDE the mask (a plain centroid can fall outside a
    concave cell, where the heat never enters the mask). Extent = the
    instance's largest bounding-box span over the axes, measured from
    the instance's OWN pixels (a max-projection shortcut shadows any
    instance overlapped by a higher id along the projected axes and
    under-measures it — round-4 code-review finding). Returns
    ((n_ids, nd) int coords, (n_ids,) int extents), row-aligned with
    ``ids``.
    """
    nd = labels.ndim
    coords = np.indices(labels.shape).reshape(nd, -1).T  # (P, nd)
    flat = labels.ravel()
    meds = np.zeros((len(ids), nd), dtype=np.int64)
    extents = np.zeros(len(ids), dtype=np.int64)
    order = np.argsort(flat, kind="stable")
    sorted_lab = flat[order]
    starts = np.searchsorted(sorted_lab, ids, side="left")
    ends = np.searchsorted(sorted_lab, ids, side="right")
    for row, (s, e) in enumerate(zip(starts, ends)):
        pix = coords[order[s:e]]  # (n_i, nd)
        centroid = pix.mean(axis=0)
        meds[row] = pix[np.argmin(((pix - centroid) ** 2).sum(axis=1))]
        extents[row] = int((pix.max(axis=0) - pix.min(axis=0) + 1).max())
    return meds, extents


def _neighbor_offsets(nd: int) -> np.ndarray:
    """All 3^nd - 1 neighbor offsets (the diffusion stencil)."""
    grids = np.meshgrid(*([np.array([-1, 0, 1])] * nd), indexing="ij")
    offs = np.stack([g.ravel() for g in grids], axis=1)
    return offs[np.any(offs != 0, axis=1)]


def _shift(a: np.ndarray, off: Sequence[int], fill) -> np.ndarray:
    """``a`` translated by ``off`` with constant fill (np.roll without the
    wrap-around — a wrapped diffusion would leak heat across the frame)."""
    out = np.full_like(a, fill)
    src = []
    dst = []
    for o, n in zip(off, a.shape):
        if o >= 0:
            src.append(slice(0, n - o))
            dst.append(slice(o, n))
        else:
            src.append(slice(-o, n))
            dst.append(slice(0, n + o))
    out[tuple(dst)] = a[tuple(src)]
    return out


def flow_targets(
    labels: np.ndarray,
    n_iter: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Instance label map -> (flows, prob) training targets.

    ``labels``: (H, W) or (Z, H, W) integer instance map, 0 = background
    (every distinct positive value is one instance). Returns
    ``flows`` (*spatial, nd) float32 — unit vectors pointing up the
    diffusion gradient (toward the instance medoid), zero outside
    instances and (axis order matches the array axes: dy before dx) —
    and ``prob`` (*spatial) float32 in {0, 1}.

    Diffusion: heat is injected at each instance medoid every step and
    averaged over the 3^nd-neighborhood *restricted to same-instance
    pixels* each step, so heat flows around concavities rather than
    across walls; ``n_iter`` defaults to twice the largest instance's
    bounding-box extent (enough steps for heat to reach the farthest
    pixel of the largest cell, cf. Stringer et al. 2021).
    """
    labels = np.asarray(labels)
    nd = labels.ndim
    if nd not in (2, 3):
        raise ValueError(f"labels must be 2D or 3D, got {labels.shape}")
    inside = labels > 0
    prob = inside.astype(np.float32)
    flows = np.zeros(labels.shape + (nd,), dtype=np.float32)
    ids = np.unique(labels[inside])
    if ids.size == 0:
        return flows, prob

    meds, extents = _instance_stats(labels, ids)
    if n_iter is None:
        # heat must cross the largest cell; 2x its extent converges the
        # interior gradient direction (magnitude is normalized away)
        n_iter = max(16, 2 * int(extents.max()))
    source = np.zeros(labels.shape, dtype=np.float32)
    source[tuple(meds.T)] = 1.0

    offs = _neighbor_offsets(nd)
    # same-instance neighbor masks, one per stencil offset (computed once)
    neigh_ok = [
        inside & (_shift(labels, off, 0) == labels) for off in offs
    ]
    denom = np.ones(labels.shape, dtype=np.float32)  # self always counts
    for ok in neigh_ok:
        denom += ok
    T = np.zeros(labels.shape, dtype=np.float32)
    for _ in range(int(n_iter)):
        T += source
        acc = T.copy()  # self contribution
        for off, ok in zip(offs, neigh_ok):
            acc += np.where(ok, _shift(T, off, 0.0), 0.0)
        T = acc / denom
        T *= inside  # heat exists only inside instances
    # gradient of log-heat: log flattens the exponential decay so far-from-
    # center pixels still carry a well-conditioned direction
    logT = np.log(1e-20 + T)
    for ax in range(nd):
        up = [0] * nd
        up[ax] = 1
        dn = [0] * nd
        dn[ax] = -1
        ok_up = neigh_ok[_off_index(offs, up)]
        ok_dn = neigh_ok[_off_index(offs, dn)]
        v_up = np.where(ok_up, _shift(logT, up, 0.0), logT)
        v_dn = np.where(ok_dn, _shift(logT, dn, 0.0), logT)
        # note _shift(x, +1) brings the PREVIOUS pixel forward: value at
        # p becomes x[p - 1]; so the forward-neighbor value is _shift(-1)
        flows[..., ax] = np.where(inside, v_dn - v_up, 0.0) / 2.0
    mag = np.sqrt((flows**2).sum(axis=-1))
    flows /= np.maximum(mag, 1e-20)[..., None]
    flows *= inside[..., None]
    return flows.astype(np.float32), prob


def _off_index(offs: np.ndarray, off: Sequence[int]) -> int:
    idx = np.nonzero((offs == np.asarray(off)).all(axis=1))[0]
    return int(idx[0])


# ---------------------------------------------------------------------------
# serving: follow the flow field on the device
# ---------------------------------------------------------------------------


def _inputs(flow, mask, device) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``flow`` as f32 on its device (a tensor) or on ``device`` (numpy),
    its rank checked, and ``mask`` (if any) as a tensor on the same device."""
    if isinstance(flow, torch.Tensor):
        flow = flow.to(torch.float32)
    else:
        flow = torch.as_tensor(np.asarray(flow, np.float32), device=resolve_device(device))
    nd = flow.shape[-1]
    if flow.ndim - 1 != nd:
        raise ValueError(
            f"flow rank mismatch: {tuple(flow.shape)} carries {nd} components "
            f"over {flow.ndim - 1} spatial axes"
        )
    if mask is not None:
        mask = torch.as_tensor(mask, device=flow.device)
    return flow, mask


def _field(flow, mask, device) -> Tuple[torch.Tensor, Tuple[int, ...], int]:
    """``_inputs``'s field, masked, with its spatial shape and component
    count."""
    flow, mask = _inputs(flow, mask, device)
    if mask is not None:
        flow = flow * mask.to(torch.float32)[..., None]
    return flow, tuple(flow.shape[:-1]), flow.shape[-1]


def _grid(spatial: Tuple[int, ...], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every pixel's own coordinate, (prod(spatial), nd) f32, and the last
    coordinate of each axis, (nd,) f32; both made on ``device`` (a copy of
    host values would wait for the card's queue)."""
    grids = torch.meshgrid(
        *[torch.arange(s, dtype=torch.float32, device=device) for s in spatial], indexing="ij"
    )
    lim = torch.stack([torch.full((), s - 1.0, device=device) for s in spatial])
    return torch.stack(grids, dim=-1).reshape(-1, len(spatial)), lim


def _shift_axis_next(x: torch.Tensor, ax: int) -> torch.Tensor:
    """Value at p becomes x[p+1] along ``ax``, edge-clamped."""
    n = x.shape[ax]
    return torch.cat([x.narrow(ax, 1, n - 1), x.narrow(ax, n - 1, 1)], dim=ax)


def _pack_corners(field: torch.Tensor) -> torch.Tensor:
    """(*spatial, C) -> flat (prod(spatial), 2^nd * C), every pixel's
    multilinear corner neighbourhood packed into its row (corner order
    ``itertools.product((0, 1), repeat=nd)``). Done once per integration."""
    nd = field.ndim - 1
    corners = []
    for corner in itertools.product((0, 1), repeat=nd):
        v = field
        for ax, o in enumerate(corner):
            if o:
                v = _shift_axis_next(v, ax)
        corners.append(v)
    packed = torch.cat(corners, dim=-1)
    return packed.reshape(-1, packed.shape[-1])


def _corner_weights(frac) -> torch.Tensor:
    """(P, 2^nd, 1) multilinear weights in corner order: each the product of
    the axes' ``1 - f`` or ``f`` taken in axis order, as the JAX package
    forms them (its leading ``f * 0 + 1`` factor is exactly 1)."""
    ws = [torch.stack([1.0 - f, f], dim=1) for f in frac]  # (P, 2) an axis
    w = ws[0]
    for wa in ws[1:]:
        w = (w[:, :, None] * wa[:, None, :]).reshape(w.shape[0], -1)
    return w[..., None]


def _sample_packed(
    packed: torch.Tensor, spatial, c: int, p: torch.Tensor, cols: torch.Tensor
) -> torch.Tensor:
    """Multilinear sample of the packed field at points ``p`` (P, nd): ONE
    gather of the 2^nd*C-wide rows, then the weighted corners summed in
    corner order. Clamps as the JAX package's: ``x`` to [0, n-1], its base
    to [0, n-2]. ``cols``: ``arange(2^nd * C)`` on the field's device."""
    nd = len(spatial)
    base, frac = [], []
    for ax in range(nd):
        n = spatial[ax]
        x = p[:, ax].clamp(0.0, n - 1.0)
        x0 = torch.floor(x).clamp(0, max(n - 2, 0))
        base.append(x0.to(torch.long))
        frac.append(x - x0)
    flat_idx = base[0]
    for ax in range(1, nd):
        flat_idx = flat_idx * spatial[ax] + base[ax]
    # one element gather of the rows' words: index_select (and indexing, and
    # torch.gather) serve narrow rows with a kernel built for wide ones, 6x
    # slower on an H100
    words = flat_idx[:, None] * packed.shape[1] + cols
    g = torch.take(packed, words).reshape(p.shape[0], 2**nd, c)
    gw = g * _corner_weights(frac)
    out = gw[:, 0]
    for ci in range(1, 2**nd):
        out = out + gw[:, ci]
    return out


def follow_flows(
    flow,
    mask=None,
    n_iter: int = 200,
    step: float = 1.0,
    device: Union[str, torch.device, None] = None,
) -> torch.Tensor:
    """Integrate the flow field: every pixel follows its flow to a sink.

    ``flow``: (*spatial, nd) unit-flow field, (H, W, 2) or (Z, H, W, 3),
    axis order matching the array axes; a tensor stays on its device, a
    numpy array goes to ``device`` (default the card). ``mask``: optional
    (*spatial) bool; background pixels see zero flow and stay put. Returns
    (*spatial, nd) f32 final positions on the field's device.

    ``n_iter`` Euler steps ``p = clip(p + step * sample(p), 0, n - 1)``. A
    CUDA field launches the Euler kernel once (``flow_kernels.euler``, which
    counts its launches) or raises; a CPU field runs
    ``follow_flows_reference``. The positions never leave the device.
    """
    flow, mask = _inputs(flow, mask, device)
    if flow.device.type == "cpu":
        return follow_flows_reference(flow, mask, n_iter=n_iter, step=step)
    flow = flow.contiguous()
    if flow.data_ptr() % 8:  # a view that starts mid-pair: the kernel loads pairs
        flow = flow.clone()
    if mask is not None:
        mask = mask.to(torch.bool).contiguous()
    return flow_kernels.euler(flow, mask, int(n_iter), float(step))


def follow_flows_reference(
    flow,
    mask=None,
    n_iter: int = 200,
    step: float = 1.0,
    device: Union[str, torch.device, None] = None,
) -> torch.Tensor:
    """The plain version of ``follow_flows``, on any device: every pixel
    takes ``n_iter`` eager steps, each one flat gather of the corner rows
    packed once up front plus the combine, about 28 launches a step on the
    card."""
    flow, spatial, nd = _field(flow, mask, device)
    p, lim = _grid(spatial, flow.device)
    packed = _pack_corners(flow)
    cols = torch.arange(packed.shape[1], device=flow.device)
    for _ in range(int(n_iter)):
        v = _sample_packed(packed, spatial, nd, p, cols)
        p = torch.minimum((p + step * v).clamp_min(0.0), lim)
    return p.reshape(spatial + (nd,))


def follow_flows_doubling(
    flow,
    mask=None,
    n_iter: int = 256,
    step: float = 1.0,
    device: Union[str, torch.device, None] = None,
) -> torch.Tensor:
    """Integrate the flow field by pointer doubling on the integer successor
    map: ``ceil(log2(n_iter))`` flat gathers in place of ``n_iter`` steps.

    Each pixel's successor is its Euler step rounded to the lattice,
    ``S[p] = clip(round(p + step * flow[p]))`` (half to even, as
    ``jnp.round``); composing ``S`` with itself doubles the steps taken, so
    ``n_iter`` rounds up to a power of two (200 runs as 256). Returns
    (*spatial, nd) f32 positions on the field's device, integer-valued.
    """
    flow, spatial, nd = _field(flow, mask, device)
    p0, lim = _grid(spatial, flow.device)
    succ = torch.minimum(torch.round(p0 + step * flow.reshape(-1, nd)).clamp_min(0.0), lim)
    succ = succ.to(torch.long)
    flat = succ[:, 0]
    for ax in range(1, nd):
        flat = flat * spatial[ax] + succ[:, ax]
    n_compose = max(1, int(np.ceil(np.log2(max(2, n_iter)))))
    for _ in range(n_compose):
        flat = flat.index_select(0, flat)
    coords = []
    for s in reversed(spatial):
        coords.append(flat % s)
        flat = torch.div(flat, s, rounding_mode="floor")
    final = torch.stack(coords[::-1], dim=-1).to(torch.float32)
    return final.reshape(spatial + (nd,))


# ---------------------------------------------------------------------------
# serving: host-side grouping of converged sinks
# ---------------------------------------------------------------------------


def _binary_dilate(a: np.ndarray, iters: int = 1) -> np.ndarray:
    """3^nd binary dilation via shifted ORs (no scipy needed on this path)."""
    out = a.copy()
    for _ in range(iters):
        acc = out.copy()
        for off in _neighbor_offsets(a.ndim):
            acc |= _shift(out, off, False)
        out = acc
    return out


def group_sinks(
    final: np.ndarray,
    mask: np.ndarray,
    min_sink: int = 3,
    min_area: int = 15,
    snap_radius: int = 3,
) -> np.ndarray:
    """Converged positions -> instance label map (host, irregular work).

    ``final``: (*spatial, nd) positions from ``follow_flows`` (2D frames
    or 3D volumes); ``mask``: (*spatial) bool foreground. Pixels of one
    cell converge onto a compact cluster of bins around its medoid: bins
    holding >= ``min_sink`` arrivals are sink bins, adjacent sink bins
    merge into one sink cluster (CCL after a 1-px 3^nd dilation bridges
    near-medoid splits), and every foreground pixel takes the label of
    the cluster its final position landed in. Stragglers whose final bin
    is not a cluster (flow noise at cell boundaries) snap to the nearest
    cluster within ``snap_radius`` via label dilation; instances smaller
    than ``min_area`` (pixels in 2D, voxels in 3D) are dropped; labels
    are renumbered 1..N.
    """
    mask = np.asarray(mask, bool)
    nd = mask.ndim
    fidx = tuple(
        np.clip(np.rint(final[..., ax]).astype(np.int64), 0, s - 1)
        for ax, s in enumerate(mask.shape)
    )
    land = tuple(f[mask] for f in fidx)
    counts = np.zeros(mask.shape, dtype=np.int32)
    np.add.at(counts, land, 1)
    sinks = counts >= int(min_sink)
    if not sinks.any():
        return np.zeros(mask.shape, dtype=np.int32)
    clusters = loc_lib.label_components(_binary_dilate(sinks, 1))
    # assign: each fg pixel reads the cluster at its landing bin
    lab = np.zeros(mask.shape, dtype=np.int32)
    lab[mask] = clusters[land]
    # stragglers: landing bin belongs to no cluster -> nearest cluster
    # within snap_radius (max-filter label dilation, ties arbitrary)
    for _ in range(int(snap_radius)):
        un = mask & (lab == 0)
        if not un.any():
            break
        dil = clusters.copy()
        for off in _neighbor_offsets(nd):
            dil = np.maximum(dil, _shift(clusters, off, 0))
        lab[un] = dil[tuple(f[un] for f in fidx)]
        clusters = dil
    if min_area > 1:
        sizes = np.bincount(lab.ravel())
        kill = np.nonzero(sizes < int(min_area))[0]
        if kill.size:
            lab[np.isin(lab, kill[kill > 0])] = 0
    # renumber 1..N (stable in first-appearance order)
    ids = np.unique(lab[lab > 0])
    if ids.size:
        remap = np.zeros(int(lab.max()) + 1, dtype=np.int32)
        remap[ids] = np.arange(1, ids.size + 1, dtype=np.int32)
        lab = remap[lab]
    return lab


def masks_from_flows(
    flow: np.ndarray,
    prob: np.ndarray,
    cellprob_threshold: float = 0.5,
    n_iter: int = 200,
    step: float = 1.0,
    min_sink: int = 3,
    min_area: int = 15,
    final: Optional[np.ndarray] = None,
    device: Union[str, torch.device, None] = None,
) -> np.ndarray:
    """(flow, prob) maps -> instance label map (2D frames or 3D volumes).

    ``flow`` (*spatial, nd) unit flows, ``prob`` (*spatial) cell
    probability in [0, 1] (post-sigmoid). ``final`` skips the integration
    when the serving pass already followed the flows; otherwise
    ``follow_flows`` runs on ``device`` (default the card).
    """
    mask = np.asarray(prob) > float(cellprob_threshold)
    if final is None:
        final = follow_flows(flow, mask, n_iter=n_iter, step=step, device=device).cpu().numpy()
    return group_sinks(
        np.asarray(final), mask, min_sink=min_sink, min_area=min_area
    )


# ---------------------------------------------------------------------------
# evaluation: instance matching (AP / matched IoU)
# ---------------------------------------------------------------------------


def match_instances(
    gt: np.ndarray, pred: np.ndarray
) -> Tuple[np.ndarray, int, int]:
    """Optimal one-to-one IoU matching of two instance label maps.

    Returns (ious, n_gt, n_pred): ``ious`` is the per-matched-pair IoU
    vector under a Hungarian assignment maximizing total IoU (zeros
    padded for unmatched GT are NOT included — use n_gt/n_pred for the
    precision/recall denominators).
    """
    from scipy.optimize import linear_sum_assignment

    gt = np.asarray(gt).ravel()
    pred = np.asarray(pred).ravel()
    n_gt = int(gt.max())
    n_pred = int(pred.max())
    if n_gt == 0 or n_pred == 0:
        return np.zeros(0, dtype=np.float64), n_gt, n_pred
    # sparse intersection histogram over (gt, pred) id pairs
    both = (gt > 0) & (pred > 0)
    pair = gt[both].astype(np.int64) * (n_pred + 1) + pred[both]
    inter = np.bincount(pair, minlength=(n_gt + 1) * (n_pred + 1)).reshape(
        n_gt + 1, n_pred + 1
    )[1:, 1:]
    area_gt = np.bincount(gt, minlength=n_gt + 1)[1:]
    area_pr = np.bincount(pred, minlength=n_pred + 1)[1:]
    union = area_gt[:, None] + area_pr[None, :] - inter
    iou = inter / np.maximum(union, 1)
    rows, cols = linear_sum_assignment(-iou)
    matched = iou[rows, cols]
    return matched[matched > 0], n_gt, n_pred


def average_precision(
    gt: np.ndarray,
    pred: np.ndarray,
    thresholds: Sequence[float] = (0.5, 0.75, 0.9),
) -> dict:
    """Cell-counting AP and matched-IoU summary at the given thresholds.

    AP@t = TP / (TP + FP + FN) with TP = matched pairs of IoU >= t (the
    standard cell-segmentation AP, e.g. the Cellpose/StarDist papers).
    Also reports ``mean_matched_iou`` (over IoU>=0.5 matches) and the
    raw instance counts.
    """
    ious, n_gt, n_pred = match_instances(gt, pred)
    out = {"n_gt": n_gt, "n_pred": n_pred}
    for t in thresholds:
        tp = int((ious >= t).sum())
        denom = n_gt + n_pred - tp
        out[f"ap{int(round(t * 100))}"] = tp / denom if denom else 1.0
    good = ious[ious >= 0.5]
    out["mean_matched_iou"] = float(good.mean()) if good.size else 0.0
    return out
