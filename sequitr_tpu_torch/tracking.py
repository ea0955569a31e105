"""Built-in object linking: tracks (and lineages) from objects.h5.

A copy of ``sequitr_tpu.tracking`` (host numpy and scipy; the port imports
nothing of the JAX package).

The reference delegates tracking to btrack (its Bayesian cell tracker);
the segmentation outputs here stay btrack-compatible (``objects.h5``) and
that remains the supported path for publication-grade lineage tracking.
This module adds what the reference never had: a BUILT-IN linker good
enough for QC, motility statistics and emitter trajectories without
leaving the framework. Two motion models share one assignment core
(globally-optimal per-frame-pair Hungarian matching with short-gap
closing):

* ``nearest`` — gated Euclidean costs, no state. Exact and cheap, but
  crossing paths can swap identities (a motion-model-free linker has no
  basis to prefer either).
* ``kalman`` — a constant-velocity Kalman filter per track (batched
  numpy over all active tracks; this is irregular host-side work per
  SURVEY.md §3.5, not a device graph). Costs are innovation Mahalanobis
  distances gated at ``gate_sigma``, so a track's own motion history
  disambiguates crossings and carries prediction through detection gaps.

``divisions=True`` additionally resolves binary fission: a track that
either vanishes next to two newborn detections, or continues next to one,
becomes a retired parent of two fresh child tracks (``parent_id`` /
``root_id`` / ``generation`` lineage fields; Cell-Tracking-Challenge LBEP
export). A deliberate heuristic — btrack remains the Bayesian,
hypothesis-scored path — but with ``mitotic_class`` gating (sequitr's
interphase/mitotic class maps, SURVEY.md §2 UNet2D) it recovers clean
lineages from the classifier the serve already ran.

Exposed through the job API as the ``track_objects`` pipeline (consumes a
serve's ``objects.h5``, emits ``tracks.csv`` + ``lbep.txt``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from sequitr_tpu_torch.localize import FrameTable

__all__ = ["Track", "link_tables", "reindex_lineage", "write_tracks_csv",
           "write_track_summaries_csv", "write_lbep"]

_BIG = 1e12  # over-gate sentinel fed to the assignment solver


@dataclasses.dataclass
class Track:
    """Summary of one linked trajectory (lineage fields -1/0 for roots)."""

    track_id: int
    t_start: int
    t_end: int  # inclusive
    n_points: int
    length_px: float  # summed step length
    net_displacement_px: float  # |last - first|
    parent_id: int = -1  # -1 = root (no division parent)
    root_id: int = -1  # founding ancestor (own id for roots)
    generation: int = 0  # divisions since the root

    @property
    def duration(self) -> int:
        return self.t_end - self.t_start + 1

    @property
    def n_links(self) -> int:
        return max(self.n_points - 1, 0)

    @property
    def mean_speed(self) -> float:
        return self.length_px / max(self.duration - 1, 1)

    @property
    def straightness(self) -> float:
        return (
            self.net_displacement_px / self.length_px
            if self.length_px > 0 else 0.0
        )


class _Rec:
    """Mutable per-track state for the linker's whole-life bookkeeping.

    One record per track (no per-frame dataclass churn — FrameTable's own
    rationale). ``x``/``P`` are the Kalman state (None under ``nearest``).
    """

    __slots__ = ("first", "last", "t0", "last_t", "n", "length",
                 "parent", "root", "gen", "cls", "x", "P")

    def __init__(self, p, t, cls, parent=-1, root=-1, gen=0):
        self.first = p
        self.last = p
        self.t0 = t
        self.last_t = t
        self.n = 1
        self.length = 0.0
        self.parent = parent
        self.root = root
        self.gen = gen
        self.cls = cls
        self.x = None
        self.P = None


def _kf_matrices(q: float, r: float):
    """Constant-velocity model matrices at dt=1 (state [pos3, vel3]).

    ``q`` is the white-acceleration std (px/frame^2) driving the discrete
    process noise; ``r`` the detection std (px). 2D data rides the same
    3D state with z identically 0 (contributes nothing to costs).
    """
    eye = np.eye(3)
    F = np.eye(6)
    F[:3, 3:] = eye
    Q = (q * q) * np.block([[eye / 4.0, eye / 2.0], [eye / 2.0, eye]])
    R = (r * r) * eye
    return F, Q, R


def _kf_init(p: np.ndarray, r: float, v0: float):
    x = np.zeros(6)
    x[:3] = p
    P = np.diag([r * r] * 3 + [v0 * v0] * 3).astype(np.float64)
    return x, P


def _assign(cost: np.ndarray, gate: float) -> List[Tuple[int, int]]:
    """Globally-optimal matching under a hard cost gate.

    Hungarian on the raw costs, then pairs beyond the gate are discarded:
    with a rectangular matrix scipy's implementation already leaves the
    surplus rows/cols unmatched, and dropping over-gate pairs afterwards
    is equivalent to a gated assignment for metric costs at these sizes.
    """
    from scipy.optimize import linear_sum_assignment

    # flatten every over-gate pairing to one large constant so the
    # optimizer never trades a valid pair away to improve an invalid one
    # (invalid pairs are interchangeable; they are dropped below anyway)
    capped = np.where(cost <= gate, cost, max(gate, 1.0) * 1e6)
    rows, cols = linear_sum_assignment(capped)
    return [(int(r), int(c)) for r, c in zip(rows, cols) if cost[r, c] <= gate]


def _resolve_divisions(
    records: List["_Rec"],
    active: Set[int],
    matched: Dict[int, int],
    newborn: List[int],
    pts: np.ndarray,
    div_gate: float,
    mitotic_class: Optional[int],
    kalman: bool,
) -> Tuple[Dict[int, int], Set[int]]:
    """Greedy binary-fission resolution for one frame.

    Candidate parents must hold >= 2 points (one-frame blips do not found
    lineages) and, when ``mitotic_class`` is set, have last linked a
    detection of that class. Two geometries:

    * vanished parent (active, unmatched this frame): its two nearest
      newborns both inside the division gate become the children;
    * matched parent: its matched detection becomes child one and the
      nearest newborn child two — and BOTH must sit within the division
      gate of the parent's prior fix (nearest) / prediction (kalman),
      the position where the cell actually divided. Without that anchor
      a single spurious detection near any healthy track would retire it
      into a fake lineage; even so this geometry fires on ONE unexplained
      detection, so on noisy data set ``mitotic_class`` (the strong
      second signal) or tighten ``division_distance``.

    Candidates resolve greedily by the FARTHER child's distance from the
    parent (both must fit); each newborn is consumed once and each parent
    divides at most once. A candidate whose staged children were consumed
    by a closer parent simply does not divide this frame (no re-matching
    pass — a documented simplification).

    Returns ``(child_of, divided)``: detection index -> parent tid for
    every staged child, and the parent tids that divided. The caller
    retires divided parents and births the children.
    """
    pool = set(newborn)
    cands = []
    for tid in sorted(active):
        rec = records[tid]
        if rec.n < 2:
            continue
        if mitotic_class is not None and rec.cls != mitotic_class:
            continue
        pos = rec.x[:3] if kalman else rec.last
        near = sorted(
            (float(np.linalg.norm(pts[c] - pos)), c)
            for c in sorted(pool)
        )
        near = [(d, c) for d, c in near if d <= div_gate]
        if tid in matched:
            d_m = float(np.linalg.norm(pts[matched[tid]] - pos))
            if d_m <= div_gate and near:
                cands.append((max(d_m, near[0][0]), tid, "m",
                              matched[tid], near[0][1]))
        elif len(near) >= 2:
            cands.append((near[1][0], tid, "v", near[0][1], near[1][1]))
    child_of: Dict[int, int] = {}
    divided: Set[int] = set()
    for _, tid, kind, c1, c2 in sorted(cands, key=lambda x: (x[0], x[1])):
        if tid in divided:
            continue
        if kind == "m":
            if c2 not in pool:
                continue
            pool.discard(c2)
        else:
            if c1 not in pool or c2 not in pool:
                continue
            pool.discard(c1)
            pool.discard(c2)
        child_of[c1] = tid
        child_of[c2] = tid
        divided.add(tid)
    return child_of, divided


def link_tables(
    tables: Sequence[FrameTable],
    max_distance: float = 20.0,
    max_gap: int = 0,
    *,
    motion_model: str = "nearest",
    gate_sigma: float = 4.0,
    process_noise: float = 1.0,
    measurement_noise: float = 1.0,
    init_velocity_noise: Optional[float] = None,
    divisions: bool = False,
    division_distance: Optional[float] = None,
    mitotic_class: Optional[int] = None,
) -> Tuple[List[np.ndarray], List[Track]]:
    """Link per-frame detections into tracks (optionally: lineages).

    ``tables``: per-frame ``FrameTable``s in t order (e.g. from
    ``localize.read_objects_h5``). ``max_distance``: hard gate (pixels)
    on a frame-to-frame step (under ``kalman`` it caps the Euclidean
    step on TOP of the Mahalanobis gate — a sanity bound while the
    velocity estimate is still wide). ``max_gap``: how many consecutive
    frames a track may miss a detection and still be continued (0 =
    strict consecutive linking; under ``kalman`` the prediction keeps
    extrapolating through the gap).

    ``motion_model="kalman"``: per-track constant-velocity Kalman filter;
    assignment costs are innovation Mahalanobis distances gated at
    ``gate_sigma``. ``process_noise`` (accel std, px/frame^2) sets how
    fast velocity may drift; ``measurement_noise`` (px) the detection
    noise; ``init_velocity_noise`` the velocity prior std of a newborn
    track (default ``max_distance / 2`` — wide enough that a track's
    second detection anywhere inside the Euclidean gate is acceptable).

    ``divisions=True``: binary-fission resolution each frame (see
    ``_resolve_divisions`` for the exact geometry/greedy rules). A parent
    retires at its previous frame (Cell-Tracking-Challenge semantics: a
    parent ends strictly before its children begin) and the children
    carry ``parent_id``/``root_id``/``generation``. ``division_distance``
    defaults to ``max_distance``. ``mitotic_class``: only tracks whose
    LAST linked detection carries this semantic class (coords[:, 4]) may
    divide — wire it to the classifier the serve already ran.

    Returns ``(track_ids, tracks)``: per-frame int32 arrays assigning a
    track id to every detection (aligned with each table's rows), and the
    per-track summaries. Detections that start a new trajectory get fresh
    ids; tracks are never merged.
    """
    if max_distance <= 0:
        raise ValueError(f"max_distance must be positive, got {max_distance}")
    if max_gap < 0:
        raise ValueError(f"max_gap must be >= 0, got {max_gap}")
    if motion_model not in ("nearest", "kalman"):
        raise ValueError(
            f"motion_model must be 'nearest' or 'kalman', got {motion_model!r}"
        )
    kalman = motion_model == "kalman"
    if kalman:
        if gate_sigma <= 0:
            raise ValueError(f"gate_sigma must be positive, got {gate_sigma}")
        if process_noise <= 0 or measurement_noise <= 0:
            raise ValueError(
                "process_noise and measurement_noise must be positive, got "
                f"{process_noise}, {measurement_noise}"
            )
        v0 = (
            max_distance / 2.0
            if init_velocity_noise is None else float(init_velocity_noise)
        )
        if v0 <= 0:
            raise ValueError(f"init_velocity_noise must be positive, got {v0}")
        F, Q, R = _kf_matrices(process_noise, measurement_noise)
    div_gate = (
        max_distance if division_distance is None else float(division_distance)
    )
    if divisions and div_gate <= 0:
        raise ValueError(f"division_distance must be positive, got {div_gate}")

    track_ids: List[np.ndarray] = []
    records: List[_Rec] = []
    active: Set[int] = set()  # ids still eligible for matching

    def _born(p, t, cls, parent=-1):
        tid = len(records)
        if parent >= 0:
            par = records[parent]
            rec = _Rec(p, t, cls, parent=parent, root=par.root,
                       gen=par.gen + 1)
        else:
            rec = _Rec(p, t, cls, root=tid)
        if kalman:
            rec.x, rec.P = _kf_init(p, measurement_noise, v0)
        records.append(rec)
        active.add(tid)
        return tid

    for t, tb in enumerate(tables):
        n = len(tb)
        ids = np.full(n, -1, np.int32)
        pts = tb.coords[:, 1:4].astype(np.float64) if n else np.zeros((0, 3))
        cls_col = tb.coords[:, 4].astype(np.int64) if n else np.zeros(0, int)
        # retire tracks whose gap budget is spent
        active = {k for k in active if t - records[k].last_t <= max_gap + 1}
        act_ids = sorted(active)
        if kalman and act_ids:
            # one predict step per frame for EVERY active track — a track
            # unseen for g frames has extrapolated g+1 steps by the time
            # it competes for a match (gap closing with motion)
            xs = np.stack([records[k].x for k in act_ids])
            Ps = np.stack([records[k].P for k in act_ids])
            xs = xs @ F.T
            Ps = F @ Ps @ F.swapaxes(-1, -2) + Q
            for i, k in enumerate(act_ids):
                records[k].x, records[k].P = xs[i], Ps[i]
        pairs: List[Tuple[int, int]] = []
        if n and act_ids:
            if kalman:
                pred = xs[:, :3]
                y = pts[None, :, :] - pred[:, None, :]  # (n_trk, n_det, 3)
                Sinv = np.linalg.inv(Ps[:, :3, :3] + R)
                m2 = np.einsum("nmi,nij,nmj->nm", y, Sinv, y)
                cost = np.sqrt(np.maximum(m2, 0.0))
                eucl = np.linalg.norm(y, axis=-1)
                cost = np.where(eucl <= max_distance, cost, _BIG)
                gate = gate_sigma
            else:
                act_pts = np.stack([records[k].last for k in act_ids])
                cost = np.linalg.norm(
                    act_pts[:, None, :] - pts[None, :, :], axis=-1
                )
                gate = max_distance
            pairs = _assign(cost, gate)

        matched = {act_ids[r]: c for r, c in pairs}  # tid -> det index
        taken = set(matched.values())
        newborn = [c for c in range(n) if c not in taken]

        child_of: Dict[int, int] = {}
        if divisions and newborn:
            child_of, divided = _resolve_divisions(
                records, active, matched, newborn, pts,
                div_gate, mitotic_class, kalman,
            )
            for tid in divided:
                # a divided parent is done: its match (if any) becomes a
                # child instead, and it never competes again
                matched.pop(tid, None)
                active.discard(tid)

        # commit surviving matches
        for tid, c in matched.items():
            rec = records[tid]
            step = float(np.linalg.norm(pts[c] - rec.last))
            rec.length += step
            rec.last = pts[c]
            rec.last_t = t
            rec.n += 1
            rec.cls = int(cls_col[c])
            ids[c] = tid
            if kalman:
                yv = pts[c] - rec.x[:3]
                S = rec.P[:3, :3] + R
                K = rec.P[:, :3] @ np.linalg.inv(S)
                rec.x = rec.x + K @ yv
                rec.P = rec.P - K @ rec.P[:3, :]

        # division children + leftover newborns (fresh root tracks)
        for c in range(n):
            if ids[c] < 0:
                ids[c] = _born(
                    pts[c], t, int(cls_col[c]), parent=child_of.get(c, -1)
                )
        track_ids.append(ids)

    tracks = [
        Track(
            track_id=i,
            t_start=r.t0,
            t_end=r.last_t,
            n_points=r.n,
            length_px=round(r.length, 3),
            net_displacement_px=round(
                float(np.linalg.norm(r.last - r.first)), 3
            ),
            parent_id=r.parent,
            root_id=r.root,
            generation=r.gen,
        )
        for i, r in enumerate(records)
    ]
    return track_ids, tracks


def reindex_lineage(
    tracks: Sequence[Track],
) -> Tuple[List[Track], Dict[int, int]]:
    """Compactly relabel a FILTERED track list into a self-consistent
    forest.

    After dropping tracks (e.g. ``min_track_length``), surviving children
    may reference absent parents/roots and ids become non-contiguous —
    which breaks the CTC convention (lbep labels pair 1:1 and
    consecutively) and leaves dangling lineage references. This relabels
    ids to 0..n-1 (ascending original order, so parents stay below
    children), clears parent references to dropped tracks and recomputes
    ``root_id``/``generation`` relative to the surviving forest: an
    orphaned child becomes a generation-0 root of its remaining subtree.

    Returns ``(new_tracks, remap)`` with ``remap`` = old id -> new id
    (apply it to per-frame ``track_ids`` arrays to keep the CSVs
    aligned).
    """
    ordered = sorted(tracks, key=lambda t: t.track_id)
    remap = {t.track_id: i for i, t in enumerate(ordered)}
    out: List[Track] = []
    root_of: Dict[int, int] = {}
    gen_of: Dict[int, int] = {}
    for t in ordered:
        nid = remap[t.track_id]
        # children are born later than their parents, so ascending order
        # is topological and the parent (if kept) is already resolved
        if t.parent_id in remap:
            pid = remap[t.parent_id]
            root, gen = root_of[pid], gen_of[pid] + 1
        else:
            pid, root, gen = -1, nid, 0
        root_of[nid], gen_of[nid] = root, gen
        out.append(dataclasses.replace(
            t, track_id=nid, parent_id=pid, root_id=root, generation=gen
        ))
    return out, remap


def write_track_summaries_csv(path: str, tracks: Sequence[Track]) -> int:
    """One row per TRACK: the QC table (lifetime, path length, net
    displacement, mean speed, straightness) plus the lineage columns
    (parent_id -1 and generation 0 for undivided roots). Returns the
    track count. (Endpoints live on ``Track`` — no re-walk of the
    detections.)"""
    with open(path, "w") as f:
        f.write(
            "track_id,t_start,t_end,n_points,length_px,"
            "net_displacement_px,mean_speed_px_per_frame,straightness,"
            "parent_id,root_id,generation\n"
        )
        for tr in tracks:
            f.write(
                f"{tr.track_id},{tr.t_start},{tr.t_end},{tr.n_points},"
                f"{tr.length_px:.3f},{tr.net_displacement_px:.3f},"
                f"{tr.mean_speed:.3f},{tr.straightness:.3f},"
                f"{tr.parent_id},{tr.root_id},{tr.generation}\n"
            )
    return len(tracks)


def write_lbep(path: str, tracks: Sequence[Track]) -> int:
    """Cell-Tracking-Challenge lineage table: one ``L B E P`` row per
    track (label, begin frame, end frame, parent label). CTC labels are
    1-based with 0 = no parent, so ids are shifted by one relative to
    the CSVs (documented here and in the pipeline docstring). Returns
    the row count."""
    with open(path, "w") as f:
        for tr in tracks:
            f.write(
                f"{tr.track_id + 1} {tr.t_start} {tr.t_end} "
                f"{tr.parent_id + 1}\n"
            )
    return len(tracks)


def write_tracks_csv(
    path: str,
    tables: Sequence[FrameTable],
    track_ids: Sequence[np.ndarray],
) -> int:
    """Write linked detections as CSV (one row per detection, track-id
    first — trivially loadable by pandas/numpy/Fiji). Returns row count."""
    n = 0
    with open(path, "w") as f:
        f.write("track_id,t,x,y,z,label,area,intensity_mean\n")
        for tb, ids in zip(tables, track_ids):
            for i in range(len(tb)):
                c = tb.coords[i]
                f.write(
                    f"{int(ids[i])},{int(c[0])},{c[1]:.3f},{c[2]:.3f},"
                    f"{c[3]:.3f},{int(c[4])},{int(tb.area[i])},"
                    f"{tb.intensity_mean[i]:.4f}\n"
                )
                n += 1
    return n
