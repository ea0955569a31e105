"""Quantification pipelines: per-object measurement and tracking.

Port of ``sequitr_tpu.server.pipelines.quantify``: ``measure_objects``
(2D and ``dims: 3``), ``count_spots`` (2D and ``dims: 3``),
``measure_tracks``, ``track_objects`` and the shared object-derivation
helpers (CCL / watershed split / per-object stats) the interop pipelines
build on. The same job JSON writes the same files, CSV columns, metrics
keys and JobError texts as the JAX server.

Every job here is host numpy/scipy in the JAX package (irregular
per-object joins and reductions) and stays host code: the port's
``localize``, ``native`` (the single-sweep C++ stats), ``tracking`` and
``ops.colocalize`` are copies of the JAX package's host modules, so these
jobs write byte-identical CSVs on any server device.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np

from sequitr_tpu_torch import localize as loc_lib
from sequitr_tpu_torch import native, tracking
from sequitr_tpu_torch.config import ServerConfiguration
from sequitr_tpu_torch.data.source import FrameSource, VolumeSequence
from sequitr_tpu_torch.ops import colocalize as coloc_lib
from sequitr_tpu_torch.server import jobs as jobs_lib
from sequitr_tpu_torch.server.jobs import Job
from sequitr_tpu_torch.server.server import (
    _apply_frame_range,
    _parse_z_pages,
    _resolve_inputs,
    register,
)
from sequitr_tpu_torch.utils import PhaseTimer


def _frame_or_fail(job: Job, source, t: int, volume: bool = False):
    """Read frame/volume ``t`` from a quantification input; a corrupt
    page mid-stack is deterministic — fail fast instead of burning
    retries (the direct-read twin of ``_reads_fail_fast``)."""
    try:
        return np.asarray(source.volume(t) if volume else source.frame(t))
    except ValueError as e:
        raise jobs_lib.JobError(f"job {job.id}: corrupt input at t={t}: {e}")


def _instances_from_labels(lab: np.ndarray) -> np.ndarray:
    """Trust a label map's ids AS instance ids (``instances: true``):
    renumber densely to 1..n in ascending-id order, no CCL/watershed.

    The semantics for stacks produced by an INSTANCE segmenter
    (``segment_flows``): re-deriving connected components would merge
    the touching cells the segmenter just separated."""
    lab = np.ascontiguousarray(lab.astype(np.int32, copy=False))
    ids = np.unique(lab[lab > 0])
    if ids.size == 0:
        return np.zeros(lab.shape, np.int32)
    if int(ids[-1]) == ids.size:
        return lab  # already dense 1..n
    remap = np.zeros(int(ids[-1]) + 1, np.int32)
    remap[ids] = np.arange(1, ids.size + 1, dtype=np.int32)
    return remap[np.maximum(lab, 0)]


def _check_instances_params(instances: bool, split_touching: bool) -> None:
    if instances and split_touching:
        raise jobs_lib.JobError(
            "instances: true means the label stack already carries one id "
            "per object — split_touching would re-derive them; drop one"
        )


def _derive_objects(lab: np.ndarray, split_touching: bool,
                    min_distance: int, min_area: int,
                    instances: bool = False):
    """Shared object semantics for the quantification pipelines
    (measure_objects / count_spots): a label frame -> instance map +
    per-object stats + the min_area keep mask.

    Returns ``(inst, n, areas, classes, keep, cy, cx)`` — ``inst`` int32
    with ids 1..n, ``keep`` a bool mask over ids (index id-1), ``cy/cx``
    per-object centroids. A multi-channel label frame is a deterministic
    JobError. ``instances``: trust the label ids as instance ids
    (segment_flows stacks — CCL would re-merge touching cells); the
    class column is 1 for every object (instance maps carry no class).
    """

    if lab.ndim == 3:
        raise jobs_lib.JobError(
            f"labels entry must be single-channel (got {lab.shape})"
        )
    lab = lab.astype(np.int32, copy=False)
    if instances:
        inst = _instances_from_labels(lab)
        lab = (inst > 0).astype(np.int32)  # class 1 everywhere
    elif split_touching:
        inst = loc_lib.split_touching_instances(
            lab, min_distance=min_distance
        )
    else:
        inst = loc_lib.label_components(lab > 0)
    n = int(inst.max())
    if n == 0:
        z = np.zeros(0, np.int64)
        return inst, 0, z, z, np.zeros(0, bool), z, z
    kcls = int(lab.max()) + 1
    areas, cy, cx, _, classes = native.label_full_stats(
        inst, lab, None, n, kcls
    )
    return inst, n, areas, classes, areas >= min_area, cy, cx


def _derive_objects_3d(lab: np.ndarray, split_touching: bool,
                       min_distance: int, min_area: int,
                       instances: bool = False):
    """Volumetric twin of ``_derive_objects`` for (Z, H, W) label volumes:
    6-connected 3D components (or the 3D watershed under
    ``split_touching``, or the ids themselves under ``instances``) + the
    single-sweep 3D native stats. Returns
    ``(inst, n, areas, classes, keep, cz, cy, cx)``."""
    from scipy import ndimage


    if lab.ndim != 3:
        raise jobs_lib.JobError(
            f"dims=3 labels must be (Z, H, W) volumes (got {lab.shape})"
        )
    lab = lab.astype(np.int32, copy=False)
    if instances:
        inst = _instances_from_labels(lab)
        lab = (inst > 0).astype(np.int32)  # class 1 everywhere
        n = int(inst.max())
    elif split_touching:
        inst = loc_lib.split_touching_instances(
            lab, min_distance=min_distance
        )
        n = int(inst.max())
    else:
        structure = ndimage.generate_binary_structure(3, 1)
        inst, n = ndimage.label(lab > 0, structure=structure)
    if n == 0:
        zz = np.zeros(0, np.int64)
        return inst, 0, zz, zz, np.zeros(0, bool), zz, zz, zz
    kcls = int(lab.max()) + 1
    areas, cz, cy, cx, _, classes = native.label_full_stats_3d(
        inst, lab, None, n, kcls
    )
    return inst, n, areas, classes, areas >= min_area, cz, cy, cx


def _measure_objects_3d(job: Job, paths) -> Dict[str, str]:
    """Volumetric ``measure_objects`` (``dims: 3``): per-object
    quantification over a timelapse of z-stacks.

    Same contract as the 2D path with the volume-timelapse input
    conventions every 3D pipeline shares (one z-stack file per timepoint
    via directory/glob entries, or a single T·Z-page file with ``z``
    pages-per-volume): a label volume sequence defines the objects (3D
    6-connected components, or the 3D watershed under
    ``split_touching``), each further entry is an intensity channel
    sequence. measurements.csv rows
    ``t,id,class,area,z,y,x,mean_c0..[,coloc cols]`` — volumes carry a z
    centroid; ``colocalize`` works unchanged (the pair statistics are
    connectivity-agnostic bincount reductions over the instance map).
    """

    p = job.params
    z = _parse_z_pages(job)
    try:
        lsource = VolumeSequence(paths[0], z=z)
    except ValueError as e:
        raise jobs_lib.JobError(f"job {job.id}: cannot read labels: {e}")
    csources = []
    try:
        for p_ in paths[1:]:
            try:
                csources.append(VolumeSequence(p_, z=z))
            except ValueError as e:
                raise jobs_lib.JobError(
                    f"job {job.id}: cannot read inputs: {e}"
                )
        lsource = _apply_frame_range(job, lsource)
        for k, cs in enumerate(csources):
            if cs.spatial != lsource.spatial:
                raise jobs_lib.JobError(
                    f"channel {k}: volume shape {cs.spatial} != labels "
                    f"{lsource.spatial}"
                )
        csources = [_apply_frame_range(job, cs) for cs in csources]
        for k, cs in enumerate(csources):
            if len(cs) != len(lsource):
                raise jobs_lib.JobError(
                    f"channel {k}: {len(cs)} timepoint(s) != labels "
                    f"{len(lsource)}"
                )
        min_area = int(p.get("min_area", 1))
        split_touching = bool(p.get("split_touching", False))
        instances = bool(p.get("instances", False))
        _check_instances_params(instances, split_touching)
        min_distance = int(p.get("min_distance", 5))
        colocalize = bool(p.get("colocalize", False))
        thr_spec = p.get("coloc_threshold", "otsu")
        if colocalize and len(csources) < 2:
            raise jobs_lib.JobError(
                "colocalize needs >= 2 intensity channels, got "
                f"{len(csources)}"
            )
        if colocalize:
            try:
                coloc_lib.validate_threshold_spec(thr_spec, len(csources))
            except ValueError as e:
                raise jobs_lib.JobError(f"job {job.id}: {e}")
    except BaseException:
        lsource.close()
        for cs in csources:
            cs.close()
        raise

    timer = PhaseTimer()
    n_vols = len(lsource)
    n_ch = len(csources)
    pairs = (
        [(i, j) for i in range(n_ch) for j in range(i + 1, n_ch)]
        if colocalize else []
    )
    out_path = os.path.join(job.output, "measurements.csv")
    tmp = out_path + ".tmp"
    rep = jobs_lib.ProgressReporter(job, n_vols)
    n_rows = 0
    t0 = time.time()
    try:
        with open(tmp, "w") as f:
            f.write(
                "t,id,class,area,z,y,x,"
                + ",".join(f"mean_c{k}" for k in range(n_ch))
                + "".join(
                    f",pearson_c{i}c{j},m1_c{i}c{j},m2_c{i}c{j}"
                    for i, j in pairs
                )
                + "\n"
            )
            for t in range(n_vols):
                with timer.phase("read"):
                    lab = _frame_or_fail(job, lsource, t, volume=True)
                    chans = [
                        _frame_or_fail(job, cs, t, volume=True).astype(
                            np.float32, copy=False
                        )
                        for cs in csources
                    ]
                with timer.phase("measure"):
                    inst, n, areas, classes, keep_mask, cz, cy, cx = (
                        _derive_objects_3d(
                            lab, split_touching, min_distance, min_area,
                            instances=instances,
                        )
                    )
                    if n == 0:
                        rep.step()
                        continue
                    lab_i = lab.astype(np.int32, copy=False)
                    kcls = int(lab_i.max()) + 1
                    means = [
                        native.label_full_stats_3d(
                            inst, lab_i, ch, n, kcls
                        )[4]
                        for ch in chans
                    ]
                    keep = np.flatnonzero(keep_mask)
                    if pairs:
                        pair_stats = coloc_lib.object_coloc_pairs(
                            inst, n, chans,
                            coloc_lib.resolve_thresholds(chans, thr_spec),
                        )
                with timer.phase("write"):
                    t_abs = t + lsource.frame_offset
                    for i in keep:
                        f.write(
                            f"{t_abs},{i + 1},{int(classes[i])},"
                            f"{int(areas[i])},{cz[i]:.4f},{cy[i]:.4f},"
                            f"{cx[i]:.4f},"
                            + ",".join(f"{m[i]:.6g}" for m in means)
                            + "".join(
                                f",{pair_stats[pr]['pearson'][i]:.6g}"
                                f",{pair_stats[pr]['m1'][i]:.6g}"
                                f",{pair_stats[pr]['m2'][i]:.6g}"
                                for pr in pairs
                            )
                            + "\n"
                        )
                    n_rows += len(keep)
                rep.step()
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    finally:
        lsource.close()
        for cs in csources:
            cs.close()
    os.replace(tmp, out_path)
    rep.finish()
    metrics = dict(
        timer.summary(), total_s=round(time.time() - t0, 4),
        n_objects=n_rows, n_frames=n_vols, n_channels=n_ch,
    )
    return {"measurements": out_path, "metrics": json.dumps(metrics)}


@register("measure_objects")
def measure_objects(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Per-object intensity quantification across channels (no model).

    The classic "segment on one channel, measure the others" workflow:
    a label stack (a segmentation job's ``labels.tif``, chained via
    ``depends_on``, or any integer mask stack) defines the objects, and
    each additional input entry is an intensity channel quantified per
    object. The instance map is computed ONCE per frame; each channel
    then reuses it through the single-sweep native stats
    (``native.label_full_stats``), so K channels cost one CCL + K sweeps.
    This is an extension beyond the reference's capability list (its
    localization measured only the segmentation input's own intensity).

    input: [labels entry, intensity entry 1, ..., intensity entry K]
    (each a stack / dir / glob; all same (T, H, W); K >= 1). params:

    * ``min_area`` (default 1): drop smaller objects.
    * ``split_touching`` (default false) + ``min_distance`` (default 5):
      watershed-split abutting cells, same semantics as segmentation.
    * ``frame_range``: [start, stop) timepoints (absolute t in the CSV).
    * ``dims: 3``: VOLUMETRIC quantification over a timelapse of
      z-stacks (``_measure_objects_3d``) — inputs follow the shared
      volume conventions (per-timepoint files or a single T·Z-page file
      with ``z``); rows gain a z centroid column.
    * ``colocalize`` (default false; needs >= 2 channels): per-object
      colocalization for every channel pair — Pearson correlation over
      the object's pixels plus Manders M1/M2 split coefficients
      (``ops/colocalize.py``; columns ``pearson_c{i}c{j}``,
      ``m1_c{i}c{j}`` = fraction of channel i intensity inside channel
      j-positive pixels, ``m2`` the converse; ``nan`` where undefined —
      zero variance / zero intensity). ``coloc_threshold``: "otsu"
      (default, per frame per channel), a number, or a per-channel list
      of absolute positivity thresholds for the Manders terms.

    Outputs: measurements.csv with one row per object:
    ``t,id,class,area,y,x,mean_c0,...,mean_c{K-1}[,coloc cols]`` — ``id``
    is the per-frame instance number, ``class`` the majority semantic
    label of the object's pixels, means are per-channel averages over
    the object's pixels. Metrics: n_objects, n_frames, n_channels.
    """

    paths = _resolve_inputs(job)
    if len(paths) < 2:
        raise jobs_lib.JobError(
            "measure_objects needs [labels, intensity channel(s)...] "
            f"(>= 2 inputs), got {len(paths)}"
        )
    try:
        dims = int(job.params.get("dims", 2))
    except (TypeError, ValueError):
        raise jobs_lib.JobError(
            f"dims={job.params.get('dims')!r} must be 2 or 3"
        )
    if dims == 3:
        return _measure_objects_3d(job, paths)
    if dims != 2:
        raise jobs_lib.JobError(f"dims={dims} must be 2 or 3")
    try:
        lsource = FrameSource(paths=[paths[0]])
    except ValueError as e:
        raise jobs_lib.JobError(f"job {job.id}: cannot read labels: {e}")
    csources = []
    # open channels + validate; close every lazy reader on a rejected
    # submission (warm workers must not leak fds)
    try:
        for p_ in paths[1:]:
            try:
                csources.append(FrameSource(paths=[p_]))
            except ValueError as e:
                raise jobs_lib.JobError(
                    f"job {job.id}: cannot read inputs: {e}"
                )
        lsource = _apply_frame_range(job, lsource)
        for k, cs in enumerate(csources):
            if cs.spatial != lsource.spatial:
                raise jobs_lib.JobError(
                    f"channel {k}: spatial {cs.spatial} != labels "
                    f"{lsource.spatial}"
                )
        csources = [_apply_frame_range(job, cs) for cs in csources]
        for k, cs in enumerate(csources):
            if len(cs) != len(lsource):
                raise jobs_lib.JobError(
                    f"channel {k}: {len(cs)} frame(s) != labels "
                    f"{len(lsource)}"
                )
        p = job.params
        min_area = int(p.get("min_area", 1))
        split_touching = bool(p.get("split_touching", False))
        instances = bool(p.get("instances", False))
        _check_instances_params(instances, split_touching)
        min_distance = int(p.get("min_distance", 5))
        colocalize = bool(p.get("colocalize", False))
        thr_spec = p.get("coloc_threshold", "otsu")
        if colocalize and len(csources) < 2:
            raise jobs_lib.JobError(
                "colocalize needs >= 2 intensity channels, got "
                f"{len(csources)}"
            )
        if colocalize:
            # malformed specs fail fast at submit time, not after N
            # frames (or never, on an all-empty stack) — review finding
            try:
                coloc_lib.validate_threshold_spec(thr_spec, len(csources))
            except ValueError as e:
                raise jobs_lib.JobError(f"job {job.id}: {e}")
    except BaseException:
        lsource.close()
        for cs in csources:
            cs.close()
        raise

    timer = PhaseTimer()
    n_frames = len(lsource)
    n_ch = len(csources)
    pairs = (
        [(i, j) for i in range(n_ch) for j in range(i + 1, n_ch)]
        if colocalize else []
    )
    out_path = os.path.join(job.output, "measurements.csv")
    tmp = out_path + ".tmp"
    rep = jobs_lib.ProgressReporter(job, n_frames)
    n_rows = 0
    t0 = time.time()
    try:
        with open(tmp, "w") as f:
            f.write(
                "t,id,class,area,y,x,"
                + ",".join(f"mean_c{k}" for k in range(n_ch))
                + "".join(
                    f",pearson_c{i}c{j},m1_c{i}c{j},m2_c{i}c{j}"
                    for i, j in pairs
                )
                + "\n"
            )
            with lsource:
                for t in range(n_frames):
                    with timer.phase("read"):
                        lab = _frame_or_fail(job, lsource, t)
                        chans = [
                            _frame_or_fail(job, cs, t).astype(np.float32, copy=False)
                            for cs in csources
                        ]
                    with timer.phase("measure"):
                        inst, n, areas, classes, keep_mask, cy, cx = (
                            _derive_objects(
                                lab, split_touching, min_distance, min_area,
                                instances=instances,
                            )
                        )
                        if n == 0:
                            rep.step()
                            continue
                        lab_i = lab.astype(np.int32, copy=False)
                        kcls = int(lab_i.max()) + 1
                        means = [
                            native.label_full_stats(
                                inst, lab_i, ch, n, kcls
                            )[3]
                            for ch in chans
                        ]
                        keep = np.flatnonzero(keep_mask)
                        if pairs:
                            pair_stats = coloc_lib.object_coloc_pairs(
                                inst, n, chans,
                                coloc_lib.resolve_thresholds(chans, thr_spec),
                            )
                    with timer.phase("write"):
                        t_abs = t + lsource.frame_offset
                        for i in keep:
                            f.write(
                                f"{t_abs},{i + 1},{int(classes[i])},"
                                f"{int(areas[i])},{cy[i]:.4f},{cx[i]:.4f},"
                                + ",".join(
                                    f"{m[i]:.6g}" for m in means
                                )
                                + "".join(
                                    f",{pair_stats[pr]['pearson'][i]:.6g}"
                                    f",{pair_stats[pr]['m1'][i]:.6g}"
                                    f",{pair_stats[pr]['m2'][i]:.6g}"
                                    for pr in pairs
                                )
                                + "\n"
                            )
                        n_rows += len(keep)
                    rep.step()
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    finally:
        for cs in csources:
            cs.close()
    os.replace(tmp, out_path)
    rep.finish()
    metrics = dict(
        timer.summary(), total_s=round(time.time() - t0, 4),
        n_objects=n_rows, n_frames=n_frames, n_channels=n_ch,
    )
    return {"measurements": out_path, "metrics": json.dumps(metrics)}


@register("count_spots")
def count_spots(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Assign localized emitters to segmented objects (spots per cell).

    The FISH/smFISH workflow: a segmentation defines the cells, a
    single-molecule localization provides the spots, and the biology
    lives in the per-cell spot counts. input: [labels entry,
    emitters.csv] — the labels entry (a segmentation job's ``labels.tif``
    or any integer mask stack) defines objects per frame; the
    emitters.csv (a ``localize_emitters`` job's output — plain,
    astigmatic and volumetric layouts all parse; only the t/y/x columns
    drive the planar assignment) provides detections. Chains from both
    producers via ``depends_on``. Host-side (irregular per-frame joins,
    SURVEY.md §3.5). An extension beyond the reference's capability list.

    params:

    * ``min_area`` / ``split_touching`` / ``min_distance``: object
      semantics as in ``measure_objects`` (spots on objects dropped by
      ``min_area`` count as unassigned).
    * ``capture_radius`` (default 0.0 px): spots landing on background
      are assigned to the nearest object within this distance (EDT
      nearest-instance lookup — membrane-proximal spots the mask just
      misses); 0 = strict inside-the-mask assignment.
    * ``frame_range``: [start, stop) label timepoints; emitter rows
      outside it are dropped.
    * ``dims: 3``: VOLUMETRIC assignment — the labels entry follows the
      shared volume-timelapse conventions (per-timepoint z-stack files
      or one T·Z-page file with ``z``), the emitters csv must carry a z
      column (a ``localize_emitters dims: 3`` run), and spots join on
      their rounded (z, y, x) voxel (capture_radius becomes a 3D
      distance in voxels — set ``z_scale`` upstream if z is not in
      voxels).

    Outputs: spots.csv (the emitters rows + an ``object_id`` column,
    -1 = unassigned) and spot_counts.csv (``t,id,class,area,n_spots`` —
    one row per object INCLUDING zero-spot objects: "no signal in this
    cell" is a measurement). Metrics: n_spots, n_assigned, n_objects,
    spots_per_object_mean.
    """

    paths = _resolve_inputs(job)
    if len(paths) != 2:
        raise jobs_lib.JobError(
            f"count_spots needs [labels, emitters.csv], got {len(paths)} "
            "input(s)"
        )
    lab_path, em_path = paths
    if lab_path.endswith(".csv"):  # a natural argument-order slip
        lab_path, em_path = em_path, lab_path
    p = job.params
    try:
        dims = int(p.get("dims", 2))
    except (TypeError, ValueError):
        raise jobs_lib.JobError(f"dims={p.get('dims')!r} must be 2 or 3")
    if dims not in (2, 3):
        raise jobs_lib.JobError(f"dims={dims} must be 2 or 3")
    try:
        if dims == 3:
            lsource = VolumeSequence(lab_path, z=_parse_z_pages(job))
        else:
            lsource = FrameSource(paths=[lab_path])
    except ValueError as e:
        raise jobs_lib.JobError(f"job {job.id}: cannot read labels: {e}")
    # per-spot coordinate column names, axis order matching the label
    # array's (z, )y, x layout
    axes = ("z", "y", "x") if dims == 3 else ("y", "x")
    try:
        lsource = _apply_frame_range(job, lsource)
        try:
            min_area = int(p.get("min_area", 1))
            split_touching = bool(p.get("split_touching", False))
            instances = bool(p.get("instances", False))
            min_distance = int(p.get("min_distance", 5))
            radius = float(p.get("capture_radius", 0.0))
        except (TypeError, ValueError) as e:
            raise jobs_lib.JobError(f"job {job.id}: bad param: {e}")
        _check_instances_params(instances, split_touching)
        if radius < 0:
            raise jobs_lib.JobError(
                f"capture_radius must be >= 0, got {radius}"
            )
        try:
            with open(em_path) as ef:
                header = ef.readline().strip()
                cols = header.split(",")
                try:
                    c_t = cols.index("t")
                    c_ax = [cols.index(a) for a in axes]
                except ValueError:
                    raise jobs_lib.JobError(
                        f"emitters csv must have t,{','.join(axes)} "
                        f"columns, got {header!r}"
                    )
                by_t: Dict[int, list] = {}
                for line in ef:
                    line = line.strip()
                    if not line:
                        continue
                    parts = line.split(",")
                    try:
                        t_row = int(float(parts[c_t]))
                        coords = tuple(float(parts[c]) for c in c_ax)
                    except (ValueError, IndexError):
                        raise jobs_lib.JobError(
                            f"malformed emitters row: {line!r}"
                        )
                    by_t.setdefault(t_row, []).append((coords, line))
        except OSError as e:
            raise jobs_lib.JobError(
                f"job {job.id}: cannot read emitters: {e}"
            )
    except BaseException:
        lsource.close()
        raise

    timer = PhaseTimer()
    n_frames = len(lsource)
    spots_path = os.path.join(job.output, "spots.csv")
    counts_path = os.path.join(job.output, "spot_counts.csv")
    rep = jobs_lib.ProgressReporter(job, n_frames)
    n_spots = n_assigned = n_objects = 0
    t0 = time.time()
    try:
        with open(spots_path + ".tmp", "w") as sf, \
                open(counts_path + ".tmp", "w") as cf, lsource:
            sf.write(header + ",object_id\n")
            cf.write("t,id,class,area,n_spots\n")
            for t in range(n_frames):
                t_abs = t + lsource.frame_offset
                with timer.phase("read"):
                    lab = _frame_or_fail(job, lsource, t, volume=dims == 3)
                with timer.phase("assign"):
                    if dims == 3:
                        inst, n, areas, classes, keep = _derive_objects_3d(
                            lab, split_touching, min_distance, min_area,
                            instances=instances,
                        )[:5]
                    else:
                        inst, n, areas, classes, keep = _derive_objects(
                            lab, split_touching, min_distance, min_area,
                            instances=instances,
                        )[:5]
                    # assignment sees only KEPT objects: a spot next to a
                    # min_area-dropped speck must still capture to a real
                    # object in range (review finding — the EDT used to
                    # resolve to the nearest instance including dropped
                    # ones, stranding the spot)
                    inst_kept = (
                        np.where(keep[np.maximum(inst - 1, 0)], inst, 0)
                        if n else inst
                    )
                    rows = by_t.get(t_abs, [])
                    oids = np.full(len(rows), -1, np.int64)
                    if rows and n:
                        idx = [
                            np.rint(
                                np.asarray([r[0][a] for r in rows])
                            ).astype(int)
                            for a in range(len(axes))
                        ]
                        # out-of-frame coordinates (emitters from a
                        # different ROI/crop) are unassigned, never
                        # snapped to the border (review finding)
                        inb = np.ones(len(rows), bool)
                        for iv, lim in zip(idx, inst.shape):
                            inb &= (iv >= 0) & (iv < lim)
                        clipped = tuple(
                            np.clip(iv, 0, lim - 1)
                            for iv, lim in zip(idx, inst.shape)
                        )
                        hit = np.where(inb, inst_kept[clipped], 0)
                        bg = inb & (hit == 0)
                        if radius > 0 and bg.any():
                            from scipy import ndimage

                            dist, nearest = ndimage.distance_transform_edt(
                                inst_kept == 0, return_indices=True
                            )
                            at = tuple(iv[bg] for iv in idx)
                            close = dist[at] <= radius
                            near = inst_kept[
                                tuple(nearest[a][at] for a in range(len(axes)))
                            ]
                            hit[bg] = np.where(close, near, 0)
                        oids = np.where(hit > 0, hit, -1).astype(np.int64)
                    counts = np.bincount(
                        oids[oids > 0], minlength=n + 1
                    ) if n else np.zeros(1, np.int64)
                with timer.phase("write"):
                    for (_, line), oid in zip(rows, oids):
                        sf.write(f"{line},{int(oid)}\n")
                    for i in np.flatnonzero(keep):
                        cf.write(
                            f"{t_abs},{i + 1},{int(classes[i])},"
                            f"{int(areas[i])},{int(counts[i + 1])}\n"
                        )
                    n_spots += len(rows)
                    n_assigned += int((oids > 0).sum())
                    n_objects += int(keep.sum())
                rep.step()
    except BaseException:
        for pth in (spots_path, counts_path):
            try:
                os.unlink(pth + ".tmp")
            except OSError:
                pass
        raise
    os.replace(spots_path + ".tmp", spots_path)
    os.replace(counts_path + ".tmp", counts_path)
    rep.finish()
    metrics = dict(
        timer.summary(), total_s=round(time.time() - t0, 4),
        n_spots=n_spots, n_assigned=n_assigned, n_objects=n_objects,
        spots_per_object_mean=round(n_assigned / max(n_objects, 1), 3),
    )
    return {
        "spots": spots_path,
        "spot_counts": counts_path,
        "metrics": json.dumps(metrics),
    }


def _read_tracks_csv(path: str):
    """tracks.csv -> ``({t: [(y, x, z, track_id), ...]}, max_track_id)``
    (shared by export_ctc and measure_tracks — one parser, one set of
    malformed-row semantics)."""
    by_t: Dict[int, list] = {}
    max_tid = -1
    with open(path) as f:
        cols = f.readline().strip().split(",")
        try:
            c_id, c_t, c_x, c_y = (
                cols.index("track_id"), cols.index("t"),
                cols.index("x"), cols.index("y"),
            )
        except ValueError:
            raise jobs_lib.JobError(
                f"{path}: not a tracks.csv (columns {cols})"
            )
        c_z = cols.index("z") if "z" in cols else None
        for line in f:
            parts = line.strip().split(",")
            if len(parts) < 4:
                continue
            try:
                tid = int(parts[c_id])
                t_row = int(float(parts[c_t]))
                y = float(parts[c_y])
                x = float(parts[c_x])
                z = float(parts[c_z]) if c_z is not None else 0.0
            except ValueError:
                raise jobs_lib.JobError(
                    f"malformed tracks row: {line.strip()!r}"
                )
            by_t.setdefault(t_row, []).append((y, x, z, tid))
            max_tid = max(max_tid, tid)
    return by_t, max_tid


def _match_centroids(pts, cand_pts, tol: float):
    """Gated ONE-TO-ONE greedy nearest assignment of N-D points.

    ``pts`` (n, d) query points, ``cand_pts`` (m, d) candidates; returns
    a length-n list of candidate indices (-1 = no match within ``tol``).
    k-nearest candidates sorted by distance, each side used once —
    per-query nearest alone double-books a candidate when two queries
    share a position (the ring-plus-center-fragment case). Shared by
    export_ctc and measure_tracks.
    """
    from scipy.spatial import cKDTree

    assign = [-1] * len(pts)
    if not len(pts) or not len(cand_pts):
        return assign
    tree = cKDTree(np.asarray(cand_pts))
    k = min(3, len(cand_pts))
    d, idx = tree.query(
        np.asarray(pts), k=k, distance_upper_bound=tol
    )
    d = d.reshape(len(pts), -1)
    idx = idx.reshape(len(pts), -1)
    order = sorted(
        (float(d[a, b]), a, int(idx[a, b]))
        for a in range(len(pts)) for b in range(d.shape[1])
        if np.isfinite(d[a, b])
    )
    used_p, used_c = set(), set()
    for _, a, j in order:
        if a in used_p or j in used_c:
            continue
        used_p.add(a)
        used_c.add(j)
        assign[a] = j
    return assign


@register("measure_tracks")
def measure_tracks(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Join a tracking run onto per-object measurements: intensity
    traces per track (the reporter-over-lineage product).

    The completion of the segment -> measure -> track triangle: a
    ``measure_objects`` run quantifies channels per object per frame, a
    ``track_objects`` run links the same objects through time — this
    joins them by (t, centroid) so every measurement row gains its track
    identity, yielding per-track multi-channel time series (cell-cycle
    reporters, signalling dynamics, photobleaching per clone). input:
    [measure_objects output dir (or measurements.csv), track_objects
    output dir (or tracks.csv)] — chain all three with ``depends_on``.

    Join: KD-tree on each frame's tracking detections, gated one-to-one
    within ``match_tol`` (default 0.1 px — both CSVs store the SAME
    native-sweep centroids at 3-4 decimals, so genuine joins are exact;
    run both steps with the same object params). Volumetric runs join in
    full (y, x, z) when the measurements carry a z column (``dims: 3``).
    Measurement rows with no tracking row keep ``track_id -1``
    (min_track_length-filtered blips). Zero joins with rows on both
    sides is a deterministic JobError (mismatched object params);
    tracking rows that match no measurement (a ``frame_range`` subset,
    or differing object params) surface as ``n_unjoined_track_rows`` +
    a runtime warning so truncated traces never look complete.

    Outputs: traces.csv — the measurement columns with ``track_id``
    prepended, sorted by (track_id, t); track -1 rows last. Metrics:
    n_rows, n_joined, n_unjoined, n_unjoined_track_rows, n_tracks.
    """
    paths = _resolve_inputs(job)
    if len(paths) != 2:
        raise jobs_lib.JobError(
            "measure_tracks needs [measurements, tracking output], got "
            f"{len(paths)} input(s)"
        )

    def _as_file(p_, name):
        return os.path.join(p_, name) if os.path.isdir(p_) else p_

    meas_path = _as_file(paths[0], "measurements.csv")
    trk_path = _as_file(paths[1], "tracks.csv")
    alt_m = _as_file(paths[1], "measurements.csv")
    alt_t = _as_file(paths[0], "tracks.csv")

    def _header(p_):
        try:
            with open(p_) as f:
                return f.readline().strip().split(",")
        except OSError:
            return None

    # accept either argument order, sniffed by HEADER (path existence
    # alone cannot disambiguate two explicit .csv paths — review fix):
    # the tracks side is the one carrying a track_id column
    def _sides_ok(m, t):
        hm, ht = _header(m), _header(t)
        return (
            hm is not None and ht is not None
            and "track_id" in ht and "track_id" not in hm
        )

    if _sides_ok(meas_path, trk_path):
        pass
    elif _sides_ok(alt_m, alt_t):
        meas_path, trk_path = alt_m, alt_t
    else:
        raise jobs_lib.JobError(
            f"cannot resolve measurements.csv + tracks.csv from {paths!r} "
            "(the tracks side must carry a track_id column)"
        )
    h_m = _header(meas_path)
    p = job.params
    try:
        tol = float(p.get("match_tol", 0.1))
    except (TypeError, ValueError) as e:
        raise jobs_lib.JobError(f"job {job.id}: bad param: {e}")
    if tol <= 0:
        raise jobs_lib.JobError(f"match_tol must be > 0, got {tol}")

    mcols = h_m
    try:
        mix = {c: mcols.index(c) for c in ("t", "y", "x")}
    except ValueError:
        raise jobs_lib.JobError(
            f"{meas_path}: needs columns ('t', 'y', 'x'), got {mcols}"
        )
    use_z = "z" in mcols  # volumetric measurements join in 3D
    if use_z:
        mix["z"] = mcols.index("z")
    mrows = []
    with open(meas_path) as f:
        f.readline()
        for line in f:
            line = line.strip()
            if line:
                mrows.append(line.split(","))
    trk_by_t, _ = _read_tracks_csv(trk_path)
    n_track_rows = sum(len(v) for v in trk_by_t.values())
    try:
        meas_by_t: Dict[int, list] = {}
        for r in mrows:
            meas_by_t.setdefault(int(float(r[mix["t"]])), []).append(r)
    except (ValueError, IndexError) as e:
        raise jobs_lib.JobError(f"job {job.id}: malformed csv row: {e}")

    joined = []
    n_joined = 0
    try:
        for t, rows in sorted(meas_by_t.items()):
            cands = trk_by_t.get(t, [])
            if cands:
                dims_sl = slice(0, 3 if use_z else 2)
                pts = [
                    tuple(
                        float(r[mix[a]]) for a in
                        (("y", "x", "z") if use_z else ("y", "x"))
                    )
                    for r in rows
                ]
                assign = _match_centroids(
                    pts, [c[dims_sl] for c in cands], tol
                )
                ids = [cands[j][3] if j >= 0 else -1 for j in assign]
                n_joined += sum(j >= 0 for j in assign)
            else:
                ids = [-1] * len(rows)
            for r, tid in zip(rows, ids):
                joined.append((tid, t, r))
    except (ValueError, IndexError) as e:
        raise jobs_lib.JobError(f"job {job.id}: malformed csv row: {e}")
    if n_joined == 0 and mrows and n_track_rows:
        raise jobs_lib.JobError(
            "no measurement row joined any tracking row: run "
            "measure_objects and track_objects with MATCHING object "
            f"params (match_tol={tol})"
        )
    n_unjoined_track_rows = n_track_rows - n_joined
    if n_unjoined_track_rows:
        job.runtime_warnings.append(
            f"{n_unjoined_track_rows} tracking row(s) joined no "
            "measurement (frame_range subset, or object params differ "
            "between the two runs) — traces are PARTIAL for those tracks"
        )
    out_path = os.path.join(job.output, "traces.csv")
    with open(out_path + ".tmp", "w") as f:
        f.write("track_id," + ",".join(mcols) + "\n")
        # track -1 rows last; within a track, time order
        joined.sort(key=lambda v: (v[0] < 0, v[0], v[1]))
        for tid, _, r in joined:
            f.write(f"{tid}," + ",".join(r) + "\n")
    os.replace(out_path + ".tmp", out_path)
    metrics = {
        "n_rows": len(joined),
        "n_joined": n_joined,
        "n_unjoined": len(joined) - n_joined,
        "n_unjoined_track_rows": n_unjoined_track_rows,
        "n_tracks": len({tid for tid, _, _ in joined if tid >= 0}),
    }
    return {"traces": out_path, "metrics": json.dumps(metrics)}


@register("track_objects")
def track_objects(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Link a serve's ``objects.h5`` into trajectories (tracks.csv).

    A BUILT-IN linker (globally-optimal gated Hungarian assignment per
    frame pair, short-gap closing — ``sequitr_tpu.tracking``) for QC,
    motility statistics and emitter trajectories. The objects file stays
    btrack-compatible; btrack remains the supported path for
    publication-grade Bayesian tracking. This pipeline is an extension
    beyond the reference's capability list (SURVEY.md §0: sequitr
    delegates ALL tracking to btrack).

    input: [objects.h5] (a segmentation/emitter serve's output). params:
    ``max_distance`` (linking gate in pixels, default 20), ``max_gap``
    (frames a track may go undetected, default 0), ``obj_type`` (h5 group,
    default 1), ``min_track_length`` (drop shorter tracks from the CSV,
    default 1; survivors are compactly relabelled and re-rooted so the
    outputs stay a self-consistent forest with CTC-contiguous labels —
    an orphaned child becomes a generation-0 root).

    ``motion_model: "kalman"`` switches to a constant-velocity Kalman
    filter per track with Mahalanobis gating (``gate_sigma``, default 4;
    ``process_noise`` accel std px/frame^2; ``measurement_noise`` px;
    ``init_velocity_noise`` px/frame) — crossings disambiguated by each
    track's own motion history, gaps closed by prediction. ``divisions:
    true`` resolves binary fission into parent/child lineages
    (``division_distance`` gate, default ``max_distance``;
    ``mitotic_class`` restricts dividing parents to tracks whose last
    detection carries that semantic class — wire it to the classifier
    the serve already ran). Outputs: tracks.csv, track_summaries.csv
    (with parent_id/root_id/generation columns) and lbep.txt
    (Cell-Tracking-Challenge ``L B E P`` lineage table, 1-based labels,
    parent 0 = none) (+ metrics: n_tracks, n_links, n_divisions,
    mean/max track length).
    """

    paths = _resolve_inputs(job)
    if len(paths) != 1:
        raise jobs_lib.JobError("track_objects needs exactly one objects.h5")
    p = job.params
    try:
        tables = loc_lib.read_objects_h5(
            paths[0], obj_type=int(p.get("obj_type", 1))
        )
    except (OSError, KeyError, ValueError, TypeError) as e:
        # any malformed file/params is deterministic: fail fast, no retry
        raise jobs_lib.JobError(f"job {job.id}: cannot read objects: {e!r}")
    mit = p.get("mitotic_class")
    try:
        track_ids, tracks = tracking.link_tables(
            tables,
            max_distance=float(p.get("max_distance", 20.0)),
            max_gap=int(p.get("max_gap", 0)),
            motion_model=str(p.get("motion_model", "nearest")),
            gate_sigma=float(p.get("gate_sigma", 4.0)),
            process_noise=float(p.get("process_noise", 1.0)),
            measurement_noise=float(p.get("measurement_noise", 1.0)),
            init_velocity_noise=(
                None if p.get("init_velocity_noise") is None
                else float(p["init_velocity_noise"])
            ),
            divisions=bool(p.get("divisions", False)),
            division_distance=(
                None if p.get("division_distance") is None
                else float(p["division_distance"])
            ),
            mitotic_class=None if mit is None else int(mit),
        )
    except (ValueError, TypeError) as e:
        raise jobs_lib.JobError(f"job {job.id}: {e}")
    min_len = int(p.get("min_track_length", 1))
    if min_len > 1:
        keep = np.fromiter(
            (t.track_id for t in tracks if t.n_points >= min_len), np.int32
        )
        masks = [np.isin(ids, keep) for ids in track_ids]
        # drop filtered detections from the CSVs entirely
        tables = [
            loc_lib.FrameTable(
                coords=tb.coords[m],
                area=tb.area[m],
                intensity_mean=tb.intensity_mean[m],
            )
            for tb, m in zip(tables, masks)
        ]
        track_ids = [ids[m] for ids, m in zip(track_ids, masks)]
        keep_set = set(int(k) for k in keep)
        tracks = [t for t in tracks if t.track_id in keep_set]
        # compact relabel + re-root so every output stays a
        # self-consistent forest with CTC-contiguous labels (an orphaned
        # child becomes a generation-0 root; filters do not cascade)
        tracks, remap = tracking.reindex_lineage(tracks)
        track_ids = [
            np.fromiter((remap[int(i)] for i in ids), np.int32, len(ids))
            for ids in track_ids
        ]
    csv_path = os.path.join(job.output, "tracks.csv")
    n_rows = tracking.write_tracks_csv(csv_path, tables, track_ids)
    sum_path = os.path.join(job.output, "track_summaries.csv")
    tracking.write_track_summaries_csv(sum_path, tracks)
    lbep_path = os.path.join(job.output, "lbep.txt")
    tracking.write_lbep(lbep_path, tracks)
    lens = [t.n_points for t in tracks] or [0]
    parents = {t.parent_id for t in tracks if t.parent_id >= 0}
    metrics = {
        "n_tracks": len(tracks),
        # links actually MADE (frame-to-frame assignments) vs detections
        # written: a gate too tight shows n_links 0 even with many rows
        "n_links": int(sum(t.n_links for t in tracks)),
        "n_detections": n_rows,
        "n_frames": len(tables),
        "n_divisions": len(parents),
        "mean_track_len": round(float(np.mean(lens)), 2),
        "max_track_len": int(np.max(lens)),
    }
    return {
        "tracks": csv_path,
        "track_summaries": sum_path,
        "lbep": lbep_path,
        "metrics": json.dumps(metrics),
    }
