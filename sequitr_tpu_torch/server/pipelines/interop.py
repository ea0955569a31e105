"""Interop/QC pipelines: CTC export, acquisition QC, z-projection.

Port of ``sequitr_tpu.server.pipelines.interop``: ``export_ctc``
(Cell-Tracking-Challenge RES folders, host numpy), ``qc_stack``
(per-frame and, with ``dims: 3``, per-plane acquisition QC) and
``project_stack`` (max/min/sum/mean/std/median/best-focus/EDoF). The same
job JSON writes the same files, CSV columns, metrics keys and JobError
texts as the JAX server.

``qc_stack`` and ``project_stack`` run on ``config.device``: frames and
volumes go to the device in their native dtype (uint16 at two bytes a
pixel) through ``infer.stream_frames`` (reads and the next item's work
queued ahead), and each item comes back in one copy (``qc_stack``: the
(7,) or (Z, 7) metric rows; ``project_stack``: the projection, plus the
best plane or the height map where the method makes one). Flags, CSVs
and the per-volume aggregates are host numpy, as in the JAX server.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np

from sequitr_tpu_torch.config import ServerConfiguration
from sequitr_tpu_torch.data import tiff
from sequitr_tpu_torch.data.source import FrameSource, VolumeSequence
from sequitr_tpu_torch.ops import projection as proj_lib
from sequitr_tpu_torch.ops import qc as qc_lib
from sequitr_tpu_torch.pipeline import infer as infer_lib
from sequitr_tpu_torch.server import jobs as jobs_lib
from sequitr_tpu_torch.server.jobs import Job
from sequitr_tpu_torch.server.pipelines.quantify import (
    _check_instances_params,
    _derive_objects,
    _frame_or_fail,
    _match_centroids,
    _read_tracks_csv,
)
from sequitr_tpu_torch.server.server import (
    _append_writer,
    _apply_frame_range,
    _out_compression,
    _parse_z_pages,
    _reads_fail_fast,
    _resolve_inputs,
    register,
)
from sequitr_tpu_torch.utils import PhaseTimer, resolve_device


@register("export_ctc")
def export_ctc(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Render a tracking run in Cell-Tracking-Challenge (CTC) format.

    The interop endpoint of the lineage story: CTC evaluation tools
    (TRA/SEG measures, lineage viewers) consume a RES folder of per-frame
    16-bit instance masks whose labels ARE the track labels, plus
    ``res_track.txt`` (the ``L B E P`` table ``track_objects`` already
    writes as lbep.txt). input: [labels entry, track_objects output dir]
    — the SAME labels stack the tracked objects.h5 was localized from,
    and the tracking run to render (chain both with ``depends_on``).

    Each frame's instances are re-derived with the same object semantics
    the serve used (``min_area``/``split_touching``/``min_distance`` must
    match it) and joined to the tracking rows by centroid (a KD-tree
    within ``match_tol``, default 0.1 px — centroids are stored at 3
    decimals, so genuine matches are exact). Matched pixels repaint to
    the CTC 1-based track label (``track_id + 1``, exactly the labels
    lbep.txt carries); instances with no tracking row (e.g. dropped by
    ``min_track_length``) paint background and count in ``n_unmatched``.

    Outputs: ``mask{t:0Nd}.tif`` one per frame (uint16, N = max(3,
    digits of T) — the CTC RES naming, 0-based WITHIN the export, so a
    ``frame_range`` subset is itself a valid contiguous RES folder) +
    ``res_track.txt`` (trimmed/shifted to the exported range; parents
    outside it clear to 0). Zero matches with tracking rows present is a
    deterministic JobError (the object params do not reproduce the
    serve); partially-unmatched rows surface as a runtime warning +
    ``n_unmatched_rows``. 2D only (CTC's own format is per-frame planar
    masks).
    """

    paths = _resolve_inputs(job)
    if len(paths) != 2:
        raise jobs_lib.JobError(
            f"export_ctc needs [labels, tracking output dir], got "
            f"{len(paths)} input(s)"
        )
    lab_path, trk_path = paths
    if os.path.isdir(lab_path) and os.path.exists(
        os.path.join(lab_path, "tracks.csv")
    ):
        lab_path, trk_path = trk_path, lab_path  # argument-order slip
    tracks_csv = (
        os.path.join(trk_path, "tracks.csv")
        if os.path.isdir(trk_path) else trk_path
    )
    lbep_src = os.path.join(os.path.dirname(tracks_csv), "lbep.txt")
    if not os.path.exists(tracks_csv) or not os.path.exists(lbep_src):
        raise jobs_lib.JobError(
            f"{trk_path!r} is not a track_objects output (needs "
            "tracks.csv + lbep.txt)"
        )
    try:
        lsource = FrameSource(paths=[lab_path])
    except ValueError as e:
        raise jobs_lib.JobError(f"job {job.id}: cannot read labels: {e}")
    try:
        lsource = _apply_frame_range(job, lsource)
        p = job.params
        try:
            min_area = int(p.get("min_area", 1))
            split_touching = bool(p.get("split_touching", False))
            instances = bool(p.get("instances", False))
            min_distance = int(p.get("min_distance", 5))
            tol = float(p.get("match_tol", 0.1))
        except (TypeError, ValueError) as e:
            raise jobs_lib.JobError(f"job {job.id}: bad param: {e}")
        if tol <= 0:
            raise jobs_lib.JobError(f"match_tol must be > 0, got {tol}")
        _check_instances_params(instances, split_touching)
        by_t, max_tid = _read_tracks_csv(tracks_csv)
        if max_tid + 1 > 65535:
            raise jobs_lib.JobError(
                f"{max_tid + 1} CTC labels exceed uint16 (65535 max)"
            )
    except BaseException:
        lsource.close()
        raise

    timer = PhaseTimer()
    n_frames = len(lsource)
    start = lsource.frame_offset
    # CTC folders are 0-based and contiguous: a frame_range export
    # renumbers its masks from 0 and rewrites res_track to the subrange
    # (a wholesale lbep copy would reference frames with no mask file —
    # an invalid RES folder; code-review finding)
    width = max(3, len(str(n_frames - 1)))
    rep = jobs_lib.ProgressReporter(job, n_frames)
    n_matched = n_unmatched = n_unmatched_rows = 0
    t0 = time.time()
    comp = _out_compression(job)
    with lsource:
        for t in range(n_frames):
            t_abs = t + start
            with timer.phase("read"):
                lab = _frame_or_fail(job, lsource, t)
            with timer.phase("relabel"):
                inst, n, areas, classes, keep, cy, cx = _derive_objects(
                    lab, split_touching, min_distance, min_area,
                    instances=instances,
                )
                lut = np.zeros(n + 1, np.uint16)
                rows = by_t.get(t_abs, [])
                kept = np.flatnonzero(keep) if n else np.zeros(0, int)
                got = 0
                if len(kept) and rows:
                    # gated ONE-TO-ONE assignment (shared helper): a
                    # per-instance nearest query would double-book a row
                    # when two instances share a centroid (ring + center
                    # fragment), painting one track label twice and the
                    # other never
                    assign = _match_centroids(
                        np.stack([cy[kept], cx[kept]], axis=1),
                        [(r[0], r[1]) for r in rows], tol,
                    )
                    for i, j in zip(kept, assign):
                        if j >= 0:
                            lut[i + 1] = rows[j][3] + 1  # CTC 1-based
                            got += 1
                    n_unmatched_rows += len(rows) - got
                else:
                    n_unmatched_rows += len(rows)
                n_matched += got
                n_unmatched += len(kept) - got
                mask = lut[inst]
            with timer.phase("write"):
                pth = os.path.join(job.output, f"mask{t:0{width}d}.tif")
                tiff.write_stack(pth, mask[None], compression=comp)
            rep.step()
    if n_matched == 0 and by_t:
        # every tracking row missed every instance: the object semantics
        # (min_area/split_touching/min_distance) do not match the serve
        # the tracking was computed from — deterministic, fail loudly
        raise jobs_lib.JobError(
            "no tracking row matched any instance: object-derivation "
            "params must MATCH the serve the tracking consumed "
            f"(min_area={min_area}, split_touching={split_touching}, "
            f"min_distance={min_distance}, match_tol={tol})"
        )
    if n_unmatched_rows:
        job.runtime_warnings.append(
            f"{n_unmatched_rows} tracking row(s) matched no instance "
            "(frame_range subset, or object params differ from the serve)"
        )
    res_path = os.path.join(job.output, "res_track.txt")
    stop = start + n_frames
    with open(lbep_src) as f, open(res_path + ".tmp", "w") as out_f:
        kept_labels = set()
        rows_lbep = []
        for line in f:
            parts = line.split()
            if len(parts) != 4:
                continue
            lbl, b, e, par = (int(v) for v in parts)
            if e < start or b >= stop:
                continue  # entirely outside the exported range
            rows_lbep.append(
                (lbl, max(b - start, 0), min(e, stop - 1) - start, par)
            )
            kept_labels.add(lbl)
        for lbl, b, e, par in rows_lbep:
            out_f.write(
                f"{lbl} {b} {e} {par if par in kept_labels else 0}\n"
            )
    os.replace(res_path + ".tmp", res_path)
    rep.finish()
    metrics = dict(
        timer.summary(), total_s=round(time.time() - t0, 4),
        n_frames=n_frames, n_matched=n_matched, n_unmatched=n_unmatched,
        n_unmatched_rows=n_unmatched_rows,
    )
    return {
        "masks": os.path.join(job.output, "mask*.tif"),
        "res_track": res_path,
        "metrics": json.dumps(metrics),
    }


def _parse_qc_params(job: Job):
    """Shared qc_stack threshold parsing/validation (2D and 3D paths must
    not drift): returns (sat_param, mad_k, focus_drop, dark_fraction,
    sat_max); malformed or out-of-range values are deterministic
    JobErrors."""
    p = job.params
    try:
        sat_param = p.get("saturation_level")
        sat_param = None if sat_param is None else float(sat_param)
        mad_k = float(p.get("focus_mad_k", 3.5))
        focus_drop = float(p.get("focus_drop", 0.5))
        dark_fraction = float(p.get("dark_fraction", 0.5))
        sat_max = float(p.get("saturation_max", 0.01))
    except (TypeError, ValueError) as e:
        # bad params are deterministic: fail fast, never retry
        raise jobs_lib.JobError(f"job {job.id}: bad qc param: {e}")
    if (
        mad_k <= 0 or not 0 <= dark_fraction < 1
        or not 0 < sat_max <= 1 or not 0 < focus_drop <= 1
    ):
        raise jobs_lib.JobError(
            f"bad thresholds: focus_mad_k={mad_k} (>0), focus_drop="
            f"{focus_drop} ((0,1]), dark_fraction={dark_fraction} "
            f"([0,1)), saturation_max={sat_max} ((0,1])"
        )
    return sat_param, mad_k, focus_drop, dark_fraction, sat_max


def _qc_stack_3d(job: Job, paths, device) -> Dict[str, str]:
    """Volumetric ``qc_stack`` (``dims: 3``): per-plane QC + per-volume
    focal-drift flags for timelapses of z-stacks.

    Per timepoint, every z-plane scores in one batched pass of
    ``ops.qc.frame_qc`` on ``device`` (one copy back a volume). Two
    outputs:

    * ``qc.csv`` — one row per (t, channel, z): the plane metrics, for
      drilling into any flagged volume;
    * ``qc_volumes.csv`` — one row per (t, channel): ``best_z`` (the
      sharpest plane — its drift over time IS the focal-creep signal
      ``register_stack dims: 3`` corrects), the best plane's focus
      scores, volume-wide mean/sat_frac, and the run-relative flags
      (the same focus/dark/saturated rules applied to the per-volume
      aggregates — a volume whose BEST plane went soft is out of focus
      everywhere).

    Metrics add ``best_z_drift`` (max |best_z - median best_z| per
    channel, in planes): a nonzero drift with clean flags means the
    sample is walking in z and registration should run first.
    """
    z_pages = _parse_z_pages(job)
    sources = []
    try:
        for p_ in paths:
            try:
                sources.append(VolumeSequence(p_, z=z_pages))
            except ValueError as e:
                raise jobs_lib.JobError(
                    f"job {job.id}: cannot read inputs: {e}"
                )
        sources = [_apply_frame_range(job, s) for s in sources]
        if len({(len(s), s.spatial) for s in sources}) != 1:
            raise jobs_lib.JobError(
                "channels disagree in length/shape: "
                + str([(len(s), s.spatial) for s in sources])
            )
        (sat_param, mad_k, focus_drop, dark_fraction,
         sat_max) = _parse_qc_params(job)
    except BaseException:
        for s in sources:
            s.close()
        raise

    timer = PhaseTimer()
    t0 = time.time()
    n_vols = len(sources[0])
    offset = sources[0].frame_offset
    rep = jobs_lib.ProgressReporter(job, n_vols * len(sources))
    plane_tables = []  # per channel: (T, Z, 7)
    i_focus = qc_lib.METRICS.index("focus_vol")
    i_mean = qc_lib.METRICS.index("mean")
    i_sat = qc_lib.METRICS.index("sat_frac")
    try:
        for ch, src in enumerate(sources):
            sat = (
                sat_param if sat_param is not None
                else qc_lib.default_saturation_level(src.dtype)
            )
            # the threshold as the JAX server's f32 scalar
            sat_f = np.inf if sat is None else float(np.float32(sat))
            rows = []
            for out in infer_lib.stream_frames(
                lambda v: qc_lib.frame_qc(v, sat_f),
                _reads_fail_fast(
                    job, (src.volume(t) for t in range(n_vols))
                ),
                prefetch_host=infer_lib._copy_to_host_async,
                device=device,
            ):
                with timer.phase("fetch"):
                    rows.append(np.asarray(out))
                rep.step()
            plane_tables.append(
                np.stack(rows)
                if rows else np.zeros((0, 1, len(qc_lib.METRICS)))
            )
    finally:
        for s in sources:
            s.close()
    with timer.phase("flag"):
        vol_tables, best_zs, flags = [], [], []
        for tb in plane_tables:  # (T, Z, 7)
            bz = np.argmax(tb[:, :, i_focus], axis=1)
            vt = tb[np.arange(len(tb)), bz].copy()  # best plane's row
            vt[:, i_mean] = tb[:, :, i_mean].mean(axis=1)
            # saturation is ABSOLUTE (ops/qc.py): a single laser-spiked
            # plane must flag the volume — a Z-mean would dilute it
            # below the threshold (review finding)
            vt[:, i_sat] = tb[:, :, i_sat].max(axis=1)
            vol_tables.append(vt)
            best_zs.append(bz)
            flags.append(qc_lib.flag_frames(
                vt, mad_k=mad_k, dark_fraction=dark_fraction,
                sat_max=sat_max, focus_drop=focus_drop,
            ))
    qc_path = os.path.join(job.output, "qc.csv")
    with open(qc_path + ".tmp", "w") as f:
        f.write("t,channel,z," + ",".join(qc_lib.METRICS) + "\n")
        for t in range(n_vols):
            for ch, tb in enumerate(plane_tables):
                for z in range(tb.shape[1]):
                    vals = ",".join(f"{v:.6g}" for v in tb[t, z])
                    f.write(f"{t + offset},{ch},{z},{vals}\n")
    os.replace(qc_path + ".tmp", qc_path)
    volumes_path = os.path.join(job.output, "qc_volumes.csv")
    with open(volumes_path + ".tmp", "w") as f:
        f.write(
            "t,channel,best_z," + ",".join(qc_lib.METRICS) + ",flags\n"
        )
        for t in range(n_vols):
            for ch in range(len(sources)):
                vals = ",".join(f"{v:.6g}" for v in vol_tables[ch][t])
                f.write(
                    f"{t + offset},{ch},{int(best_zs[ch][t])},{vals},"
                    f"{'+'.join(flags[ch][t])}\n"
                )
    os.replace(volumes_path + ".tmp", volumes_path)
    rep.finish()
    per_flag: Dict[str, int] = {}
    flagged = set()
    drift = 0.0
    for ch in range(len(sources)):
        if len(best_zs[ch]):
            med = float(np.median(best_zs[ch]))
            # float deviation: int() truncated a genuine one-plane shift
            # to 0 when an even-length run put the median at x.5
            drift = max(
                drift, round(float(np.abs(best_zs[ch] - med).max()), 1)
            )
        for t, fl in enumerate(flags[ch]):
            if fl:
                flagged.add(t)
            for name in fl:
                per_flag[name] = per_flag.get(name, 0) + 1
    metrics = dict(
        timer.summary(), total_s=round(time.time() - t0, 4),
        n_frames=n_vols, n_channels=len(sources),
        n_flagged_volumes=len(flagged), best_z_drift=drift,
        **{f"n_{k}": v for k, v in sorted(per_flag.items())},
    )
    return {
        "qc": qc_path,
        "qc_volumes": volumes_path,
        "metrics": json.dumps(metrics),
    }


@register("qc_stack")
def qc_stack(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Per-frame acquisition QC of a timelapse (no model required).

    The triage step BEFORE chip time is spent: scores every frame's
    focus (Laplacian variance + Tenengrad), exposure (mean/std/p01/p99)
    and saturation fraction in one pass per frame on ``config.device``
    (``ops/qc.py``), then flags outliers with run-relative robust
    statistics — ``focus`` (score ``focus_mad_k`` robust sigmas below
    the run median), ``dark`` (mean under ``dark_fraction`` x the run
    median) and ``saturated`` (fraction over ``saturation_max``). Feed
    the flagged frame list to ``frame_range``/pre-filtering before
    training or serving. An extension beyond the reference's capability
    list (its era triaged by eye).

    input: one or more channel entries (the shared one-TIFF-per-channel
    convention; each channel scores and flags independently). params:
    ``saturation_level`` (absolute; default = the integer dtype's
    full-scale value, float inputs skip saturation unless given),
    ``focus_mad_k`` (default 3.5), ``focus_drop`` (default 0.5 — a
    focus flag also requires the score under this fraction of the run
    median), ``dark_fraction`` (default 0.5), ``saturation_max``
    (default 0.01), ``frame_range``. ``dims: 3`` runs the volumetric
    variant (``_qc_stack_3d``: per-plane rows + per-volume flags +
    ``best_z`` focal-drift tracking over the shared volume-timelapse
    input conventions).

    Outputs: qc.csv — one row per (frame, channel):
    ``t,channel,focus_vol,tenengrad,mean,std,p01,p99,sat_frac,flags``
    (``flags`` is ``+``-joined, empty = clean). Metrics: n_frames,
    n_flagged and per-flag counts.
    """


    device = resolve_device(config.device)
    paths = _resolve_inputs(job)
    p = job.params
    try:
        dims = int(p.get("dims", 2))
    except (TypeError, ValueError):
        raise jobs_lib.JobError(f"dims={p.get('dims')!r} must be 2 or 3")
    if dims == 3:
        return _qc_stack_3d(job, paths, device)
    if dims != 2:
        raise jobs_lib.JobError(f"dims={dims} must be 2 or 3")
    sources = []
    try:
        for p_ in paths:
            try:
                sources.append(FrameSource(paths=[p_]))
            except ValueError as e:
                raise jobs_lib.JobError(
                    f"job {job.id}: cannot read inputs: {e}"
                )
        sources = [_apply_frame_range(job, s) for s in sources]
        if len({(len(s), s.spatial) for s in sources}) != 1:
            raise jobs_lib.JobError(
                "channels disagree in length/shape: "
                + str([(len(s), s.spatial) for s in sources])
            )
        (sat_param, mad_k, focus_drop, dark_fraction,
         sat_max) = _parse_qc_params(job)
    except BaseException:
        for s in sources:
            s.close()
        raise

    timer = PhaseTimer()
    n_frames = len(sources[0])
    offset = sources[0].frame_offset
    rep = jobs_lib.ProgressReporter(job, n_frames * len(sources))
    tables = []  # per-channel (T, 7)
    t0 = time.time()
    try:
        for ch, src in enumerate(sources):
            sat = (
                sat_param if sat_param is not None
                else qc_lib.default_saturation_level(src.dtype)
            )
            sat_f = np.inf if sat is None else float(np.float32(sat))
            rows = []
            with src:
                for out in infer_lib.stream_frames(
                    lambda f: qc_lib.frame_qc(f, sat_f),
                    _reads_fail_fast(
                        job, (src.frame(t) for t in range(n_frames))
                    ),
                    prefetch_host=infer_lib._copy_to_host_async,
                    device=device,
                ):
                    with timer.phase("fetch"):
                        rows.append(np.asarray(out))
                    rep.step()
            tables.append(np.stack(rows) if rows else np.zeros((0, 7)))
    finally:
        # a mid-stream failure in channel k must not leak the remaining
        # channels' open readers in a long-lived worker (close is
        # idempotent; the with-block already closed the current one)
        for s in sources:
            s.close()
    with timer.phase("flag"):
        flags = [
            qc_lib.flag_frames(
                tb, mad_k=mad_k, dark_fraction=dark_fraction,
                sat_max=sat_max, focus_drop=focus_drop,
            )
            for tb in tables
        ]
    qc_path = os.path.join(job.output, "qc.csv")
    with open(qc_path + ".tmp", "w") as f:
        f.write("t,channel," + ",".join(qc_lib.METRICS) + ",flags\n")
        for t in range(n_frames):
            for ch in range(len(sources)):
                vals = ",".join(f"{v:.6g}" for v in tables[ch][t])
                f.write(
                    f"{t + offset},{ch},{vals},"
                    f"{'+'.join(flags[ch][t])}\n"
                )
    os.replace(qc_path + ".tmp", qc_path)
    rep.finish()
    per_flag: Dict[str, int] = {}
    flagged = set()
    for ch in range(len(sources)):
        for t, fl in enumerate(flags[ch]):
            if fl:
                flagged.add(t)
            for name in fl:
                per_flag[name] = per_flag.get(name, 0) + 1
    metrics = dict(
        timer.summary(), total_s=round(time.time() - t0, 4),
        n_frames=n_frames, n_channels=len(sources),
        n_flagged_frames=len(flagged),
        **{f"n_{k}": v for k, v in sorted(per_flag.items())},
    )
    return {"qc": qc_path, "metrics": json.dumps(metrics)}


@register("project_stack")
def project_stack_job(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Z-project a volume timelapse into a 2D timelapse.

    The bridge from volumetric acquisitions to the whole 2D pipeline
    family: project each timepoint's z-stack to one frame
    (``ops/projection.py`` on ``config.device``, timepoints streamed with
    H2D overlap) and chain segmentation / denoising /
    tracking / quantification on the projection via ``depends_on``. An
    extension beyond the reference's capability list (its era projected
    host-side in ImageJ before submitting jobs).

    input: one or more channel entries over the shared volume-timelapse
    conventions (directory/glob = one z-stack file per timepoint, or a
    single T·Z-page file with ``z`` pages per volume; a bare single
    file is a one-volume sequence). params: ``method`` (default
    ``"max"``: max / min / sum / mean / std / median / best_focus /
    edof), ``z`` (pages per volume), ``z_range: [lo, hi]`` (project
    planes lo..hi-1 only), ``edof_radius`` (local sharpness window
    half-width, default 4), ``edof_gamma`` (weighting exponent, default
    4.0), ``edof_mode`` (``"blend"`` smooth / ``"select"`` hard argmax),
    ``save_height`` (edof only: also write the per-pixel argmax-z
    height map), ``frame_range``, ``compress_output``.

    Outputs: projected.tif (single channel) or projected_c{k}.tif —
    selection methods (max/min/best_focus) keep the input dtype
    bit-exactly, arithmetic ones (sum/mean/std/median/edof) write
    float32; projection.csv (``t,channel,best_z`` — best_focus only);
    height.tif / height_c{k}.tif (uint16). Metrics: n_frames,
    n_channels, method, per-phase timings.
    """

    device = resolve_device(config.device)
    paths = _resolve_inputs(job)
    p = job.params
    method = str(p.get("method", "max"))
    try:
        project = proj_lib.make_projector(
            method,
            radius=int(p.get("edof_radius", 4)),
            gamma=float(p.get("edof_gamma", 4.0)),
            mode=str(p.get("edof_mode", "blend")),
        )
    except (TypeError, ValueError) as e:
        raise jobs_lib.JobError(f"job {job.id}: {e}")
    save_height = bool(p.get("save_height", False))
    if save_height and method != "edof":
        raise jobs_lib.JobError(
            f"save_height requires method: 'edof' (got {method!r} — "
            "only EDoF produces a per-pixel height map)"
        )
    z_range = p.get("z_range")
    if z_range is not None:
        try:
            z_lo, z_hi = (int(v) for v in z_range)
        except (TypeError, ValueError):
            raise jobs_lib.JobError(
                f"z_range={z_range!r} must be [lo, hi] plane indices"
            )
        if not 0 <= z_lo < z_hi:
            raise jobs_lib.JobError(
                f"z_range=[{z_lo}, {z_hi}] must satisfy 0 <= lo < hi"
            )
    z_pages = _parse_z_pages(job)
    sources = []
    try:
        for p_ in paths:
            try:
                sources.append(VolumeSequence(p_, z=z_pages))
            except ValueError as e:
                raise jobs_lib.JobError(
                    f"job {job.id}: cannot read inputs: {e}"
                )
        sources = [_apply_frame_range(job, s) for s in sources]
        if len({(len(s), s.spatial) for s in sources}) != 1:
            raise jobs_lib.JobError(
                "channels disagree in length/shape: "
                + str([(len(s), s.spatial) for s in sources])
            )
        n_planes = sources[0].spatial[0]
        if z_range is not None and z_hi > n_planes:
            raise jobs_lib.JobError(
                f"z_range=[{z_lo}, {z_hi}] exceeds the volumes' "
                f"{n_planes} planes"
            )
        if z_range is None:
            z_lo, z_hi = 0, n_planes
    except BaseException:
        for s in sources:
            s.close()
        raise

    timer = PhaseTimer()
    t0 = time.time()
    n_vols = len(sources[0])
    offset = sources[0].frame_offset
    compression = _out_compression(job)
    keeps_dtype = proj_lib.METHODS[method]
    rep = jobs_lib.ProgressReporter(job, n_vols * len(sources))
    best_rows = []  # (t, channel, best_z) rows for best_focus

    def _prefetch(out):
        proj, aux = out
        if method in ("best_focus", "edof"):
            aux = infer_lib._copy_to_host_async(aux)
        return infer_lib._copy_to_host_async(proj), aux

    outputs: Dict[str, str] = {}
    try:
        for ch, src in enumerate(sources):
            one = len(sources) == 1
            out_path = os.path.join(
                job.output,
                "projected.tif" if one else f"projected_c{ch}.tif",
            )
            out_dtype = np.dtype(src.dtype if keeps_dtype else np.float32)
            _, h, w = src.spatial
            est = float(n_vols) * h * w * out_dtype.itemsize
            writer = _append_writer(out_path, est, compression)
            hwriter = None
            if save_height:
                h_path = os.path.join(
                    job.output,
                    "height.tif" if one else f"height_c{ch}.tif",
                )
                hwriter = _append_writer(h_path, est, compression)

            def volumes(src=src):
                for t in range(n_vols):
                    yield src.volume(t)[z_lo:z_hi]

            t_idx = 0
            with src, writer:
                try:
                    for proj, aux in infer_lib.stream_frames(
                        project,
                        _reads_fail_fast(job, volumes()),
                        prefetch_host=_prefetch,
                        device=device,
                    ):
                        with timer.phase("write"):
                            writer.append(
                                np.asarray(proj).astype(
                                    out_dtype, copy=False
                                )
                            )
                            if method == "best_focus":
                                # best_z is relative to z_range's origin
                                best_rows.append((
                                    t_idx + offset, ch,
                                    int(np.asarray(aux)) + z_lo,
                                ))
                            if hwriter is not None:
                                hwriter.append(
                                    (np.asarray(aux) + z_lo).astype(
                                        np.uint16
                                    )
                                )
                        rep.step()
                        t_idx += 1
                except BaseException:
                    # discard the partial height file too (the main
                    # writer's own __exit__ aborts); close() would
                    # COMMIT a truncated stack into place
                    if hwriter is not None:
                        hwriter.abort()
                    raise
                if hwriter is not None:
                    hwriter.close()
            outputs["projected" if one else f"projected_c{ch}"] = out_path
            if save_height:
                outputs["height" if one else f"height_c{ch}"] = h_path
    finally:
        for s in sources:
            s.close()
    if method == "best_focus":
        csv_path = os.path.join(job.output, "projection.csv")
        with open(csv_path + ".tmp", "w") as f:
            f.write("t,channel,best_z\n")
            for t, ch, z in sorted(best_rows):
                f.write(f"{t},{ch},{z}\n")
        os.replace(csv_path + ".tmp", csv_path)
        outputs["projection"] = csv_path
    rep.finish()
    metrics = dict(
        timer.summary(), total_s=round(time.time() - t0, 4),
        n_frames=n_vols, n_channels=len(sources), method=method,
    )
    outputs["metrics"] = json.dumps(metrics)
    return outputs
