"""Instance segmentation: ``segment_flows`` (2D and volumetric),
``segment_stars`` and their evaluators ``evaluate_flows`` (2D and
volumetric) and ``evaluate_stars``.

Port of the serving jobs of ``sequitr_tpu.server.pipelines.instances``: the
same job JSON, params and outputs (``labels.tif`` as uint16 with ids
renumbered 1..N per frame, or one ``labels_t{t:04d}.tif`` a timepoint for a
``dims == 3`` flows model; ``objects.h5`` / ``objects.csv``; ``prob.tif``
under ``save_prob``; ``frames_per_sec`` / ``volumes_per_sec`` in the
metrics). The regular work (normalize, tiled forward, stitch, and for flows
the flow integration) runs on ``config.device``, the card unless the server
runs on the CPU; the irregular work stays on the host as in the JAX
package: the sink grouping (``ops.flows.group_sinks``) and the polygon NMS
(``ops.stardist.instances_from_rays``). The evaluators serve exactly as
their serving twins and score on the host: truth ids renumbered densely,
Hungarian IoU matching (``ops.flows.match_instances``), AP pooled over the
whole stack. The training jobs ``train_flows`` (2D and volumetric) and
``train_stars`` build their shards on the host (targets per full frame or
volume, foreground-biased crops, the JAX jobs' bytes) and train on
``config.device`` (``pipeline.fit.fit_flows`` / ``fit_stars``),
registering kinds ``flows`` and ``stars``.
"""

from __future__ import annotations

import glob as glob_lib
import json
import os
import time
from typing import Dict

import numpy as np

from sequitr_tpu_torch.config import ServerConfiguration
from sequitr_tpu_torch.server import jobs as jobs_lib
from sequitr_tpu_torch.server.jobs import Job
from sequitr_tpu_torch.server.server import (
    _append_writer,
    _apply_frame_range,
    _apply_roi,
    _check_truth_shape,
    _n_devices,
    _out_compression,
    _parse_z_pages,
    _reads_fail_fast,
    _require_model,
    _require_polyphase_model,
    _resolve_inputs,
    _tile_config,
    _truth_reader,
    register,
)
from sequitr_tpu_torch.utils import resolve_device


def _stream(job: Job, device, fn, frames):
    """Frames through ``fn(frame) -> (a, b)`` two ahead, both outputs
    starting their copy to the host as soon as they are queued."""
    from sequitr_tpu_torch.pipeline import infer as infer_lib

    def prefetch_host(out):
        return tuple(infer_lib._copy_to_host_async(t) for t in out)

    return infer_lib.stream_frames(
        fn, _reads_fail_fast(job, frames), prefetch_host=prefetch_host, device=device
    )


class _FramePass:
    """The device pass of a serving job: ``pass_(frame)`` runs
    ``make(device)(model, frame)`` on the job's device; ``sharded()`` is
    the same pass over a chunk of frames with one frame a device of the
    pool (``parallel.make_dp_frame_inferrer``), the outputs stacked."""

    def __init__(self, model, make, device):
        self.model, self.make, self.device = model, make, device
        self.fn = make(device)

    def __call__(self, frame):
        return self.fn(self.model, frame)

    def sharded(self):
        from sequitr_tpu_torch import parallel

        dp = parallel.make_dp_frame_inferrer(
            lambda dev: parallel.mesh.frame_by_frame(self.make(dev)), parallel.make_mesh(device=self.device)
        )
        return lambda chunk: dp(self.model, chunk)


def _flows_serving(job: Job, config: ServerConfiguration, spatial, n_channels, device):
    """Shared setup of the flow-field serving jobs: load the ``flows`` model,
    build the tile config, and return ``(segment, group)``: the device pass
    ``segment(frame) -> (final, prob)`` (``infer.cached_flows_segmenter``)
    and the host sink grouping ``group(final_np, prob_np) -> labels``.
    A 3-axis ``spatial`` with a ``dims == 3`` model serves whole volumes."""
    from sequitr_tpu_torch.ops import flows as flows_ops
    from sequitr_tpu_torch.pipeline import infer as infer_lib

    dims = len(spatial)
    cfg, model = _require_model(job, config, "flows")
    if cfg.dims != dims:
        raise jobs_lib.JobError(
            f"job {job.id}: model is {cfg.dims}D, expected {dims}D"
        )
    if cfg.in_channels != n_channels:
        raise jobs_lib.JobError(
            f"model expects {cfg.in_channels} channel(s), "
            f"got {n_channels} input stack(s)"
        )
    p = job.params
    if int(p.get("tta", 1)) != 1:
        raise jobs_lib.JobError(
            "tta is unsupported for flow-field serving (vector outputs "
            "need component-aware flips); use tta: 1"
        )
    tc = _tile_config(
        p, dims=dims,
        frame_spatial=spatial, min_multiple=cfg.min_input_multiple,
        exact_only=True, allow_polyphase=True,
    )
    if tc.polyphase:
        _require_polyphase_model(cfg)
    thresh = float(p.get("cellprob_threshold", 0.5))

    def make(dev):
        return infer_lib.cached_flows_segmenter(
            cfg, tc, tuple(spatial), n_iter=int(p.get("n_iter", 200)),
            step_size=float(p.get("step_size", 1.0)),
            cellprob_threshold=thresh,
            # "euler" (default) or "doubling" (pointer doubling on the
            # rounded successor map: log2(n_iter) gathers)
            integrator=str(p.get("integrator", "euler")),
            device=dev,
        )

    try:
        segment = _FramePass(model, make, device)
    except ValueError as e:
        # bad patch/overlap/head combos are deterministic — never retry
        raise jobs_lib.JobError(str(e))
    min_sink = int(p.get("min_sink", 3))
    min_area = int(p.get("min_area", 15))
    snap = int(p.get("snap_radius", 3))

    def group(final_np: np.ndarray, prob_np: np.ndarray) -> np.ndarray:
        return flows_ops.group_sinks(
            final_np, prob_np > thresh,
            min_sink=min_sink, min_area=min_area, snap_radius=snap,
        )

    return segment, group


def _serve_frames(job: Job, source, device, segment, to_labels, group_phase: str):
    """The 2D body shared by ``segment_flows`` and ``segment_stars``: stream
    the frames through ``segment``, turn each frame's two outputs into an
    instance map on the host, write labels.tif (+ prob.tif) and localize.
    ``to_labels(a_np, b_np) -> (labels, prob_np)`` takes the outputs in
    ``segment``'s order and is timed as ``group_phase``."""
    from sequitr_tpu_torch import localize as loc_lib
    from sequitr_tpu_torch.utils import PhaseTimer

    timer = PhaseTimer()
    n_frames = len(source)
    do_localize = job.params.get("localize", True)
    save_prob = bool(job.params.get("save_prob"))
    min_area = int(job.params.get("min_area", 15))
    labels_path = os.path.join(job.output, "labels.tif")
    px = float(n_frames) * np.prod(source.spatial)
    comp = _out_compression(job)
    labels_w = _append_writer(labels_path, px * 2, comp)
    prob_w = (
        _append_writer(os.path.join(job.output, "prob.tif"), px * 4, comp)
        if save_prob else None
    )
    tables = []
    n_objects = 0
    n_dev = _n_devices(device)
    use_dp = bool(job.params.get("data_parallel")) and n_dev > 1
    t0 = time.time()

    def handle(t, a_np, b_np):
        nonlocal n_objects
        with timer.phase(group_phase):
            lab, prob_np = to_labels(a_np, b_np)
        n_objects += int(lab.max())
        with timer.phase("write"):
            labels_w.append(lab.astype(np.uint16, copy=False))
            if prob_w is not None:
                prob_w.append(prob_np.astype(np.float32, copy=False))
        if do_localize:
            inten = source.frame(t)
            if inten.ndim == 3:
                inten = inten.mean(axis=-1)
            with timer.phase("localize"):
                tables.append(
                    loc_lib.localize_instances_table(
                        lab, t=t + source.frame_offset,
                        intensity=inten, min_area=min_area,
                    )
                )
        rep.step()

    try:
        with source:
            rep = jobs_lib.ProgressReporter(job, n_frames)
            if use_dp:
                # frames sharded over the devices: one whole frame a device
                # a dispatch; the grouping stays per frame on the host
                results = _stream(job, device, segment.sharded(), source.chunks(n_dev))
                t = 0
                while t < n_frames:
                    with timer.phase("infer"):
                        out = next(results)
                    with timer.phase("fetch"):
                        a_np, b_np = (np.asarray(o) for o in out)
                    for k in range(min(n_dev, n_frames - t)):
                        handle(t, a_np[k], b_np[k])
                        t += 1
            else:
                results = _stream(job, device, segment, source.frames())
                for t in range(n_frames):
                    with timer.phase("infer"):
                        out = next(results)
                    with timer.phase("fetch"):
                        a_np, b_np = (np.asarray(o) for o in out)
                    handle(t, a_np, b_np)
            rep.finish()
    except BaseException:
        labels_w.abort()
        if prob_w is not None:
            prob_w.abort()
        raise
    labels_w.close()
    if prob_w is not None:
        prob_w.close()

    total_s = time.time() - t0
    metrics = dict(
        timer.summary(), n_frames=n_frames, n_objects=n_objects,
        total_s=round(total_s, 4), device=str(device),
    )
    if total_s > 0:
        metrics["frames_per_sec"] = round(n_frames / total_s, 3)
    outputs: Dict[str, str] = {
        "labels": labels_path, "metrics": json.dumps(metrics),
    }
    if prob_w is not None:
        outputs["prob"] = os.path.join(job.output, "prob.tif")
    if do_localize:
        h5_path = os.path.join(job.output, "objects.h5")
        loc_lib.export_btrack_h5_tables(
            h5_path, tables, n_frames=source.frame_offset + n_frames
        )
        outputs["objects"] = h5_path
        if job.params.get("save_objects_csv"):
            csv_path = os.path.join(job.output, "objects.csv")
            loc_lib.export_objects_csv(csv_path, tables)
            outputs["objects_csv"] = csv_path
    return outputs


def _frame_source(job: Job):
    from sequitr_tpu_torch.data.source import FrameSource

    try:
        source = FrameSource(paths=_resolve_inputs(job))
    except ValueError as e:
        raise jobs_lib.JobError(f"job {job.id}: cannot read inputs: {e}")
    return _apply_roi(job, _apply_frame_range(job, source))


@register("segment_flows")
def segment_flows(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Flow-field INSTANCE segmentation of a (T, H, W) TIFF stack.

    Every foreground pixel follows the predicted flow to its cell's sink on
    the device; sinks group into instances on the host, so touching cells
    come out as separate labels. input: one TIFF per channel. params: model,
    the tiling params (patch, overlap, normalize, p_lo/p_hi, polyphase),
    frame range / roi, ``n_iter`` / ``step_size`` / ``integrator``
    (``euler`` or ``doubling``), ``cellprob_threshold``, ``min_sink`` /
    ``min_area`` / ``snap_radius`` (sink grouping), ``save_prob``,
    ``localize`` (default true), ``data_parallel`` (2D: one frame a device
    of the pool).
    Outputs: labels.tif (uint16, ids renumbered 1..N per frame), objects.h5
    (btrack layout), optionally prob.tif.

    A ``dims == 3`` model routes to the volumetric branch: ONE
    volume-sequence entry (per-timepoint z-stack files, or one file with
    the ``z`` pages-per-volume param), 3D instances per timepoint,
    ``labels_t{t:04d}.tif`` a timepoint and one objects.h5 with per-object
    z centroids.
    """
    device = resolve_device(config.device)
    paths = _resolve_inputs(job)
    cfg_probe, _ = _require_model(job, config, "flows")
    if cfg_probe.dims == 3:
        return _segment_flows_volumes(job, config, paths, device)
    source = _frame_source(job)
    segment, group = _flows_serving(job, config, source.spatial, source.n_channels, device)
    return _serve_frames(
        job, source, device, segment,
        lambda final_np, prob_np: (group(final_np, prob_np), prob_np), "group",
    )


def _segment_flows_volumes(job: Job, config: ServerConfiguration, paths, device) -> Dict[str, str]:
    """Volumetric branch of ``segment_flows`` (``dims == 3`` models): one
    whole (Z, H, W) volume a dispatch (trilinear integration on the device),
    3D sink grouping on the host, per-timepoint label volumes and ONE
    objects.h5 with per-object z centroids."""
    from sequitr_tpu_torch import localize as loc_lib
    from sequitr_tpu_torch.data import tiff
    from sequitr_tpu_torch.data.source import VolumeSequence
    from sequitr_tpu_torch.utils import PhaseTimer

    if job.params.get("roi") is not None:
        raise jobs_lib.JobError(
            "roi serving is 2D-only (crop the volume upstream)"
        )
    if len(paths) != 1:
        raise jobs_lib.JobError(
            f"3D segment_flows takes ONE volume-sequence entry (the model "
            f"is single-channel), got {len(paths)}"
        )
    try:
        source = VolumeSequence(paths[0], z=_parse_z_pages(job))
    except ValueError as e:
        raise jobs_lib.JobError(f"job {job.id}: cannot read inputs: {e}")
    try:
        source = _apply_frame_range(job, source)
        segment, group = _flows_serving(job, config, source.spatial, 1, device)
    except BaseException:
        source.close()
        raise

    timer = PhaseTimer()
    n_vols = len(source)
    do_localize = job.params.get("localize", True)
    save_prob = bool(job.params.get("save_prob"))
    min_area = int(job.params.get("min_area", 15))
    comp = _out_compression(job)
    tables = []
    n_objects = 0
    rep = jobs_lib.ProgressReporter(job, n_vols, phase="volumes")
    t0 = time.time()
    # each timepoint's file is written whole on its own: a failure midway
    # leaves only complete per-timepoint volumes
    with source:
        results = _stream(job, device, segment, source.volumes())
        for t in range(n_vols):
            with timer.phase("infer"):
                final, prob = next(results)
            with timer.phase("fetch"):
                final_np = np.asarray(final)
                prob_np = np.asarray(prob)
            with timer.phase("group"):
                lab = group(final_np, prob_np)
            n_objects += int(lab.max())
            t_abs = t + source.frame_offset
            with timer.phase("write"):
                lp = os.path.join(job.output, f"labels_t{t_abs:04d}.tif")
                tiff.write_stack(lp, lab.astype(np.uint16, copy=False), compression=comp)
                if save_prob:
                    tiff.write_stack(
                        os.path.join(job.output, f"prob_t{t_abs:04d}.tif"),
                        prob_np.astype(np.float32, copy=False),
                        compression=comp,
                    )
            if do_localize:
                with timer.phase("localize"):
                    tables.append(
                        loc_lib.localize_instances_table(
                            lab, t=t_abs,
                            intensity=np.asarray(source.volume(t), np.float32),
                            min_area=min_area,
                        )
                    )
            rep.step()
        rep.finish()

    total_s = time.time() - t0
    metrics = dict(
        timer.summary(), n_volumes=n_vols, n_objects=n_objects,
        total_s=round(total_s, 4), device=str(device),
    )
    if total_s > 0:
        metrics["volumes_per_sec"] = round(n_vols / total_s, 3)
    outputs: Dict[str, str] = {
        "labels": os.path.join(job.output, "labels_t*.tif"),
        "metrics": json.dumps(metrics),
    }
    if save_prob:
        outputs["prob"] = os.path.join(job.output, "prob_t*.tif")
    if do_localize:
        h5_path = os.path.join(job.output, "objects.h5")
        loc_lib.export_btrack_h5_tables(
            h5_path, tables, n_frames=source.frame_offset + n_vols
        )
        outputs["objects"] = h5_path
        if job.params.get("save_objects_csv"):
            csv_path = os.path.join(job.output, "objects.csv")
            loc_lib.export_objects_csv(csv_path, tables)
            outputs["objects_csv"] = csv_path
    return outputs


def _match_scores(job: Job):
    """``(add, finish)``: ``add(truth, pred)`` matches one frame's (or
    volume's) instances and pools the counts; ``finish(metrics)`` adds the
    pooled AP at ``thresholds`` (default 0.5, 0.75, 0.9), the mean matched
    IoU, the counts, and the per-item ap50 series (``per_frame``) to
    ``metrics``. Pooled counts: AP over the whole stack, not a mean of
    per-frame APs (a frame with one cell would weigh as much as one with
    hundreds)."""
    from sequitr_tpu_torch.ops import flows as flows_ops

    thresholds = tuple(
        float(v) for v in job.params.get("thresholds", (0.5, 0.75, 0.9))
    )
    tp = {t: 0 for t in thresholds}
    tot = {"gt": 0, "pred": 0, "iou_sum": 0.0, "iou_n": 0}
    per_frame = [] if job.params.get("per_frame") else None

    def add(truth_t, lab):
        # renumber truth ids densely (match_instances indexes by max id;
        # sparse ids from cropped stacks stay cheap)
        ids = np.unique(truth_t[truth_t > 0])
        if ids.size:
            remap = np.zeros(int(ids.max()) + 1, dtype=np.int64)
            remap[ids] = np.arange(1, ids.size + 1)
            truth_t = remap[np.maximum(truth_t, 0)]
        ious, n_gt, n_pred = flows_ops.match_instances(truth_t, lab)
        tot["gt"] += n_gt
        tot["pred"] += n_pred
        for th in thresholds:
            tp[th] += int((ious >= th).sum())
        good = ious[ious >= 0.5]
        tot["iou_sum"] += float(good.sum())
        tot["iou_n"] += int(good.size)
        if per_frame is not None:
            m_tp = int((ious >= 0.5).sum())
            denom = n_gt + n_pred - m_tp
            per_frame.append(round(m_tp / denom, 6) if denom else None)

    def finish(metrics: dict, per_key: str) -> dict:
        metrics.update(
            n_gt=tot["gt"], n_pred=tot["pred"],
            mean_matched_iou=(
                round(tot["iou_sum"] / tot["iou_n"], 6) if tot["iou_n"] else 0.0
            ),
        )
        for th in thresholds:
            denom = tot["gt"] + tot["pred"] - tp[th]
            metrics[f"ap{int(round(th * 100))}"] = (
                round(tp[th] / denom, 6) if denom else 1.0
            )
        if per_frame is not None:
            metrics[per_key] = per_frame
        return metrics

    return add, finish


def _score_instances(job: Job, source, read_truth, pred_labels) -> Dict[str, str]:
    """Pooled instance-AP scoring loop shared by the 2D evaluators
    (``evaluate_flows``, ``evaluate_stars``): ``pred_labels`` yields one
    host instance map a source frame, ``read_truth(t)`` the truth at
    ABSOLUTE frame ``t``. Honors ``thresholds``, ``per_frame`` and
    ``save_labels``; owns the progress reporter and the labels writer."""
    n_frames = len(source)
    labels_w = (
        _append_writer(
            os.path.join(job.output, "labels.tif"),
            float(n_frames) * np.prod(source.spatial) * 2,
            _out_compression(job),
        )
        if job.params.get("save_labels") else None
    )
    add, finish = _match_scores(job)
    rep = jobs_lib.ProgressReporter(job, n_frames)
    try:
        with source:
            for t in range(n_frames):
                lab = next(pred_labels)
                add(read_truth(t + source.frame_offset), lab)
                if labels_w is not None:
                    labels_w.append(lab.astype(np.uint16, copy=False))
                rep.step()
            rep.finish()
    except BaseException:
        if labels_w is not None:
            labels_w.abort()
        raise
    metrics = finish({"n_frames": n_frames}, "per_frame_ap50")
    outputs: Dict[str, str] = {"metrics": json.dumps(metrics)}
    if labels_w is not None:
        labels_w.close()
        outputs["labels"] = os.path.join(job.output, "labels.tif")
    return outputs


def _evaluate_frames(job: Job, config: ServerConfiguration, paths, device, serving) -> Dict[str, str]:
    """The 2D body of ``evaluate_flows`` and ``evaluate_stars``: the images
    (``paths[:-1]``) served by ``serving(job, config, spatial, n_channels,
    device) -> (pass, to_labels)``, scored against the truth
    (``paths[-1]``)."""
    from sequitr_tpu_torch.data.source import FrameSource

    try:
        source = FrameSource(paths=paths[:-1])
    except ValueError as e:
        raise jobs_lib.JobError(f"job {job.id}: cannot read inputs: {e}")
    source = _apply_frame_range(job, source)
    t_shape, read_truth, close_truth = _truth_reader(job, paths[-1])
    try:
        _check_truth_shape(source, t_shape)
        run, to_labels = serving(job, config, source.spatial, source.n_channels, device)

        def pred_labels():
            results = _stream(job, device, run, source.frames())
            while True:
                a, b = next(results)
                yield to_labels(np.asarray(a), np.asarray(b))

        return _score_instances(job, source, read_truth, pred_labels())
    finally:
        close_truth()


def _need_truth(job: Job, paths) -> None:
    if len(paths) < 2:
        raise jobs_lib.JobError(
            f"job {job.id}: need [image(s)..., instance labels], "
            f"got {len(paths)} input(s)"
        )


@register("evaluate_flows")
def evaluate_flows(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Score a ``flows`` model against ground-truth INSTANCE labels.

    input: [image.tif, ..., instances.tif] (the LAST path is the ground
    truth). Serves the model exactly as ``segment_flows`` would, then
    matches predicted to true instances per frame (Hungarian, IoU-optimal,
    ``ops.flows.match_instances``) and reports AP@t = TP / (TP + FP + FN)
    pooled over frames at ``thresholds`` (default [0.5, 0.75, 0.9]),
    ``mean_matched_iou`` over IoU >= 0.5 matches and the instance counts.
    params: the ``segment_flows`` serving params, ``per_frame: true`` for
    a per-frame ap50 series, ``save_labels: true`` to also write the
    predicted instance maps. On the card one quantile pass a frame.

    A ``dims == 3`` model routes to the volumetric branch: input = [image
    volume-sequence entry, instance-label volume-sequence entry] (the
    ``z`` pages-per-volume param applies to both), AP pooled over 3D
    instances across timepoints (one quantile pass a volume).
    """
    device = resolve_device(config.device)
    paths = _resolve_inputs(job)
    _need_truth(job, paths)
    cfg_probe, _ = _require_model(job, config, "flows")
    if cfg_probe.dims == 3:
        return _evaluate_flows_volumes(job, config, paths, device)
    return _evaluate_frames(job, config, paths, device, _flows_serving)


def _evaluate_flows_volumes(job: Job, config: ServerConfiguration, paths, device) -> Dict[str, str]:
    """Volumetric branch of ``evaluate_flows``: [image volume entry,
    instance-label volume entry], Hungarian AP over 3D instances pooled
    across timepoints (the 2D branch's metric contract)."""
    from sequitr_tpu_torch.data.source import VolumeSequence

    if len(paths) != 2:
        raise jobs_lib.JobError(
            f"3D evaluate_flows takes [image volumes, label volumes] "
            f"(2 entries), got {len(paths)}"
        )
    z = _parse_z_pages(job)
    try:
        source = VolumeSequence(paths[0], z=z)
        truth = VolumeSequence(paths[1], z=z)
    except ValueError as e:
        raise jobs_lib.JobError(f"job {job.id}: cannot read inputs: {e}")
    try:
        if truth.spatial != source.spatial or len(truth) < len(source):
            raise jobs_lib.JobError(
                f"image/label volume mismatch: images "
                f"{(len(source),) + tuple(source.spatial)}, labels "
                f"{(len(truth),) + tuple(truth.spatial)}"
            )
        source = _apply_frame_range(job, source)
        segment, group = _flows_serving(job, config, source.spatial, 1, device)
    except BaseException:
        source.close()
        truth.close()
        raise
    n_vols = len(source)
    add, finish = _match_scores(job)
    rep = jobs_lib.ProgressReporter(job, n_vols, phase="volumes")
    with source, truth:
        results = _stream(job, device, segment, source.volumes())
        for t in range(n_vols):
            final, prob = next(results)
            lab = group(np.asarray(final), np.asarray(prob))
            add(np.asarray(truth.volume(t + source.frame_offset), np.int64), lab)
            rep.step()
        rep.finish()
    metrics = finish({"n_volumes": n_vols}, "per_volume_ap50")
    return {"metrics": json.dumps(metrics)}


def _stars_serving(job: Job, config: ServerConfiguration, spatial, n_channels, device):
    """Shared setup of the star-convex serving jobs: load the ``stars``
    model, build the tile config, and return ``(predict, to_labels)``: the
    device pass ``predict(frame) -> (prob, dist)``
    (``infer.cached_stars_predictor``) and the host NMS and rasterization
    ``to_labels(prob_np, dist_np) -> labels``."""
    from sequitr_tpu_torch.ops import stardist as sd
    from sequitr_tpu_torch.pipeline import infer as infer_lib

    if len(spatial) != 2:
        raise jobs_lib.JobError(
            f"star-convex serving takes 2D frames, got {spatial}; "
            f"volumetric instances are served by segment_flows"
        )
    cfg, model = _require_model(job, config, "stars")
    if cfg.in_channels != n_channels:
        raise jobs_lib.JobError(
            f"model expects {cfg.in_channels} channel(s), "
            f"got {n_channels} input stack(s)"
        )
    p = job.params
    if int(p.get("tta", 1)) != 1:
        raise jobs_lib.JobError(
            "tta is unsupported for star-convex serving (per-ray outputs "
            "need permutation-aware flips); use tta: 1"
        )
    tc = _tile_config(
        p, dims=2,
        frame_spatial=spatial, min_multiple=cfg.min_input_multiple,
        exact_only=True, allow_polyphase=True,
    )
    if tc.polyphase:
        _require_polyphase_model(cfg)
    try:
        predict = _FramePass(
            model, lambda dev: infer_lib.cached_stars_predictor(cfg, tc, tuple(spatial), dev), device
        )
    except ValueError as e:
        # bad patch/overlap/head combos are deterministic — never retry
        raise jobs_lib.JobError(str(e))
    prob_thresh = float(p.get("prob_threshold", 0.5))
    nms_thresh = float(p.get("nms_threshold", 0.3))
    min_area = int(p.get("min_area", 15))
    peak_window = int(p.get("peak_window", 5))

    def to_labels(prob_np: np.ndarray, dist_np: np.ndarray) -> np.ndarray:
        return sd.instances_from_rays(
            prob_np, dist_np, prob_thresh=prob_thresh,
            nms_thresh=nms_thresh, min_area=min_area,
            peak_window=peak_window,
        )

    return predict, to_labels


@register("segment_stars")
def segment_stars(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Star-convex INSTANCE segmentation of a (T, H, W) TIFF stack.

    The device pass emits per-pixel object probability and per-ray boundary
    distances; greedy polygon NMS on the host keeps one star-convex polygon
    per cell. input: one TIFF per channel. params: model, the tiling params
    (patch, overlap, normalize, p_lo/p_hi, polyphase), frame range / roi,
    ``prob_threshold`` (default 0.5), ``nms_threshold`` (default 0.3),
    ``peak_window`` (default 5), ``min_area``, ``save_prob``, ``localize``
    (default true), ``data_parallel`` (one frame a device of the pool).
    Outputs: labels.tif
    (uint16, ids renumbered 1..N per frame), objects.h5 (btrack layout),
    optionally prob.tif.
    """
    device = resolve_device(config.device)
    source = _frame_source(job)
    predict, to_labels = _stars_serving(job, config, source.spatial, source.n_channels, device)
    return _serve_frames(
        job, source, device, predict,
        lambda prob_np, dist_np: (to_labels(prob_np, dist_np), prob_np), "nms",
    )


@register("evaluate_stars")
def evaluate_stars(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Score a ``stars`` model against ground-truth INSTANCE labels.

    input: [image.tif, ..., instances.tif] (the LAST path is the ground
    truth). Serves the model exactly as ``segment_stars`` would, then
    scores pooled instance AP (``evaluate_flows``' metrics: Hungarian
    IoU-optimal matching, AP@t = TP / (TP + FP + FN) at ``thresholds``,
    ``mean_matched_iou`` and counts). params: the ``segment_stars``
    serving params, ``per_frame``, ``save_labels``. On the card one
    quantile pass a frame.
    """
    device = resolve_device(config.device)
    paths = _resolve_inputs(job)
    _need_truth(job, paths)
    return _evaluate_frames(job, config, paths, device, _stars_serving)


# ---------------------------------------------------------------------------
# training: train_flows (2D and volumes) and train_stars
# ---------------------------------------------------------------------------


def _foreground_crop(rng, shape, patch, prob, has_fg):
    """A random ``patch`` window, retried up to 8 times until it holds
    foreground (when the frame has any)."""
    from sequitr_tpu_torch.server.pipelines.training import _crop

    for _try in range(8):
        sl = _crop(rng, shape, patch)
        if not has_fg or prob[sl].any():
            break
    return sl


def _instance_sources(job: Job, dims: int):
    """``(source, labels_src, read_img, read_lab)`` of a train_flows /
    train_stars job's [image(s)..., instance labels] inputs (``dims`` 3:
    two volume-sequence entries, ``z`` pages a volume)."""
    from sequitr_tpu_torch.data import tiff
    from sequitr_tpu_torch.data.source import FrameSource, VolumeSequence

    paths = _resolve_inputs(job)
    if len(paths) < 2:
        raise jobs_lib.JobError(
            f"job {job.id}: need [image(s)..., instance labels], "
            f"got {len(paths)} input(s)"
        )
    if dims == 3:
        if len(paths) != 2:
            raise jobs_lib.JobError(
                "train_flows dims=3 takes [image volumes, label "
                f"volumes] (2 entries), got {len(paths)}"
            )
        z = _parse_z_pages(job)
        try:
            source = VolumeSequence(paths[0], z=z)
            labels_src = VolumeSequence(paths[1], z=z)
        except ValueError as e:
            raise jobs_lib.JobError(f"job {job.id}: cannot read inputs: {e}")
        if labels_src.spatial != source.spatial or len(labels_src) < len(source):
            source.close()
            labels_src.close()
            raise jobs_lib.JobError(
                f"image/label volume mismatch: images "
                f"{(len(source),) + source.spatial}, labels "
                f"{(len(labels_src),) + labels_src.spatial}"
            )
        return source, labels_src, source.volume, lambda t: np.asarray(labels_src.volume(t), np.int64)
    try:
        source = FrameSource(paths=paths[:-1])
    except ValueError as e:
        raise jobs_lib.JobError(f"job {job.id}: cannot read inputs: {e}")
    try:
        lab_stack = np.asarray(tiff.read_stack(paths[-1]))
    except (ValueError, OSError) as e:
        raise jobs_lib.JobError(f"job {job.id}: cannot read labels: {e}")
    if lab_stack.ndim == 2:
        lab_stack = lab_stack[None]
    if lab_stack.shape[0] < len(source) or tuple(lab_stack.shape[1:]) != source.spatial:
        raise jobs_lib.JobError(
            f"image/label shape mismatch: images "
            f"{(len(source),) + source.spatial},"
            f" labels {tuple(lab_stack.shape)}"
        )
    return source, None, source.frame, lambda t: lab_stack[t].astype(np.int64)


def _instance_records(job: Job, dims: int, default_patch, targets, encode) -> int:
    """Write the job's ``records/train-*`` shards: each frame or volume
    normalized on the host, its targets (``targets(labels)`` -> (target,
    prob)) computed whole, then ``patches_per_frame`` foreground-biased
    ``patch`` crops encoded by ``encode(img, target, prob)``. Returns the
    channel count."""
    from sequitr_tpu_torch.data import records as records_lib
    from sequitr_tpu_torch.server.pipelines.training import _normalize_frame, _record_normalize

    p = job.params
    source, labels_src, read_img, read_lab = _instance_sources(job, dims)
    patch = tuple(int(v) for v in p.get("patch", default_patch))
    if len(patch) != dims or any(ps > s for s, ps in zip(source.spatial, patch)):
        source.close()
        if labels_src is not None:
            labels_src.close()
        raise jobs_lib.JobError(
            f"patch {patch} must be {dims} axes and fit the "
            f"{'volumes' if dims == 3 else 'frames'} {source.spatial}"
        )
    n_crops = int(p.get("patches_per_frame", 4))
    p_lo, p_hi = float(p.get("p_lo", 5.0)), float(p.get("p_hi", 99.5))
    norm_rec = _record_normalize(p)
    rng = np.random.default_rng(int(p.get("seed", 0)))
    n_frames = len(source)

    def gen_payloads():
        # the label volumes' handles are released however generation ends
        try:
            with source:
                for t in jobs_lib.track(job, range(n_frames), total=n_frames, phase="records"):
                    img = np.asarray(read_img(t), dtype=np.float32)
                    if norm_rec:
                        img = _normalize_frame(img, dims, p_lo, p_hi)
                    if dims == 3:
                        img = img[..., None]
                    target, prob = targets(read_lab(t))
                    has_fg = bool(prob.any())
                    for _ in range(n_crops):
                        sl = _foreground_crop(rng, img.shape[:dims], patch, prob, has_fg)
                        yield encode(img[sl], target[sl], prob[sl])
        finally:
            if labels_src is not None:
                labels_src.close()

    rec_dir = os.path.join(job.output, "records")
    os.makedirs(rec_dir, exist_ok=True)
    records_lib.write_shards(
        os.path.join(rec_dir, "train"), gen_payloads(), shard_size=int(p.get("shard_size", 128)),
    )
    return 1 if dims == 3 else source.n_channels


@register("train_flows")
def train_flows(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Train a flow-field instance segmenter (Cellpose-style).

    input: [image.tif, ..., instances.tif], the last the instance label
    stack; ``dims: 3``: [image volumes, label volumes] (volume-sequence
    entries, ``z`` pages a volume, single-channel). Flow targets are
    computed per full frame or volume on the host
    (``ops.flows.flow_targets``), then random foreground-biased ``patch``
    crops (default [64, 64], [8, 64, 64] for volumes;
    ``patches_per_frame`` 4) go into shards written once and reused on
    resume. Trains (``fit_flows``) a ``dims + 1``-channel regression head
    over the ``flows_cells`` preset (depth 3 for volumes) on
    ``config.device``. params: ``model`` (required), ``normalize``,
    ``p_lo``/``p_hi``, ``depth``, ``base_features``, ``norm``,
    ``compute_dtype``, ``polyphase``, the photometric jitters, the
    training and observability params of ``train_unet2d`` (keep_best on
    ``eval_loss``), ``ema_decay``, ``resume``, ``seed``. Registers kind
    ``flows``, served by ``segment_flows``, ``evaluate_flows`` and
    ``parity_check``.
    """
    import dataclasses

    from sequitr_tpu_torch.data import records as records_lib
    from sequitr_tpu_torch.models import zoo
    from sequitr_tpu_torch.ops import flows as flows_ops
    from sequitr_tpu_torch.pipeline import fit as fit_lib
    from sequitr_tpu_torch.server.pipelines.training import (
        _family_train_config, _fit_and_register, _fit_config, _resume_state,
    )

    device = resolve_device(config.device)
    p = job.params
    dims = int(p.get("dims", 2))
    if dims not in (2, 3):
        raise jobs_lib.JobError(f"train_flows needs dims 2 or 3, got {dims}")
    rec_dir = os.path.join(job.output, "records")
    shard_paths = sorted(glob_lib.glob(os.path.join(rec_dir, "*.tfrecord")))
    if not shard_paths:
        n_channels = _instance_records(
            job, dims, (64, 64) if dims == 2 else (8, 64, 64), flows_ops.flow_targets,
            fit_lib.encode_flow_example,
        )
        shard_paths = sorted(glob_lib.glob(os.path.join(rec_dir, "*.tfrecord")))
    else:
        first = next(records_lib.read_records(shard_paths[0]), None)
        if first is None:
            raise jobs_lib.JobError(f"job {job.id}: empty record shards in {rec_dir}")
        n_channels = fit_lib._decode_flow(first)["image"].shape[-1]

    base = zoo.get("flows_cells")
    cfg = dataclasses.replace(
        base,
        in_channels=n_channels,
        num_classes=dims + 1,  # (dy, dx[, dz]) x FLOW_SCALE + prob logit
        dims=dims,
        depth=int(p.get("depth", base.depth if dims == 2 else 3)),
        base_features=int(p.get("base_features", base.base_features)),
        norm=p.get("norm", base.norm),
        compute_dtype=str(p.get("compute_dtype", "bfloat16")),
    )
    tc = _family_train_config(p, cfg, 3e-4, jitter=True)
    fc = _fit_config(job, "eval_loss", 16, dump=False)
    init_state = _resume_state(job, cfg, tc, device)
    return _fit_and_register(
        job, config, device, "flows", cfg, tc, fc, init_state, fit_lib.fit_flows, shard_paths, rec_dir,
    )


@register("train_stars")
def train_stars(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Train a star-convex instance segmenter (StarDist-style, 2D).

    input: [image.tif, ..., instances.tif], the last the instance label
    stack. Ray-distance and normalized-EDT targets are computed per full
    frame on the host (``ops.stardist.star_targets``, ``n_rays`` 32, a
    multiple of 4; ``max_dist`` caps the march), then random
    foreground-biased ``patch`` crops (default [64, 64];
    ``patches_per_frame`` 4) go into shards written once and reused on
    resume. Trains (``fit_stars``) a ``1 + n_rays``-channel head over the
    ``stars_cells`` preset on ``config.device``. params as
    ``train_flows`` (2D only). Registers kind ``stars``, served by
    ``segment_stars``, ``evaluate_stars`` and ``parity_check``.
    """
    import dataclasses
    import logging

    from sequitr_tpu_torch.data import records as records_lib
    from sequitr_tpu_torch.models import zoo
    from sequitr_tpu_torch.ops import stardist as sd
    from sequitr_tpu_torch.pipeline import fit as fit_lib
    from sequitr_tpu_torch.server.pipelines.training import (
        _family_train_config, _fit_and_register, _fit_config, _resume_state,
    )

    device = resolve_device(config.device)
    p = job.params
    if int(p.get("dims", 2)) != 2:
        raise jobs_lib.JobError(
            "train_stars is 2D only (star-convex rays); volumetric "
            "instances train via train_flows dims: 3"
        )
    n_rays = int(p.get("n_rays", 32))
    if n_rays < 4 or n_rays % 4:
        raise jobs_lib.JobError(f"n_rays must be a positive multiple of 4, got {n_rays}")
    rec_dir = os.path.join(job.output, "records")
    shard_paths = sorted(glob_lib.glob(os.path.join(rec_dir, "*.tfrecord")))
    if not shard_paths:
        max_dist = p.get("max_dist")
        max_dist = None if max_dist is None else float(max_dist)
        logging.getLogger("sequitr_tpu_torch.server").info(
            "train_stars %s: ray march budget = %s (n_rays=%d)", job.id,
            "auto (largest instance bbox diagonal)" if max_dist is None else f"{max_dist:g} px", n_rays,
        )
        n_channels = _instance_records(
            job, 2, (64, 64),
            lambda lab: sd.star_targets(lab, n_rays=n_rays, max_dist=max_dist),
            fit_lib.encode_stars_example,
        )
        shard_paths = sorted(glob_lib.glob(os.path.join(rec_dir, "*.tfrecord")))
    else:
        first = next(records_lib.read_records(shard_paths[0]), None)
        if first is None:
            raise jobs_lib.JobError(f"job {job.id}: empty record shards in {rec_dir}")
        decoded = fit_lib._decode_stars(first)
        n_channels = decoded["image"].shape[-1]
        n_rays = decoded["dist"].shape[-1]

    base = zoo.get("stars_cells")
    cfg = dataclasses.replace(
        base,
        in_channels=n_channels,
        num_classes=1 + n_rays,  # prob logit + per-ray distances
        depth=int(p.get("depth", base.depth)),
        base_features=int(p.get("base_features", base.base_features)),
        norm=p.get("norm", base.norm),
        compute_dtype=str(p.get("compute_dtype", "bfloat16")),
    )
    tc = _family_train_config(p, cfg, 3e-4, jitter=True)
    fc = _fit_config(job, "eval_loss", 16, dump=False)
    init_state = _resume_state(job, cfg, tc, device)
    return _fit_and_register(
        job, config, device, "stars", cfg, tc, fc, init_state, fit_lib.fit_stars, shard_paths, rec_dir,
    )
