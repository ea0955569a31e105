"""Semantic segmentation: ``segmentation_unet2d``, ``segmentation_unet3d``,
their evaluators ``evaluate_unet2d`` / ``evaluate_unet3d``, and
``parity_check``.

Port of the jobs of ``sequitr_tpu.server.pipelines.segmentation``: the
same params and outputs (labels.tif as uint16, probs.tif under
``save_probs``, entropy.tif, objects.h5 / objects.csv; for volume
timelapses one labels_t{t:04d}.tif a timepoint and one objects.h5; the
``frames_per_sec`` / ``mvox_per_sec`` / ``volumes_per_sec`` metrics; the
evaluators' metrics JSON and JobErrors). The evaluators serve exactly as
their serving twins and score on the host (confusion matrices, as the JAX
package does). Registration happens at import time via the shared
registry in ``sequitr_tpu_torch.server.server``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from sequitr_tpu_torch import tracing
from sequitr_tpu_torch.config import ServerConfiguration
from sequitr_tpu_torch.server import jobs as jobs_lib
from sequitr_tpu_torch.server.jobs import Job
from sequitr_tpu_torch.server.server import (
    _append_writer,
    _apply_frame_range,
    _apply_roi,
    _check_truth_shape,
    _expand_inputs_entry,
    _n_devices,
    _normalized_entropy,
    _out_compression,
    _parse_eval_ignore,
    _parse_z_pages,
    _read_stack_or_fail,
    _reads_fail_fast,
    _require_model,
    _require_polyphase_model,
    _resolve_inputs,
    _run_frames,
    _spatial_ways,
    _tile_config,
    _truth_reader,
    register,
)
from sequitr_tpu_torch.utils import resolve_device


@register("segmentation_unet2d")
def segmentation_unet2d(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Tiled UNet2D segmentation of a (T, H, W) TIFF stack.

    params: model (name under models_dir), patch, overlap, window,
    normalize, p_lo, p_hi, save_probs (bool), localize (bool, default True),
    min_area, polyphase (bool, default False: serve through
    ``models.polyphase``; even patch axes, transpose-upsample models without
    model-level space-to-depth).
    Outputs: labels.tif (+ probs.tif), objects.h5 (btrack layout).
    """
    from concurrent.futures import ThreadPoolExecutor

    from sequitr_tpu_torch import localize as loc_lib
    from sequitr_tpu_torch.data.source import FrameSource
    from sequitr_tpu_torch.utils import PhaseTimer

    device = resolve_device(config.device)
    paths = _resolve_inputs(job)
    try:
        # lazy per-frame ingest: host memory stays O(frames in flight)
        source = FrameSource(paths=paths)
    except ValueError as e:
        # unreadable input is deterministic — fail fast, never retry
        raise jobs_lib.JobError(f"job {job.id}: cannot read inputs: {e}")
    source = _apply_roi(job, _apply_frame_range(job, source))

    cfg, model = _require_model(job, config, "unet")
    if cfg.in_channels != source.n_channels:
        raise jobs_lib.JobError(
            f"model expects {cfg.in_channels} channel(s), "
            f"got {source.n_channels} input stack(s)"
        )
    tc = _tile_config(
        job.params, dims=2,
        frame_spatial=source.spatial, min_multiple=cfg.min_input_multiple,
        allow_polyphase=True,
    )
    if tc.polyphase:
        # the polyphase forward covers the plain serving topology; reject
        # the rest loudly rather than silently serving the standard graph
        _require_polyphase_model(cfg)
        if job.params.get("spatial_parallel"):
            raise jobs_lib.JobError(
                "polyphase + spatial_parallel is not supported; the "
                "spatial path runs its own halo-exchange forward"
            )

    timer = PhaseTimer()
    n_frames = len(source)
    frame_offset = source.frame_offset
    tables = []  # compact per-frame localization tables (t order)
    # localization is host CPU work: one worker thread runs frame t's
    # labelling while frame t+1's outputs come back from the card
    do_localize = job.params.get("localize", True)
    save_probs = bool(job.params.get("save_probs"))
    min_area = int(job.params.get("min_area", 1))
    split_touching = bool(job.params.get("split_touching"))
    min_distance = int(job.params.get("min_distance", 5))
    labels_path = os.path.join(job.output, "labels.tif")
    probs_path = os.path.join(job.output, "probs.tif")
    # bounded: each pending future pins its frame's label + intensity arrays
    futures: deque = deque()
    max_pending = 8
    n_classes = cfg.num_classes
    px = float(n_frames) * np.prod(source.spatial)
    comp = _out_compression(job)
    labels_w = _append_writer(labels_path, px * 2, comp)
    probs_w = (
        _append_writer(
            probs_path,
            px * n_classes * np.dtype(tc.probs_dtype).itemsize,
            comp,
        )
        if save_probs else None
    )
    # per-pixel predictive uncertainty: normalized softmax entropy in [0, 1]
    save_entropy = bool(job.params.get("save_entropy"))
    if save_entropy and n_classes < 2:
        raise jobs_lib.JobError(
            "save_entropy requires a model with num_classes >= 2"
        )
    entropy_w = (
        _append_writer(
            os.path.join(job.output, "entropy.tif"), px * 4, comp
        )
        if save_entropy else None
    )
    # live progress + cooperative cancellation, checked once per frame
    rep = jobs_lib.ProgressReporter(job, n_frames)
    try:
        with ThreadPoolExecutor(max_workers=1) as pool, source:
            # each next() queues work on the card; each np.asarray waits
            # for a result's copy to the host
            results = _run_frames(cfg, tc, model, source, job, device)
            for t in range(n_frames):
                with timer.phase("infer"):
                    result = next(results)
                with timer.phase("fetch"):
                    labels_np = np.asarray(result.labels).astype(
                        np.uint16, copy=False
                    )
                with timer.phase("write"):
                    labels_w.append(labels_np)
                if probs_w is not None or entropy_w is not None:
                    with timer.phase("fetch"):
                        probs_np = np.asarray(result.probs)
                    with timer.phase("write"):
                        if probs_w is not None:
                            # page t*K + k = frame t, class k
                            for k in range(n_classes):
                                probs_w.append(probs_np[..., k])
                        if entropy_w is not None:
                            entropy_w.append(
                                _normalized_entropy(probs_np, n_classes)
                            )
                if do_localize:
                    # per-object mean intensity; channel-mean if multi-channel
                    inten = source.frame(t)
                    if inten.ndim == 3:
                        inten = inten.mean(axis=-1)
                    futures.append(
                        pool.submit(
                            tracing.bind(loc_lib.localize_frame_table), labels_np,
                            # ABSOLUTE frame index, so frame_range segments
                            # splice back into full-timelapse tracks
                            t=t + source.frame_offset,
                            intensity=inten, min_area=min_area,
                            n_classes=n_classes,
                            split_touching=split_touching,
                            min_distance=min_distance,
                        )
                    )
                    while len(futures) > max_pending:
                        with timer.phase("localize"):
                            tables.append(futures.popleft().result())
                rep.step()
            with timer.phase("localize"):
                while futures:
                    tables.append(futures.popleft().result())
            rep.finish()
        # the writers' drain of their last deflates is the job's write
        with timer.phase("write"):
            labels_w.close()
            if probs_w is not None:
                probs_w.close()
            if entropy_w is not None:
                entropy_w.close()
    except BaseException:
        labels_w.abort()
        if probs_w is not None:
            probs_w.abort()
        if entropy_w is not None:
            entropy_w.abort()
        raise

    outputs: Dict[str, str] = {}
    n_objects = sum(len(tb) for tb in tables)
    metrics = dict(timer.summary(), n_frames=n_frames, n_objects=n_objects)
    # work is queued asynchronously: throughput = frames over queue + fetch time
    total_s = timer.total("infer", "fetch")
    if total_s > 0:
        metrics["frames_per_sec"] = round(n_frames / total_s, 3)
    metrics["device"] = str(device)
    outputs["metrics"] = json.dumps(metrics)
    outputs["labels"] = labels_path
    if save_probs:
        outputs["probs"] = probs_path
        outputs["probs_layout"] = (
            f"pages=(T={n_frames})*(K={n_classes}), frame-major"
        )
    if entropy_w is not None:
        outputs["entropy"] = os.path.join(job.output, "entropy.tif")
    if do_localize:
        h5_path = os.path.join(job.output, "objects.h5")
        loc_lib.export_btrack_h5_tables(
            h5_path, tables, n_frames=frame_offset + n_frames
        )
        outputs["objects"] = h5_path
        if job.params.get("save_objects_csv"):
            csv_path = os.path.join(job.output, "objects.csv")
            loc_lib.export_objects_csv(csv_path, tables)
            outputs["objects_csv"] = csv_path
    return outputs


@register("evaluate_unet2d")
def evaluate_unet2d(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Score a registered model against ground-truth labels.

    The post-training counterpart of the train jobs' holdout eval: segment
    a stack exactly as ``segmentation_unet2d`` serves it and compare to
    provided label maps. input: [image.tif, ..., labels.tif] (one TIFF per
    channel, the LAST path is the ground truth). params: model, the usual
    tiling params, ``per_frame: true`` for a per-frame mIoU series
    (``null`` for a wholly ignored frame), ``save_labels: true`` to also
    write the predicted label maps, ``ignore_label`` (pixels carrying it
    are excluded from every metric). Outputs: ``metrics`` JSON with
    per-class IoU, mIoU, dice and pixel accuracy over the whole stack.
    """
    from sequitr_tpu_torch.data.source import FrameSource
    from sequitr_tpu_torch.ops import losses

    device = resolve_device(config.device)
    paths = _resolve_inputs(job)
    if len(paths) < 2:
        raise jobs_lib.JobError(
            f"job {job.id}: need [image(s)..., labels], got {len(paths)} input(s)"
        )
    try:
        source = FrameSource(paths=paths[:-1])
    except ValueError as e:
        raise jobs_lib.JobError(f"job {job.id}: cannot read inputs: {e}")
    source = _apply_frame_range(job, source)
    t_shape, read_truth, close_truth = _truth_reader(job, paths[-1])
    try:
        _check_truth_shape(source, t_shape)
        cfg, model = _require_model(job, config, "unet")
        if cfg.dims != 2:
            raise jobs_lib.JobError(f"job {job.id}: model is {cfg.dims}D, expected 2D")
        if cfg.in_channels != source.n_channels:
            raise jobs_lib.JobError(
                f"model expects {cfg.in_channels} channel(s), "
                f"got {source.n_channels} input stack(s)"
            )
        tc = _tile_config(
            job.params, dims=2,
            frame_spatial=source.spatial, min_multiple=cfg.min_input_multiple,
        )
        k = cfg.num_classes
        ignore = _parse_eval_ignore(job, k)
        # one (K+1, K) confusion matrix accumulates frame by frame: the
        # whole-stack metrics without holding every label map
        cm = np.zeros((k + 1, k), dtype=np.int64)
        per_frame = [] if job.params.get("per_frame") else None
        n_frames = len(source)
        labels_w = (
            _append_writer(
                os.path.join(job.output, "labels.tif"),
                float(n_frames) * np.prod(source.spatial) * 2,
                _out_compression(job),
            )
            if job.params.get("save_labels") else None
        )
        rep = jobs_lib.ProgressReporter(job, n_frames)
        try:
            with source:
                results = _run_frames(cfg, tc, model, source, job, device)
                for t in range(n_frames):
                    pred = np.asarray(next(results).labels)
                    truth_t = read_truth(t + source.frame_offset)
                    if ignore is not None:
                        keep_px = truth_t != ignore
                        fcm = losses.confusion_matrix_np(pred[keep_px], truth_t[keep_px], k)
                    else:
                        fcm = losses.confusion_matrix_np(pred, truth_t, k)
                    cm += fcm
                    if per_frame is not None:
                        if fcm.sum() == 0:
                            # a wholly ignored frame has no score: null, not
                            # a vacuous 1.0 a reader would take for perfect
                            per_frame.append(None)
                        else:
                            f_ious, _, _ = losses.metrics_from_confusion(fcm)
                            per_frame.append(round(float(np.mean(f_ious)), 6))
                    if labels_w is not None:
                        labels_w.append(pred.astype(np.uint16, copy=False))
                    rep.step()
                rep.finish()
        except BaseException:
            if labels_w is not None:
                labels_w.abort()
            raise
    finally:
        close_truth()

    ious, dices, accuracy = losses.metrics_from_confusion(cm)
    if cm.sum() == 0:
        accuracy = 1.0  # vacuous, matching miou and the 3D evaluator
    metrics = {
        "miou": round(float(np.mean(ious)), 6),
        "pixel_accuracy": round(accuracy, 6),
        "n_frames": n_frames,
    }
    for i in range(k):
        metrics[f"iou_{i}"] = round(float(ious[i]), 6)
        metrics[f"dice_{i}"] = round(float(dices[i]), 6)
    if per_frame is not None:
        metrics["per_frame_miou"] = per_frame

    outputs: Dict[str, str] = {"metrics": json.dumps(metrics)}
    if labels_w is not None:
        labels_w.close()
        outputs["labels"] = os.path.join(job.output, "labels.tif")
    return outputs


def _parity_params(job: Job, cfg, dims: int, what: str):
    """``(reference, spatial, n_probes, tolerance, rng)`` of a parity job,
    validated against the model's input multiple."""
    p = job.params
    ref = str(p.get("reference", "torch"))
    spatial = tuple(int(v) for v in p.get("spatial", (64, 64)))
    if len(spatial) != dims:
        raise jobs_lib.JobError(f"spatial {spatial} must {what}")
    if any(s % cfg.min_input_multiple for s in spatial):
        raise jobs_lib.JobError(
            f"every spatial axis of {spatial} must be divisible by "
            f"{cfg.min_input_multiple}"
        )
    n_probes = int(p.get("n_probes", 4))
    if n_probes < 1:
        raise jobs_lib.JobError(f"n_probes must be >= 1, got {n_probes}")
    tolerance = float(p.get("tolerance", 1e-3))
    rng = np.random.default_rng(int(p.get("seed", 0)))
    return ref, spatial, n_probes, tolerance, rng


def _ours(fn, device, *xs):
    """``fn``'s f32 forward (IEEE f32 on the card) on host arrays moved to
    ``device``; the result on the host."""
    import torch

    from sequitr_tpu_torch.utils import ieee_f32

    with torch.inference_mode(), ieee_f32():
        out = fn(*(torch.from_numpy(x).to(device) for x in xs))
    return out.float().cpu().numpy()


@register("parity_check")
def parity_check(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Validate a registered model against an independent re-derivation.

    After ``import-model`` lands converted weights, this job runs them
    through the port's ``UNet`` (batch norm unfolded, f32, on
    ``config.device``) AND a reference implementation in another framework
    (``reference: "torch"`` default, ``models.torch_reference``, or
    ``"keras"``, ``models.tf_reference``; both on the CPU) on random probe
    frames, reporting per-pixel deltas. params: model, ``reference``,
    ``spatial`` ([H, W] or [Z, H, W], default [64, 64]; divisible by the
    model's pooling multiple), ``n_probes`` (default 4), ``seed``.
    Outputs: metrics JSON with max/mean |dlogits| and label agreement.
    Fails (deterministically) if max |dlogits| exceeds ``tolerance``
    (default 1e-3). A ``gan`` model checks the generator and the
    discriminator (``_parity_check_gan``).
    """
    from sequitr_tpu_torch.models import convert

    kind, cfg, flat = _require_model(job, config, unfolded=True)
    device = resolve_device(config.device)
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    if kind == "gan":
        return _parity_check_gan(job, cfg32, flat, device)
    ref, spatial, n_probes, tolerance, rng = _parity_params(
        job, cfg, cfg.dims, f"have {cfg.dims} axes for this model"
    )
    probes = rng.normal(size=(n_probes,) + spatial + (cfg.in_channels,)).astype(np.float32)

    # f32 on both sides: this validates WEIGHT conversion, not bf16 drift
    ours = _ours(convert.load_flat(cfg32, flat, device=device), device, probes)
    params, state = convert.nest_flat(flat)
    try:
        if ref == "torch":
            from sequitr_tpu_torch.models import torch_reference

            model = torch_reference.build_torch_unet(cfg32)
            torch_reference.inject_weights_torch(model, cfg32, params, state)
            theirs = torch_reference.torch_forward(model, probes)
        elif ref == "keras":
            from sequitr_tpu_torch.models import tf_reference

            model = tf_reference.build_tf_unet(cfg32, spatial)
            tf_reference.inject_weights(model, cfg32, params, state)
            theirs = tf_reference.tf_forward(model, probes)
        else:
            raise jobs_lib.JobError(f"reference={ref!r} must be 'torch' or 'keras'")
    except (NotImplementedError, ImportError) as e:
        raise jobs_lib.JobError(f"reference {ref!r} unavailable: {e}")

    d = np.abs(ours - theirs)
    agree = float((np.argmax(ours, -1) == np.argmax(theirs, -1)).mean())
    metrics = {
        "reference": ref,
        "max_abs_dlogits": round(float(d.max()), 8),
        "mean_abs_dlogits": round(float(d.mean()), 8),
        "label_agreement": round(agree, 6),
        "n_probes": n_probes,
        "spatial": list(spatial),
    }
    if float(d.max()) > tolerance:
        raise jobs_lib.JobError(
            f"parity FAILED: max |dlogits| {float(d.max()):.3e} > "
            f"tolerance {tolerance:.1e} vs the {ref} reference "
            f"(metrics: {json.dumps(metrics)})"
        )
    return {"metrics": json.dumps(metrics)}


def _parity_check_gan(job: Job, cfg32, flat, device) -> Dict[str, str]:
    """GAN branch of ``parity_check``: the generator (with its output
    activation) AND the discriminator against an independent
    re-derivation (torch or keras) on identical weights."""
    from sequitr_tpu_torch.models import convert
    from sequitr_tpu_torch.models import gan as gan_lib
    from sequitr_tpu_torch.models import torch_reference

    ref = str(job.params.get("reference", "torch"))
    if ref not in ("torch", "keras"):
        raise jobs_lib.JobError(f"reference={ref!r} must be 'torch' or 'keras'")
    ref, spatial, n_probes, tolerance, rng = _parity_params(
        job, cfg32, 2, "be [H, W] (the GAN family is 2D)"
    )
    x = rng.normal(size=(n_probes,) + spatial + (cfg32.in_channels,)).astype(np.float32)
    y = rng.normal(size=(n_probes,) + spatial + (cfg32.out_channels,)).astype(np.float32)
    gcfg = cfg32.generator_config

    try:
        model = convert.load_flat(cfg32, flat, device=device)
        ours_g = _ours(lambda t: gan_lib.generator_apply(model, t), device, x)
        ours_d = _ours(lambda a, b: gan_lib.discriminator_apply(model, a, b), device, x, y)
        params, state = convert.nest_flat(flat)
        pair = np.concatenate([x, y], axis=-1)
        if ref == "torch":
            gen_model = torch_reference.build_torch_unet(gcfg)
            torch_reference.inject_weights_torch(gen_model, gcfg, params["gen"], state.get("gen", {}))
            theirs_g = torch_reference.torch_forward(gen_model, x)
            disc_model = torch_reference.build_torch_patchgan(cfg32)
            torch_reference.inject_patchgan_weights_torch(disc_model, cfg32, params)
            theirs_d = torch_reference.torch_forward(disc_model, pair)
        else:
            from sequitr_tpu_torch.models import tf_reference

            gen_model = tf_reference.build_tf_unet(gcfg, spatial)
            tf_reference.inject_weights(gen_model, gcfg, params["gen"], state.get("gen", {}))
            theirs_g = tf_reference.tf_forward(gen_model, x)
            disc_model = tf_reference.build_tf_patchgan(cfg32, spatial)
            tf_reference.inject_patchgan_weights(disc_model, cfg32, params)
            theirs_d = tf_reference.tf_forward(disc_model, pair)
        if cfg32.output_activation == "tanh":
            theirs_g = np.tanh(theirs_g)
        elif cfg32.output_activation == "sigmoid":
            theirs_g = 1.0 / (1.0 + np.exp(-theirs_g))
    except (NotImplementedError, ImportError) as e:
        raise jobs_lib.JobError(f"reference {ref!r} unavailable: {e}")

    dg = np.abs(ours_g - theirs_g)
    dd = np.abs(ours_d - theirs_d)
    metrics = {
        "reference": ref,
        "max_abs_dgen": round(float(dg.max()), 8),
        "mean_abs_dgen": round(float(dg.mean()), 8),
        "max_abs_ddisc": round(float(dd.max()), 8),
        "n_probes": n_probes,
        "spatial": list(spatial),
    }
    worst = max(float(dg.max()), float(dd.max()))
    if worst > tolerance:
        raise jobs_lib.JobError(
            f"parity FAILED: max |d| {worst:.3e} > tolerance "
            f"{tolerance:.1e} vs the torch reference "
            f"(metrics: {json.dumps(metrics)})"
        )
    return {"metrics": json.dumps(metrics)}


@register("evaluate_unet3d")
def evaluate_unet3d(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Volumetric counterpart of ``evaluate_unet2d``.

    input: [volume.tif, labels.tif] ((Z, H, W) stacks, one volume TIFF per
    channel). params: model, 3-axis tiling params, ``save_labels``,
    ``ignore_label`` (sparse ground truth excluded from every metric).
    The whole volume runs through the 3D inferrer as
    ``segmentation_unet3d`` serves it. Outputs per-class IoU/dice, mIoU and
    voxel accuracy over the volume.
    """
    import torch

    from sequitr_tpu_torch.data import tiff
    from sequitr_tpu_torch.ops import losses
    from sequitr_tpu_torch.pipeline import infer as infer_lib

    device = resolve_device(config.device)
    paths = _resolve_inputs(job)
    if len(paths) < 2:
        raise jobs_lib.JobError(
            f"job {job.id}: need [volume channel(s)..., labels], "
            f"got {len(paths)} input(s)"
        )
    vols = []
    for p_ in paths[:-1]:
        v = _read_stack_or_fail(job, p_)
        if v.ndim != 3:
            raise jobs_lib.JobError(
                f"unet3d expects (Z, H, W) stacks, got {v.shape} from {p_}"
            )
        vols.append(v)
    if len({v.shape for v in vols}) != 1:
        raise jobs_lib.JobError(
            f"channel stacks disagree in shape: {[v.shape for v in vols]}"
        )
    vol = np.stack(vols, axis=-1) if len(vols) > 1 else vols[0]
    vol_spatial = tuple(vol.shape[:3])
    truth = _read_stack_or_fail(job, paths[-1]).astype(np.int32)
    if vol_spatial != truth.shape:
        raise jobs_lib.JobError(
            f"volume/label shape mismatch: {vol_spatial} vs {truth.shape}"
        )

    cfg, model = _require_model(job, config, "unet")
    _require_3d(job, cfg, vol.shape[-1] if vol.ndim == 4 else 1, "input stack(s)")
    k = cfg.num_classes
    # validate BEFORE the volumetric inference: a bad param must not cost
    # card time first
    ignore = _parse_eval_ignore(job, k)
    tc = _tile_config(
        job.params, dims=3,
        frame_spatial=vol_spatial, min_multiple=cfg.min_input_multiple,
    )
    tc = dataclasses.replace(tc, emit_probs=False)  # segmentation_unet3d's labels-only graph
    fn = infer_lib.cached_frame_inferrer(cfg, tc, vol_spatial, device)
    _, labels = fn(model, vol)
    preds = labels.cpu().numpy().astype(np.int32)
    p_eval, t_eval = preds, truth
    if ignore is not None:
        keep_vx = truth != ignore
        p_eval, t_eval = preds[keep_vx], truth[keep_vx]
    # the scores on the host, as the JAX package computes them
    p_t, t_t = torch.from_numpy(p_eval), torch.from_numpy(t_eval)
    ious = losses.iou(p_t, t_t, k).numpy()
    dices = losses.dice(p_t, t_t, k).numpy()
    metrics = {
        "miou": round(float(np.mean(ious)), 6),
        "voxel_accuracy": round(
            float((p_eval == t_eval).mean()) if p_eval.size else 1.0, 6
        ),
    }
    for i in range(k):
        metrics[f"iou_{i}"] = round(float(ious[i]), 6)
        metrics[f"dice_{i}"] = round(float(dices[i]), 6)

    outputs: Dict[str, str] = {"metrics": json.dumps(metrics)}
    if job.params.get("save_labels"):
        out_path = os.path.join(job.output, "labels.tif")
        tiff.write_stack(out_path, preds.astype(np.uint16), compression=_out_compression(job))
        outputs["labels"] = out_path
    return outputs


def _require_3d(job: Job, cfg, n_channels: int, what: str) -> None:
    if cfg.dims != 3:
        raise jobs_lib.JobError(f"job {job.id}: model is {cfg.dims}D, expected 3D")
    if cfg.in_channels != n_channels:
        raise jobs_lib.JobError(
            f"model expects {cfg.in_channels} channel(s), got {n_channels} {what}"
        )


def _volume_tile_config(job: Job, cfg, zhw):
    """The 3D job's tiling; the inferrer computes softmax maps only when
    probs or entropy are saved (labels-only otherwise)."""
    tc = _tile_config(
        job.params, dims=3,
        frame_spatial=zhw, min_multiple=cfg.min_input_multiple,
        allow_polyphase=True,
    )
    if tc.polyphase:
        _require_polyphase_model(cfg)
    if job.params.get("save_entropy") and cfg.num_classes < 2:
        raise jobs_lib.JobError(
            "save_entropy requires a model with num_classes >= 2"
        )
    want_probs = bool(job.params.get("save_probs") or job.params.get("save_entropy"))
    return dataclasses.replace(tc, emit_probs=want_probs)


def _probs_planes(probs_np: np.ndarray) -> np.ndarray:
    """(Z, H, W, K) -> (Z*K, H, W) pages, plane-major."""
    return np.moveaxis(probs_np, -1, 1).reshape(-1, *probs_np.shape[1:3])


@register("segmentation_unet3d")
def segmentation_unet3d(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Tiled UNet3D segmentation of a (Z, H, W) volume.

    Same output contract as the 2D pipeline: labels.tif (uint16, a (Z, H, W)
    stack), optional per-class probs.tif (``save_probs``, plane-major),
    entropy.tif (``save_entropy``), and btrack objects.h5 with 3D centroids
    (``localize``, default True). Whole volumes within the 4.4 M-voxel
    budget run as one patch; larger ones tile at (16, 128, 128) / (4, 32,
    32) unless ``patch`` / ``overlap`` say otherwise. ``polyphase``: the
    (1, 2, 2) phase forward (even H/W patch axes).

    TIMELAPSES OF VOLUMES: a directory/glob input entry (one z-stack file
    per timepoint) or a single file with the ``z`` pages-per-volume param
    serves every timepoint through one cached inferrer, streamed two
    ahead — per-timepoint ``labels_t{t:04d}.tif`` (+ probs/entropy) and ONE
    ``objects.h5`` over all timepoints. ``frame_range`` selects timepoints.
    """
    from sequitr_tpu_torch import localize as loc_lib
    from sequitr_tpu_torch.data import tiff
    from sequitr_tpu_torch.pipeline import infer as infer_lib
    from sequitr_tpu_torch.utils import PhaseTimer

    device = resolve_device(config.device)
    if job.params.get("roi") is not None:
        raise jobs_lib.JobError(
            "roi serving is 2D-only (crop the volume upstream)"
        )
    # one TIFF per channel, stacked on the trailing axis
    paths = _resolve_inputs(job)
    z_param = job.params.get("z")
    # a dir/glob entry IS the timelapse convention even when it expands
    # to a single file (a 1-timepoint sequence, not a bare volume file)
    if z_param is not None or any(
        _expand_inputs_entry(p_) != [p_] for p_ in paths
    ):
        return _segment_volume_timelapse(
            job, config, paths, _parse_z_pages(job), device
        )
    # the stored dtype crosses to the card (uint16: 2 bytes a voxel)
    vols = []
    for p_ in paths:
        v = _read_stack_or_fail(job, p_)
        if v.ndim != 3:
            raise jobs_lib.JobError(
                f"unet3d expects (Z, H, W) stacks, got {v.shape} from {p_}"
            )
        vols.append(v)
    if len({v.shape for v in vols}) != 1:
        raise jobs_lib.JobError(
            f"channel stacks disagree in shape: {[v.shape for v in vols]}"
        )
    vol = np.stack(vols, axis=-1) if len(vols) > 1 else vols[0]
    vol_spatial = tuple(vol.shape[:3])

    cfg, model = _require_model(job, config, "unet")
    _require_3d(job, cfg, vol.shape[-1] if vol.ndim == 4 else 1, "input stack(s)")
    tc = _volume_tile_config(job, cfg, vol_spatial)
    if tc.polyphase and job.params.get("spatial_parallel"):
        raise jobs_lib.JobError(
            "polyphase + spatial_parallel is not supported; the "
            "spatial path runs its own halo-exchange forward"
        )

    timer = PhaseTimer()
    t0 = time.time()
    sp = job.params.get("spatial_parallel")
    n_dev = _n_devices(device)
    if sp and n_dev > 1:
        # the volume Z-sharded over the devices (plane halo exchange, the
        # whole-volume result), normalized whole first
        from sequitr_tpu_torch import parallel
        from sequitr_tpu_torch.parallel import spatial as spatial_lib

        s_ways = _spatial_ways(sp, n_dev, divide=False, tc=tc)
        mesh = parallel.make_mesh(s_ways, device=device)
        try:
            sp_fn = spatial_lib.spatial_unet3d_infer(
                cfg, mesh, vol_spatial,
                probs_dtype=tc.probs_dtype, labels_dtype=tc.labels_dtype,
            )
        except (ValueError, NotImplementedError) as e:
            # bad shape/config for sharding is deterministic — no retry
            raise jobs_lib.JobError(str(e))
        with timer.phase("infer"):
            v = torch.as_tensor(vol, device=device)
            x = infer_lib._normalize((v if v.ndim == 4 else v[..., None])[None], tc)[0]
            probs, labels = sp_fn(model, x)
    else:
        fn = infer_lib.cached_frame_inferrer(cfg, tc, vol_spatial, device)
        with timer.phase("infer"):
            probs, labels = fn(model, vol)
    with timer.phase("fetch"):
        labels_np = labels.cpu().numpy()
        probs_np = None if probs is None else probs.cpu().numpy()

    outputs: Dict[str, str] = {}
    comp = _out_compression(job)
    labels_path = os.path.join(job.output, "labels.tif")
    with timer.phase("write"):
        tiff.write_stack(labels_path, labels_np.astype(np.uint16), compression=comp)
    outputs["labels"] = labels_path
    if job.params.get("save_entropy"):
        # normalized softmax entropy per voxel (see the 2D path)
        ent = _normalized_entropy(probs_np, cfg.num_classes)
        entropy_path = os.path.join(job.output, "entropy.tif")
        tiff.write_stack(entropy_path, ent, compression=comp)
        outputs["entropy"] = entropy_path
    if job.params.get("save_probs"):
        probs_path = os.path.join(job.output, "probs.tif")
        tiff.write_stack(probs_path, _probs_planes(probs_np), compression=comp)
        outputs["probs"] = probs_path
        outputs["probs_layout"] = (
            f"pages=(Z={vol.shape[0]})*(K={probs_np.shape[-1]}), plane-major"
        )
    if job.params.get("localize", True):
        with timer.phase("localize"):
            # per-object mean intensity (f32, as read); channel-mean for
            # multi-channel input
            vol32 = vol.astype(np.float32, copy=False)
            inten = vol32.mean(axis=-1) if vol.ndim == 4 else vol32
            objects = loc_lib.localize_volume(
                labels_np, t=int(job.params.get("t", 0)), intensity=inten,
                min_area=int(job.params.get("min_area", 1)),
                split_touching=bool(job.params.get("split_touching")),
                min_distance=int(job.params.get("min_distance", 5)),
            )
            h5_path = os.path.join(job.output, "objects.h5")
            # a volume is one timepoint (t param); map has that single row
            loc_lib.export_btrack_h5(
                h5_path, objects, n_frames=int(job.params.get("t", 0)) + 1
            )
        outputs["objects"] = h5_path
        outputs["n_objects"] = str(len(objects))
        if job.params.get("save_objects_csv"):
            csv_path = os.path.join(job.output, "objects.csv")
            loc_lib.export_objects_csv(csv_path, objects)
            outputs["objects_csv"] = csv_path
    total_s = time.time() - t0
    mvox = float(np.prod(vol_spatial)) / 1e6
    outputs["metrics"] = json.dumps(
        dict(
            timer.summary(), total_s=round(total_s, 4),
            mvox_per_sec=round(mvox / max(total_s, 1e-9), 3),
            volumes_per_sec=round(1.0 / max(total_s, 1e-9), 3),
            device=str(device),
        )
    )
    return outputs


def _segment_volume_timelapse(
    job: Job,
    config: ServerConfiguration,
    paths,
    z: Optional[int],
    device,
) -> Dict[str, str]:
    """Timelapse body of ``segmentation_unet3d``: stream a sequence of
    (Z, H, W) volumes (one file per timepoint, or one T*Z-page file with
    ``z``) through one cached inferrer, two ahead (reads on a reader thread,
    host->card and card->host copies on side streams); per-timepoint labels
    (+ probs/entropy) files and a single btrack objects.h5 spanning every
    timepoint.
    """
    from sequitr_tpu_torch import localize as loc_lib
    from sequitr_tpu_torch.data import tiff
    from sequitr_tpu_torch.data.source import VolumeSequence
    from sequitr_tpu_torch.pipeline import infer as infer_lib
    from sequitr_tpu_torch.utils import PhaseTimer

    try:
        channels = [VolumeSequence(entry, z=z) for entry in paths]
    except ValueError as e:
        raise jobs_lib.JobError(f"job {job.id}: cannot read inputs: {e}")
    try:
        shapes = {c.spatial for c in channels}
        counts = {len(c) for c in channels}
        if len(shapes) != 1 or len(counts) != 1:
            raise jobs_lib.JobError(
                f"job {job.id}: channel volume sequences disagree: shapes "
                f"{sorted(shapes)}, timepoints {sorted(counts)}"
            )
        channels = [_apply_frame_range(job, c) for c in channels]
        src = channels[0]
        n_t = len(src)
        zhw = tuple(src.spatial)

        cfg, model = _require_model(job, config, "unet")
        _require_3d(job, cfg, len(channels), "input sequence(s)")
        if job.params.get("spatial_parallel"):
            raise jobs_lib.JobError(
                "spatial_parallel is single-volume only; serve a volume "
                "timelapse per-timepoint (the per-volume graph is cached "
                "across timepoints) or split the range across workers with "
                "frame_range"
            )
        tc = _volume_tile_config(job, cfg, zhw)
    except BaseException:
        for ch in channels:
            ch.close()
        raise
    timer = PhaseTimer()
    t0 = time.time()
    comp = _out_compression(job)
    save_probs = bool(job.params.get("save_probs"))
    save_entropy = bool(job.params.get("save_entropy"))
    do_localize = bool(job.params.get("localize", True))
    min_area = int(job.params.get("min_area", 1))
    split_touching = bool(job.params.get("split_touching"))
    min_distance = int(job.params.get("min_distance", 5))

    # volumes read ahead keep their host copy here for the localization's
    # intensities, in order (the reader thread appends, this loop pops)
    read: deque = deque()

    def host_volumes():
        for t in range(n_t):
            vols = [ch.volume(t) for ch in channels]
            vol = np.stack(vols, axis=-1) if len(vols) > 1 else vols[0]
            if do_localize:
                read.append(vol)
            yield vol

    fn = infer_lib.cached_frame_inferrer(cfg, tc, zhw, device)
    outputs: Dict[str, str] = {}
    all_objects = []
    results = infer_lib.infer_stack(
        fn, model, _reads_fail_fast(job, host_volumes()),
        fetch_probs=save_probs or save_entropy, device=device,
    )
    try:
        for t in jobs_lib.track(job, range(n_t), total=n_t, phase="volumes"):
            with timer.phase("infer"):
                result = next(results)
            with timer.phase("fetch"):
                labels_np = np.asarray(result.labels)
                if save_probs or save_entropy:
                    probs_np = np.asarray(result.probs)  # one copy for both uses
            t_abs = src.frame_offset + t
            with timer.phase("write"):
                lp = os.path.join(job.output, f"labels_t{t_abs:04d}.tif")
                tiff.write_stack(lp, labels_np.astype(np.uint16), compression=comp)
                if save_entropy:
                    tiff.write_stack(
                        os.path.join(job.output, f"entropy_t{t_abs:04d}.tif"),
                        _normalized_entropy(probs_np, cfg.num_classes),
                        compression=comp,
                    )
                if save_probs:
                    tiff.write_stack(
                        os.path.join(job.output, f"probs_t{t_abs:04d}.tif"),
                        _probs_planes(probs_np), compression=comp,
                    )
            if do_localize:
                with timer.phase("localize"):
                    vol = read.popleft()
                    inten = vol.mean(axis=-1) if vol.ndim == 4 else vol
                    all_objects.extend(
                        loc_lib.localize_volume(
                            labels_np, t=t_abs, intensity=inten,
                            min_area=min_area,
                            split_touching=split_touching,
                            min_distance=min_distance,
                        )
                    )
    finally:
        results.close()  # stops the reader thread
        for ch in channels:
            ch.close()
    # per-timepoint file families: the output keys point at the directory
    outputs["labels"] = job.output
    if save_entropy:
        outputs["entropy"] = job.output
    if save_probs:
        outputs["probs"] = job.output
        outputs["probs_layout"] = (
            f"per-timepoint probs_t*.tif: pages=(Z={zhw[0]})*"
            f"(K={cfg.num_classes}), plane-major"
        )
    if do_localize:
        h5_path = os.path.join(job.output, "objects.h5")
        loc_lib.export_btrack_h5(
            h5_path, all_objects, n_frames=src.frame_offset + n_t
        )
        outputs["objects"] = h5_path
        outputs["n_objects"] = str(len(all_objects))
        if job.params.get("save_objects_csv"):
            csv_path = os.path.join(job.output, "objects.csv")
            loc_lib.export_objects_csv(csv_path, all_objects)
            outputs["objects_csv"] = csv_path
    total_s = time.time() - t0
    mvox = float(np.prod(zhw)) * n_t / 1e6
    outputs["metrics"] = json.dumps(
        dict(
            timer.summary(), total_s=round(total_s, 4),
            n_volumes=n_t,
            mvox_per_sec=round(mvox / max(total_s, 1e-9), 3),
            volumes_per_sec=round(n_t / max(total_s, 1e-9), 3),
            device=str(device),
        )
    )
    return outputs
