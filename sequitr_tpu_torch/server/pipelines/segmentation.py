"""Semantic-segmentation serving: ``segmentation_unet2d``.

Port of ``sequitr_tpu.server.pipelines.segmentation.segmentation_unet2d``:
the same params and outputs (labels.tif as uint16, probs.tif under
``save_probs``, entropy.tif, objects.h5 / objects.csv, the
``frames_per_sec`` metric). Registration happens at import time via the
shared registry in ``sequitr_tpu_torch.server.server``.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from sequitr_tpu_torch.config import ServerConfiguration
from sequitr_tpu_torch.server import jobs as jobs_lib
from sequitr_tpu_torch.server.jobs import Job
from sequitr_tpu_torch.server.server import (
    _append_writer,
    _apply_frame_range,
    _apply_roi,
    _normalized_entropy,
    _out_compression,
    _require_model,
    _require_polyphase_model,
    _resolve_inputs,
    _run_frames,
    _tile_config,
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
    from collections import deque
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
                            loc_lib.localize_frame_table, labels_np,
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
    except BaseException:
        labels_w.abort()
        if probs_w is not None:
            probs_w.abort()
        if entropy_w is not None:
            entropy_w.abort()
        raise
    labels_w.close()
    if probs_w is not None:
        probs_w.close()
    if entropy_w is not None:
        entropy_w.close()

    outputs: Dict[str, str] = {}
    n_objects = sum(len(tb) for tb in tables)
    metrics = dict(timer.summary(), n_frames=n_frames, n_objects=n_objects)
    # work is queued asynchronously: throughput = frames over queue + fetch time
    total_s = sum(timer._acc.get(k, 0.0) for k in ("infer", "fetch"))
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
