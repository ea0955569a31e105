"""Optics pipelines: illumination correction.

Port of ``correct_illumination`` from ``sequitr_tpu.server.pipelines.optics``
(flat-field + photobleach). The estimate pass samples frames on the host
(``ops.illumination.fit_shading`` / ``estimate_bleach_exp``, numpy); the
streaming pass runs every frame through ``ops.illumination.make_corrector``
on ``config.device``. The same job JSON writes the same files, CSV columns
and metrics keys as the JAX server. The module's other jobs (PSF
localization, astigmatism calibration, deconvolution) are a later slice.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np
import torch

from sequitr_tpu_torch.config import ServerConfiguration
from sequitr_tpu_torch.data import tiff
from sequitr_tpu_torch.data.source import FrameSource
from sequitr_tpu_torch.ops import illumination as illum
from sequitr_tpu_torch.pipeline import infer as infer_lib
from sequitr_tpu_torch.server import jobs as jobs_lib
from sequitr_tpu_torch.server.jobs import Job
from sequitr_tpu_torch.server.server import (
    _append_writer,
    _apply_frame_range,
    _apply_roi,
    _out_compression,
    _reads_fail_fast,
    _resolve_inputs,
    register,
)
from sequitr_tpu_torch.utils import PhaseTimer, resolve_device


@register("correct_illumination")
def correct_illumination_job(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Retrospective illumination correction of a timelapse stack.

    No model required — exposes ``ops.illumination`` through the job
    API. Estimation pass: up to ``sample_frames`` evenly-spaced frames
    (random access, O(sample) reads) give a flat-field shading profile
    (per-pixel median + low-order polynomial fit — the same estimator
    mosaics use) and a photobleach model, on the host. Streaming pass:
    every frame goes to ``config.device`` in its native dtype and runs
    through the corrector (cast -> divide by shading -> per-frame median
    -> gain scale; ``ops.illumination.make_corrector``) with page-append
    float32 output, progress + cancellation like every serving pipeline.

    params: ``flatfield`` (default true), ``flatfield_order`` (total 2D
    polynomial degree, default 2), ``bleach`` ("exp" fits the
    log-median decay over the sampled frames and applies the inverse
    ramp — removes the monotone trend only; "ratio" rescales every
    frame by its OWN on-device median to the first frame's level —
    exact stationarity but erases real global dynamics; "none"),
    ``sample_frames`` (default 64, >= 2), plus the uniform
    ``frame_range`` / ``roi`` / ``compress_output``. Multi-channel: one
    input entry per channel, independent profile + bleach per channel.

    Calibrate-once / apply-many (the mosaic positions-reuse pattern):
    ``estimate_only: true`` writes shading.tif + gains.csv and skips
    the corrected stack; ``shading`` (a shading.tif path or a previous
    job's output dir, chains via ``depends_on``) applies that measured
    profile instead of re-estimating — so one blank/reference run can
    correct every subsequent acquisition round, and the profile a
    dedicated flat-field acquisition measures beats any retrospective
    estimate. Bleach is still per-run (each acquisition bleaches its
    own sample).

    Outputs: corrected.tif (float32; corrected_c{k}.tif per channel),
    shading.tif (one page per channel), gains.csv (per-frame applied
    gain + median per channel, absolute frame indices), metrics incl.
    per-channel ``bleach_rate`` (positive = decaying, per-frame log
    units). 2D-only: a volume has no single plane sharing one shading
    profile, so ``dims: 3`` is rejected loudly.
    """
    device = resolve_device(config.device)
    p = job.params
    if int(p.get("dims", 2)) != 2:
        raise jobs_lib.JobError(
            "correct_illumination is 2D-only: frames of a fixed-FoV "
            "timelapse share one shading profile; a volume does not"
        )
    mode = str(p.get("bleach", "exp"))
    if mode not in ("exp", "ratio", "none"):
        raise jobs_lib.JobError(
            f"bleach must be 'exp', 'ratio' or 'none', got {mode!r}"
        )
    use_ff = bool(p.get("flatfield", True))
    order = int(p.get("flatfield_order", 2))
    if not 1 <= order <= 6:
        raise jobs_lib.JobError(
            f"flatfield_order={order} must be in [1, 6]"
        )
    sample = int(p.get("sample_frames", 64))
    if sample < 2:
        raise jobs_lib.JobError(
            f"sample_frames must be >= 2, got {sample}"
        )
    estimate_only = bool(p.get("estimate_only", False))
    shading_src = p.get("shading")
    if shading_src is not None and not use_ff:
        raise jobs_lib.JobError(
            "shading provided but flatfield: false — a supplied profile "
            "IS the flat-field correction; drop one of the two"
        )

    paths = _resolve_inputs(job)
    try:
        source = FrameSource(paths=paths)
    except ValueError as e:
        raise jobs_lib.JobError(
            f"job {job.id}: cannot read inputs {paths}: {e}"
        )
    source = _apply_roi(job, _apply_frame_range(job, source))
    n = len(source)
    if n < 1:
        raise jobs_lib.JobError("empty input stack")
    n_chan = source.n_channels
    h, w = source.spatial

    timer = PhaseTimer()
    t0 = time.time()
    with source:
        # -- estimation pass (host, sampled) --------------------------
        # sampling is gated on what the job actually needs: the profile
        # and/or the exp fit want a spread of frames; ratio wants only
        # frame 0's median; flat-field-off + bleach-none reads nothing
        with timer.phase("estimate"):
            shading = np.ones((h, w, n_chan), np.float32)
            ref_med = np.ones(n_chan, np.float32)
            rates = np.zeros(n_chan, np.float64)
            gains_all = np.ones((n, n_chan), np.float32)
            idx = np.zeros(0, int)
            if shading_src is not None:
                # reuse a measured/previously-estimated profile: a path
                # to shading.tif, or a previous job's output dir (chains
                # via depends_on) — calibrate once, apply every round
                sp = str(shading_src)
                if os.path.isdir(sp):
                    sp = os.path.join(sp, "shading.tif")
                try:
                    prof = np.asarray(tiff.read_stack(sp), np.float32)
                except (OSError, ValueError) as e:
                    raise jobs_lib.JobError(
                        f"cannot read shading profile {sp}: {e}"
                    )
                if prof.ndim == 2:
                    prof = prof[None]
                if prof.shape != (n_chan, h, w):
                    raise jobs_lib.JobError(
                        f"shading profile {sp} is {prof.shape}, input "
                        f"needs ({n_chan}, {h}, {w}) (channels, H, W)"
                    )
                if not np.isfinite(prof).all() or prof.min() <= 0:
                    raise jobs_lib.JobError(
                        f"shading profile {sp} must be finite and > 0"
                    )
                shading = np.ascontiguousarray(
                    np.moveaxis(prof, 0, -1)
                )
            estimate_ff = use_ff and shading_src is None
            if estimate_ff or mode == "exp":
                idx = np.unique(
                    np.linspace(0, n - 1, min(sample, n)).round().astype(int)
                )
                sampled = np.stack(
                    [np.atleast_3d(source.frame(int(t))) for t in idx]
                ).astype(np.float32)  # (S, H, W, C)
                if estimate_ff:
                    for c in range(n_chan):
                        shading[:, :, c] = illum.fit_shading(
                            sampled[..., c], order=order
                        )
                corr = sampled / shading[None]
                meds = np.median(corr, axis=(1, 2))  # (S, C)
                ref_med = meds[0].astype(np.float32)  # idx includes 0
                if mode == "exp":
                    for c in range(n_chan):
                        gains_all[:, c], rates[c] = (
                            illum.estimate_bleach_exp(idx, meds[:, c], n)
                        )
            elif mode == "ratio":
                f0 = np.atleast_3d(source.frame(0)).astype(np.float32)
                f0 = f0 / shading
                ref_med = np.median(f0, axis=(0, 1)).astype(np.float32)
                idx = np.zeros(1, int)
            if mode == "ratio":
                # the corrector falls back to gain 1 on a blank
                # reference — surface that it happened, per channel
                for c in np.nonzero(ref_med <= 1e-6)[0]:
                    job.runtime_warnings.append(
                        f"ratio reference (first served frame, channel "
                        f"{c}) is blank; no bleach gain applied to that "
                        "channel"
                    )

        outputs = {}
        if estimate_only:
            # calibration-only run: write the profile + planned gains
            # (medians known only at the sampled frames); a later apply
            # job reuses them via `shading` / depends_on
            med_at = (
                {int(t): meds[s] for s, t in enumerate(idx)}
                if len(idx) and mode == "exp" else {}
            )
            nan_med = np.full(n_chan, np.nan)
            gain_rows = [
                (t + source.frame_offset, gains_all[t].astype(np.float64),
                 med_at.get(t, nan_med))
                for t in range(n)
            ]
        else:
            # -- streaming pass (device): work is queued `prefetch`
            # frames ahead while a reader thread overlaps disk ingest
            # with compute and D2H starts right after each queueing —
            # the same stream_frames shape as serving
            run = illum.make_corrector(mode)
            shading_dev = torch.from_numpy(shading).to(device)
            gains_dev = torch.from_numpy(gains_all).to(device)
            ref_dev = torch.from_numpy(ref_med).to(device)
            t_iter = iter(range(n))

            def dev_fn(frame):
                # stream_frames launches strictly in frame order, so the
                # per-frame gain row rides a closed-over index iterator
                return run(
                    frame, shading_dev, gains_dev[next(t_iter)], ref_dev
                )

            est = float(n) * h * w * 4
            comp = _out_compression(job)
            names = (
                ["corrected"]
                if n_chan == 1
                else [f"corrected_c{k}" for k in range(n_chan)]
            )
            writers = []
            gain_rows = []
            try:
                for name in names:
                    pth = os.path.join(job.output, f"{name}.tif")
                    writers.append(
                        (name, pth, _append_writer(pth, est, comp))
                    )
                frames3 = _reads_fail_fast(
                    job, (np.atleast_3d(f) for f in source.frames())
                )
                for t, (out, med, g) in enumerate(
                    jobs_lib.track(
                        job,
                        infer_lib.stream_frames(
                            dev_fn, frames3,
                            # all three outputs are fetched: D2H each
                            prefetch_host=lambda out: [
                                infer_lib._copy_to_host_async(a)
                                for a in out
                            ],
                            device=device,
                        ),
                        total=n,
                    )
                ):
                    with timer.phase("fetch"):
                        got = np.asarray(out, np.float32)
                        gain_rows.append(
                            (t + source.frame_offset,
                             np.asarray(g, np.float64),
                             np.asarray(med, np.float64))
                        )
                    with timer.phase("write"):
                        for k, (_n, _p, wtr) in enumerate(writers):
                            wtr.append(np.ascontiguousarray(got[..., k]))
            except BaseException:
                for _name, _pth, wtr in writers:
                    wtr.abort()
                raise
            for name, pth, wtr in writers:
                wtr.close()
                outputs[name] = pth

    shading_path = os.path.join(job.output, "shading.tif")
    tiff.write_stack(
        shading_path, np.ascontiguousarray(np.moveaxis(shading, -1, 0))
    )
    outputs["shading"] = shading_path
    gains_path = os.path.join(job.output, "gains.csv")
    hdr = (
        "frame,"
        + ",".join(f"gain_c{k}" for k in range(n_chan))
        + ","
        + ",".join(f"median_c{k}" for k in range(n_chan))
    )
    tmp = gains_path + ".tmp"
    with open(tmp, "w") as f:
        f.write(hdr + "\n")
        for t_abs, g, med in gain_rows:
            f.write(
                f"{t_abs},"
                + ",".join(f"{v:.6f}" for v in g)
                + ","
                + ",".join(f"{v:.6f}" for v in med)
                + "\n"
            )
    os.replace(tmp, gains_path)
    outputs["gains"] = gains_path

    total_s = time.time() - t0
    metrics = dict(
        timer.summary(), total_s=round(total_s, 4), n_frames=n,
        sample_frames=int(len(idx)), bleach=mode,
        flatfield=bool(use_ff),
        shading_min=round(float(shading.min()), 4),
        shading_max=round(float(shading.max()), 4),
    )
    for c in range(n_chan):
        metrics[f"bleach_rate_c{c}"] = round(float(rates[c]), 6)
    if total_s > 0:
        metrics["frames_per_sec"] = round(n / total_s, 3)
    outputs["metrics"] = json.dumps(metrics)
    return outputs
