"""Optics pipelines: localization, deconvolution, illumination.

Port of ``sequitr_tpu.server.pipelines.optics``: ``localize_emitters``
(2D, volumetric ``dims: 3`` and astigmatic z), ``calibrate_astigmatism``,
``deconvolve`` (Richardson-Lucy, 2D, multi-channel, volumes and volume
timelapses) and ``correct_illumination`` (flat-field + photobleach). The
same job JSON writes the same files, CSV columns and metrics keys as the
JAX server.

The PSF jobs run ``psf`` on ``config.device``: frames and volumes go to
the device in their native dtype, streamed ``infer.stream_frames``-style
(reads and the next item's work queued ahead); a localized frame comes
back in one copy (its valid mask and fields packed), a deconvolved frame
in one. The robust threshold (median + k*MAD) is host numpy over the
host frame, as in the JAX server. ``data_parallel`` on a pool of more
than one device (``parallel.device_pool``) gives each device its own frame
(volume) a dispatch (``parallel.make_dp_localizer*``,
``make_dp_deconvolver``) and reports ``n_devices``; on one device it
streams, as the JAX server does on one chip. The illumination job's estimate pass samples
frames on the host (``ops.illumination.fit_shading`` /
``estimate_bleach_exp``, numpy); its streaming pass runs every frame
through ``ops.illumination.make_corrector`` on the device.

The two test hooks of the JAX module, ``__test_wedge__`` (never returns)
and ``__test_slow__`` (sleeps, polling the cancel marker), register only
under ``SEQUITR_TEST_WEDGE`` / ``SEQUITR_TEST_SLOW``, for the lifecycle
tests of the supervisor, drain, cancel, reclaim and recycle paths.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch

from sequitr_tpu_torch import localize as loc_lib
from sequitr_tpu_torch import parallel, psf
from sequitr_tpu_torch.config import ServerConfiguration
from sequitr_tpu_torch.data import tiff
from sequitr_tpu_torch.data.source import FrameSource, VolumeSequence
from sequitr_tpu_torch.ops import illumination as illum
from sequitr_tpu_torch.pipeline import infer as infer_lib
from sequitr_tpu_torch.server import jobs as jobs_lib
from sequitr_tpu_torch.server.jobs import Job
from sequitr_tpu_torch.server.server import (
    _append_writer,
    _apply_frame_range,
    _apply_roi,
    _dp_chunk_stream,
    _expand_inputs_entry,
    _n_devices,
    _out_compression,
    _parse_z_pages,
    _read_stack_or_fail,
    _reads_fail_fast,
    _resolve_inputs,
    _robust_threshold,
    _volume_chunks,
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


def _localize_dp(job: Job, chunks, n: int, n_dev: int, thr_abs, k_sig: float, dp, keys, emit,
                 phase: str = "chunks") -> None:
    """The data-parallel form of ``_localize_stream``: ``n_dev`` items a
    chunk (the tail padded), each item's threshold taken on the host,
    ``dp(chunk, thresholds) -> (coords, valid, fits)`` with one item a
    device of the pool, the chunk's rows back in one copy."""
    done = 0
    for chunk, n_real in _dp_chunk_stream(job, chunks, n, n_dev, phase=phase):
        chunk = np.asarray(chunk, np.float32)
        thrs = np.asarray([_robust_threshold(a, thr_abs, k_sig) for a in chunk], np.float32)
        _, valid, fits = dp(chunk, thrs)
        packed = psf.pack_valid(valid, fits, keys).cpu().numpy()  # (1 + keys, D, K)
        for k in range(n_real):
            emit(done, psf.unpack_valid(packed[:, k], keys))
            done += 1


def _localize_stream(job: Job, arrays, n: int, thr_abs, k_sig: float, fit, keys, emit, device,
                     phase: str = "frames") -> None:
    """Stream host items (frames or volumes) through ``fit`` on ``device``.

    Each item's threshold (``_robust_threshold`` over its f32 host copy)
    is taken on the reader thread as the item is read (read errors become
    deterministic JobErrors); ``fit(dev_item, thr) -> (valid, fits)`` is
    queued two items ahead of the fetch, and its mask and fields come back
    packed in one copy started right after the queueing (one sync an
    item). ``emit(k, host_fits)`` gets the valid rows of item k in order.
    """
    thresholds: deque = deque()

    def with_threshold():
        for a in _reads_fail_fast(job, iter(arrays)):
            thresholds.append(_robust_threshold(np.asarray(a, dtype=np.float32), thr_abs, k_sig))
            yield a

    def run(dev_item):
        valid, fits = fit(dev_item, thresholds.popleft())
        return psf.pack_valid(valid, fits, keys)

    packed_iter = infer_lib.stream_frames(
        run, with_threshold(), prefetch_host=infer_lib._copy_to_host_async, device=device,
    )
    for k, packed in enumerate(jobs_lib.track(job, packed_iter, total=n, phase=phase)):
        emit(k, psf.unpack_valid(np.asarray(packed), keys))


def _write_rows(f, t: int, got: dict, keys) -> int:
    """One item's emitters.csv rows (``t`` then ``keys`` at %.4f)."""
    cols = [got[c] for c in keys]
    for row in zip(*cols):
        f.write(f"{t}," + ",".join(f"{v:.4f}" for v in row) + "\n")
    return len(cols[0])


def _btrack_table(t: int, xs, ys, amps, zs=None) -> loc_lib.FrameTable:
    coords = np.zeros((len(ys), 5), dtype=np.float32)
    coords[:, 0] = t
    coords[:, 1] = xs
    coords[:, 2] = ys
    if zs is not None:
        coords[:, 3] = zs
    return loc_lib.FrameTable(
        coords=coords, area=np.ones(len(ys), np.int32), intensity_mean=np.asarray(amps, np.float32),
    )


@register("localize_emitters")
def localize_emitters_job(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Single-molecule sub-pixel emitter localization over a TIFF stack.

    No model: max-pool NMS detection + Gaussian-mask fits
    (``psf.localize_emitters``) on ``config.device``. params:
    ``threshold`` (absolute intensity) or ``threshold_sigmas`` (robust
    per-frame: median + k*MAD, default 5), ``max_peaks``,
    ``min_distance``, ``window``, ``sigma``. Outputs: emitters.csv with
    columns t,y,x,amplitude,background (sub-pixel y/x, brightest-first
    within each frame); ``btrack: true`` additionally writes objects.h5 in
    btrack's object layout.

    3D modes (both emit a z column and fill the btrack z coordinate):

    * ``dims: 3``: volumetric localization (``psf.localize_emitters_3d``)
      over a volume sequence (directory/glob = one z-stack file per
      timepoint, or one T·Z-page file with ``z`` pages-per-volume; a bare
      file is a one-volume sequence). Extra params: ``min_distance_z``,
      ``window_z``, ``sigma_z``; z in voxels.
    * ``astigmatism: <calibration>``: single-frame 3D via a
      cylindrical-lens calibration (``psf.localize_emitters_astig``): a
      calibration-JSON path, the output directory of a
      ``calibrate_astigmatism`` job, or an inline ``{qx, qy, z_range,
      window}`` dict; z in calibration units, the csv adds
      sigma_y/sigma_x. 2D frame streams only.

    ``z_scale`` (default 1.0) multiplies z only in the btrack export.
    ``data_parallel``: one card serves it single-device (output identical
    to streaming).
    """
    device = resolve_device(config.device)
    (path,) = _resolve_inputs(job)[:1]
    p = job.params
    dims = int(p.get("dims", 2))
    calib = _load_astig_calibration(job)
    if dims == 3 and calib is not None:
        raise jobs_lib.JobError(
            "astigmatism infers z from 2D frames; it does not combine "
            "with dims=3 volumetric input"
        )
    if dims == 3:
        if p.get("roi") is not None:
            raise jobs_lib.JobError("roi localization is 2D-only")
        return _localize_volume_timelapse(job, path, device)
    if dims != 2:
        raise jobs_lib.JobError(f"dims={dims} (expected 2 or 3)")

    try:
        source = FrameSource(paths=[path])
    except ValueError as e:
        raise jobs_lib.JobError(f"job {job.id}: cannot read {path}: {e}")
    source = _apply_roi(job, _apply_frame_range(job, source))

    max_peaks = int(p.get("max_peaks", 256))
    min_distance = int(p.get("min_distance", 2))
    window = int(p.get("window", 7))
    # astig: an explicit window overrides; None = the calibration's own
    astig_window = window if "window" in p else None
    sigma = float(p.get("sigma", 1.5))
    thr_abs = p.get("threshold")
    k_sig = float(p.get("threshold_sigmas", 5.0))
    want_btrack = bool(p.get("btrack"))
    z_scale = float(p.get("z_scale", 1.0))
    if calib is not None and want_btrack and "z_scale" not in p:
        job.runtime_warnings.append(
            "astigmatism z is in calibration units but btrack x/y are in "
            "pixels; set z_scale (multiplied into z for the btrack export, "
            "e.g. 1/pixel_size_nm for z in nm) so tracking gates on "
            "consistent units"
        )
    n_frames = len(source)
    n_dev = _n_devices(device) if p.get("data_parallel") else 1

    out_path = os.path.join(job.output, "emitters.csv")
    tmp = out_path + ".tmp"
    n_rows = 0
    tables = [] if want_btrack else None
    if calib is not None:
        header = "t,z,y,x,sigma_y,sigma_x,amplitude,background\n"
        keys = ["z", "y", "x", "sigma_y", "sigma_x", "amplitude", "background"]
        win = calib.window if astig_window is None else astig_window

        def fit(frame, thr):
            _, valid, fits = psf._detect_and_fit_astig(
                frame, thr, calib, max_peaks=max_peaks, min_distance=min_distance, window=win, n_grid=241,
            )
            return valid, fits
    else:
        header = "t,y,x,amplitude,background\n"
        keys = ["y", "x", "amplitude", "background"]

        def fit(frame, thr):
            _, valid, fits = psf._detect_and_fit(
                frame, thr, max_peaks=max_peaks, min_distance=min_distance, window=window, sigma=sigma,
            )
            return valid, fits

    try:
        with source, open(tmp, "w") as f:
            f.write(header)

            def emit(k, got):
                nonlocal n_rows
                t = source.frame_offset + k  # absolute frame index
                n_rows += _write_rows(f, t, got, keys)
                if tables is not None:
                    # the JAX server scales the float64 z
                    zs = got["z"].astype(np.float64) * z_scale if calib is not None else None
                    tables.append(_btrack_table(t, got["x"], got["y"], got["amplitude"], zs))

            if n_dev > 1:
                # frames sharded over the devices: one frame a device a
                # dispatch
                mesh = parallel.make_mesh(device=device)
                if calib is not None:
                    dp = parallel.make_dp_localizer_astig(
                        mesh, calib, max_peaks=max_peaks, min_distance=min_distance, window=astig_window,
                    )
                else:
                    dp = parallel.make_dp_localizer(
                        mesh, max_peaks=max_peaks, min_distance=min_distance, window=window, sigma=sigma,
                    )
                _localize_dp(job, source.chunks(n_dev), n_frames, n_dev, thr_abs, k_sig, dp, keys, emit)
            else:
                _localize_stream(job, source.frames(), n_frames, thr_abs, k_sig, fit, keys, emit, device)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    os.replace(tmp, out_path)
    outputs = {"emitters": out_path, "n_emitters": str(n_rows), "n_frames": str(n_frames)}
    if n_dev > 1:
        outputs["n_devices"] = str(n_dev)
    if tables is not None:
        h5_path = os.path.join(job.output, "objects.h5")
        loc_lib.export_btrack_h5_tables(h5_path, tables, n_frames=source.frame_offset + n_frames)
        outputs["objects"] = h5_path
    return outputs


def _load_astig_calibration(job: Job):
    """Resolve the ``astigmatism`` param to an AstigCalibration (or None):
    a calibration-JSON path, a directory holding
    ``astig_calibration.json`` (a ``calibrate_astigmatism`` job's output),
    or an inline dict."""
    astig = job.params.get("astigmatism")
    if astig is None:
        return None
    if isinstance(astig, dict):
        try:
            return psf.AstigCalibration.from_dict(astig)
        except (TypeError, ValueError) as e:
            raise jobs_lib.JobError(f"job {job.id}: bad astigmatism: {e}")
    if not isinstance(astig, str):
        raise jobs_lib.JobError(
            f"job {job.id}: astigmatism must be a calibration path or "
            f"dict, got {type(astig).__name__}"
        )
    path = astig
    if os.path.isdir(path):
        path = os.path.join(path, "astig_calibration.json")
    try:
        return psf.AstigCalibration.from_json(path)
    # TypeError: structurally wrong JSON (e.g. "qx": 1 hits len() on an int)
    except (OSError, TypeError, ValueError, json.JSONDecodeError) as e:
        raise jobs_lib.JobError(
            f"job {job.id}: cannot load astigmatism calibration "
            f"{astig!r}: {e}"
        )


def _localize_volume_timelapse(job: Job, path: str, device: torch.device) -> Dict[str, str]:
    """dims=3 body of ``localize_emitters``: volumetric detection+fitting
    per (Z, H, W) timepoint of a volume sequence; rows stream into
    emitters.csv (t,z,y,x in voxels)."""
    p = job.params
    try:
        seq = VolumeSequence(path, z=_parse_z_pages(job))
    except ValueError as e:
        raise jobs_lib.JobError(f"job {job.id}: cannot read inputs: {e}")
    seq = _apply_frame_range(job, seq)

    max_peaks = int(p.get("max_peaks", 256))
    min_distance = int(p.get("min_distance", 2))
    min_distance_z = int(p.get("min_distance_z", 1))
    window = int(p.get("window", 7))
    window_z = int(p.get("window_z", 5))
    sigma = float(p.get("sigma", 1.5))
    sigma_z = float(p.get("sigma_z", sigma))
    thr_abs = p.get("threshold")
    k_sig = float(p.get("threshold_sigmas", 5.0))
    want_btrack = bool(p.get("btrack"))
    z_scale = float(p.get("z_scale", 1.0))
    n_t = len(seq)
    n_dev = _n_devices(device) if p.get("data_parallel") else 1

    out_path = os.path.join(job.output, "emitters.csv")
    tmp = out_path + ".tmp"
    n_rows = 0
    tables = [] if want_btrack else None
    keys = ["z", "y", "x", "amplitude", "background"]

    def fit(vol, thr):
        _, valid, fits = psf._detect_and_fit_3d(
            vol, thr, max_peaks=max_peaks, min_distance=min_distance, min_distance_z=min_distance_z,
            window=window, window_z=window_z, sigma=sigma, sigma_z=sigma_z,
        )
        return valid, fits

    try:
        with open(tmp, "w") as f:
            f.write("t,z,y,x,amplitude,background\n")

            def emit(k, got):
                nonlocal n_rows
                t = seq.frame_offset + k
                n_rows += _write_rows(f, t, got, keys)
                if tables is not None:
                    tables.append(_btrack_table(t, got["x"], got["y"], got["amplitude"], got["z"] * z_scale))

            if n_dev > 1:
                # TIMEPOINTS sharded over the devices
                dp = parallel.make_dp_localizer3d(
                    parallel.make_mesh(device=device), max_peaks=max_peaks, min_distance=min_distance,
                    min_distance_z=min_distance_z, window=window, window_z=window_z,
                    sigma=sigma, sigma_z=sigma_z,
                )
                _localize_dp(job, _volume_chunks(seq, n_dev), n_t, n_dev, thr_abs, k_sig, dp, keys, emit)
            else:
                _localize_stream(job, seq.volumes(), n_t, thr_abs, k_sig, fit, keys, emit, device, phase="volumes")
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    finally:
        seq.close()
    os.replace(tmp, out_path)
    outputs = {"emitters": out_path, "n_emitters": str(n_rows), "n_frames": str(n_t)}
    if n_dev > 1:
        outputs["n_devices"] = str(n_dev)
    if tables is not None:
        h5_path = os.path.join(job.output, "objects.h5")
        loc_lib.export_btrack_h5_tables(h5_path, tables, n_frames=seq.frame_offset + n_t)
        outputs["objects"] = h5_path
    return outputs


@register("calibrate_astigmatism")
def calibrate_astigmatism_job(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Fit an astigmatic width-vs-z calibration from a bead z-scan.

    input: [bead_scan.tif], a (Z, H, W) stack of an isolated bead, one
    frame per known stage position: ``z_positions`` (list) or ``z_start``
    + ``z_step``. params: ``window`` (elliptical-fit crop, default 15),
    ``min_distance``, ``iterations``. Outputs ``astig_calibration.json``
    (the file ``localize_emitters``' ``astigmatism`` param accepts; point
    it at this job's output dir to chain with ``depends_on``) and a
    round-trip self-check: the per-plane widths inverted through the
    fitted curves (``psf.z_from_widths``), z residual RMSE in ``metrics``.
    """
    device = resolve_device(config.device)
    (path,) = _resolve_inputs(job)[:1]
    stack = _read_stack_or_fail(job, path).astype(np.float32)
    if stack.ndim != 3:
        raise jobs_lib.JobError(
            f"bead scan must be a (Z, H, W) stack, got {stack.shape}"
        )
    p = job.params
    zp = p.get("z_positions")
    if zp is not None:
        try:
            zs = np.asarray([float(v) for v in zp], dtype=np.float64)
        except (TypeError, ValueError):
            raise jobs_lib.JobError(f"bad z_positions: {zp!r}")
    elif "z_step" in p:
        try:
            z0 = float(p.get("z_start", 0.0))
            dz = float(p["z_step"])
        except (TypeError, ValueError):
            raise jobs_lib.JobError("z_start/z_step must be numbers")
        if dz == 0:
            raise jobs_lib.JobError("z_step must be nonzero")
        zs = z0 + dz * np.arange(stack.shape[0], dtype=np.float64)
    else:
        raise jobs_lib.JobError(
            "calibrate_astigmatism needs z_positions (list) or "
            "z_start + z_step"
        )
    try:
        calib, diag = psf.calibrate_astigmatism(
            stack, zs,
            window=int(p.get("window", 15)),
            min_distance=int(p.get("min_distance", 3)),
            iterations=int(p.get("iterations", 12)),
            diagnostics=True,
            device=device,
        )
    except ValueError as e:
        raise jobs_lib.JobError(f"job {job.id}: calibration failed: {e}")

    # round-trip self-check: invert the measured widths through the
    # fitted curves; the residual quantifies defocus-model adherence
    z_hat = psf.z_from_widths(diag["sigma_x"], diag["sigma_y"], calib, device=device).cpu().numpy()
    rmse = float(np.sqrt(np.mean((z_hat - diag["z"]) ** 2)))
    span = float(zs.max() - zs.min())

    out_path = os.path.join(job.output, "astig_calibration.json")
    tmp = out_path + ".tmp"
    calib.to_json(tmp)
    os.replace(tmp, out_path)
    metrics = {
        "n_planes": int(stack.shape[0]),
        "z_range": [float(zs.min()), float(zs.max())],
        "roundtrip_z_rmse": round(rmse, 4),
        "roundtrip_z_rmse_frac": round(rmse / max(span, 1e-12), 6),
    }
    return {"calibration": out_path, "metrics": json.dumps(metrics)}


def _psf_3d(p: dict, device) -> torch.Tensor:
    sigma = float(p.get("sigma", 1.5))
    return psf.gaussian_psf_3d(
        int(p.get("psf_size", 9)), int(p.get("psf_size_z", 5)), sigma, float(p.get("sigma_z", sigma * 2.0)), device,
    )


def _write_planes(path: str, got: np.ndarray, comp: str, timer) -> None:
    """A (Z, H, W) result page by page (tmp + rename, BigTIFF when large)."""
    writer = _append_writer(path, float(got.nbytes), comp)
    try:
        with timer.phase("write"):
            for plane in got:
                writer.append(plane)
    except BaseException:
        writer.abort()
        raise
    writer.close()


if os.environ.get("SEQUITR_TEST_WEDGE"):  # pragma: no cover - subprocess only
    # test hook: a pipeline that never returns, for exercising the watchdog
    # -> worker-recycle path end-to-end from a real supervisor subprocess
    @register("__test_wedge__")
    def _test_wedge(job: Job, config: ServerConfiguration):
        time.sleep(3600)


if os.environ.get("SEQUITR_TEST_SLOW"):  # pragma: no cover - subprocess only
    # test hook for the multi-worker e2e: a job slow enough to SIGKILL its
    # owner mid-run. Writes the worker's pid so the test kills exactly that
    # process; the reclaimed RE-run sees the pid file already present and
    # finishes fast (the rescue, not the sleep, is what's under test).
    @register("__test_slow__")
    def _test_slow(job: Job, config: ServerConfiguration):
        out = job.output or "."
        os.makedirs(out, exist_ok=True)
        pid_file = os.path.join(out, "worker_pid.txt")
        rerun = os.path.exists(pid_file)
        with open(pid_file, "w") as f:
            f.write(str(os.getpid()))
        end = time.time() + (0.5 if rerun else float(job.params.get("sleep", 10.0)))
        while time.time() < end:
            # poll the cancel marker like every real pipeline does between
            # frames/steps, so lifecycle tests can cancel this job too
            if jobs_lib.cancel_requested(job):
                raise jobs_lib.JobCancelled(
                    f"job {job.id} cancelled mid-sleep"
                )
            time.sleep(0.2)
        return {"rerun": str(rerun)}


@register("deconvolve")
def deconvolve_job(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Richardson-Lucy deconvolution of a TIFF stack (PSF subsystem).

    No model: ``psf.richardson_lucy`` on ``config.device`` (cuFFT on the
    card). 2D mode deconvolves each frame of a (T, H, W) stack with a
    Gaussian PSF; ``dims: 3`` treats the input as one (Z, H, W) volume
    with an anisotropic 3D PSF. params: ``iterations`` (default 20),
    ``sigma`` (in-plane PSF sigma, px, default 1.5), ``psf_size`` (default
    9), and for 3D ``sigma_z``/``psf_size_z``. Multi-channel (2D): one
    input entry per channel, each deconvolved with the shared PSF into
    ``deconvolved_c{k}.tif`` (the channels one batch of FFT calls).
    Frames stream with H2D overlap and page-append output. Outputs:
    deconvolved.tif (float32). ``data_parallel`` (2D only): one card
    serves it single-device.

    Timelapses of volumes (dims=3): a directory/glob entry or a single
    T·Z-page file with ``z`` pages-per-volume deconvolves every timepoint
    into ``deconvolved_t{t:04d}.tif``; ``frame_range`` selects timepoints.
    """
    device = resolve_device(config.device)
    paths = _resolve_inputs(job)
    path = paths[0]
    p = job.params
    iterations = int(p.get("iterations", 20))
    sigma = float(p.get("sigma", 1.5))
    psf_size = int(p.get("psf_size", 9))
    dims = int(p.get("dims", 2))
    if iterations < 1:
        raise jobs_lib.JobError(f"iterations must be >= 1, got {iterations}")

    timer = PhaseTimer()
    t0 = time.time()
    out_path = os.path.join(job.output, "deconvolved.tif")
    if dims == 3 and p.get("roi") is not None:
        raise jobs_lib.JobError("roi deconvolution is 2D-only")
    if dims == 3 and len(paths) > 1:
        raise jobs_lib.JobError(
            "multi-channel deconvolution is 2D-only (one entry per "
            "channel); deconvolve dims=3 volumes one channel per job"
        )
    if dims == 3 and p.get("data_parallel"):
        raise jobs_lib.JobError(
            "data_parallel deconvolution is 2D-only (a dims=3 volume is "
            "one fused graph; timelapses stream per timepoint)"
        )
    if dims == 3:
        z_val = _parse_z_pages(job)
        if z_val is not None or _expand_inputs_entry(path) != [path]:
            return _deconvolve_volume_timelapse(job, path, z_val, timer, t0, device)
        if job.params.get("frame_range") is not None:
            raise jobs_lib.JobError(
                "frame_range applies to 2D frame streams or volume "
                "TIMELAPSES (directory/glob or z input), not a single "
                "dims=3 volume"
            )
        vol = _read_stack_or_fail(job, path)
        if vol.ndim != 3:
            raise jobs_lib.JobError(
                f"dims=3 expects one (Z, H, W) stack, got {vol.shape}"
            )
        kernel = _psf_3d(p, device)
        with timer.phase("infer"):
            out = psf.richardson_lucy(torch.from_numpy(np.ascontiguousarray(vol)).to(device), kernel, iterations)
        with timer.phase("fetch"):
            got = out.cpu().numpy()
        _write_planes(out_path, got, _out_compression(job), timer)
        n_frames = vol.shape[0]
    else:
        try:
            source = FrameSource(paths=paths)
        except ValueError as e:
            raise jobs_lib.JobError(
                f"job {job.id}: cannot read inputs {paths}: {e}"
            )
        source = _apply_roi(job, _apply_frame_range(job, source))
        n_dev = _n_devices(device) if job.params.get("data_parallel") else 1
        n_chan = source.n_channels
        kernel = psf.gaussian_psf_2d(psf_size, sigma, device)
        n_frames = len(source)
        comp = _out_compression(job)
        est = float(n_frames) * np.prod(source.spatial) * 4
        names = ["deconvolved"] if n_chan == 1 else [f"deconvolved_c{k}" for k in range(n_chan)]
        writers = []  # opened inside the abort guard

        def write_frame(got):
            """Append one deconvolved frame, one page per channel writer."""
            chans = got[..., None] if got.ndim == 2 else got
            for k, (_n, _p, w) in enumerate(writers):
                w.append(np.ascontiguousarray(chans[..., k]))

        try:
            for name in names:
                pth = out_path if name == "deconvolved" else os.path.join(job.output, f"{name}.tif")
                writers.append((name, pth, _append_writer(pth, est, comp)))
            with source:
                if n_dev > 1:
                    # frames sharded over the devices: one frame a device a
                    # dispatch
                    dp = parallel.make_dp_deconvolver(parallel.make_mesh(device=device), kernel, iterations)
                    for chunk, n_real in _dp_chunk_stream(job, source.chunks(n_dev), n_frames, n_dev):
                        with timer.phase("infer"):
                            out = dp(np.asarray(chunk, np.float32))
                        with timer.phase("fetch"):
                            got = out.cpu().numpy()
                        with timer.phase("write"):
                            for k in range(n_real):
                                write_frame(got[k])
                else:
                    for out in jobs_lib.track(
                        job,
                        infer_lib.stream_frames(
                            lambda f: psf.richardson_lucy_frame(f, kernel, iterations),
                            _reads_fail_fast(job, source.frames()),
                            prefetch_host=infer_lib._copy_to_host_async,
                            device=device,
                        ),
                        total=n_frames,
                    ):
                        with timer.phase("fetch"):
                            got = np.asarray(out, dtype=np.float32)
                        with timer.phase("write"):
                            write_frame(got)
        except BaseException:
            for _name, _pth, w in writers:
                w.abort()
            raise
        outputs = {}
        for name, pth, w in writers:
            w.close()
            outputs[name] = pth
    total_s = time.time() - t0
    metrics = dict(timer.summary(), total_s=round(total_s, 4), n_frames=n_frames)
    if dims != 3 and n_dev > 1:
        metrics["n_devices"] = n_dev
    if total_s > 0:
        metrics["frames_per_sec"] = round(n_frames / total_s, 3)
    if dims == 3:
        outputs = {"deconvolved": out_path}
    outputs["metrics"] = json.dumps(metrics)
    return outputs


def _deconvolve_volume_timelapse(
    job: Job, path: str, z: Optional[int], timer, t0: float, device: torch.device
) -> Dict[str, str]:
    """Timelapse body of ``deconvolve`` dims=3: every (Z, H, W) timepoint
    of a volume sequence through Richardson-Lucy on ``device``, streamed
    (the next volume's read and work queued ahead of the fetch);
    per-timepoint ``deconvolved_t{t:04d}.tif`` outputs."""
    p = job.params
    iterations = int(p.get("iterations", 20))
    try:
        seq = VolumeSequence(path, z=z)
    except ValueError as e:
        raise jobs_lib.JobError(f"job {job.id}: cannot read inputs: {e}")
    seq = _apply_frame_range(job, seq)
    kernel = _psf_3d(p, device)
    comp = _out_compression(job)
    n_t = len(seq)

    def deconvolve(vol):
        with timer.phase("infer"):  # queueing the volume's work
            return psf.richardson_lucy(vol, kernel, iterations)

    try:
        for t, out in enumerate(jobs_lib.track(
            job,
            infer_lib.stream_frames(
                deconvolve,
                _reads_fail_fast(job, seq.volumes()),
                prefetch_host=infer_lib._copy_to_host_async,
                device=device,
            ),
            total=n_t, phase="volumes",
        )):
            with timer.phase("fetch"):
                got = np.asarray(out, dtype=np.float32)
            t_abs = seq.frame_offset + t
            _write_planes(os.path.join(job.output, f"deconvolved_t{t_abs:04d}.tif"), got, comp, timer)
    finally:
        seq.close()
    total_s = time.time() - t0
    metrics = dict(
        timer.summary(), total_s=round(total_s, 4), n_volumes=n_t,
        volumes_per_sec=round(n_t / max(total_s, 1e-9), 3),
    )
    return {"deconvolved": job.output, "metrics": json.dumps(metrics)}
