"""Geometry pipelines: drift registration and mosaic stitching.

Port of ``sequitr_tpu.server.pipelines.geometry``: ``register_stack``
(FFT phase-correlation drift correction, 2D + volumetric) and
``stitch_mosaic`` (seam correlation, global solve, feathered blend,
flat-field + gain matching). The same job JSON writes the same files,
CSV columns and metrics keys as the JAX server. The FFT work runs on
``config.device`` (cuFFT on the card) through ``ops.registration`` and
``mosaic``; frames go to the device in their native dtype.

``data_parallel`` on a pool of more than one device
(``parallel.device_pool``) shards ``register_stack``'s frames
(``parallel.make_dp_registerer``) and ``stitch_mosaic``'s seams
(``parallel.make_dp_seam_correlator``) over the devices; on one device it
serves single-device, as the JAX server does on one chip. ``stitch_mosaic``'s ``backend: "cpu"`` runs the
whole stitch on the host CPU, and ``"auto"`` picks it for grids of at
most 16 seams when the server's device is a card, the JAX package's
threshold, kept so the same job JSON takes the same choice.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np

import torch

from sequitr_tpu_torch import mosaic as mosaic_lib
from sequitr_tpu_torch import parallel
from sequitr_tpu_torch.config import ServerConfiguration
from sequitr_tpu_torch.data.source import FrameSource, VolumeSequence
from sequitr_tpu_torch.ops import registration as reg_lib
from sequitr_tpu_torch.pipeline import infer as infer_lib
from sequitr_tpu_torch.server import jobs as jobs_lib
from sequitr_tpu_torch.server.jobs import Job
from sequitr_tpu_torch.server.server import (
    _append_writer,
    _apply_frame_range,
    _expand_inputs_entry,
    _n_devices,
    _out_compression,
    _parse_roi_values,
    _parse_z_pages,
    _reads_fail_fast,
    _reject_low_confidence,
    _resolve_inputs,
    register,
)
from sequitr_tpu_torch.utils import PhaseTimer, resolve_device


def _host(x) -> np.ndarray:
    """A device tensor (or an array) as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.asarray(x)


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host frame or volume on ``device`` in its native dtype."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)

@register("register_stack")
def register_stack_job(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Drift-correct a timelapse by FFT phase correlation (no model).

    Exposes ``ops.registration`` through the job API: stage drift is
    estimated frame-to-frame (or against the first frame), integrated,
    and each frame is resampled back onto a stationary field of view —
    the per-frame estimate+resample step runs on ``config.device``
    (``ops.registration.register_step``: cuFFT on the card). params:

    * ``mode``: ``"previous"`` (default) — frame-to-frame steps integrate
      into the drift trajectory (robust when the scene evolves slowly);
      ``"first"`` — every frame correlates against the stack's first
      frame (no error accumulation; needs a persistent scene).
    * ``subpixel`` (default true): Fourier-shift resample (float32
      output); false = integer ``roll`` — lossless, output keeps the
      input dtype (use for label stacks).
    * ``window`` (default true): Hann window before correlation.
    * ``refine`` (default 2): correlation passes per estimate — pass 2+
      re-correlates after shifting the frame back by the running
      estimate, collapsing the window-induced bias (measured ~10x per
      pass; registration.py module docstring). 1 = classic single-pass.
    * ``crop`` (default false): write only the common field of view
      (two passes: estimate, then apply+crop) instead of full frames
      with wrapped borders.
    * ``estimate_only`` (default false): write shifts.csv only.
    * ``frame_range``: [start, stop) as in the serving pipelines.
    * ``data_parallel`` (default false): ``first`` mode only (``previous``
      mode integrates an anchor chain serially and rejects the flag), 2D
      only: ``frame_batch`` frames a device of the pool a dispatch; on a
      pool of one device the job serves single-device.
    * ``estimate_roi`` ([y0, x0, y1, x1], 2D only): estimate the drift
      from a STABLE SUBREGION (fiducial marks, adherent patch) instead
      of the whole frame — estimation FFTs shrink to the ROI while the
      trajectory resamples FULL frames. Per-frame motion beyond half
      the ROI is unrecoverable (the mod-N period follows the
      estimation window).
    * ``frame_batch`` (default 1): frames per batched call in ``first``
      mode (``ops.registration.register_batch``) — amortizes per-call
      overhead on small frames. Output identical to streaming;
      ``previous`` mode rejects it (serial anchor chain).
    * ``dims`` (default 2): 3 = VOLUMETRIC registration of a timelapse of
      z-stacks — one multi-page TIFF per timepoint (directory/glob entry,
      natural sort), one (dz, dy, dx) estimate per volume in a single 3D
      correlation (axial focus creep included, which per-plane 2D
      registration cannot see); outputs per-timepoint
      ``registered_t{t:04d}[_c{k}].tif`` volumes and a dz/dy/dx
      shifts.csv.
    * ``z`` (dims=3 only): pages per volume for the SINGLE-FILE
      convention — one TIFF of T·Z pages (flattened hyperstack);
      timepoint t is pages [t·z, (t+1)·z), read lazily. Outputs stay
      per-timepoint files.

    * ``min_response`` (default 0 = off): confidence gate on the
      correlation peak-to-sidelobe ratio — estimates below it (blank
      frames, shutter drops, focus jumps; a healthy lock measures >~10,
      unrelated content ~5) are REJECTED: the trajectory holds at the
      last accepted shift and, in ``previous`` mode, the anchor is NOT
      re-anchored onto the bad frame, so one corrupt frame cannot derail
      the rest of the stack. Rejections stay visible (their low response
      in shifts.csv; ``n_low_confidence`` in the metrics).
    * ``align_channels`` (default false): also correct the STATIC
      inter-channel offset (chromatic aberration / dual-camera
      registration) — channel k's shift vs channel 0 is estimated as the
      median over sampled frames (<=5 in 2D; <=3 volumes in dims=3,
      where the offset is a full (dz, dy, dx) — axial chromatic shift
      included) and folded into every frame's resample (and the crop
      bounds); offsets land in the metrics. In integer mode
      (``subpixel: false``) the offsets are quantized to whole pixels
      (the roll is lossless; a sub-pixel remainder cannot be) — the
      reported offset is always the APPLIED one.

    Multi-channel (one TIFF per input entry): shifts are estimated on the
    FIRST channel and applied to every channel. Outputs:
    ``registered.tif`` (single channel) or ``registered_c{k}.tif``,
    ``shifts.csv`` (frame, dy, dx, step_dy, step_dx, response — dy/dx are
    the cumulative physical drift correction, mod-N unwrapped
    (``registration.unwrap_trajectory``; the applied wrap-resample is
    unaffected by unwrapping); response is the correlation
    peak-to-sidelobe ratio, low = unreliable lock), and drift metrics.
    """
    device = resolve_device(config.device)
    p = job.params
    mode = p.get("mode", "previous")
    if mode not in ("previous", "first"):
        raise jobs_lib.JobError(
            f"mode={mode!r} must be 'previous' or 'first'"
        )
    subpixel = bool(p.get("subpixel", True))
    window = bool(p.get("window", True))
    refine = int(p.get("refine", 2))
    if not 1 <= refine <= 8:
        raise jobs_lib.JobError(f"refine={refine} must be in [1, 8]")
    crop = bool(p.get("crop", False))
    estimate_only = bool(p.get("estimate_only", False))
    try:
        min_response = float(p.get("min_response", 0.0))
    except (TypeError, ValueError):
        raise jobs_lib.JobError(
            f"min_response={p.get('min_response')!r} must be a number"
        )
    if not 0.0 <= min_response < float("inf"):  # also catches NaN
        raise jobs_lib.JobError(
            f"min_response={min_response!r} must be a finite number >= 0"
        )
    dims = int(p.get("dims", 2))
    dp_param = bool(p.get("data_parallel"))
    if dims == 3:
        if dp_param:
            raise jobs_lib.JobError(
                "data_parallel registration is 2D-only (volume sequences "
                "are few-timepoint; shifts ride channel 0 serially)"
            )
        if p.get("estimate_roi") is not None:
            raise jobs_lib.JobError(
                "estimate_roi registration is 2D-only"
            )
        try:
            fb3 = int(p.get("frame_batch", 1) or 1)
        except (TypeError, ValueError):
            fb3 = 2  # garbage: reject via the same deterministic path
        if fb3 > 1:
            raise jobs_lib.JobError(
                "frame_batch registration is 2D-only (volume sequences "
                "are few-timepoint; one 3D correlation per dispatch)"
            )
        z = _parse_z_pages(job)
        return _register_volumes(
            job, device, mode, subpixel, window, refine, crop, estimate_only,
            z=z, min_response=min_response,
            align_channels=bool(p.get("align_channels", False)),
        )
    if dims != 2:
        raise jobs_lib.JobError(f"dims={dims} must be 2 or 3")
    if p.get("roi") is not None:
        raise jobs_lib.JobError(
            "register_stack takes estimate_roi (drift from a stable "
            "subregion; FULL frames are resampled), not roi"
        )
    if dp_param and mode != "first":
        raise jobs_lib.JobError(
            "data_parallel registration needs mode='first': 'previous' "
            "mode integrates a frame-to-frame anchor chain, which is "
            "inherently serial"
        )
    try:
        frame_batch = int(p.get("frame_batch", 1))
    except (TypeError, ValueError):
        raise jobs_lib.JobError(
            f"frame_batch={p.get('frame_batch')!r} must be an integer"
        )
    if not 1 <= frame_batch <= 256:
        raise jobs_lib.JobError(
            f"frame_batch={frame_batch} must be in [1, 256]"
        )
    if frame_batch > 1 and mode != "first":
        raise jobs_lib.JobError(
            "frame_batch needs mode='first': 'previous' mode integrates "
            "a frame-to-frame anchor chain, which is inherently serial"
        )
    use_dp = dp_param and _n_devices(device) > 1
    use_batch = use_dp or frame_batch > 1
    est_roi = p.get("estimate_roi")
    if est_roi is not None:
        est_roi = _parse_roi_values(est_roi, "estimate_roi")
    reject_stats = {"n": 0}  # min_response rejections (2D estimators)

    paths = _resolve_inputs(job)
    try:
        source = FrameSource(paths=paths)
    except ValueError as e:
        raise jobs_lib.JobError(f"job {job.id}: cannot read inputs: {e}")
    source = _apply_frame_range(job, source)
    n_frames = len(source)
    h, w = source.spatial
    timer = PhaseTimer()
    t0 = time.time()

    def estimate_frames(src, resample):
        """Per-frame (frame, cum, step, resp, corrected) via the fused
        step. ``src`` yields (H, W) or (H, W, C) frames; shifts are
        estimated on channel 0. ``resample=True`` additionally returns
        the fused on-device resample of channel 0 (None otherwise, and
        its inverse FFT never enters the graph).

        ``min_response`` confidence gate: an estimate whose PSR falls
        below it (blank frame, shutter drop, focus jump) is REJECTED —
        the trajectory holds at the last accepted shift, the anchor is
        NOT re-anchored onto the bad frame (one corrupt frame must not
        derail the rest of the stack), and the fused resample is
        discarded (the consumer re-applies the held shift)."""
        anchor = None
        cum = torch.zeros(2, dtype=torch.float32, device=device)
        zero = torch.zeros(2, dtype=torch.float32, device=device)
        held = np.zeros(2, np.float32)
        for frame in src.frames():
            ch0 = frame[..., 0] if frame.ndim == 3 else frame
            if anchor is None:
                # window sized from the frames actually served (an
                # estimate_roi source streams ROI-sized frames)
                win = reg_lib._window(ch0.shape, window, device)
                anchor = torch.fft.fftn(
                    torch.from_numpy(ch0.astype(np.float32)).to(device) * win
                )
                yield frame, zero, zero, None, None
                continue
            fft_win, new_cum, corr, step, resp = reg_lib.register_step(
                anchor, _to_device(ch0, device),
                cum if mode == "previous" else zero,
                subpixel=subpixel, window=window, refine=refine,
                resample=resample,
            )
            if _reject_low_confidence(resp, min_response, reject_stats):
                yield frame, held, np.zeros(2, np.float32), resp, None
                continue
            if mode == "previous":
                anchor, cum = fft_win, new_cum
            held = _host(new_cum)
            yield frame, new_cum, step, resp, corr

    def estimate_frames_batched(src, resample):
        """Batched form of ``estimate_frames`` (first mode only): chunks
        of ``frame_batch`` frames, one ``register_batch`` call per chunk
        (disk reads two chunks ahead). Yields the SAME per-frame tuples,
        so the consumer loops don't care which estimator ran. With
        ``data_parallel`` each device of the pool correlates (and
        resamples) its ``frame_batch`` frames of the chunk against its
        copy of the reference."""
        if use_dp:
            mesh = parallel.make_mesh(device=device)
            chunk_n = mesh.size * frame_batch
            run = parallel.make_dp_registerer(
                mesh, subpixel=subpixel, window=window, refine=refine, resample=resample,
            )
        else:
            chunk_n = frame_batch

            def run(ref_img, frames):
                return reg_lib.register_batch(
                    ref_img, frames, subpixel=subpixel, window=window,
                    refine=refine, resample=resample,
                )

        ref = None
        zero = np.zeros(2, np.float32)
        held = zero
        t, left = 0, len(src)
        for chunk in infer_lib._iter_read_ahead(
            _reads_fail_fast(job, src.chunks(chunk_n)), 2
        ):
            ch0 = chunk[..., 0] if chunk.ndim == 4 else chunk
            if ref is None:
                ref = _to_device(ch0[0], device)
            shifts, resps, corrs = run(ref, _to_device(ch0, device))
            shifts = _host(shifts)
            resps = _host(resps)
            # one bulk D2H per chunk, not one small sync per frame in
            # the write loop
            corrs = _host(corrs) if resample else None
            for k in range(min(chunk_n, left)):
                if t == 0:
                    # canonical reference-frame row: exact zeros, no
                    # response, the ORIGINAL pixels (no FFT round-trip)
                    yield chunk[0], zero, zero, None, None
                elif _reject_low_confidence(
                    resps[k], min_response, reject_stats
                ):
                    # hold the last accepted shift and discard the
                    # fused (bad-shift) resample
                    yield (
                        chunk[k], held, np.zeros(2, np.float32),
                        float(resps[k]), None,
                    )
                else:
                    held = shifts[k]
                    yield (
                        chunk[k],
                        shifts[k],
                        shifts[k],  # first mode: step == cum estimate
                        float(resps[k]),
                        corrs[k] if resample else None,
                    )
                t += 1
            left -= chunk_n

    estimator = estimate_frames_batched if use_batch else estimate_frames

    # chromatic alignment: each channel k > 0 carries a STATIC offset vs
    # channel 0 (chromatic aberration / camera registration); estimated
    # once as the per-channel median over sampled frames, then folded
    # into every frame's resample alongside the temporal drift. The
    # array is filled IN PLACE inside the managed `with source:` scope
    # below (the sampling reads frames); closures capture it here.
    align_channels = bool(p.get("align_channels", False))
    chan_offsets = np.zeros((source.n_channels, 2), np.float32)
    if align_channels and source.n_channels < 2:
        raise jobs_lib.JobError(
            "align_channels needs >= 2 input channels (one TIFF per "
            "channel)"
        )

    def measure_chan_offsets() -> None:
        n_sample = min(5, n_frames)
        # per channel: list of confident samples — the min_response gate
        # applies here too (a shutter-drop sample must not drag every
        # channel's static offset toward zero for the whole stack)
        samples = [[] for _ in range(source.n_channels)]
        for i in range(n_sample):
            fr = source.frame(i * (n_frames - 1) // max(n_sample - 1, 1))
            ch0 = _to_device(fr[..., 0], device)
            for c in range(1, source.n_channels):
                s_c, r_c = reg_lib.phase_correlate(
                    ch0, _to_device(fr[..., c], device),
                    subpixel=subpixel, window=window, refine=refine,
                )
                if min_response and float(r_c) < min_response:
                    continue
                samples[c].append(_host(s_c))
        est = np.zeros((source.n_channels, 2), np.float32)
        for c in range(1, source.n_channels):
            if not samples[c]:
                raise jobs_lib.JobError(
                    f"align_channels: no sampled frame reached "
                    f"min_response={min_response:g} for channel {c} — "
                    f"cannot measure its chromatic offset"
                )
            est[c] = np.median(np.stack(samples[c]), axis=0)
        if not subpixel:
            # integer mode rolls whole pixels: quantize the offsets so
            # the reported correction IS the applied correction (the
            # sub-pixel remainder cannot be applied losslessly)
            est = np.round(est)
        chan_offsets[:] = est

    def apply_cum(frame: np.ndarray, cum) -> np.ndarray:
        """Shift every channel of a native frame by the cumulative shift
        (+ that channel's static chromatic offset)."""
        cum = _host(cum).astype(np.float32)
        if not np.any(cum) and not np.any(chan_offsets):
            return frame  # reference frame: exact, no resample round-trip
        chans = frame[..., None] if frame.ndim == 2 else frame
        per_chan = []
        for c in range(chans.shape[-1]):
            s = cum + chan_offsets[c]
            if not np.any(s):
                per_chan.append(np.asarray(chans[..., c]))
            elif not subpixel:
                r = np.round(s).astype(int)
                per_chan.append(
                    np.roll(chans[..., c], (r[0], r[1]), axis=(0, 1))
                )
            else:
                per_chan.append(
                    _host(
                        reg_lib.apply_shift(
                            _to_device(chans[..., c], device), s
                        )
                    )
                )
        out = np.stack(per_chan, axis=-1)
        return out[..., 0] if frame.ndim == 2 else out

    # integer mode is lossless: the output keeps the native input dtype
    out_dtype = np.float32 if subpixel else source.dtype
    shifts_rows = []  # (t_abs, cum, step, resp)
    writers = []

    def open_writers(ys: slice = slice(0, h), xs: slice = slice(0, w)):
        ch = source.n_channels
        hh, ww = ys.stop - ys.start, xs.stop - xs.start
        est = float(n_frames) * hh * ww * np.dtype(out_dtype).itemsize
        names = (
            ["registered.tif"]
            if ch == 1
            else [f"registered_c{c}.tif" for c in range(ch)]
        )
        for name in names:
            writers.append(
                _append_writer(
                    os.path.join(job.output, name), est, _out_compression(job)
                )
            )
        return names

    def write_frame(frame: np.ndarray, ys: slice, xs: slice):
        chans = frame[..., None] if frame.ndim == 2 else frame
        for c, wr in enumerate(writers):
            with timer.phase("write"):
                wr.append(np.asarray(chans[ys, xs, c], dtype=out_dtype))

    def unwrapped_cums():
        """The physical (mod-N-resolved) trajectory; resampling is
        unaffected by wrapping, but crop selection and shifts.csv are.
        The mod-N period is the ESTIMATION frame size — with
        estimate_roi the estimates wrap at the ROI dims, not the
        frame's."""
        period = (
            (est_roi[2] - est_roi[0], est_roi[3] - est_roi[1])
            if est_roi is not None
            else (h, w)
        )
        return reg_lib.unwrap_trajectory(
            np.stack([c for c, _, _ in shifts_rows]), period
        )

    with source:
        try:
            if align_channels:
                measure_chan_offsets()
            if estimate_only or crop or est_roi is not None:
                # pass 1: estimate the trajectory only — on channel 0
                # alone (multi-channel stacks skip reading the rest),
                # with the fused resample compiled out (resample=False).
                # estimate_roi crops the ESTIMATION source (drift is
                # measured on a stable subregion, with ROI-sized FFTs)
                # while pass 2 resamples FULL frames by the trajectory.
                if source.n_channels > 1 or est_roi is not None:
                    # separate channel-0 source: close after pass 1
                    est_source = _apply_frame_range(
                        job, FrameSource(paths=[paths[0]])
                    )
                    if est_roi is not None:
                        try:
                            est_source.crop(*est_roi)
                        except ValueError as e:
                            est_source.close()
                            raise jobs_lib.JobError(
                                f"bad estimate_roi: {e}"
                            )
                else:
                    # pass 2 re-streams `source`: it must stay open
                    est_source = source
                try:
                    for _, cum, step, resp, _ in jobs_lib.track(
                        job,
                        estimator(est_source, resample=False),
                        total=n_frames,
                        phase="estimate",
                    ):
                        shifts_rows.append((_host(cum), _host(step), resp))
                finally:
                    if est_source is not source:
                        est_source.close()
                if not estimate_only:
                    ys, xs = slice(0, h), slice(0, w)
                    if crop:
                        # crop bounds cover every channel's TOTAL shift
                        # (temporal drift + its chromatic offset)
                        u = unwrapped_cums()
                        all_shifts = (
                            np.concatenate([u + off for off in chan_offsets])
                            if np.any(chan_offsets)
                            else u
                        )
                        try:
                            ys, xs = reg_lib.common_crop(
                                all_shifts, (h, w)
                            )
                        except ValueError as e:
                            raise jobs_lib.JobError(str(e))
                    names = open_writers(ys, xs)
                    # pass 2: apply + crop (lazy readers re-stream the
                    # stack). UNWRAPPED shifts: estimates are canonical
                    # mod the ESTIMATION window — identical operators
                    # for whole-frame estimation (the resample is
                    # wrap-invariant at the frame period) but off by a
                    # multiple of the ROI size under estimate_roi.
                    # (In practice first-mode ROI estimates degrade and
                    # are min_response-gated before cleanly wrapping;
                    # unwrapped application covers the periodic-content
                    # edge case where they do wrap cleanly.)
                    rows = iter(unwrapped_cums())
                    for frame in jobs_lib.track(
                        job, source.frames(), total=n_frames, phase="frames"
                    ):
                        cum = next(rows)
                        with timer.phase("infer"):
                            shifted = apply_cum(frame, cum)
                        write_frame(shifted, ys, xs)
            else:
                names = open_writers()
                # the fused on-device resample IS the output for
                # single-channel sub-pixel serves; integer mode keeps the
                # native dtype via a host roll, multi-channel resamples
                # each channel from the estimated trajectory
                use_fused = subpixel and source.n_channels == 1
                for frame, cum, step, resp, corr in jobs_lib.track(
                    job,
                    estimator(source, resample=use_fused),
                    total=n_frames,
                    phase="frames",
                ):
                    with timer.phase("infer"):
                        if use_fused and corr is not None:
                            shifted = _host(corr)
                        else:
                            shifted = apply_cum(frame, cum)
                    write_frame(shifted, slice(0, h), slice(0, w))
                    shifts_rows.append((_host(cum), _host(step), resp))
        except BaseException:
            for wr in writers:
                wr.abort()
            raise
    for wr in writers:
        wr.close()

    cums = unwrapped_cums()
    shifts_path = os.path.join(job.output, "shifts.csv")
    tmp = shifts_path + ".tmp"
    with open(tmp, "w") as f:
        f.write("frame,dy,dx,step_dy,step_dx,response\n")
        for i, (_, step, resp) in enumerate(shifts_rows):
            r = "" if resp is None else f"{float(resp):.3f}"
            f.write(
                f"{source.frame_offset + i},{cums[i][0]:.4f},{cums[i][1]:.4f},"
                f"{step[0]:.4f},{step[1]:.4f},{r}\n"
            )
    os.replace(tmp, shifts_path)

    total_s = time.time() - t0
    steps = np.stack([s for _, s, _ in shifts_rows[1:]]) if len(shifts_rows) > 1 else np.zeros((0, 2))
    resps = [float(r) for _, _, r in shifts_rows if r is not None]
    metrics = dict(
        timer.summary(),
        total_s=round(total_s, 4),
        n_frames=n_frames,
        max_drift_px=round(float(np.hypot(cums[:, 0], cums[:, 1]).max()), 3),
        rms_step_px=round(
            float(np.sqrt(np.mean(np.hypot(steps[:, 0], steps[:, 1]) ** 2)))
            if len(steps)
            else 0.0,
            3,
        ),
        min_response=round(min(resps), 3) if resps else None,
    )
    if align_channels:
        # keyed on the PARAM, not the value: a measured zero offset is a
        # result ("already co-registered"), not an absent measurement
        metrics["chromatic_offsets_px"] = [
            [round(float(v), 4) for v in off] for off in chan_offsets
        ]
    if min_response:
        metrics["n_low_confidence"] = reject_stats["n"]
    if frame_batch > 1:
        metrics["frame_batch"] = frame_batch
    if total_s > 0:
        metrics["frames_per_sec"] = round(n_frames / total_s, 3)
    out = {"shifts": shifts_path, "metrics": json.dumps(metrics)}
    if not estimate_only:
        for name in names:
            key = "registered" if name == "registered.tif" else name[:-4]
            out[key] = os.path.join(job.output, name)
    return out


def _register_volumes(
    job: Job,
    device: torch.device,
    mode: str,
    subpixel: bool,
    window: bool,
    refine: int,
    crop: bool,
    estimate_only: bool,
    z: Optional[int] = None,
    min_response: float = 0.0,
    align_channels: bool = False,
) -> Dict[str, str]:
    """Volumetric (dims=3) body of ``register_stack``: one 3D phase
    correlation per timepoint over a sequence of (Z, H, W) volume files.

    Ingest is one ``VolumeSequence`` per channel (one multi-page TIFF per
    timepoint); channel 0 drives the estimate, every channel is resampled
    by the shared trajectory. Volumes stream one timepoint at a time —
    the same memory envelope as the 3D serving pipelines. Outputs
    per-timepoint ``registered_t{t:04d}[_c{k}].tif`` files (atomic
    write-then-rename each) mirroring the input convention, plus a
    dz/dy/dx ``shifts.csv`` and drift metrics.
    """
    paths = _resolve_inputs(job)
    try:
        channels = [VolumeSequence(entry, z=z) for entry in paths]
    except ValueError as e:
        raise jobs_lib.JobError(f"job {job.id}: cannot read inputs: {e}")
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
    if n_t < 2:
        raise jobs_lib.JobError(
            f"job {job.id}: registration needs >= 2 timepoints (one "
            f"(Z, H, W) stack FILE per timepoint — a directory or glob "
            f"input entry); got {n_t}"
        )
    zhw = src.spatial
    timer = PhaseTimer()
    t0 = time.time()

    def read_volume(ch, t: int) -> np.ndarray:
        """One timepoint read, timed, deterministic on corrupt data."""
        with timer.phase("read"):
            try:
                return ch.volume(t)
            except ValueError as e:
                raise jobs_lib.JobError(f"job {job.id}: {e}")

    reject_stats = {"n": 0}

    # static per-channel chromatic offsets (dz, dy, dx) vs channel 0 —
    # the volumetric mirror of the 2D align_channels path (axial
    # chromatic shift is real in multi-fluorophore z-stacks)
    chan_offsets = np.zeros((len(channels), 3), np.float32)
    if align_channels:
        if len(channels) < 2:
            raise jobs_lib.JobError(
                "align_channels needs >= 2 input channels (one volume "
                "sequence per channel)"
            )
        n_sample = min(3, n_t)
        samples = [[] for _ in range(len(channels))]
        for i in range(n_sample):
            t_i = i * (n_t - 1) // max(n_sample - 1, 1)
            v0 = _to_device(read_volume(src, t_i), device)
            for c in range(1, len(channels)):
                s_c, r_c = reg_lib.phase_correlate(
                    v0, _to_device(read_volume(channels[c], t_i), device),
                    subpixel=subpixel, window=window, refine=refine,
                )
                if min_response and float(r_c) < min_response:
                    continue
                samples[c].append(_host(s_c))
        for c in range(1, len(channels)):
            if not samples[c]:
                raise jobs_lib.JobError(
                    f"align_channels: no sampled timepoint reached "
                    f"min_response={min_response:g} for channel {c}"
                )
            chan_offsets[c] = np.median(np.stack(samples[c]), axis=0)
        if not subpixel:
            chan_offsets = np.round(chan_offsets)  # lossless-roll quantum

    def estimate_volumes(resample):
        """(vol_ch0, cum, step, resp, corrected_ch0) per timepoint.

        Yields the volume it read so the single-pass apply loop never
        re-reads the driving channel's file. The ``min_response`` gate
        holds the trajectory (and the anchor) when an estimate's PSR is
        below it — one blank/corrupt timepoint must not derail the
        sequence (see the 2D estimator's docstring)."""
        anchor = None
        cum = torch.zeros(3, dtype=torch.float32, device=device)
        zero = torch.zeros(3, dtype=torch.float32, device=device)
        held = np.zeros(3, np.float32)
        for t in range(n_t):
            v = read_volume(src, t)
            if anchor is None:
                win = reg_lib._window(zhw, window, device)
                anchor = torch.fft.fftn(
                    _to_device(v, device).to(torch.float32) * win
                )
                yield v, zero, zero, None, None
                continue
            fft_win, new_cum, corr, step, resp = reg_lib.register_step(
                anchor,
                _to_device(v, device),
                cum if mode == "previous" else zero,
                subpixel=subpixel,
                window=window,
                refine=refine,
                resample=resample,
            )
            if _reject_low_confidence(resp, min_response, reject_stats):
                yield v, held, np.zeros(3, np.float32), resp, None
                continue
            if mode == "previous":
                anchor, cum = fft_win, new_cum
            held = _host(new_cum)
            yield v, new_cum, step, resp, corr

    # integer mode keeps native values; mixed channel dtypes promote the
    # same way FrameSource.dtype does for the 2D path (np.result_type),
    # never silently truncating a float channel into channel 0's ints
    out_dtype = (
        np.float32
        if subpixel
        else np.result_type(*[c.dtype for c in channels])
    )

    def apply_cum(vol: np.ndarray, cum) -> np.ndarray:
        cum = _host(cum).astype(np.float32)
        if not np.any(cum):
            return vol
        if not subpixel:
            r = np.round(cum).astype(int)
            return np.roll(vol, tuple(r), axis=(0, 1, 2))
        return _host(reg_lib.apply_shift(_to_device(vol, device), cum))

    def vol_name(t_abs: int, c: int) -> str:
        suffix = "" if len(channels) == 1 else f"_c{c}"
        return f"registered_t{t_abs:04d}{suffix}.tif"

    def write_volume(t: int, vol_by_channel, sl) -> None:
        for c, v in enumerate(vol_by_channel):
            with timer.phase("write"):
                out = np.asarray(v[sl], dtype=out_dtype)
                # TiffAppendWriter is already atomic (write-temp-rename)
                # and goes BigTIFF when a volume could brush the classic
                # 4 GiB offset limit; compress_output is honored as in 2D
                w = _append_writer(
                    os.path.join(
                        job.output, vol_name(src.frame_offset + t, c)
                    ),
                    float(out.nbytes),
                    _out_compression(job),
                )
                try:
                    for plane in out:
                        w.append(plane)
                except BaseException:
                    w.abort()
                    raise
                w.close()

    shifts_rows = []  # (cum, step, resp)

    def unwrapped_cums():
        return reg_lib.unwrap_trajectory(
            np.stack([c for c, _, _ in shifts_rows]), zhw
        )

    full = tuple(slice(0, n) for n in zhw)
    try:
        if estimate_only or crop:
            for _, cum, step, resp, _ in jobs_lib.track(
                job, estimate_volumes(resample=False), total=n_t,
                phase="estimate",
            ):
                shifts_rows.append((_host(cum), _host(step), resp))
            if not estimate_only:
                sl = full
                if crop:
                    try:
                        u = unwrapped_cums()
                        all_shifts = (
                            np.concatenate([u + off for off in chan_offsets])
                            if np.any(chan_offsets)
                            else u
                        )
                        sl = reg_lib.common_crop(all_shifts, zhw)
                    except ValueError as e:
                        raise jobs_lib.JobError(str(e))
                rows = iter(shifts_rows)
                for t in jobs_lib.track(
                    job, range(n_t), total=n_t, phase="volumes"
                ):
                    cum, _, _ = next(rows)
                    vols = [read_volume(ch, t) for ch in channels]
                    with timer.phase("infer"):
                        vols = [
                            apply_cum(v, _host(cum) + chan_offsets[ci])
                            for ci, v in enumerate(vols)
                        ]
                    write_volume(t, vols, sl)
        else:
            use_fused = subpixel and len(channels) == 1
            rows_iter = estimate_volumes(resample=use_fused)
            for t, (v0, cum, step, resp, corr) in enumerate(
                jobs_lib.track(job, rows_iter, total=n_t, phase="volumes")
            ):
                extra = [read_volume(ch, t) for ch in channels[1:]]
                with timer.phase("infer"):
                    if use_fused:
                        # corr is None for the reference row AND for
                        # confidence-rejected timepoints — both resample
                        # by the held cum (zero-shift short-circuits)
                        vols = [
                            _host(corr)
                            if corr is not None
                            else apply_cum(v0, cum)
                        ]
                    else:
                        vols = [
                            apply_cum(v, _host(cum) + chan_offsets[ci])
                            for ci, v in enumerate([v0] + extra)
                        ]
                write_volume(t, vols, full)
                shifts_rows.append((_host(cum), _host(step), resp))
    finally:
        for ch in channels:
            ch.close()  # frees each sequence's cached first volume

    cums = unwrapped_cums()
    shifts_path = os.path.join(job.output, "shifts.csv")
    tmp = shifts_path + ".tmp"
    with open(tmp, "w") as f:
        f.write("frame,dz,dy,dx,step_dz,step_dy,step_dx,response\n")
        for i, (_, step, resp) in enumerate(shifts_rows):
            r = "" if resp is None else f"{float(resp):.3f}"
            f.write(
                f"{src.frame_offset + i},"
                f"{cums[i][0]:.4f},{cums[i][1]:.4f},{cums[i][2]:.4f},"
                f"{step[0]:.4f},{step[1]:.4f},{step[2]:.4f},{r}\n"
            )
    os.replace(tmp, shifts_path)

    total_s = time.time() - t0
    steps = (
        np.stack([s for _, s, _ in shifts_rows[1:]])
        if len(shifts_rows) > 1
        else np.zeros((0, 3))
    )
    resps = [float(r) for _, _, r in shifts_rows if r is not None]
    metrics = dict(
        timer.summary(),
        total_s=round(total_s, 4),
        n_volumes=n_t,
        max_drift_px=round(
            float(np.linalg.norm(cums, axis=1).max()), 3
        ),
        rms_step_px=round(
            float(np.sqrt(np.mean(np.linalg.norm(steps, axis=1) ** 2)))
            if len(steps)
            else 0.0,
            3,
        ),
        min_response=round(min(resps), 3) if resps else None,
    )
    if min_response:
        metrics["n_low_confidence"] = reject_stats["n"]
    if align_channels:
        metrics["chromatic_offsets_px"] = [
            [round(float(v), 4) for v in off] for off in chan_offsets
        ]
    if total_s > 0:
        metrics["volumes_per_sec"] = round(n_t / total_s, 3)
    out = {"shifts": shifts_path, "metrics": json.dumps(metrics)}
    if not estimate_only:
        out["registered"] = job.output
    return out


@register("stitch_mosaic")
def stitch_mosaic_job(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Stitch a grid of overlapping fields of view into one mosaic.

    Exposes ``sequitr_tpu_torch.mosaic`` through the job API (no model).
    Slide scanners / motorized stages acquire large samples as an
    (R, C) grid of overlapping tiles; this produces the single
    stationary composite every downstream pipeline wants. Pairwise seam
    offsets are measured with the registration stack's phase correlator
    batched over ALL seams of a direction in one call, positions come
    from a weighted global least-squares solve, and the composite is
    feather-blended (mosaic.py design notes). params:

    * ``grid``: [rows, cols] — REQUIRED; tiles arrive in acquisition
      order as R*C single-frame TIFFs (directory/glob entry, natural
      sort) or one R*C-page stack.
    * ``overlap``: nominal seam overlap — px int, fraction of the tile
      in (0, 1), or a per-axis [oy, ox] pair (default 0.1).
    * ``order``: ``"row"`` (default) or ``"snake"`` (serpentine stage
      scans: odd rows acquired right-to-left).
    * ``subpixel`` (default true): sub-pixel seam estimates + batched
      fractional Fourier-shift placement; false = whole-pixel (lossless
      — use for label tiles).
    * ``window`` (default true), ``refine`` (default 2): forwarded to
      the phase correlator (same semantics as register_stack).
    * ``min_response`` (default 0 = off): PSR confidence gate — seams
      below it (featureless overlap: empty glass) fall back to nominal
      grid spacing at near-zero weight instead of shearing the mosaic.
    * ``estimate_only`` (default false): write positions/seams CSVs only.
    * ``positions``: REUSE a previous solve instead of estimating — a
      positions.csv path, a previous stitch job's output dir (chains
      via ``depends_on``: one ``estimate_only`` stitch, then every
      later acquisition round composites at the same stage coordinates),
      or an inline row-major ``[[y, x], ...]`` list.
    * ``flatfield`` (default false): retrospective flat-field
      correction — the shading/vignetting profile every tile shares is
      estimated per channel (median across tiles + low-order polynomial
      fit, ``mosaic.estimate_flatfield``) and divided out before seam
      estimation and blending; uncorrected vignetting prints a dark
      grid of seams into the composite. ``true`` = order 2; an integer
      sets the polynomial order (up to 6). Profile min/max land in the
      metrics.
    * ``match_gains`` (default false): per-tile gain matching —
      photobleaching makes later tiles of a scan dimmer by a per-TILE
      factor flat-field cannot express (the blend then shows intensity
      steps at seams). Adjacent tiles image the same content in their
      overlap, so strip-median ratios give per-seam gain differences
      and an anchored log-space least-squares solves per-tile gains
      (product normalized to 1; blank seams skipped). Composes with
      ``flatfield`` (shading first, then gains); gain range lands in
      the metrics.
    * ``data_parallel`` (default false): the seam pairs sharded over the
      device pool (``metrics.n_devices``); on a pool of one device the
      stitch runs single-device, as the JAX server does on one chip.

    Multi-channel: the uniform convention — one input entry per channel
    (each an R*C tile sequence in the same acquisition order). Seams are
    estimated on channel 0 and the SAME positions composite every
    channel (they share the stage, exactly like register_stack's
    trajectory riding channel 0); outputs ``mosaic_c{k}.tif``.

    ``timelapse: true`` — multi-position LIVE imaging (the btrack
    acquisition shape): each of the R*C files in an entry is one stage
    position's T-page timelapse. Positions are fixed across time, so
    seams are estimated once (channel 0, timepoint 0) and the same
    solved positions composite every timepoint, streamed page-by-page
    (read-ahead, bounded memory, cancellable) into a T-page
    ``mosaic.tif`` — which feeds straight into ``segmentation_*`` →
    ``track_objects`` as one chain.

    Outputs: ``mosaic.tif`` (float32 composite; uncovered rim px are 0)
    or per-channel ``mosaic_c{k}.tif``, ``positions.csv`` (tile, row,
    col, y, x — canvas-coordinate tile origins), ``seams.csv`` (i, j,
    dy, dx, response, used — the per-seam measurements and their
    confidence; used=0 marks nominal fallbacks), and metrics incl.
    ``rms_residual`` px (post-solve seam disagreement — the
    stitch-consistency QC number; large values mean stage nonlinearity,
    a wrong overlap hint, or sample motion).

    ``backend``: ``"device"`` (default), ``"cpu"``, or ``"auto"``.
    ``"cpu"`` runs the whole stitch on the host CPU (single device by
    definition: it rejects ``data_parallel``). ``"auto"`` runs grids of
    at most 16 seams (about 3x3) on the host when the server's device is
    a card and ``data_parallel`` is off, anything larger on the device:
    the JAX package's threshold, which rests on a TPU measurement and is
    kept so that the same job JSON takes the same choice on both servers
    (the card's own reading of both backends is in PERF.md). The
    resolved choice lands in the outputs.
    """
    device = resolve_device(config.device)
    backend = _resolve_mosaic_backend(job, device)
    if backend == "cpu":
        if job.params.get("data_parallel"):
            raise jobs_lib.JobError(
                "backend: 'cpu' pins the stitch to the host (single "
                "device); it cannot combine with data_parallel"
            )
        device = torch.device("cpu")
    outputs = _stitch_mosaic_body(job, device)
    outputs["backend"] = backend
    return outputs


def _resolve_mosaic_backend(job: Job, device: torch.device) -> str:
    """Resolve the ``backend`` param to 'device' or 'cpu'.

    ``auto`` picks the host for SMALL grids (seam-pair count <= 16, the
    JAX package's threshold) when the server's ``device`` is a card and
    ``data_parallel`` is off; larger scans stay on the device. A
    malformed ``grid`` resolves to 'device' and fails the body's own
    validation loudly.
    """
    backend = str(job.params.get("backend", "device"))
    if backend not in ("device", "cpu", "auto"):
        raise jobs_lib.JobError(
            f"backend={backend!r} must be 'device', 'cpu', or 'auto'"
        )
    if backend != "auto":
        return backend
    grid = job.params.get("grid")
    seams = None
    if (
        isinstance(grid, (list, tuple)) and len(grid) == 2
        and all(
            isinstance(v, int) and not isinstance(v, bool) and v >= 1
            for v in grid
        )
    ):
        r, c = int(grid[0]), int(grid[1])
        seams = r * (c - 1) + (r - 1) * c
    small = seams is not None and seams <= 16
    if (
        small
        and not job.params.get("data_parallel")
        and device.type != "cpu"
    ):
        return "cpu"
    return "device"


def _stitch_mosaic_body(job: Job, device: torch.device) -> Dict[str, str]:
    p = job.params
    grid = p.get("grid")
    if (
        not isinstance(grid, (list, tuple))
        or len(grid) != 2
        or not all(
            isinstance(v, int) and not isinstance(v, bool) and v >= 1
            for v in grid
        )
    ):
        raise jobs_lib.JobError(
            f"grid={grid!r} must be [rows, cols] with positive integers"
        )
    r, c = int(grid[0]), int(grid[1])
    order = p.get("order", "row")
    if order not in ("row", "snake"):
        raise jobs_lib.JobError(f"order={order!r} must be 'row' or 'snake'")
    subpixel = bool(p.get("subpixel", True))
    window = bool(p.get("window", True))
    refine = int(p.get("refine", 2))
    if not 1 <= refine <= 8:
        raise jobs_lib.JobError(f"refine={refine} must be in [1, 8]")
    try:
        min_response = float(p.get("min_response", 0.0))
    except (TypeError, ValueError):
        raise jobs_lib.JobError(
            f"min_response={p.get('min_response')!r} must be a number"
        )
    if not 0.0 <= min_response < float("inf"):
        raise jobs_lib.JobError(
            f"min_response={min_response!r} must be a finite number >= 0"
        )
    estimate_only = bool(p.get("estimate_only", False))

    correlate = None
    dp_devices = 0
    if (
        bool(p.get("data_parallel"))
        and _n_devices(device) > 1
        # a positions-reuse job never correlates seams: no mesh, and no
        # n_devices as if seams had been sharded
        and p.get("positions") is None
    ):
        mesh = parallel.make_mesh(device=device)
        dp_devices = mesh.size
        correlate = parallel.make_dp_seam_correlator(
            mesh, subpixel=subpixel, window=window, refine=refine
        )

    timelapse = bool(p.get("timelapse", False))
    timer = PhaseTimer()
    t0 = time.time()
    entries = _resolve_inputs(job)
    # one input entry per CHANNEL (the uniform convention); channels are
    # read LAZILY one at a time — estimation and each blend need a
    # single channel, so host memory stays O(one channel's tiles)
    kw = dict(
        subpixel=subpixel, window=window, refine=refine,
        min_response=min_response, estimate_only=estimate_only,
        device=device, order=order, timer=timer, t0=t0,
        correlate=correlate, dp_devices=dp_devices,
    )
    if timelapse:
        return _stitch_mosaic_timelapse(job, r, c, entries, **kw)

    sources = []
    try:
        for pth in entries:
            try:
                sources.append(FrameSource(paths=[pth]))
            except ValueError as e:
                raise jobs_lib.JobError(
                    f"job {job.id}: cannot read {pth}: {e}"
                )
        if len(sources[0]) != r * c:
            raise jobs_lib.JobError(
                f"{len(sources[0])} tiles for a {r}x{c} grid "
                f"(need {r * c})"
            )
        h, w = sources[0].spatial
        for k, s in enumerate(sources[1:], 1):
            if len(s) != r * c or s.spatial != (h, w):
                raise jobs_lib.JobError(
                    f"channel {k} ({entries[k]}) disagrees: {len(s)} "
                    f"tiles of {s.spatial} vs {r * c} of {(h, w)}"
                )

        def read_chan_t(k: int, t: int) -> np.ndarray:
            return np.stack(
                [
                    np.asarray(f, np.float32)
                    for f in sources[k].frames()
                ]
            )

        return _stitch_mosaic_core(
            job, r, c, n_chan=len(sources), n_t=1, spatial=(h, w),
            read_chan_t=read_chan_t, **kw,
        )
    finally:
        for s in sources:
            s.close()


def _write_mosaic_csvs(job: Job, result, r: int, c: int) -> Dict[str, str]:
    """positions.csv + seams.csv (write-temp-rename), shared by the
    single-shot and timelapse stitch paths."""
    pos_path = os.path.join(job.output, "positions.csv")
    tmp = pos_path + ".tmp"
    with open(tmp, "w") as f:
        f.write("tile,row,col,y,x\n")
        for k in range(r * c):
            f.write(
                f"{k},{k // c},{k % c},"
                f"{result.positions[k, 0]:.4f},{result.positions[k, 1]:.4f}\n"
            )
    os.replace(tmp, pos_path)
    seams_path = os.path.join(job.output, "seams.csv")
    tmp = seams_path + ".tmp"
    with open(tmp, "w") as f:
        f.write("i,j,dy,dx,response,used\n")
        for e in range(len(result.edges)):
            f.write(
                f"{result.edges[e, 0]},{result.edges[e, 1]},"
                f"{result.offsets[e, 0]:.4f},{result.offsets[e, 1]:.4f},"
                f"{result.responses[e]:.3f},{int(result.used[e])}\n"
            )
    os.replace(tmp, seams_path)
    return {"positions": pos_path, "seams": seams_path}


class _TilePool:
    """fd-capped lazy FrameSource pool for per-position timelapse files.

    Mirrors ``_SequenceReader._MAX_OPEN``'s rationale at job scale: a
    20x20 3-channel scan is 1200 files, and holding a reader open per
    file would exhaust the default 1024-fd table. Readers open on
    demand and an LRU evicts past the budget (half the soft RLIMIT, so
    the worker's own files/sockets keep headroom); typical jobs stay
    fully resident, giant ones re-parse an evicted file's IFD chain on
    return — slower, never wrong.
    """

    def __init__(self, paths):
        import resource
        from collections import OrderedDict

        soft = resource.getrlimit(resource.RLIMIT_NOFILE)[0]
        if soft == resource.RLIM_INFINITY:
            soft = 8192
        self.max_open = max(8, int(soft) // 2)
        self._paths = list(paths)
        self._open: "OrderedDict[int, object]" = OrderedDict()

    def source(self, i: int):
        src = self._open.pop(i, None)
        if src is None:
            if len(self._open) >= self.max_open:
                _, old = self._open.popitem(last=False)
                old.close()
            try:
                src = FrameSource(paths=[self._paths[i]])
            except ValueError as e:
                raise ValueError(f"{self._paths[i]}: {e}")
        self._open[i] = src  # most-recently-used position
        return src

    def path(self, i: int) -> str:
        return self._paths[i]

    def close(self) -> None:
        for src in self._open.values():
            src.close()
        self._open.clear()


def _stitch_mosaic_timelapse(
    job: Job,
    r: int,
    c: int,
    entries,
    **kw,
) -> Dict[str, str]:
    """``stitch_mosaic`` with ``timelapse: true`` — multi-position live
    imaging (the btrack acquisition shape: a fixed grid of stage
    positions re-imaged every cycle).

    Conventions: each input ENTRY is one channel (uniform multi-channel
    convention); inside an entry, each of the R*C files
    (directory/glob, natural order; ``order: snake`` for serpentine
    stage scans) is one POSITION's T-page timelapse. Stage positions
    are fixed across time, so seams are estimated ONCE — channel 0,
    timepoint 0 — and the same solved positions composite EVERY
    timepoint (the shared ``_stitch_mosaic_core`` streaming loop).
    Outputs a T-page ``mosaic.tif`` (or ``mosaic_c{k}.tif``) — the
    stitched timelapse feeds straight into segmentation → objects.h5 →
    tracking. File handles ride an fd-capped pool (``_TilePool``).
    """
    chan_files = []
    for pth in entries:
        files = _expand_inputs_entry(pth)
        if len(files) != r * c:
            raise jobs_lib.JobError(
                f"{len(files)} tile timelapses for a {r}x{c} grid "
                f"(need {r * c}) in {pth}"
            )
        chan_files.append(files)
    n_chan = len(chan_files)
    pool = _TilePool([f for cf in chan_files for f in cf])
    try:
        # validate every position once (each opens through the pool)
        try:
            first = pool.source(0)
            n_t = len(first)
            h, w = first.spatial
        except ValueError as e:
            raise jobs_lib.JobError(f"job {job.id}: cannot read {e}")
        for i in range(1, n_chan * r * c):
            try:
                s = pool.source(i)
            except ValueError as e:
                raise jobs_lib.JobError(f"job {job.id}: cannot read {e}")
            if len(s) != n_t or s.spatial != (h, w):
                raise jobs_lib.JobError(
                    f"{pool.path(i)} disagrees: {len(s)} timepoints of "
                    f"{s.spatial} vs {n_t} of {(h, w)}"
                )

        def read_chan_t(k: int, t: int) -> np.ndarray:
            base = k * r * c
            return np.stack(
                [
                    np.asarray(
                        pool.source(base + pos).frame(t), np.float32
                    )
                    for pos in range(r * c)
                ]
            )

        return _stitch_mosaic_core(
            job, r, c, n_chan=n_chan, n_t=n_t, spatial=(h, w),
            read_chan_t=read_chan_t, **kw,
        )
    finally:
        pool.close()


def _stitch_mosaic_core(
    job: Job,
    r: int,
    c: int,
    *,
    n_chan: int,
    n_t: int,
    spatial,
    read_chan_t,
    order: str,
    subpixel: bool,
    window: bool,
    refine: int,
    min_response: float,
    estimate_only: bool,
    device: torch.device,
    timer,
    t0: float,
    correlate=None,
    dp_devices: int = 0,
) -> Dict[str, str]:
    """Shared stitch engine: estimate once on (channel 0, timepoint 0),
    then stream one composite per (timepoint, channel) to page-append
    writers with disk read-ahead overlapping the blend.

    ``read_chan_t(k, t) -> (R*C, H, W) float32`` tiles in ACQUISITION
    order — the core applies the serpentine permutation, so readers
    stay order-agnostic. The single-shot path is simply ``n_t=1``; the
    timelapse path streams T pages per channel through the same loop
    (bounded memory, cancellable).
    """
    h, w = spatial
    perm = (
        mosaic_lib.snake_indices((r, c))
        if order == "snake"
        else np.arange(r * c)
    )

    raw_first = {"tiles": None}

    def first_tiles() -> np.ndarray:
        """(Channel 0, timepoint 0) tiles, row-major, read once and
        shared by overlap auto-estimation, the correction fits and the
        seam estimate."""
        if raw_first["tiles"] is None:
            try:
                raw_first["tiles"] = read_chan_t(0, 0)[perm]
            except ValueError as e:
                # corrupt input is deterministic — fail fast, no retry
                raise jobs_lib.JobError(
                    f"job {job.id}: cannot read inputs: {e}"
                )
        return raw_first["tiles"]

    ov_param = job.params.get("overlap", 0.1)
    overlap_estimated = False
    if isinstance(ov_param, str):
        if ov_param != "auto":
            raise jobs_lib.JobError(
                f"overlap={ov_param!r} must be px / fraction / [oy, ox] "
                f"/ 'auto'"
            )
        # the one parameter a user can get wrong, measured from the data:
        # whole-tile correlation of adjacent pairs wraps W - ov to -ov
        # (mosaic.estimate_overlap)
        try:
            overlap = mosaic_lib.estimate_overlap(
                first_tiles(), (r, c), device=device
            )
        except ValueError as e:
            raise jobs_lib.JobError(str(e))
        overlap_estimated = True
    else:
        try:
            overlap = mosaic_lib.normalize_overlap(ov_param, (h, w))
        except (TypeError, ValueError) as e:
            raise jobs_lib.JobError(f"bad overlap: {e}")
    # retrospective flat-field: every tile sees the same optical path,
    # so the shading profile is estimated per channel from its first
    # timepoint's tiles and divided out of every tile before seam
    # estimation AND blending (vignetting otherwise prints a dark grid
    # of seams into the composite)
    ff_param = job.params.get("flatfield", False)
    if ff_param is True:
        ff_order = 2
    elif ff_param is False or ff_param is None:
        ff_order = 0
    else:
        try:
            ff_order = int(ff_param)
        except (TypeError, ValueError):
            raise jobs_lib.JobError(
                f"flatfield={ff_param!r} must be a boolean or the "
                f"polynomial order"
            )
        # 1/0 are the common hand-written JSON boolean spellings: treat
        # them as on/off (order 1 would silently fit a PLANE, which
        # cannot express the radial vignette this feature removes)
        if ff_order == 0:
            pass
        elif ff_order == 1:
            ff_order = 2
        elif not 2 <= ff_order <= 6:
            raise jobs_lib.JobError(
                f"flatfield order {ff_order} must be in [2, 6] "
                f"(or a boolean)"
            )
    match_gains = bool(job.params.get("match_gains", False))
    profiles: Dict[int, np.ndarray] = {}
    gains: Dict[int, np.ndarray] = {}

    def corrected(k: int, tiles: np.ndarray) -> np.ndarray:
        """Correct one channel's ROW-MAJOR tile stack: flat-field
        (per-pixel shading shared by all tiles), then per-tile gain
        matching (photobleaching across the scan — a per-TILE factor
        flat-field cannot express). Both estimated once per channel
        from its first timepoint and reused."""
        if ff_order:
            if k not in profiles:
                profiles[k] = mosaic_lib.estimate_flatfield(
                    tiles, order=ff_order
                )
            tiles = tiles / profiles[k]
        if match_gains:
            if k not in gains:
                gains[k] = mosaic_lib.solve_tile_gains(
                    tiles, (r, c), overlap
                )
            tiles = tiles * gains[k][:, None, None]
        return tiles

    with timer.phase("estimate"):
        given = job.params.get("positions")
        if given is not None:
            # reuse a previous job's solve (chain: one estimate_only
            # stitch, then every later acquisition round composites at
            # the same stage coordinates without re-estimating)
            result = _load_mosaic_positions(job, given, r, c)
            if (ff_order or match_gains) and estimate_only:
                # the blend loop (which fits profiles lazily on first
                # use) never runs in estimate_only mode, so pre-fit here
                # or the metrics would miss the profile/gain ranges; in
                # blending runs, pre-fitting would just read channel 0
                # twice
                corrected(0, first_tiles())
        else:
            first = corrected(0, first_tiles())
            result = mosaic_lib.stitch_grid(
                first, (r, c), overlap=overlap, order="row",
                subpixel=subpixel, window=window, refine=refine,
                min_response=min_response, blend=False,
                device=device, correlate=correlate,
            )

    outputs: Dict[str, str] = {}
    canvas_shape = None
    if not estimate_only:
        comp = _out_compression(job)
        writers: list = [None] * n_chan

        def produce():
            for t in range(n_t):
                for k in range(n_chan):
                    yield k, read_chan_t(k, t)

        work = jobs_lib.track(
            job,
            infer_lib._iter_read_ahead(produce(), 2),
            total=n_t * n_chan, phase="composites",
        )
        try:
            for k, tiles in _reads_fail_fast(job, iter(work)):
                with timer.phase("blend"):
                    composite = mosaic_lib.blend_mosaic(
                        corrected(k, tiles[perm]), result.positions,
                        overlap, subpixel=subpixel, device=device,
                    )
                canvas_shape = composite.shape
                if writers[k] is None:
                    name = "mosaic" if n_chan == 1 else f"mosaic_c{k}"
                    path = os.path.join(job.output, f"{name}.tif")
                    writers[k] = (
                        name, path,
                        _append_writer(
                            path, float(composite.nbytes) * n_t, comp
                        ),
                    )
                with timer.phase("write"):
                    writers[k][2].append(composite)
        except BaseException:
            for wr in writers:
                if wr is not None:
                    wr[2].abort()
            raise
        for name, path, writer in writers:
            writer.close()
            outputs[name] = path

    outputs.update(_write_mosaic_csvs(job, result, r, c))
    total_s = time.time() - t0
    metrics = dict(
        timer.summary(),
        total_s=round(total_s, 4),
        n_tiles=r * c,
        rms_residual_px=round(result.rms_residual, 5),
        n_low_confidence=int((~result.used).sum()),
        overlap_y=overlap[0],
        overlap_x=overlap[1],
    )
    if overlap_estimated:
        metrics["overlap_estimated"] = True
    if n_t > 1:
        metrics["n_timepoints"] = n_t
        metrics["timepoints_per_sec"] = round(
            n_t / max(total_s, 1e-9), 3
        )
    else:
        metrics["tiles_per_sec"] = round(r * c / max(total_s, 1e-9), 3)
    if dp_devices:
        metrics["n_devices"] = dp_devices
    if canvas_shape is not None:
        metrics["canvas_h"] = int(canvas_shape[0])
        metrics["canvas_w"] = int(canvas_shape[1])
    if profiles:
        metrics["flatfield_min"] = round(
            float(min(pr.min() for pr in profiles.values())), 4
        )
        metrics["flatfield_max"] = round(
            float(max(pr.max() for pr in profiles.values())), 4
        )
    if gains:
        metrics["gain_min"] = round(
            float(min(g.min() for g in gains.values())), 4
        )
        metrics["gain_max"] = round(
            float(max(g.max() for g in gains.values())), 4
        )
    outputs["metrics"] = json.dumps(metrics)
    return outputs


def _load_mosaic_positions(job: Job, given, r: int, c: int):
    """A ``positions`` param → MosaicResult shell: a positions.csv path,
    the output DIR of a previous stitch job (chains via depends_on), or
    an inline [[y, x], ...] list (row-major). No seams were measured, so
    edges/offsets are empty and rms_residual is 0 — seams.csv records
    the reuse honestly (header only)."""
    if isinstance(given, str):
        path = given
        if os.path.isdir(path):
            path = os.path.join(path, "positions.csv")
        try:
            rows = np.loadtxt(
                path, delimiter=",", skiprows=1, ndmin=2
            )
        except (OSError, ValueError) as e:
            raise jobs_lib.JobError(
                f"job {job.id}: cannot read positions {path}: {e}"
            )
        if rows.shape[1] < 5:
            raise jobs_lib.JobError(
                f"positions file {path} is not a stitch positions.csv "
                f"(tile,row,col,y,x)"
            )
        pos = rows[np.argsort(rows[:, 0])][:, 3:5]
    elif isinstance(given, (list, tuple)):
        try:
            pos = np.asarray(given, dtype=np.float64)
        except (TypeError, ValueError) as e:
            raise jobs_lib.JobError(
                f"inline positions must be [[y, x], ...]: {e}"
            )
        if pos.ndim != 2 or pos.shape[1] != 2:
            raise jobs_lib.JobError(
                f"inline positions must be [[y, x], ...], got shape "
                f"{pos.shape}"
            )
    else:
        raise jobs_lib.JobError(
            f"positions={given!r} must be a positions.csv path, a "
            f"previous stitch job's output dir, or an inline list"
        )
    if len(pos) != r * c:
        raise jobs_lib.JobError(
            f"{len(pos)} positions for a {r}x{c} grid (need {r * c})"
        )
    if not np.isfinite(pos).all():
        # a NaN would turn floor().astype(int64) into INT64_MIN deep in
        # the blend — reject deterministically instead
        raise jobs_lib.JobError("positions contain non-finite values")
    pos = pos - pos.min(axis=0, keepdims=True)
    return mosaic_lib.MosaicResult(
        positions=pos,
        edges=np.zeros((0, 2), np.int64),
        offsets=np.zeros((0, 2)),
        responses=np.zeros(0),
        used=np.zeros(0, bool),
        rms_residual=0.0,
        mosaic=None,
    )
