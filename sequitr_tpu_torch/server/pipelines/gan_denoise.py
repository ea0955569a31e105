"""Enhancement/denoising: ``enhancement_gan``, ``denoise`` and their
evaluators ``evaluate_gan`` and ``evaluate_denoise``.

Port of the jobs of ``sequitr_tpu.server.pipelines.gan_denoise``: the
pix2pix generator pass (``enhanced.tif``), the Noise2Void pass
(``denoised.tif``, 2D stacks and volume sequences) and the scores of both
against clean targets (L1 / PSNR in the job's normalize space), with the
same params, outputs, metrics and JobErrors. Frames stream through the
cached enhancer/denoiser two ahead (``infer.stream_frames``),
``frame_batch`` frames a forward. The evaluators normalize their targets
on the device with the job's ``TileConfig`` (``infer._normalize``: on the
card one quantile pass a target frame or volume) and score on the host.

On a pool of more than one device (``parallel.device_pool``)
``data_parallel`` gives each device its own frame (3D denoise: its own
volume) and the enhancer's ``spatial_parallel`` splits each frame's rows
over the devices (``parallel.spatial``); on one device they stream
single-device, as the JAX server does on one chip.
"""

from __future__ import annotations

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
    _auto_frame_batch,
    _dp_chunk_stream,
    _n_devices,
    _out_compression,
    _parse_z_pages,
    _reads_fail_fast,
    _require_model,
    _require_polyphase_model,
    _resolve_inputs,
    _spatial_ways,
    _tile_config,
    _volume_chunks,
    register,
)
from sequitr_tpu_torch.utils import PhaseTimer, resolve_device


def _frame_source(job: Job):
    from sequitr_tpu_torch.data.source import FrameSource

    paths = _resolve_inputs(job)
    try:
        source = FrameSource(paths=paths)
    except ValueError as e:
        raise jobs_lib.JobError(f"job {job.id}: cannot read inputs: {e}")
    return _apply_roi(job, _apply_frame_range(job, source))


def _out_params(job: Job) -> dict:
    """The job's params with ``out_dtype`` as the tile config's output
    dtype. ``.copy()`` (not ``dict(...)``) so a ParamTracker marks every
    param read."""
    p = job.params.copy()
    if "out_dtype" in p:
        p["probs_dtype"] = p["out_dtype"]
    return p


def _gan_setup(job: Job, config: ServerConfiguration, source):
    """The job's GAN model (folded at load, ``gan.fold_generator``) and its
    tile config; a channel-count mismatch is a deterministic JobError."""
    cfg, model = _require_model(job, config, "gan")
    if cfg.in_channels != source.n_channels:
        raise jobs_lib.JobError(
            f"model expects {cfg.in_channels} channel(s), "
            f"got {source.n_channels} input stack(s)"
        )
    cfg = model.cfg  # the folded configuration keys the enhancer cache
    tc = _tile_config(
        _out_params(job), dims=2,
        frame_spatial=source.spatial, min_multiple=cfg.min_input_multiple,
        exact_only=True, allow_polyphase=True,
    )
    if tc.polyphase:
        _require_polyphase_model(cfg.generator_config)
        if job.params.get("spatial_parallel"):
            raise jobs_lib.JobError(
                "polyphase + spatial_parallel is not supported; the "
                "spatial path runs its own halo-exchange forward"
            )
    return cfg, model, tc


def _stream_to_writer(job, source, fn_for, timer, writer, c_out, device, fb=None):
    """Serve every frame of ``source`` through ``fn_for(batch)`` (the
    single-frame form for ``batch=None``) and append each output channel
    of each frame as a page; progress and cancellation once a frame.
    ``fb``: frames a call (default the job's ``frame_batch``, else auto)."""
    from sequitr_tpu_torch.pipeline import infer as infer_lib

    n_frames = len(source)
    if fb is None:
        fb = job.params.get("frame_batch")
        fb = int(fb) if fb else _auto_frame_batch(source.spatial)
        fb = max(1, min(fb, n_frames))
    rep = jobs_lib.ProgressReporter(job, n_frames)

    def write_frame(got):  # (H, W, C_out)
        with timer.phase("write"):
            for c in range(c_out):
                writer.append(got[..., c])
        rep.step()

    if fb > 1:
        fn, feed = fn_for(fb), source.chunks(fb)
    else:
        fn, feed = fn_for(None), source.frames()
    n_left = n_frames
    with source:
        for out in infer_lib.stream_frames(
            fn, _reads_fail_fast(job, feed),
            prefetch_host=infer_lib._copy_to_host_async, device=device,
        ):
            with timer.phase("fetch"):
                got = np.asarray(out)
            if fb > 1:
                for k in range(min(fb, n_left)):
                    write_frame(got[k])
                n_left -= fb
            else:
                write_frame(got)
    rep.finish()


def _parallel_plan(job: Job, cfg, tc, model, source, device, serve_for, allow_spatial: bool):
    """``(fn_for, fb)`` for ``_stream_to_writer`` on a pool of more than
    one device, or None to stream single-device. ``spatial_parallel``
    (the GAN enhancer: ``allow_spatial``) splits each frame's rows over
    the devices, an integer S runs n/S frames at once (hybrid);
    ``data_parallel`` gives each device its own frame through
    ``serve_for(batch, device)``."""
    from sequitr_tpu_torch import parallel
    from sequitr_tpu_torch.pipeline import infer as infer_lib

    n_dev = _n_devices(device)
    if n_dev <= 1:
        return None
    sp = job.params.get("spatial_parallel") if allow_spatial else None
    if sp:
        from sequitr_tpu_torch.parallel import spatial as spatial_lib

        s_ways = _spatial_ways(sp, n_dev, tc=tc)
        d_ways = n_dev // s_ways
        spatial = tuple(source.spatial)

        def norm(frames):  # (B, H, W[, C]) on the device, each frame whole
            return infer_lib._normalize(frames if frames.ndim == 4 else frames[..., None], tc)

        try:
            if d_ways > 1 and len(source) > 1:
                mesh2 = parallel.make_mesh2d((d_ways, s_ways), device=device)
                hy = spatial_lib.hybrid_gan_enhance(
                    cfg, mesh2, spatial, batch=d_ways, out_dtype=tc.probs_dtype,
                )
                return (lambda _b: lambda c: hy(model, norm(c))), d_ways
            sp_enh = spatial_lib.spatial_gan_enhance(
                cfg, parallel.make_mesh(s_ways, device=device), spatial, out_dtype=tc.probs_dtype,
            )
        except (ValueError, NotImplementedError) as e:
            raise jobs_lib.JobError(str(e))
        return (lambda _b: lambda f: sp_enh(model, norm(f[None])[0])), 1
    if job.params.get("data_parallel"):
        mesh = parallel.make_mesh(device=device)
        dp = parallel.make_dp_frame_inferrer(lambda d: serve_for(1, d), mesh)
        return (lambda _b: lambda c: dp(model, c)), n_dev
    return None


def _frames_metrics(timer, t0: float, n_frames: int, device) -> str:
    total_s = time.time() - t0
    metrics = dict(timer.summary(), total_s=round(total_s, 4), n_frames=n_frames)
    if total_s > 0:
        metrics["frames_per_sec"] = round(n_frames / total_s, 3)
    metrics["device"] = str(device)
    return json.dumps(metrics)


@register("enhancement_gan")
def enhancement_gan(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """GAN generator enhancement pass over a TIFF stack.

    input: one TIFF per input channel (stacked on the trailing axis).
    params: model (kind ``gan``), patch, overlap, window, normalize, p_lo,
    p_hi, tta, out_dtype, frame_batch, frame_range, roi, polyphase.
    Frames that are a multiple of the model's input multiple and within the
    4.4 M-pixel budget run whole. Output: enhanced.tif (float32 unless
    ``out_dtype``; multi-channel output is frame-major paged, see
    ``enhanced_layout``).
    """
    from sequitr_tpu_torch.pipeline import infer as infer_lib

    device = resolve_device(config.device)
    source = _frame_source(job)
    cfg, model, tc = _gan_setup(job, config, source)

    timer = PhaseTimer()
    n_frames = len(source)
    c_out = cfg.out_channels
    out_path = os.path.join(job.output, "enhanced.tif")
    writer = _append_writer(
        out_path,
        float(n_frames) * np.prod(source.spatial) * c_out
        * np.dtype(tc.probs_dtype).itemsize,
        _out_compression(job),
    )

    def serve_for(batch, dev):
        return infer_lib.cached_gan_enhancer(cfg, tc, tuple(source.spatial), batch, dev)

    def fn_for(batch):
        enhance = serve_for(batch, device)
        return lambda frames: enhance(model, frames)

    fn_for, fb = _parallel_plan(job, cfg, tc, model, source, device, serve_for, True) or (fn_for, None)
    t0 = time.time()
    try:
        _stream_to_writer(job, source, fn_for, timer, writer, c_out, device, fb)
    except BaseException:
        writer.abort()
        raise
    writer.close()
    outputs = {
        "enhanced": out_path,
        "metrics": _frames_metrics(timer, t0, n_frames, device),
    }
    if c_out > 1:
        outputs["enhanced_layout"] = (
            f"pages=(T={n_frames})*(C={c_out}), frame-major"
        )
    return outputs


@register("denoise")
def denoise(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Noise2Void denoising pass over a TIFF stack (kind ``n2v`` models).

    The regression U-Net runs the enhancer's normalize -> tiled forward ->
    stitch chain (raw head, no softmax) and writes the predicted clean
    stack in normalized space. input: one TIFF per channel. params: model,
    patch, overlap, window, normalize, p_lo/p_hi, tta, out_dtype,
    frame_batch, frame_range, roi, polyphase. ``spatial_parallel`` is
    refused (frames this size fit one card). Output: denoised.tif (float32
    by default; multi-channel output is frame-major paged).

    A 3D model routes to the volumetric branch (``_denoise_volumes``): ONE
    volume-sequence entry (optional ``z`` pages per volume), each (Z, H, W)
    volume through the 3D denoiser, volume-major pages.
    """
    from sequitr_tpu_torch.pipeline import infer as infer_lib

    device = resolve_device(config.device)
    if job.params.get("spatial_parallel"):
        raise jobs_lib.JobError(
            "denoise does not support spatial_parallel (frames this size "
            "fit one chip; use data_parallel for timelapse throughput)"
        )
    paths = _resolve_inputs(job)
    cfg, model = _require_model(job, config, "n2v")
    if cfg.dims == 3:
        return _denoise_volumes(job, cfg, model, paths, device)
    source = _frame_source(job)
    if cfg.in_channels != source.n_channels:
        raise jobs_lib.JobError(
            f"model expects {cfg.in_channels} channel(s), "
            f"got {source.n_channels} input stack(s)"
        )
    tc = _tile_config(
        _out_params(job), dims=2,
        frame_spatial=source.spatial, min_multiple=cfg.min_input_multiple,
        exact_only=True, allow_polyphase=True,
    )
    if tc.polyphase:
        _require_polyphase_model(cfg)

    timer = PhaseTimer()
    n_frames = len(source)
    c_out = cfg.num_classes
    out_path = os.path.join(job.output, "denoised.tif")
    writer = _append_writer(
        out_path,
        float(n_frames) * np.prod(source.spatial) * c_out
        * np.dtype(tc.probs_dtype).itemsize,
        _out_compression(job),
    )

    def serve_for(batch, dev):
        return infer_lib.cached_denoiser(cfg, tc, tuple(source.spatial), batch, dev)

    def fn_for(batch):
        den = serve_for(batch, device)
        return lambda frames: den(model, frames)

    fn_for, fb = _parallel_plan(job, cfg, tc, model, source, device, serve_for, False) or (fn_for, None)
    t0 = time.time()
    try:
        _stream_to_writer(job, source, fn_for, timer, writer, c_out, device, fb)
    except BaseException:
        writer.abort()
        raise
    writer.close()
    outputs = {
        "denoised": out_path,
        "metrics": _frames_metrics(timer, t0, n_frames, device),
    }
    if c_out > 1:
        outputs["denoised_layout"] = (
            f"pages=(T={n_frames})*(C={c_out}), frame-major"
        )
    return outputs


def _denoise_volumes(job: Job, cfg, model, paths, device) -> Dict[str, str]:
    """Volumetric branch of ``denoise`` (kind ``n2v``, ``dims == 3``).

    ONE volume-sequence entry (per-timepoint z-stack files, or a single
    file with the ``z`` pages-per-volume param); each (Z, H, W) volume runs
    the 3D denoiser (whole-volume when it fits the 4.4 M-voxel budget, else
    the default 3D tiling), streamed two ahead, and its denoised planes
    append to one page stack. ``frame_range`` selects timepoints; progress
    and cancellation once a volume.
    """
    from sequitr_tpu_torch.data.source import VolumeSequence
    from sequitr_tpu_torch.pipeline import infer as infer_lib

    if job.params.get("roi") is not None:
        raise jobs_lib.JobError("roi serving is 2D-only (crop the volume upstream)")
    if job.params.get("frame_batch"):
        raise jobs_lib.JobError(
            "3D denoise does not take frame_batch (volumes stream one at "
            "a time; a whole volume already fills a dispatch)"
        )
    if len(paths) != 1:
        raise jobs_lib.JobError(
            f"3D denoise takes ONE volume-sequence entry (the model is "
            f"single-channel), got {len(paths)}"
        )
    try:
        source = VolumeSequence(paths[0], z=_parse_z_pages(job))
    except ValueError as e:
        raise jobs_lib.JobError(f"job {job.id}: cannot read inputs: {e}")
    try:
        # close the sequence when a later parameter check rejects the job
        source = _apply_frame_range(job, source)
        tc = _tile_config(
            _out_params(job), dims=3,
            frame_spatial=source.spatial,
            min_multiple=cfg.min_input_multiple,
            exact_only=True,
        )
    except BaseException:
        source.close()
        raise
    n_vols = len(source)
    out_path = os.path.join(job.output, "denoised.tif")
    writer = _append_writer(
        out_path,
        float(n_vols) * np.prod(source.spatial)
        * np.dtype(tc.probs_dtype).itemsize,
        _out_compression(job),
    )
    timer = PhaseTimer()
    t0 = time.time()
    n_dev = _n_devices(device)

    def write_volume(vol):  # (Z, H, W)
        with timer.phase("write"):
            for plane in vol:
                writer.append(plane)

    try:
        with source:
            if job.params.get("data_parallel") and n_dev > 1:
                # TIMEPOINTS sharded over the devices: one whole volume a
                # device a dispatch
                from sequitr_tpu_torch import parallel

                dp = parallel.make_dp_frame_inferrer(
                    lambda d: infer_lib.cached_denoiser(cfg, tc, tuple(source.spatial), 1, d),
                    parallel.make_mesh(device=device),
                )
                for chunk, n_real in _dp_chunk_stream(
                    job, _volume_chunks(source, n_dev), n_vols, n_dev, phase="volumes",
                ):
                    out = dp(model, chunk)
                    with timer.phase("fetch"):
                        got = out.cpu().numpy()[..., 0]  # (D, Z, H, W)
                    for k in range(n_real):
                        write_volume(got[k])
            else:
                den = infer_lib.cached_denoiser(cfg, tc, tuple(source.spatial), None, device)
                rep = jobs_lib.ProgressReporter(job, n_vols)
                for out in infer_lib.stream_frames(
                    lambda v: den(model, v),
                    _reads_fail_fast(job, source.volumes()),
                    prefetch_host=infer_lib._copy_to_host_async, device=device,
                ):
                    with timer.phase("fetch"):
                        got = np.asarray(out)[..., 0]  # (Z, H, W)
                    write_volume(got)
                    rep.step()
                rep.finish()
    except BaseException:
        writer.abort()
        raise
    writer.close()
    total_s = time.time() - t0
    metrics = dict(timer.summary(), total_s=round(total_s, 4), n_volumes=n_vols)
    if total_s > 0:
        metrics["volumes_per_sec"] = round(n_vols / total_s, 3)
    metrics["device"] = str(device)
    outputs = {"denoised": out_path, "metrics": json.dumps(metrics)}
    if n_vols > 1:
        outputs["denoised_layout"] = (
            f"pages=(T={n_vols})*(Z={source.spatial[0]}), volume-major"
        )
    return outputs


def _normalized(items, tc, device, volume: bool):
    """Host target frames (B, *spatial[, C]), or one volume (Z, H, W),
    normalized on ``device`` under ``tc`` (``infer._normalize``: every frame,
    volume and channel its own slice), f32 on the host, with a batch axis
    and a channel axis."""
    import torch

    from sequitr_tpu_torch.pipeline import infer as infer_lib

    with torch.inference_mode():
        t = torch.as_tensor(np.ascontiguousarray(items), device=device)
        if volume:  # one single-channel volume
            t = t[None, ..., None]
        elif t.ndim == 3:
            t = t[..., None]
        return infer_lib._normalize(t, tc).cpu().numpy()


def _psnr(err: np.ndarray) -> float:
    """PSNR in dB of an error over [0, 1]-normalized frames (peak 1)."""
    mse = float(np.mean(err * err))
    return round(10.0 * float(np.log10(1.0 / max(mse, 1e-12))), 4)


def _score_pairs(job, source, tsource, fb, run, device, tc, total, phase):
    """Stream ``source`` through ``run(item) -> out`` or ``(out, x01)``
    (``infer.stream_frames``; ``fb`` frames an item, or one volume for
    ``fb=None``) beside ``tsource``'s items normalized with ``tc``:
    per-frame (per-volume) ``l1``, ``psnr`` and ``psnr_in`` lists
    (``psnr_in``: the normalized input's own score, where ``run`` returns
    it)."""
    from sequitr_tpu_torch.pipeline import infer as infer_lib

    def to_host(res):
        if isinstance(res, tuple):
            return tuple(infer_lib._copy_to_host_async(a) for a in res)
        return infer_lib._copy_to_host_async(res)

    volume = fb is None
    per_item = 1 if volume else fb
    l1s, psnrs, psnrs_in = [], [], []
    n_left = len(source)
    feed = source.volumes() if volume else source.chunks(fb)
    with source, tsource:
        tfeed = _reads_fail_fast(job, tsource.volumes() if volume else tsource.chunks(fb))
        for res in jobs_lib.track(
            job,
            infer_lib.stream_frames(
                run, _reads_fail_fast(job, feed), prefetch_host=to_host, device=device
            ),
            total=total, phase=phase,
        ):
            out, x01 = res if isinstance(res, tuple) else (res, None)
            t01 = _normalized(next(tfeed), tc, device, volume)
            out = np.asarray(out, dtype=np.float32)
            if x01 is not None:
                x01 = np.asarray(x01, dtype=np.float32)
            if volume:  # one volume: a batch of one
                out = out[None]
                x01 = None if x01 is None else x01[None]
            for k in range(min(per_item, n_left)):
                err = out[k] - t01[k]
                l1s.append(float(np.mean(np.abs(err))))
                psnrs.append(_psnr(err))
                if x01 is not None:
                    psnrs_in.append(_psnr(x01[k] - t01[k]))
            n_left -= per_item
    return l1s, psnrs, psnrs_in


def _paired_sources(job: Job, open_, first, second):
    """``(source, target)``, ``open_(first)`` and ``open_(second)``; an
    unreadable input is a JobError, and the first is closed when the
    second cannot be read."""
    try:
        source = open_(first)
    except ValueError as e:
        raise jobs_lib.JobError(f"job {job.id}: cannot read inputs: {e}")
    try:
        tsource = open_(second)
    except ValueError as e:
        source.close()
        raise jobs_lib.JobError(f"job {job.id}: cannot read inputs: {e}")
    return source, tsource


def _check_pair_shapes(source, tsource, what: str) -> None:
    a = (len(source),) + tuple(source.spatial)
    b = (len(tsource),) + tuple(tsource.spatial)
    if a != b:
        raise jobs_lib.JobError(f"{what} shape mismatch: {a} vs {b}")


@register("evaluate_gan")
def evaluate_gan(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Score a GAN enhancement model against clean target frames.

    input: the model's ``in_channels`` raw channel stacks followed by its
    ``out_channels`` target stacks (single-channel models: [raw.tif,
    target.tif], same (T, H, W)). params: model, tiling params,
    frame_batch. Outputs mean L1 and PSNR over the normalized [0, 1]
    frames plus per-frame PSNR (the serving-time counterpart of the GAN
    train job's holdout eval), served as ``enhancement_gan`` serves. The
    targets go through the job's own normalize: on the card one quantile
    pass a raw frame and one a target frame.
    """
    from sequitr_tpu_torch.data.source import FrameSource
    from sequitr_tpu_torch.pipeline import infer as infer_lib

    device = resolve_device(config.device)
    paths = _resolve_inputs(job)
    # the model determines the input split, so load it first
    cfg0, _ = _require_model(job, config, "gan")
    want = cfg0.in_channels + cfg0.out_channels
    if len(paths) != want:
        raise jobs_lib.JobError(
            f"job {job.id}: model needs {cfg0.in_channels} raw channel "
            f"stack(s) then {cfg0.out_channels} target stack(s) "
            f"({want} paths), got {len(paths)}"
        )
    source, tsource = _paired_sources(
        job, lambda ps: FrameSource(paths=ps),
        paths[: cfg0.in_channels], paths[cfg0.in_channels:],
    )
    try:
        _check_pair_shapes(source, tsource, "raw/target")
        cfg, model, tc = _gan_setup(job, config, source)
    except BaseException:
        source.close()
        tsource.close()
        raise
    n_frames = len(source)
    fb = job.params.get("frame_batch")
    fb = int(fb) if fb else _auto_frame_batch(source.spatial)
    fb = max(1, min(fb, n_frames))
    enhance = infer_lib.cached_gan_enhancer(cfg, tc, tuple(source.spatial), fb, device)
    l1s, psnrs, _ = _score_pairs(
        job, source, tsource, fb, lambda ch: enhance(model, ch), device, tc,
        -(-n_frames // fb), "chunks",
    )
    metrics = {
        "l1": round(float(np.mean(l1s)), 6),
        "psnr": round(float(np.mean(psnrs)), 4),
        "per_frame_psnr": psnrs,
        "n_frames": n_frames,
    }
    return {"metrics": json.dumps(metrics)}


@register("evaluate_denoise")
def evaluate_denoise(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Score a Noise2Void model against clean reference frames.

    input: the model's ``in_channels`` noisy channel stacks followed by the
    same number of clean stacks (single-channel: [noisy.tif, clean.tif],
    same (T, H, W)). params: model, tiling params, frame_batch, normalize
    (applied to BOTH sides so L1/PSNR compare matched intensity spaces;
    "none" for data in the model's trained scale). Outputs mean L1/PSNR,
    per-frame PSNR, and the raw noisy input's own PSNR.

    The denoiser hands back the normalized input it ran on
    (``infer.cached_denoiser(with_input=True)``), so the noisy side is
    normalized once: on the card two quantile passes a frame (noisy and
    clean) with the kernel normalize, none with ``"none"``.

    A 3D model routes to the volumetric branch: input = [noisy entry,
    clean entry] volume sequences (``z`` pages param applies to both),
    per-volume PSNR (``_evaluate_denoise_volumes``).
    """
    from sequitr_tpu_torch.data.source import FrameSource
    from sequitr_tpu_torch.pipeline import infer as infer_lib

    device = resolve_device(config.device)
    paths = _resolve_inputs(job)
    cfg, model = _require_model(job, config, "n2v")
    if cfg.dims == 3:
        return _evaluate_denoise_volumes(job, cfg, model, paths, device)
    want = 2 * cfg.in_channels
    if len(paths) != want:
        raise jobs_lib.JobError(
            f"job {job.id}: model needs {cfg.in_channels} noisy channel "
            f"stack(s) then {cfg.in_channels} clean stack(s) "
            f"({want} paths), got {len(paths)}"
        )
    source, tsource = _paired_sources(
        job, lambda ps: FrameSource(paths=ps),
        paths[: cfg.in_channels], paths[cfg.in_channels:],
    )
    try:
        # close both lazy readers when a check rejects the job
        _check_pair_shapes(source, tsource, "noisy/clean")
        # no out_dtype -> probs_dtype mapping: quantized predictions would
        # corrupt the metrics of a "successful" run
        tc = _tile_config(
            job.params, dims=2,
            frame_spatial=source.spatial, min_multiple=cfg.min_input_multiple,
            exact_only=True,
        )
    except BaseException:
        source.close()
        tsource.close()
        raise
    n_frames = len(source)
    fb = job.params.get("frame_batch")
    fb = int(fb) if fb else _auto_frame_batch(source.spatial)
    fb = max(1, min(fb, n_frames))
    den = infer_lib.cached_denoiser(cfg, tc, tuple(source.spatial), fb, device, with_input=True)
    l1s, psnrs, psnrs_in = _score_pairs(
        job, source, tsource, fb, lambda ch: den(model, ch), device, tc,
        -(-n_frames // fb), "chunks",
    )
    metrics = {
        "l1": round(float(np.mean(l1s)), 6),
        "psnr": round(float(np.mean(psnrs)), 4),
        "psnr_noisy_input": round(float(np.mean(psnrs_in)), 4),
        "per_frame_psnr": psnrs,
        "n_frames": n_frames,
    }
    return {"metrics": json.dumps(metrics)}


def _evaluate_denoise_volumes(job: Job, cfg, model, paths, device) -> Dict[str, str]:
    """Volumetric branch of ``evaluate_denoise`` (``dims == 3`` models).

    input: [noisy volume-sequence entry, clean volume-sequence entry]
    (each a dir/glob/file; the ``z`` pages-per-volume param applies to
    BOTH). Per-volume PSNR/L1 in the job's normalize space, plus the noisy
    input's own PSNR; one volume a dispatch, two quantile passes a volume
    on the card (the noisy one shared with the denoiser, the clean one).
    """
    from sequitr_tpu_torch.data.source import VolumeSequence
    from sequitr_tpu_torch.pipeline import infer as infer_lib

    if len(paths) != 2:
        raise jobs_lib.JobError(
            f"3D evaluate_denoise takes [noisy entry, clean entry] "
            f"(the model is single-channel), got {len(paths)} input(s)"
        )
    z_pages = _parse_z_pages(job)
    source, tsource = _paired_sources(
        job, lambda entry: VolumeSequence(entry, z=z_pages), paths[0], paths[1]
    )
    try:
        _check_pair_shapes(source, tsource, "noisy/clean")
        tc = _tile_config(
            job.params, dims=3,
            frame_spatial=source.spatial, min_multiple=cfg.min_input_multiple,
            exact_only=True,
        )
    except BaseException:
        source.close()
        tsource.close()
        raise
    n_vols = len(source)
    den = infer_lib.cached_denoiser(cfg, tc, tuple(source.spatial), None, device, with_input=True)
    l1s, psnrs, psnrs_in = _score_pairs(
        job, source, tsource, None, lambda v: den(model, v), device, tc, n_vols, "volumes",
    )
    metrics = {
        "l1": round(float(np.mean(l1s)), 6),
        "psnr": round(float(np.mean(psnrs)), 4),
        "psnr_noisy_input": round(float(np.mean(psnrs_in)), 4),
        "per_volume_psnr": psnrs,
        "n_volumes": n_vols,
    }
    return {"metrics": json.dumps(metrics)}
