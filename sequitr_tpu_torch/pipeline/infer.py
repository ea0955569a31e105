"""Tiled sliding-window inference (port of ``sequitr_tpu.pipeline.infer``).

The per-frame chain of the JAX package:

    normalize -> extract overlapping patches -> batched U-Net forward
    -> softmax -> weighted stitch-blend -> argmax label map

in eager PyTorch on the caller's device. Frames arrive in their storage
dtype (uint16 stacks cross to the card at 2 bytes a pixel) and are cast
there. A batch of frames runs as one batch: one quantile pass (two kernel
launches) finds every frame's percentiles, and all their patches go
through the network together.

``stream_frames`` keeps frames flowing two ahead of the consumer:
host->card copies of pinned frames run on a side stream, and results start
their card->host copy into pinned memory on another side stream as soon as
they are queued, with a CUDA event the consumer waits on.

``TileConfig.polyphase`` serves through ``models.polyphase`` (2D only).

Not ported yet (later slices): 3D volumes, and the GAN, denoiser, flows and
stars inferrers.
"""

from __future__ import annotations

import dataclasses
import functools
from collections import deque
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from sequitr_tpu_torch.models import polyphase
from sequitr_tpu_torch.models.unet import UNet, UNetConfig
from sequitr_tpu_torch.ops import normalize as norm_ops
from sequitr_tpu_torch.ops import tiling
from sequitr_tpu_torch.utils import resolve_device

__all__ = [
    "TileConfig",
    "InferenceResult",
    "HostArray",
    "tiled_apply",
    "make_frame_inferrer",
    "cached_frame_inferrer",
    "cached_batch_inferrer",
    "stream_frames",
    "infer_stack",
]

_LABEL_DTYPES = {"int32": torch.int32, "uint16": torch.uint16}
_PROBS_DTYPES = {"float32": torch.float32, "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Tiling + normalization config for sliding-window inference."""

    patch: Tuple[int, ...] = (256, 256)
    overlap: Tuple[int, ...] = (64, 64)
    window: str = "hann"
    normalize: str = "auto"  # "auto" | "pallas" | "fast" | "exact" | "none"
    p_lo: float = 5.0
    p_hi: float = 99.5
    patch_batch: Optional[int] = None  # patches per forward (None = all)
    # dtype of the emitted label map; the server asks for "uint16", the
    # on-disk format, cast on the device before the copy to the host
    labels_dtype: str = "int32"
    # dtype of the emitted softmax maps ("float16" halves the copy and
    # probs.tif); argmax runs on the f32 maps before the cast
    probs_dtype: str = "float32"
    # test-time augmentation: average softmax maps over 2/4/8 flip (and, at
    # 8, transpose: square frames only) variants of the whole frame
    tta: int = 1
    # polyphase serving forward (models.polyphase): the two thin
    # full-resolution U-Net levels run at half resolution x 4-wide channels
    # on the same weights, exactly (up to float reassociation). 2D folded
    # transpose-upsample models with even patch dims only; the build fails
    # loudly otherwise
    polyphase: bool = False
    # False = labels-only: no softmax maps are returned, and a single-tile
    # no-TTA serve skips the softmax altogether (argmax of logits == argmax
    # of softmax)
    emit_probs: bool = True

    def __post_init__(self):
        if self.labels_dtype not in _LABEL_DTYPES:
            raise ValueError(
                f"labels_dtype must be 'int32' or 'uint16', got {self.labels_dtype!r}"
            )
        if self.probs_dtype not in _PROBS_DTYPES:
            raise ValueError(
                f"probs_dtype must be 'float32' or 'float16', got {self.probs_dtype!r}"
            )
        if self.tta not in (1, 2, 4, 8):
            raise ValueError(f"tta must be 1, 2, 4 or 8, got {self.tta}")
        if self.patch_batch is not None and self.patch_batch < 1:
            raise ValueError(
                f"patch_batch must be None (auto) or >= 1, got {self.patch_batch}"
            )


@dataclasses.dataclass
class InferenceResult:
    probs: Any  # (*spatial, K) softmax map (tensor or HostArray), or None
    labels: Any  # (*spatial,) label map (tensor or HostArray)


def _normalize(frames: torch.Tensor, tc: TileConfig) -> torch.Tensor:
    """(B, *spatial, C) frames -> f32, percentiles per frame and channel.

    ``auto`` picks the histogram kernel (``"pallas"``, 1024 bins) on CUDA
    and the plain 4096-bin histogram (``"fast"``) on the CPU — the JAX
    package's accelerator and CPU choices. Any other mode name means
    ``fast``, as in the JAX package.
    """
    x = frames.to(torch.float32)
    mode = tc.normalize
    if mode == "none":
        return x
    b, c = x.shape[0], x.shape[-1]
    spatial = tuple(x.shape[1:-1])
    # every (frame, channel) pair is its own slice: fold frames into channels
    xc = torch.movedim(x, 0, -2).reshape(*spatial, b * c)
    if mode == "auto":
        mode = "pallas" if x.is_cuda else "fast"
    if mode == "exact":
        out = norm_ops.percentile_normalize(xc, tc.p_lo, tc.p_hi, channel_axis=True)
    elif mode == "pallas":
        out = norm_ops.percentile_normalize_pallas(
            xc, tc.p_lo, tc.p_hi, channel_axis=True
        )
    else:
        out = norm_ops.percentile_normalize_fast(
            xc, tc.p_lo, tc.p_hi, channel_axis=True
        )
    return torch.movedim(out.reshape(*spatial, b, c), -2, 0)


def _pad_trailing(x: torch.Tensor, pads: Tuple[int, ...], mode: str) -> torch.Tensor:
    """Pad spatial axis i of (B, *spatial, C) by ``pads[i]`` at its end.

    ``symmetric`` is numpy's mode: the mirror that repeats the edge pixel
    (``F.pad``'s ``reflect`` leaves it out). ``edge`` repeats the edge.
    Axes pad in order, each on the already padded array, as numpy does.
    """
    for ax, d in enumerate(pads, start=1):
        if not d:
            continue
        n = x.shape[ax]
        if mode == "symmetric":
            tail = x.narrow(ax, n - d, d).flip(ax)
        else:
            shape = list(x.shape)
            shape[ax] = d
            tail = x.narrow(ax, n - 1, 1).expand(shape)
        x = torch.cat([x, tail], dim=ax)
    return x


def tiled_apply(
    forward: Callable,
    x: torch.Tensor,
    grid,
    spatial: Tuple[int, ...],
    tc: TileConfig,
    out_channels: int,
) -> torch.Tensor:
    """extract patches -> (chunked) ``forward`` -> stitch, for (B, *spatial, C).

    ``forward``: (N, *patch, C_in) -> (N, *patch, out_channels). Patches of
    all B frames share forwards of ``tc.patch_batch`` (default: all at
    once; 16 for grids over 32 tiles, as the JAX package chunks).
    """
    b = x.shape[0]
    t = len(grid)
    if t == 1 and tuple(tc.patch) == tuple(spatial) and not any(tc.overlap):
        # one tile, no overlap: the window is all ones and the stitch is
        # exactly the identity
        return forward(x)
    patches = torch.cat(
        [tiling.extract_patches(x[i], grid, tc.patch) for i in range(b)]
    )
    pb = tc.patch_batch if tc.patch_batch is not None else (16 if t > 32 else None)
    if pb is None or pb >= patches.shape[0]:
        out = forward(patches)
    else:
        out = torch.cat(
            [forward(patches[i : i + pb]) for i in range(0, patches.shape[0], pb)]
        )
    out = out.reshape((b, t) + tuple(tc.patch) + (out_channels,))
    return torch.stack(
        [
            tiling.stitch_patches(out[i], grid, spatial, tc.overlap, tc.window)
            for i in range(b)
        ]
    )


def _tta_variants(tta: int, spatial: Tuple[int, int]):
    """2D symmetry variants as (flip_axes, transpose) pairs, identity first.

    Axes are frame axes (0 = rows). tta=8 composes the 4 flips with the
    transpose (square frames only).
    """
    flips4 = [(), (0,), (1,), (0, 1)]
    if tta == 1:
        return [((), False)]
    if tta == 2:
        return [((), False), ((0,), False)]
    if tta == 4:
        return [(f, False) for f in flips4]
    if spatial[0] != spatial[1]:
        raise ValueError(
            f"tta=8 in 2D adds the transpose and needs a square frame, "
            f"got {spatial}"
        )
    return [(f, t) for t in (False, True) for f in flips4]


def _tta_average(run: Callable, x: torch.Tensor, variants) -> torch.Tensor:
    """Average ``run`` over symmetry variants of a (B, *spatial, C) batch:
    transform the input, inverse-transform the output, accumulate."""
    acc = None
    for flips, transpose in variants:
        xi = x
        for ax in flips:
            xi = torch.flip(xi, dims=(ax + 1,))
        if transpose:
            xi = torch.swapaxes(xi, 1, 2)
        oi = run(xi.contiguous())
        if transpose:
            oi = torch.swapaxes(oi, 1, 2)
        for ax in flips:
            oi = torch.flip(oi, dims=(ax + 1,))
        acc = oi if acc is None else acc + oi
    return acc if len(variants) == 1 else acc / len(variants)


def _check_polyphase(tc: TileConfig, cfg: UNetConfig) -> None:
    """Build-time gate of ``tc.polyphase``. ``cfg`` may carry batch norm:
    serving folds it (``unet.fold_batchnorm``), so it is judged as folded."""
    if not tc.polyphase:
        return
    if cfg.dims == 3:
        raise NotImplementedError(
            "polyphase serving of 3D models is not ported yet (the 3D "
            "serving slice of the port)"
        )
    if not polyphase.eligible(dataclasses.replace(cfg, norm="none"), tc.patch):
        raise ValueError(
            "polyphase serving requires a transpose-upsample model "
            "without model-level space_to_depth and an even patch "
            "(H, W axes for 3D); "
            f"got dims={cfg.dims} s2d={cfg.space_to_depth} "
            f"upsample={cfg.upsample!r} patch={tc.patch}"
        )


def _make_batch_infer(
    cfg: UNetConfig,
    tc: TileConfig,
    frame_spatial: Tuple[int, ...],
    device: torch.device,
) -> Callable:
    """``infer(model, frames) -> (probs | None, labels)`` over a leading
    frame axis: frames (B, H, W) or (B, H, W, C)."""
    frame_spatial = tuple(frame_spatial)
    nd = len(frame_spatial)
    if nd != 2:
        raise NotImplementedError(
            f"{nd}D frames: only 2D serving is ported so far (3D is a later "
            "slice of the port)"
        )
    edge_pad = tuple(max(0, p - s) for s, p in zip(frame_spatial, tc.patch))
    padded_spatial = tuple(s + d for s, d in zip(frame_spatial, edge_pad))
    # "symmetric" allows pad == size (whole-frame mirror); beyond that the
    # frame is less than half a patch — replicate the edge for the rest
    pad_mode = (
        "symmetric"
        if all(d <= s for s, d in zip(frame_spatial, edge_pad))
        else "edge"
    )
    grid = tiling.tile_grid(padded_spatial, tc.patch, tc.overlap)
    variants = _tta_variants(tc.tta, padded_spatial)
    _check_polyphase(tc, cfg)
    # labels-only single-tile serves skip the softmax: one tile means the
    # stitch is a per-pixel positive rescale, and argmax is invariant under it
    logits_fast = (
        not tc.emit_probs and tc.tta == 1 and tuple(tc.patch) == padded_spatial
    )
    labels_dtype = _LABEL_DTYPES[tc.labels_dtype]
    probs_dtype = _PROBS_DTYPES[tc.probs_dtype]

    def infer(model: UNet, frames):
        with torch.inference_mode():
            frames = torch.as_tensor(frames, device=device)
            if frames.ndim == nd + 1:
                frames = frames[..., None]
            x = _normalize(frames, tc)
            if any(edge_pad):
                x = _pad_trailing(x, edge_pad, pad_mode)

            net = polyphase.serving(model) if tc.polyphase else model

            def forward(batch):
                logits = net(batch)
                return logits if logits_fast else torch.softmax(logits, dim=-1)

            probs = _tta_average(
                lambda xi: tiled_apply(
                    forward, xi, grid, padded_spatial, tc, cfg.num_classes
                ),
                x,
                variants,
            )
            if any(edge_pad):
                probs = probs[(slice(None),) + tuple(slice(0, s) for s in frame_spatial)]
            labels = torch.argmax(probs, dim=-1).to(labels_dtype)
            if not tc.emit_probs:
                return None, labels
            return probs.to(probs_dtype), labels

    return infer


def make_frame_inferrer(
    cfg: UNetConfig,
    tc: TileConfig,
    frame_spatial: Tuple[int, ...],
    device: Union[str, torch.device, None] = None,
) -> Callable:
    """Build ``infer(model, frame) -> (probs, labels)`` for one frame shape.

    ``frame``: (*frame_spatial,) or (*frame_spatial, C_in), a tensor or a
    numpy array (moved to ``device``, default the CUDA card). Normalize,
    tile, U-Net forward over all patches, per-patch softmax, stitch-blend,
    argmax. Frames smaller than the patch are mirror-padded at the trailing
    edge (after normalization: the percentiles see real pixels only) and
    the outputs cropped back. ``tc.tta > 1`` averages softmax maps over
    whole-frame symmetry variants.

    ``model`` is a ``UNet`` for ``cfg`` (BN folded or not: the server folds
    once at load; ``tc.polyphase`` needs it folded). ``probs`` is None when
    ``tc.emit_probs`` is False.
    """
    batch_infer = _make_batch_infer(cfg, tc, frame_spatial, resolve_device(device))

    def infer(model: UNet, frame):
        probs, labels = batch_infer(model, torch.as_tensor(frame)[None])
        return (None if probs is None else probs[0]), labels[0]

    return infer


@functools.lru_cache(maxsize=32)
def cached_frame_inferrer(
    cfg: UNetConfig,
    tc: TileConfig,
    frame_spatial: Tuple[int, ...],
    device: Union[str, torch.device, None] = None,
) -> Callable:
    """Process-wide cache of frame inferrers, keyed on the frozen configs,
    the frame shape and the device; the model is a per-call argument."""
    return make_frame_inferrer(cfg, tc, frame_spatial, device)


@functools.lru_cache(maxsize=32)
def cached_batch_inferrer(
    cfg: UNetConfig,
    tc: TileConfig,
    frame_spatial: Tuple[int, ...],
    batch: int,
    device: Union[str, torch.device, None] = None,
) -> Callable:
    """``infer(model, frames) -> (probs, labels)`` over ``batch`` frames
    (B, *spatial[, C]) at once: one normalize launch, one network batch.
    Small frames run faster batched than one at a time."""
    batch_infer = _make_batch_infer(cfg, tc, frame_spatial, resolve_device(device))

    def infer(model: UNet, frames):
        if len(frames) != batch:
            raise ValueError(f"expected {batch} frames, got {len(frames)}")
        return batch_infer(model, frames)

    return infer


class _ReadError:
    def __init__(self, exc: BaseException):
        self.exc = exc


def _iter_read_ahead(it: Iterator, depth: int) -> Iterator:
    """Pull items from ``it`` on a daemon thread, up to ``depth`` ahead.

    Disk reads inside ``next()`` overlap the dispatch loop. A bounded queue
    keeps memory at ``depth`` items. Exceptions in the producer re-raise at
    the consumer's ``next()``. If the consumer abandons the generator, the
    finally-block stops the producer so no thread leaks.
    """
    import queue as queue_mod
    import threading

    q: "queue_mod.Queue" = queue_mod.Queue(maxsize=max(1, depth))
    stop = threading.Event()
    done = object()

    def _put(item) -> bool:
        """Put unless the consumer has gone away; False = stop."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue_mod.Full:
                continue
        return False

    def produce():
        try:
            for item in it:
                if not _put(item):
                    return
            _put(done)
        except BaseException as e:  # re-raised consumer-side
            _put(_ReadError(e))

    threading.Thread(target=produce, daemon=True, name="frame-reader").start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, _ReadError):
                raise item.exc
            yield item
    finally:
        stop.set()


class HostArray:
    """A device tensor's copy into pinned host memory, started on a side
    stream. ``np.asarray`` waits for the copy's CUDA event, then returns
    the host array; indexing selects lazily (``result[k]`` of a batch)."""

    def __init__(self, host: torch.Tensor, event, index: Tuple = ()):
        self._host = host
        self._event = event
        self._index = index

    def __getitem__(self, k) -> "HostArray":
        return HostArray(self._host, self._event, self._index + (k,))

    def __array__(self, dtype=None, copy=None):
        self._event.synchronize()
        a = self._host.numpy()
        for k in self._index:
            a = a[k]
        return a if dtype is None else a.astype(dtype, copy=False)


_D2H_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _copy_to_host_async(t: Optional[torch.Tensor]):
    """Start ``t``'s copy to pinned host memory; returns a ``HostArray``.

    The copy runs on a per-device side stream after the work already queued
    on the current stream (the work that computes ``t``), so it overlaps
    whatever is queued next. CPU tensors (and None) pass through.
    """
    if t is None or t.device.type != "cuda":
        return t
    stream = _D2H_STREAMS.get(t.device)
    if stream is None:
        stream = _D2H_STREAMS.setdefault(t.device, torch.cuda.Stream(t.device))
    stream.wait_stream(torch.cuda.current_stream(t.device))
    with torch.cuda.stream(stream):
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    # the caching allocator must not hand t's memory out before the copy ends
    t.record_stream(stream)
    return HostArray(host, event)


def stream_frames(
    fn: Callable,
    frames: Iterable[np.ndarray],
    prefetch: int = 2,
    prefetch_host: Optional[Callable] = None,
    device: Union[str, torch.device, None] = None,
) -> Iterator:
    """Stream host frames through a per-frame device function, ``prefetch`` ahead.

    Each host frame goes to ``device`` in its own dtype; on CUDA from pinned
    memory on a side stream, which the compute stream then waits for.
    ``fn(device_frame)`` is queued ``prefetch`` frames before its result is
    consumed (PyTorch queues kernels without waiting for them), and disk
    reads run on a reader thread the same distance ahead.

    ``prefetch_host(result) -> result``: called right after each queueing;
    it starts the card->host copies of exactly the outputs the caller will
    fetch (``_copy_to_host_async``) and returns what to yield in their
    place. Yields results in order.
    """
    device = resolve_device(device)
    frames = _iter_read_ahead(iter(frames), depth=prefetch)
    h2d = torch.cuda.Stream(device) if device.type == "cuda" else None
    queue: deque = deque()

    def launch(host_frame):
        t = torch.from_numpy(np.ascontiguousarray(host_frame))
        if h2d is not None:
            compute = torch.cuda.current_stream(device)
            with torch.cuda.stream(h2d):
                t = t.pin_memory().to(device, non_blocking=True)
            compute.wait_stream(h2d)
            t.record_stream(compute)
        out = fn(t)
        if prefetch_host is not None:
            out = prefetch_host(out)
        return out

    for _ in range(prefetch):
        try:
            queue.append(launch(next(frames)))
        except StopIteration:
            break

    while queue:
        out = queue.popleft()
        try:
            queue.append(launch(next(frames)))
        except StopIteration:
            pass
        yield out


def infer_stack(
    infer_fn: Callable,
    model: UNet,
    frames: Iterable[np.ndarray],
    prefetch: int = 2,
    fetch_probs: bool = False,
    device: Union[str, torch.device, None] = None,
) -> Iterator[InferenceResult]:
    """Stream a timelapse stack through ``infer_fn(model, frame)``.

    Label maps (and softmax maps too when ``fetch_probs``) start their copy
    to the host as soon as their frame is queued, so the transfer overlaps
    the next frame's compute; ``np.asarray(result.labels)`` waits for it.
    """

    def prefetch_host(out):
        probs, labels = out
        if fetch_probs:
            probs = _copy_to_host_async(probs)
        return probs, _copy_to_host_async(labels)

    for probs, labels in stream_frames(
        lambda f: infer_fn(model, f), frames, prefetch,
        prefetch_host=prefetch_host, device=device,
    ):
        yield InferenceResult(probs=probs, labels=labels)
