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

Frames are 2D (H, W) or 3D (Z, H, W) volumes, by the length of
``frame_spatial``; a volume's percentiles are over all its Z*H*W voxels.
``TileConfig.polyphase`` serves through ``models.polyphase`` (``apply3d``
for volumes).

The GAN enhancer (``make_gan_enhancer``) and the Noise2Void denoiser
(``make_denoiser``) run the same normalize -> tile -> forward -> stitch
chain with TTA, but no softmax and no edge padding: their output is the
network's (activated) regression map in ``tc.probs_dtype``.

The instance families run the same chain on their regression heads and
finish on the device: ``make_flows_segmenter`` divides the flow channels by
``FLOW_SCALE``, takes the sigmoid of the cell-probability channel and
integrates the flow under ``prob > cellprob_threshold``
(``ops.flows.follow_flows``, or ``follow_flows_doubling``), for a
``flows`` U-Net or Cellpose's CPnet (``models.cpnet``, tile by tile, each
tile with its own style vector);
``make_stars_predictor`` takes the sigmoid of the object channel and clamps
the ray distances at 0. Both refuse TTA (vector and per-ray channels would
need component-aware flips), as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import functools
from collections import deque
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from sequitr_tpu_torch import tracing
from sequitr_tpu_torch.models import cpnet as cpnet_lib
from sequitr_tpu_torch.models import gan as gan_lib
from sequitr_tpu_torch.models import polyphase
from sequitr_tpu_torch.models import unet as unet_lib
from sequitr_tpu_torch.models.unet import UNet, UNetConfig
from sequitr_tpu_torch.ops import flows as flows_ops
from sequitr_tpu_torch.ops import normalize as norm_ops
from sequitr_tpu_torch.ops import tiling
from sequitr_tpu_torch.utils import derived, resolve_device

__all__ = [
    "TileConfig",
    "InferenceResult",
    "HostArray",
    "tiled_apply",
    "make_frame_inferrer",
    "cached_frame_inferrer",
    "cached_batch_inferrer",
    "make_gan_enhancer",
    "cached_gan_enhancer",
    "make_denoiser",
    "cached_denoiser",
    "make_flows_segmenter",
    "cached_flows_segmenter",
    "make_stars_predictor",
    "cached_stars_predictor",
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
    # test-time augmentation: average softmax maps over 2/4/8 flip variants
    # of the whole frame (8 adds the transpose in 2D, square frames only,
    # or the z-flip in 3D)
    tta: int = 1
    # polyphase serving forward (models.polyphase): the two thin
    # full-resolution U-Net levels run at half resolution x 4-wide channels
    # on the same weights, exactly (up to float reassociation). Folded
    # transpose-upsample models without model-level space-to-depth, even
    # patch dims (the H, W axes for 3D); the build fails loudly otherwise
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


def _tta_variants(nd: int, tta: int, spatial: Tuple[int, ...]):
    """Symmetry variants as (flip_axes, transpose) pairs, identity first.

    Axes are frame axes (0 = rows in 2D, z in 3D). 2D tta=8 composes the 4
    flips with the transpose (square frames only); 3D flips the in-plane
    axes (1, 2) at tta=2/4, and tta=8 is the full 2^3 flip group with z.
    """
    if tta == 1:
        return [((), False)]
    if nd == 2:
        flips4 = [(), (0,), (1,), (0, 1)]
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
    if tta == 2:
        return [((), False), ((1,), False)]
    if tta == 4:
        return [(f, False) for f in [(), (1,), (2,), (1, 2)]]
    return [
        (f, False)
        for f in [(), (0,), (1,), (2,), (0, 1), (0, 2), (1, 2), (0, 1, 2)]
    ]


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
    serving folds it (``unet.fold_batchnorm``), so it is judged as folded.
    3D models use the (1, 2, 2) phase factor (z never phased)."""
    if not tc.polyphase:
        return
    folded = dataclasses.replace(cfg, norm="none")
    ok = (
        polyphase.eligible3d(folded, tc.patch)
        if cfg.dims == 3
        else polyphase.eligible(folded, tc.patch)
    )
    if not ok:
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
    frame axis: frames (B, *spatial) or (B, *spatial, C), spatial (H, W) or
    (Z, H, W). Each build adds 1 to the counter ``inferrer.builds`` (a miss
    of ``cached_frame_inferrer`` / ``cached_batch_inferrer``)."""
    tracing.count("inferrer.builds")
    frame_spatial = tuple(frame_spatial)
    nd = len(frame_spatial)
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
    variants = _tta_variants(nd, tc.tta, padded_spatial)
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

    ``frame_spatial`` is (H, W), or (Z, H, W) for a volume and a 3D model.
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


# fold once per model state, as the server does at load: the enhancer and
# the denoiser take models folded or not, as the JAX package's fold in-graph;
# a model updated in place (a train step, keep_best, an EMA swap) is folded
# anew, and a retired model takes its folded copy with it
def _folded_unet(model: UNet) -> UNet:
    return derived(model, "fold_batchnorm", unet_lib.fold_batchnorm)


def _folded_gan(model: gan_lib.GAN) -> gan_lib.GAN:
    return derived(model, "fold_generator", gan_lib.fold_generator)


def _make_batch_map(
    run_cfg: UNetConfig,
    tc: TileConfig,
    frame_spatial: Tuple[int, ...],
    device: torch.device,
    forward_of: Callable,
    out_channels: int,
    with_input: bool = False,
) -> Callable:
    """``run(model, frames) -> (B, *spatial, out_channels)`` in
    ``tc.probs_dtype``: normalize, TTA over tiled ``forward_of(model)``,
    Hann stitch; no softmax, no edge padding (the regression serves of the
    GAN enhancer and the denoiser). ``run_cfg``: the folded network's
    ``UNetConfig``, for the polyphase gate. ``with_input``: ``run`` returns
    ``(out, x)``, ``x`` the normalized f32 input the network saw (one
    normalize serves both)."""
    spatial = tuple(frame_spatial)
    nd = len(spatial)
    grid = tiling.tile_grid(spatial, tc.patch, tc.overlap)
    variants = _tta_variants(nd, tc.tta, spatial)
    _check_polyphase(tc, run_cfg)
    out_dtype = _PROBS_DTYPES[tc.probs_dtype]

    def run(model, frames):
        with torch.inference_mode():
            frames = torch.as_tensor(frames, device=device)
            if frames.ndim == nd + 1:
                frames = frames[..., None]
            x = _normalize(frames, tc)
            forward = forward_of(model)
            out = _tta_average(
                lambda xi: tiled_apply(forward, xi, grid, spatial, tc, out_channels),
                x,
                variants,
            ).to(out_dtype)
            return (out, x) if with_input else out

    return run


def _single_or_batch(run: Callable, batch: Optional[int]) -> Callable:
    """``run(model, frames)`` as ``fn(model, frame)`` (``batch=None``) or as
    ``fn(model, frames)`` over exactly ``batch`` frames."""
    if batch is None:

        def one(model, frame):
            out = run(model, torch.as_tensor(frame)[None])
            return tuple(t[0] for t in out) if isinstance(out, tuple) else out[0]

        return one

    def fn(model, frames):
        if len(frames) != batch:
            raise ValueError(f"expected {batch} frames, got {len(frames)}")
        return run(model, frames)

    return fn


def _gan_batch_map(cfg: gan_lib.GANConfig, tc: TileConfig, frame_spatial, device) -> Callable:
    def forward_of(model):
        model = _folded_gan(model)
        gen = polyphase.serving(model.gen) if tc.polyphase else model.gen
        return lambda patches: gan_lib.activate(model.cfg, gen(patches))

    run_cfg = dataclasses.replace(cfg.generator_config, norm="none")
    return _make_batch_map(
        run_cfg, tc, frame_spatial, resolve_device(device), forward_of, cfg.out_channels
    )


def make_gan_enhancer(
    cfg: gan_lib.GANConfig,
    tc: TileConfig,
    frame_spatial: Tuple[int, ...],
    device: Union[str, torch.device, None] = None,
) -> Callable:
    """``enhance(model, frame) -> (H, W, C_out)`` for one frame shape.

    ``model`` is a ``gan.GAN`` for ``cfg`` (folded or not: it is folded
    once, ``gan.fold_generator``). ``frame``: (H, W) or (H, W, C_in), on
    the host or the card. Normalize, tiled generator + output activation,
    Hann stitch, TTA over ``tc.tta`` symmetry variants; the output in
    ``tc.probs_dtype``.
    """
    return _single_or_batch(_gan_batch_map(cfg, tc, frame_spatial, device), None)


@functools.lru_cache(maxsize=32)
def cached_gan_enhancer(
    cfg: gan_lib.GANConfig,
    tc: TileConfig,
    frame_spatial: Tuple[int, ...],
    batch: Optional[int] = None,
    device: Union[str, torch.device, None] = None,
) -> Callable:
    """Process-wide cache of GAN enhancers: ``enhance(model, frame)`` for
    ``batch=None``, else ``enhance(model, frames)`` over ``batch`` frames
    (B, H, W[, C]) -> (B, H, W, C_out)."""
    return _single_or_batch(_gan_batch_map(cfg, tc, frame_spatial, device), batch)


def _unet_batch_map(
    cfg: UNetConfig, tc: TileConfig, frame_spatial, device, with_input: bool = False,
    zero_channels: int = 0,
) -> Callable:
    """``_make_batch_map`` over a regression U-Net's raw head (the
    denoiser's, the flows' and the stars'), BN folded once per model;
    ``zero_channels`` as ``make_flows_segmenter`` takes them."""
    def forward_of(model):
        model = _folded_unet(model)
        net = polyphase.serving(model) if tc.polyphase else model
        return _with_zero_channels(net, zero_channels)

    run_cfg = dataclasses.replace(cfg, norm="none")
    return _make_batch_map(
        run_cfg, tc, frame_spatial, resolve_device(device), forward_of, cfg.num_classes,
        with_input,
    )


def make_denoiser(
    cfg: UNetConfig,
    tc: TileConfig,
    frame_spatial: Tuple[int, ...],
    device: Union[str, torch.device, None] = None,
) -> Callable:
    """``denoise(model, frame) -> (*frame_spatial, C_out)``: the serving
    pass of a Noise2Void regression U-Net (kind ``n2v``, 2D or 3D).

    The enhancer's chain with the raw head (no softmax): the output is the
    predicted clean intensity in normalized space, in ``tc.probs_dtype``.
    Batch norm is folded once per model, as the JAX package folds it.
    """
    return _single_or_batch(_unet_batch_map(cfg, tc, frame_spatial, device), None)


@functools.lru_cache(maxsize=32)
def cached_denoiser(
    cfg: UNetConfig,
    tc: TileConfig,
    frame_spatial: Tuple[int, ...],
    batch: Optional[int] = None,
    device: Union[str, torch.device, None] = None,
    with_input: bool = False,
) -> Callable:
    """Process-wide cache of denoisers (``cached_gan_enhancer``'s forms).
    ``with_input``: each call returns ``(denoised, x)``, ``x`` the
    normalized f32 input (``evaluate_denoise`` scores the noisy input on
    it without a second normalize)."""
    return _single_or_batch(
        _unet_batch_map(cfg, tc, frame_spatial, device, with_input), batch
    )


def _folded_cpnet(model) -> cpnet_lib.ServingCPnet:
    return model if isinstance(model, cpnet_lib.ServingCPnet) else derived(
        model, "fold_cpnet", cpnet_lib.fold)


def _with_zero_channels(forward: Callable, n: int) -> Callable:
    """``forward`` on patches with ``n`` zero channels appended after the
    normalized ones (Cellpose's grayscale mode: ``channels = [0, 0]``)."""
    if not n:
        return forward

    def padded(patches):
        zeros = patches.new_zeros(patches.shape[:-1] + (n,))
        return forward(torch.cat([patches, zeros], dim=-1))

    return padded


def make_flows_segmenter(
    cfg: Union[UNetConfig, cpnet_lib.CPnetConfig],
    tc: TileConfig,
    frame_spatial: Tuple[int, ...],
    n_iter: int = 200,
    step_size: float = 1.0,
    cellprob_threshold: float = 0.5,
    integrator: str = "euler",
    zero_channels: int = 0,
    device: Union[str, torch.device, None] = None,
) -> Callable:
    """``segment(model, frame) -> (final, prob)``: the flow-field serving
    pass of a ``flows`` U-Net (``cfg.num_classes == dims + 1``) or a
    ``cpnet`` CPnet (``nout == 3``).

    Normalize -> tiled forward (raw head: ``FLOW_SCALE`` x unit flows and a
    cell-probability logit) -> stitch -> ``flow / FLOW_SCALE`` (f32),
    ``prob = sigmoid(logit)`` -> the integrator under ``prob >
    cellprob_threshold``, all on ``device``. Returns the converged positions
    (*spatial, dims) and the probability (*spatial), f32 on the device; the
    host groups them (``ops.flows.group_sinks``). 2D frames or, for a
    ``dims == 3`` U-Net, whole (Z, H, W) volumes. ``integrator``: ``euler``
    (``n_iter`` steps) or ``doubling`` (``n_iter`` rounded up to a power of
    two). A CPnet runs tile by tile, each tile with its own style vector.
    ``zero_channels``: zero channels appended to each normalized patch
    (the grayscale mode of a 2-channel model served one stack).

    Spans: ``flows.forward`` (normalize, tiled forward, stitch, the flow
    and probability maps) and ``flows.integrate`` (the integrator);
    counters ``flows.tiles`` (tiles forwarded) and ``flows.euler_steps``
    (Euler steps run), both a frame.
    """
    is_cpnet = isinstance(cfg, cpnet_lib.CPnetConfig)
    if cfg.num_classes != cfg.dims + 1:
        raise ValueError(
            f"flows serving needs num_classes == dims + 1 "
            f"({cfg.dims + 1}), got {cfg.num_classes}"
        )
    if tc.tta != 1:
        raise ValueError(
            "tta is unsupported for flow-field serving (vector outputs); "
            "use tta=1"
        )
    if is_cpnet and tc.polyphase:
        raise ValueError("polyphase serving is for U-Nets, not a CPnet")
    if integrator not in ("euler", "doubling"):
        raise ValueError(
            f"integrator must be 'euler' or 'doubling', got {integrator!r}"
        )
    device = resolve_device(device)
    nd = len(frame_spatial)
    tc32 = dataclasses.replace(tc, probs_dtype="float32")
    if is_cpnet:
        run = _make_batch_map(
            None, tc32, frame_spatial, device,
            lambda model: _with_zero_channels(_folded_cpnet(model), zero_channels),
            cfg.num_classes,
        )
    else:
        run = _unet_batch_map(cfg, tc32, frame_spatial, device, zero_channels=zero_channels)
    n_tiles = len(tiling.tile_grid(frame_spatial, tc.patch, tc.overlap))
    euler = integrator == "euler"
    integrate = flows_ops.follow_flows if euler else flows_ops.follow_flows_doubling
    # a tensor divisor: a Python number would be multiplied in as its
    # reciprocal on the card (two roundings)
    scale = torch.full((1,), flows_ops.FLOW_SCALE, device=device)

    def segment(model, frame):
        with tracing.span("flows.forward"):
            out = run(model, torch.as_tensor(frame)[None])[0]
            with torch.inference_mode():
                flow = out[..., :nd] / scale
                prob = torch.sigmoid(out[..., nd])
        tracing.count("flows.tiles", n_tiles)
        with tracing.span("flows.integrate"), torch.inference_mode():
            final = integrate(flow, prob > cellprob_threshold, n_iter=n_iter, step=step_size)
        if euler:
            tracing.count("flows.euler_steps", int(n_iter))
        return final, prob

    return segment


@functools.lru_cache(maxsize=32)
def cached_flows_segmenter(
    cfg: Union[UNetConfig, cpnet_lib.CPnetConfig],
    tc: TileConfig,
    frame_spatial: Tuple[int, ...],
    n_iter: int = 200,
    step_size: float = 1.0,
    cellprob_threshold: float = 0.5,
    integrator: str = "euler",
    zero_channels: int = 0,
    device: Union[str, torch.device, None] = None,
) -> Callable:
    """Process-wide cache of flows segmenters, keyed on the frozen configs,
    the frame shape, the integration params, the zero channels and the
    device; the model is a per-call argument."""
    return make_flows_segmenter(
        cfg, tc, frame_spatial, n_iter=n_iter, step_size=step_size,
        cellprob_threshold=cellprob_threshold, integrator=integrator,
        zero_channels=zero_channels, device=device,
    )


def make_stars_predictor(
    cfg: UNetConfig,
    tc: TileConfig,
    frame_spatial: Tuple[int, ...],
    device: Union[str, torch.device, None] = None,
) -> Callable:
    """``predict(model, frame) -> (prob, dist)``: the star-convex serving
    pass of a ``stars`` model (``cfg.num_classes == 1 + n_rays``, ``n_rays``
    a positive multiple of 4; 2D only).

    Normalize -> tiled forward (raw head: object logit and per-ray
    distances) -> stitch -> ``sigmoid`` and ``max(dist, 0)`` on ``device``.
    Returns the object probability (H, W) and the distances (H, W, n_rays),
    f32 on the device; the host runs the polygon NMS
    (``ops.stardist.instances_from_rays``).
    """
    if cfg.dims != 2:
        raise ValueError(
            f"star-convex serving is 2D only (got dims={cfg.dims}); "
            f"volumetric instances are served by the flows family"
        )
    n_rays = cfg.num_classes - 1
    if n_rays < 4 or n_rays % 4:
        raise ValueError(
            f"stars serving needs num_classes == 1 + n_rays with n_rays a "
            f"positive multiple of 4, got num_classes={cfg.num_classes}"
        )
    if tc.tta != 1:
        raise ValueError(
            "tta is unsupported for star-convex serving (per-ray outputs); "
            "use tta=1"
        )
    spatial = tuple(frame_spatial)
    if len(spatial) != 2:
        raise ValueError(f"stars serving takes 2D frames, got {spatial}")
    run = _unet_batch_map(
        cfg, dataclasses.replace(tc, probs_dtype="float32"), spatial, resolve_device(device)
    )

    def predict(model: UNet, frame):
        out = run(model, torch.as_tensor(frame)[None])[0]
        with torch.inference_mode():
            return torch.sigmoid(out[..., 0]), out[..., 1:].clamp_min(0.0)

    return predict


@functools.lru_cache(maxsize=32)
def cached_stars_predictor(
    cfg: UNetConfig,
    tc: TileConfig,
    frame_spatial: Tuple[int, ...],
    device: Union[str, torch.device, None] = None,
) -> Callable:
    """Process-wide cache of stars predictors (``cached_flows_segmenter``'s
    keys, without the integration params)."""
    return make_stars_predictor(cfg, tc, frame_spatial, device)


class _ReadError:
    def __init__(self, exc: BaseException):
        self.exc = exc


def _iter_read_ahead(it: Iterator, depth: int) -> Iterator:
    """Pull items from ``it`` on a daemon thread, up to ``depth`` ahead.

    Disk reads inside ``next()`` overlap the dispatch loop. A bounded queue
    keeps memory at ``depth`` items. Exceptions in the producer re-raise at
    the consumer's ``next()``. If the consumer abandons the generator, the
    finally-block stops the producer so no thread leaks. Spans: each read
    is ``frame.read`` on the reader thread (under the consumer's job id),
    each wait for one ``stream.read_wait`` on the consumer's.
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
            while True:
                with tracing.span("frame.read"):
                    item = next(it, done)
                if item is done:
                    _put(done)
                    return
                if not _put(item):
                    return
        except BaseException as e:  # re-raised consumer-side
            _put(_ReadError(e))

    threading.Thread(target=tracing.bind(produce), daemon=True, name="frame-reader").start()
    try:
        while True:
            with tracing.span("stream.read_wait"):
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
        with tracing.span("stream.fetch_wait"):
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
    place. Yields results in order. Each queueing (the host->card copy, ``fn``
    and ``prefetch_host``) is the span ``stream.launch``.
    """
    device = resolve_device(device)
    frames = _iter_read_ahead(iter(frames), depth=prefetch)
    h2d = torch.cuda.Stream(device) if device.type == "cuda" else None
    queue: deque = deque()

    def launch(host_frame):
        with tracing.span("stream.launch"):
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
