"""Spatially-sharded U-Net TRAINING: halo-exchange convs and batch norm over
the mesh (port of ``sequitr_tpu.parallel.spatial_train``).

``parallel.spatial`` serves giant frames with their rows split over the
mesh; this module trains on them the same way (finetuning on 16k x 16k
slide-scanner mosaics whose activations do not fit one device). The
sharded step is ``pipeline.train.make_unet_train_step`` with augmentation
off, not an approximation:

* every SAME conv takes its neighbours' boundary rows (``spatial``'s halo
  exchange); the copies are differentiable, so the backward pass returns
  each boundary row's gradient to the shard that owns it;
* batch-norm statistics are global: per-shard sums are added over the mesh
  before the mean and the variance are formed (two passes, the
  subtract-then-square form, not E[x^2] - E[x]^2), so every shard
  normalizes with the statistics of the whole batch;
* the weighted cross-entropy is reduced globally (numerator and
  denominator summed over the shards) into one loss on the job's device;
* a weight used on another device is a ``.to(device)`` copy of the master
  weight, so its shards' gradients add up on the master copy, as
  ``nn.DataParallel``'s broadcast does: no hand-written reverse
  permutation, no gradient all-reduce.

Augmentation must be off (flips and rotations move pixels across shards);
pre-augment on the host. A hybrid data x space step takes a 2-D mesh: the
batch splits over the data axis and the statistics and the loss sum over
both. Plain data parallelism is the same forward with one space way
(``TrainMesh`` with only a data axis, ``forward_train_gathered``), which
``mesh.make_dp_train_step`` hands to every train step of the port; with
``polyphase`` it is the phase-domain forward
(``models.polyphase.apply_train_shards``) over the batch shards, its batch
norms through the same global sums over the 4 phase groups.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from sequitr_tpu_torch.models import polyphase as polyphase_lib
from sequitr_tpu_torch.models import unet
from sequitr_tpu_torch.parallel.mesh import Mesh, _canonical
from sequitr_tpu_torch.parallel.spatial import (
    Grid, _concat, _each, _split, _validate_spatial, grid_devices, grid_logits,
)
from sequitr_tpu_torch.utils import ieee_f32

__all__ = ["TrainMesh", "make_spatial_train_step", "sharded_forward_train", "forward_train_gathered"]


class TrainMesh:
    """A mesh read as (data, space) for the train forward: ``data_axis``
    splits the batch, ``space_axis`` the rows (axis 0 of the spatial dims);
    either may be None (one way)."""

    def __init__(self, mesh: Mesh, data_axis: Optional[str] = None, space_axis: Optional[str] = None):
        self.mesh = mesh
        self.devices = grid_devices(mesh, data_axis, space_axis)


class _Placed:
    """``wt(t, device)``: ``t`` itself on its own device, else one
    ``.to(device)`` copy per call of the forward (inside autograd, so the
    copy's gradient flows back to ``t``)."""

    def __init__(self):
        self.cache: Dict[Tuple[int, torch.device], Tuple[torch.Tensor, torch.Tensor]] = {}

    def __call__(self, t: torch.Tensor, dev: torch.device) -> torch.Tensor:
        if _canonical(t.device) == dev:
            return t
        key = (id(t), dev)
        if key not in self.cache:
            # the source is held with its copy, so its id is not reused
            self.cache[key] = (t, t.to(dev))
        return self.cache[key][1]


def _psum(parts: List[torch.Tensor], home: torch.device) -> torch.Tensor:
    """The sum of per-shard tensors, brought to ``home`` in shard order."""
    total = parts[0].to(home)
    for p in parts[1:]:
        total = total + p.to(home)
    return total


def _batch_norm_psum(x: Grid, bn, cfg: unet.UNetConfig, wt, home: torch.device, groups: int = 1):
    """Train-mode batch norm with mesh-global statistics over (batch,
    *spatial): per-shard sums added on ``home`` and divided by the global
    element count. ``groups``: the channel axis holds that many blocks of
    the norm's channels (``g*C + c``; the polyphase forward's 4 phase
    groups), reduced over with the pixels. Returns ``(grid, (new_mean,
    new_var))``, the running statistics moved ``bn_momentum`` of the way,
    as ``_BatchNorm.forward_train`` returns them."""
    flat = [t.to(torch.float32) for row in x for t in row]
    if groups > 1:
        # (N, G*C, *sp) -> (N, G, C, *sp): a view, channels-last strides kept
        flat = [t.reshape((t.shape[0], groups, -1) + tuple(t.shape[2:])) for t in flat]
    chan = 1 if groups == 1 else 2
    axes = [d for d in range(flat[0].ndim) if d != chan]
    count = sum(t.numel() // t.shape[chan] for t in flat)

    def ch(t, like):
        return wt(t, _canonical(like.device)).view((1,) * chan + (-1,) + (1,) * (like.ndim - chan - 1))

    mean = _psum([t.sum(axes) for t in flat], home) / count
    var = _psum([torch.square(t - ch(mean, t)).sum(axes) for t in flat], home) / count
    m = cfg.bn_momentum
    with torch.no_grad():
        stats = (m * bn.mean + (1 - m) * mean, m * bn.var + (1 - m) * var)
    inv = torch.rsqrt(var + cfg.bn_eps)
    normed = iter([
        ((t - ch(mean, t)) * ch(inv, t) * ch(bn.scale, t) + ch(bn.bias, t)).reshape(orig.shape)
        for t, orig in zip(flat, (t for row in x for t in row))
    ])
    return [[next(normed) for _ in row] for row in x], stats


def sharded_forward_train(model: unet.UNet, images: torch.Tensor, tmesh: TrainMesh):
    """``UNet.forward_train`` over the mesh: ``images`` (N, *spatial, C) on
    the model's device split into the (data, space) grid; returns the grid
    of f32 logit shards (NHWC each) and the new running statistics, one
    pair a batch norm in ``bn_layers`` order, from the global batch."""
    cfg = model.cfg
    home = _canonical(next(model.parameters()).device)
    wt = _Placed()
    stats: List[Tuple[torch.Tensor, torch.Tensor]] = []

    def norm(grid, bn):
        out, st = _batch_norm_psum(grid, bn, cfg, wt, home)
        stats.append(st)
        return out

    x = _split(images.to(torch.float32), tmesh.devices)
    logits = grid_logits(cfg, model, x, wt, norm if cfg.norm == "batch" else None)
    return logits, stats


def forward_train_gathered(model: unet.UNet, images: torch.Tensor, tmesh: TrainMesh, polyphase: bool = False):
    """``sharded_forward_train`` with the logits gathered on the model's
    device: ``(logits (N, *spatial, K), statistics)``, a drop-in for
    ``UNet.forward_train`` in every train step. ``polyphase``: the phase
    domain training forward (``models.polyphase.apply_train`` /
    ``apply3d_train``) over the data axis, shard by shard in lockstep, its
    batch norms over the global batch (``mesh.make_dp_train_step``'s
    meshes split no rows)."""
    home = _canonical(next(model.parameters()).device)
    if not polyphase:
        logits, stats = sharded_forward_train(model, images, tmesh)
        return _concat(logits, home), stats
    if tmesh.devices.shape[1] != 1:
        raise ValueError(
            "polyphase + spatial_parallel is not supported; the polyphase "
            f"training forward splits only the batch (a mesh of {tmesh.devices.shape[1]} space ways)"
        )
    polyphase_lib._check_train(model, images, model.cfg.dims)
    devices = tmesh.devices[:, 0]
    nb = images.shape[0] // len(devices)
    shards = [images[i * nb:(i + 1) * nb].to(dev) for i, dev in enumerate(devices)]
    wt = _Placed()

    def norm(xs, bn, groups):
        out, stats = _batch_norm_psum([[t] for t in xs], bn, model.cfg, wt, home, groups)
        return [row[0] for row in out], stats

    logits, stats = polyphase_lib.apply_train_shards(model, shards, wt, norm)
    return torch.cat([t.to(home) for t in logits], dim=0), stats


def _split_plain(x: torch.Tensor, devices: np.ndarray) -> Grid:
    """``_split`` for per-pixel maps without a channel axis (labels, weights)."""
    return _each(lambda t: t[:, 0], _split(x[..., None], devices))


def make_spatial_train_step(
    cfg: unet.UNetConfig,
    tc,
    mesh: Mesh,
    frame_spatial: Tuple[int, ...],
    batch: int,
    space_axis: str = "data",
    data_axis: Optional[str] = None,
):
    """Build ``step(state, batch, generator=None) -> (state, metrics)``,
    rows sharded over ``space_axis`` (H in 2D, Z in 3D).

    ``batch``: ``image`` (N, *spatial[, C]), ``labels`` (N, *spatial)
    integer, optional ``weights`` (N, *spatial), numpy or tensors; the
    contract of ``pipeline.train.make_unet_train_step`` (augment off), and
    the same loss, gradients and batch-norm statistics up to float
    reassociation. ``data_axis`` with a 2-D mesh (``make_mesh2d``) shards
    N too. ``generator`` is accepted for the fit loop and unused.
    ``tc.remat`` recomputes the sharded forward, halos included, in the
    backward pass (``torch.utils.checkpoint``).
    """
    from sequitr_tpu_torch.pipeline import train as train_lib

    if tc.augment:
        raise ValueError(
            "spatial training requires TrainConfig(augment=False): "
            "flips/rot90/elastic cross shard boundaries — pre-augment on "
            "the host instead"
        )
    s_ways = mesh.shape[space_axis]
    _validate_spatial(cfg, s_ways, frame_spatial)
    d_ways = mesh.shape[data_axis] if data_axis else 1
    if batch % d_ways:
        raise ValueError(f"batch={batch} not divisible by {d_ways} data shards")
    tmesh = TrainMesh(mesh, data_axis, space_axis)
    optimizer = tc.make_optimizer()
    # global pixel count for the unweighted mean and the accuracy
    n_pixels = batch * int(math.prod(frame_spatial))

    def forward(model, images):
        if tc.remat:
            return checkpoint(sharded_forward_train, model, images, tmesh, use_reentrant=False)
        return sharded_forward_train(model, images, tmesh)

    def step(state, batch_in, generator: Optional[torch.Generator] = None):
        model = state.model
        home = _canonical(next(model.parameters()).device)
        with ieee_f32(cfg.compute_dtype == "float32"):
            images = torch.as_tensor(batch_in["image"], device=home).to(torch.float32)
            if images.ndim == cfg.dims + 1:  # (N, *spatial) single-channel
                images = images[..., None]
            labels = _split_plain(torch.as_tensor(batch_in["labels"], device=home), tmesh.devices)
            weights = batch_in.get("weights")
            logits, stats = forward(model, images)
            flat_logits = [t for row in logits for t in row]
            flat_labels = [t for row in labels for t in row]
            ce = [
                -torch.gather(F.log_softmax(t, dim=-1), -1, lb.long().unsqueeze(-1)).squeeze(-1)
                for t, lb in zip(flat_logits, flat_labels)
            ]
            if weights is None:
                loss = _psum([c.sum() for c in ce], home) / n_pixels
            else:
                w = [t for row in _split_plain(torch.as_tensor(weights, device=home), tmesh.devices)
                     for t in row]
                w = [t.to(torch.float32) for t in w]
                num = _psum([(wi * c).sum() for wi, c in zip(w, ce)], home)
                den = _psum([wi.sum() for wi in w], home)
                loss = num / torch.clamp(den, min=1e-8)
            grad_norm = train_lib._update(state, optimizer, loss, stats)
            with torch.no_grad():
                correct = _psum(
                    [(torch.argmax(t, dim=-1) == lb).to(torch.float32).sum()
                     for t, lb in zip(flat_logits, flat_labels)],
                    home,
                )
        return state, {"loss": loss.detach(), "accuracy": correct / n_pixels, "grad_norm": grad_norm}

    return step
