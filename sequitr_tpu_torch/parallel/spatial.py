"""Spatially-sharded U-Net inference: halo exchange between shards (port of
``sequitr_tpu.parallel.spatial``).

A large frame's axis 0 (H in 2D, Z in 3D) is split over the mesh and every
3x3 (3x3x3) conv takes one boundary row (plane) from each neighbour, so the
result is the whole-frame forward, not an overlap-stitch approximation:

* interior shard boundaries receive the true neighbour rows (the SAME
  conv's view of the adjacent pixels);
* the global top and bottom receive zero rows (SAME zero padding);
* max-pool halves rows locally (the local row count stays even);
* the kernel-2 stride-2 transposed conv maps local rows to local rows, so
  the decoder's up-convs need no halo.

As in the JAX package everything runs in one process: the shards of a
layer are computed one after another (lockstep), a neighbour row is a
``.to(device)`` copy, and the weights are copied once to each distinct
device. Each conv goes through ``models.unet.conv``, ``UNet._conv``'s own
rounding points, so a shard rounds where the whole-frame forward rounds.
These functions fold batch norm themselves (``unet.fold_batchnorm``, once per
model state) so that the sharded graph is only convs and ReLUs; the
training form (global batch-norm statistics) is ``parallel.spatial_train``.

Multi-channel frames keep their channel axis whole; space-to-depth models
shard too (the block rearrangement is shard-local when the local row count
divides the factor, which the requirements below guarantee).

Requirements: axis 0 divisible by the shard count, and its local size (and
every other spatial axis) divisible by ``cfg.min_input_multiple``.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sequitr_tpu_torch.models import unet
from sequitr_tpu_torch.models.unet import UNetConfig, channels_last
from sequitr_tpu_torch.parallel.mesh import Mesh, replica
from sequitr_tpu_torch.utils import derived

__all__ = [
    "spatial_unet2d_infer",
    "spatial_unet3d_infer",
    "spatial_gan_enhance",
    "hybrid_unet2d_infer",
    "hybrid_gan_enhance",
]

_LABEL_DTYPES = {"int32": torch.int32, "uint16": torch.uint16}
_OUT_DTYPES = {"float32": torch.float32, "float16": torch.float16, "bfloat16": torch.bfloat16}

# a grid of shards: grid[i][j] holds batch slice i, axis-0 slice j
Grid = List[List[torch.Tensor]]
# wt(tensor, device) -> that weight on the device
Weights = Callable[[torch.Tensor, torch.device], torch.Tensor]


def _each(fn: Callable, grid: Grid) -> Grid:
    return [[fn(t) for t in row] for row in grid]


def _split(x: torch.Tensor, devices: np.ndarray) -> Grid:
    """(N, S0, ..., C) -> the NC[D]HW grid of a (data, space) device array:
    shard [i][j] = batch slice i, axis-0 slice j, on ``devices[i, j]``."""
    d, s = devices.shape
    nb, ns = x.shape[0] // d, x.shape[1] // s
    return [
        [torch.movedim(x[i * nb:(i + 1) * nb, j * ns:(j + 1) * ns].to(devices[i, j]), -1, 1)
         for j in range(s)]
        for i in range(d)
    ]


def _concat(grid: Grid, home: torch.device, axis: int = 1) -> torch.Tensor:
    """The shards back as one tensor on ``home``: axis-0 slices along
    ``axis``, batch slices along 0."""
    return torch.cat(
        [torch.cat([t.to(home) for t in row], dim=axis) for row in grid], dim=0
    )


def _neighbor_rows(row: List[torch.Tensor], j: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(last row of shard j-1, first row of shard j+1) on shard j's device;
    the edge shards get zero rows, reproducing SAME zero padding globally.
    Shards are NC[D]HW: the sharded axis is dim 2."""
    x = row[j]
    zero = torch.zeros_like(x[:, :, :1])
    top = row[j - 1][:, :, -1:].to(x.device) if j > 0 else zero
    bot = row[j + 1][:, :, :1].to(x.device) if j < len(row) - 1 else zero
    return top, bot


def _conv3x3_halo(row: List[torch.Tensor], j: int, w, b, cfg: UNetConfig) -> torch.Tensor:
    """SAME 3^dims conv of shard j: the sharded axis padded with the
    neighbours' rows (VALID there), SAME (1, 1) on the rest. A row of one
    shard is the plain SAME conv."""
    if len(row) == 1:
        return unet.conv(cfg, row[0], w, b)
    top, bot = _neighbor_rows(row, j)
    padded = channels_last(torch.cat([top, row[j], bot], dim=2))
    return unet.conv(cfg, padded, w, b, padding=(0,) + (1,) * (cfg.dims - 1))


def _block_halo(x: Grid, blk, cfg: UNetConfig, wt: Weights, norm: Optional[Callable]) -> Grid:
    """conv -> [norm] -> relu, twice, every conv with its halo exchange;
    ``norm(grid, bn)`` is the cross-shard batch norm of training."""
    for i in (1, 2):
        c = getattr(blk, f"conv{i}")
        x = [
            [_conv3x3_halo(row, j, wt(c.w, t.device), wt(c.b, t.device), cfg) for j, t in enumerate(row)]
            for row in x
        ]
        if norm is not None:
            x = norm(x, getattr(blk, f"bn{i}"))
        x = _each(torch.relu, x)
    return x


def _maxpool_local(x: torch.Tensor, dims: int) -> torch.Tensor:
    """2^dims max pool of one shard: local on the sharded axis because the
    local row count stays even through every level."""
    return F.max_pool3d(x, 2) if dims == 3 else F.max_pool2d(x, 2)


def grid_logits(cfg: UNetConfig, model: unet.UNet, x: Grid, wt: Weights, norm: Optional[Callable] = None) -> Grid:
    """The U-Net forward over a grid of NC[D]HW shards, level by level,
    every shard of a layer before the next layer: f32 logits, NHWC
    (NDHWC), one per shard. ``model`` holds the weights (on the job's
    device; ``wt`` places them), ``norm`` the training batch norm (None:
    no norm layers, as after folding)."""
    s2d = cfg.space_to_depth
    if s2d > 1:
        x = _each(lambda t: unet._space_to_depth(t, s2d), x)
    skips = []
    for lvl in range(cfg.depth):
        if lvl > 0:
            x = _each(lambda t: _maxpool_local(t, cfg.dims), x)
        x = _block_halo(x, model.enc[lvl], cfg, wt, norm)
        if lvl < cfg.depth - 1:
            skips.append(x)
    for i, lvl in enumerate(reversed(range(cfg.depth - 1))):
        skip, up = skips.pop(lvl), model.up[i]
        x = _each(lambda t: unet.conv(cfg, t, wt(up.w, t.device), wt(up.b, t.device), transpose=True), x)
        x = [[torch.cat([s, t.to(s.dtype)], dim=1) for s, t in zip(srow, row)] for srow, row in zip(skip, x)]
        del skip
        x = _block_halo(x, model.dec[i], cfg, wt, norm)
    head = model.head
    logits = _each(lambda t: unet.conv(cfg, t, wt(head.w, t.device), wt(head.b, t.device)), x)
    if s2d > 1:
        logits = _each(lambda t: unet._depth_to_space(t, s2d), logits)
    return _each(lambda t: torch.movedim(t, 1, -1).to(torch.float32), logits)


def replica_weights(model: torch.nn.Module, devices) -> Weights:
    """``wt`` over the serving copies of ``model`` (``mesh.replica``: one a
    distinct device, kept with the model)."""
    maps = {}
    for dev in set(devices):
        rep = replica(model, dev)
        if rep is not model:
            maps[dev] = {id(a): b for a, b in zip(model.parameters(), rep.parameters())}
    return lambda t, dev: maps[dev][id(t)] if dev in maps else t


def _validate_spatial(cfg: UNetConfig, n: int, frame_spatial):
    if cfg.dims != len(frame_spatial):
        raise ValueError(
            f"model is {cfg.dims}D but frame_spatial has "
            f"{len(frame_spatial)} axes"
        )
    s0, *rest = frame_spatial
    axis0 = "H" if cfg.dims == 2 else "Z"
    if s0 % n:
        raise ValueError(f"{axis0}={s0} not divisible by {n} devices")
    s_loc = s0 // n
    if s_loc % cfg.min_input_multiple:
        raise ValueError(
            f"{axis0}/device={s_loc} not divisible by {cfg.min_input_multiple}"
        )
    for s in rest:
        # unsharded axes are still s2d-rearranged and pooled locally
        if s % cfg.min_input_multiple:
            raise ValueError(
                f"axis size {s} not divisible by {cfg.min_input_multiple} "
                "(pool factor x space_to_depth)"
            )
    if cfg.upsample != "transpose":
        raise NotImplementedError("spatial sharding supports transpose upsampling")


def grid_devices(mesh: Mesh, data_axis: Optional[str] = None, space_axis: Optional[str] = None) -> np.ndarray:
    """The mesh's devices as a (data, space) array; an axis not named is one
    way (a 1-D mesh splits rows with only ``space_axis`` or nothing named,
    the batch with only ``data_axis``)."""
    if data_axis and space_axis:
        order = [mesh.axis_names.index(data_axis), mesh.axis_names.index(space_axis)]
        return np.transpose(mesh.devices, order)
    if data_axis:
        return mesh.devices.reshape(-1, 1)
    return mesh.devices.reshape(1, -1)


def _folded_unet(model: unet.UNet) -> unet.UNet:
    return derived(model, "fold_batchnorm", unet.fold_batchnorm)


def _as_batch(frames, dims: int, home: torch.device, batched: bool) -> torch.Tensor:
    """(B, *spatial[, C]) f32 on ``home`` from a frame (or batch) in any dtype."""
    x = torch.as_tensor(frames, device=home).to(torch.float32)
    if not batched:
        x = x[None]
    if x.ndim == dims + 1:
        x = x[..., None]
    return x


def _segmenter(cfg: UNetConfig, devices: np.ndarray, home: torch.device, batched: bool,
               probs_dtype: str, labels_dtype: str) -> Callable:
    """``fn(model, frame[s]) -> (probs, labels)`` over ``devices``: softmax
    and argmax on each shard, the outputs gathered on ``home``."""
    p_dt, l_dt = _OUT_DTYPES[probs_dtype], _LABEL_DTYPES[labels_dtype]

    def fn(model, frames):
        with torch.inference_mode():
            net = _folded_unet(model)
            x = _as_batch(frames, cfg.dims, home, batched)
            logits = grid_logits(net.cfg, net, _split(x, devices), replica_weights(net, devices.ravel()))
            probs = _each(lambda t: torch.softmax(t, dim=-1), logits)
            del logits
            labels = _each(lambda t: torch.argmax(t, dim=-1).to(l_dt), probs)
            probs = _concat(_each(lambda t: t.to(p_dt), probs), home)
            labels = _concat(labels, home)
            return (probs, labels) if batched else (probs[0], labels[0])

    return fn


def spatial_unet2d_infer(
    cfg: UNetConfig,
    mesh: Mesh,
    frame_spatial: Tuple[int, int],
    probs_dtype: str = "float32",
    labels_dtype: str = "int32",
) -> Callable:
    """Build ``fn(model, frame) -> (probs, labels)``, H-sharded over ``mesh``.

    ``frame``: (H, W), or (H, W, C) for a multi-channel model, already
    normalized (normalize the whole frame first: its percentiles are a
    global reduction). ``model``: a ``UNet`` of ``cfg``, BN folded or not
    (folded once per model state). The outputs, on the mesh's home device,
    equal ``softmax(model(frame))`` and its argmax up to float
    reassociation.
    """
    return _spatial_unet_infer(cfg, mesh, frame_spatial, probs_dtype, labels_dtype)


def spatial_unet3d_infer(
    cfg: UNetConfig,
    mesh: Mesh,
    vol_spatial: Tuple[int, int, int],
    probs_dtype: str = "float32",
    labels_dtype: str = "int32",
) -> Callable:
    """The volumetric form: a (Z, H, W[, C]) volume Z-sharded, every
    3x3x3 conv exchanging one boundary plane with each neighbour."""
    return _spatial_unet_infer(cfg, mesh, vol_spatial, probs_dtype, labels_dtype)


def _spatial_unet_infer(cfg, mesh, frame_spatial, probs_dtype="float32", labels_dtype="int32"):
    _validate_spatial(cfg, mesh.size, frame_spatial)
    return _segmenter(cfg, grid_devices(mesh), mesh.home, False, probs_dtype, labels_dtype)


def hybrid_unet2d_infer(
    cfg: UNetConfig,
    mesh: Mesh,
    frame_spatial: Tuple[int, int],
    batch: int,
    data_axis: str = "data",
    space_axis: str = "space",
    probs_dtype: str = "float32",
    labels_dtype: str = "int32",
) -> Callable:
    """Build ``fn(model, frames) -> (probs, labels)`` on a 2-D mesh: the
    frame batch split over ``data_axis`` and each frame's rows over
    ``space_axis`` (halos move only within a data slice). ``frames``:
    (batch, H, W[, C]), already normalized."""
    d = mesh.shape[data_axis]
    s = mesh.shape[space_axis]
    _validate_spatial(cfg, s, frame_spatial)
    if batch % d:
        raise ValueError(f"batch={batch} not divisible by {d} data shards")
    return _segmenter(
        cfg, grid_devices(mesh, data_axis, space_axis), mesh.home, True, probs_dtype, labels_dtype
    )


def _enhancer(gan_cfg, devices: np.ndarray, home: torch.device, batched: bool, out_dtype: str) -> Callable:
    from sequitr_tpu_torch.models import gan as gan_lib

    o_dt = _OUT_DTYPES[out_dtype]

    def fn(model, frames):
        with torch.inference_mode():
            gen = model.gen
            x = _as_batch(frames, 2, home, batched)
            y = grid_logits(gen.cfg, gen, _split(x, devices), replica_weights(gen, devices.ravel()))
            out = _concat(_each(lambda t: gan_lib.activate(gan_cfg, t).to(o_dt), y), home)
            return out if batched else out[0]

    return fn


def spatial_gan_enhance(
    gan_cfg,
    mesh: Mesh,
    frame_spatial: Tuple[int, int],
    out_dtype: str = "float32",
) -> Callable:
    """H-sharded GAN generator pass: ``fn(model, frame) -> (H, W, C_out)``.

    The generator is the U-Net core plus an output activation, so the same
    halo-exchange forward serves it. Pass the FOLDED configuration and
    model (``gan.fold_generator``); a batch-norm generator is refused.
    ``frame``: (H, W) or (H, W, C_in), already normalized.
    """
    ucfg = gan_cfg.generator_config
    _validate_spatial(ucfg, mesh.size, frame_spatial)
    if ucfg.norm == "batch":
        raise ValueError("fold the generator first (models.gan.fold_generator)")
    return _enhancer(gan_cfg, grid_devices(mesh), mesh.home, False, out_dtype)


def hybrid_gan_enhance(
    gan_cfg,
    mesh: Mesh,
    frame_spatial: Tuple[int, int],
    batch: int,
    data_axis: str = "data",
    space_axis: str = "space",
    out_dtype: str = "float32",
) -> Callable:
    """DP x spatial GAN enhancement on a 2-D mesh: ``fn(model, frames)``
    over (batch, H, W[, C_in]) -> (batch, H, W, C_out). Pass the FOLDED
    configuration and model."""
    ucfg = gan_cfg.generator_config
    d = mesh.shape[data_axis]
    s = mesh.shape[space_axis]
    _validate_spatial(ucfg, s, frame_spatial)
    if batch % d:
        raise ValueError(f"batch={batch} not divisible by {d} data shards")
    if ucfg.norm == "batch":
        raise ValueError("fold the generator first (models.gan.fold_generator)")
    return _enhancer(gan_cfg, grid_devices(mesh, data_axis, space_axis), mesh.home, True, out_dtype)
