"""Device mesh and data-parallel sharding (port of ``sequitr_tpu.parallel.mesh``).

The JAX package runs its multi-chip paths as one program over a mesh of
devices (``jax.sharding.Mesh``). The port keeps that single-process shape:

* a ``Mesh`` is a numpy object array of ``torch.device``s with axis names
  (``("data",)``, or ``("data", "space")`` for ``make_mesh2d``);
* a shard is a tensor on its mesh device, a contiguous slice of the
  leading axis as ``PartitionSpec("data")`` places it: device i holds rows
  ``[i*B/n, (i+1)*B/n)``;
* the weights are copied once to each distinct device, and the results come
  back, concatenated in order, on the job's device (``Mesh.home``).

The devices come from ``device_pool(device)``: every CUDA card for a CUDA
job device, the CPU alone for the CPU. ``virtual_devices(n)`` makes the
pool the job's device ``n`` times over, the counterpart of XLA's
``--xla_force_host_platform_device_count``: the same N-way code then runs on
the CPU and on one card, the exchanges between shards being copies within
one device. Nothing else turns it on.

The data-parallel wrappers keep the JAX names. Each runs the port's own
per-batch function on each device's slice (``_dp_apply``); frames are
independent, so no shard reads another's. ``make_dp_frame_inferrer``
takes a per-device batch function of any output structure (the jobs'
enhancer, denoiser, flows and stars passes ride it);
``make_dp_frame_mapper`` is the JAX name's one-output form over a
per-frame function. ``make_dp_train_step`` builds a
step whose forward runs on the mesh with batch-norm statistics over the
global batch (``spatial_train.sharded_forward_train``), as XLA runs the
JAX package's sharded step as the unsharded one.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from sequitr_tpu_torch.utils import derived, resolve_device

__all__ = [
    "Mesh",
    "device_pool",
    "virtual_devices",
    "make_mesh",
    "make_mesh2d",
    "replicated",
    "batch_sharded",
    "shard_batch",
    "replica",
    "frame_by_frame",
    "make_dp_train_step",
    "make_dp_frame_inferrer",
    "make_dp_frame_mapper",
    "make_dp_registerer",
    "make_dp_localizer",
    "make_dp_localizer3d",
    "make_dp_localizer_astig",
    "make_dp_deconvolver",
    "make_dp_seam_correlator",
]

_VIRTUAL: Optional[int] = None


def _canonical(device: torch.device) -> torch.device:
    """``cuda`` as ``cuda:<current>``, so equal devices compare equal."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def device_pool(device: Union[str, torch.device, None] = None) -> List[torch.device]:
    """The devices a job on ``device`` may shard over: every CUDA card for a
    CUDA device, ``[cpu]`` for the CPU; under ``virtual_devices(n)`` the
    job's device ``n`` times."""
    dev = _canonical(resolve_device(device))
    if _VIRTUAL is not None:
        return [dev] * _VIRTUAL
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


@contextlib.contextmanager
def virtual_devices(n: int) -> Iterator[None]:
    """Inside the block ``device_pool`` returns the job's device ``n``
    times: an ``n``-way mesh on one device (the tests on the CPU, the
    multi-card paths on one card)."""
    global _VIRTUAL
    if int(n) < 1:
        raise ValueError(f"virtual_devices needs n >= 1, got {n}")
    prev, _VIRTUAL = _VIRTUAL, int(n)
    try:
        yield
    finally:
        _VIRTUAL = prev


class Mesh:
    """Devices (a numpy object array of ``torch.device``) with one axis name
    a dimension; ``home`` is the job's device, where inputs arrive and
    results are gathered. ``shape`` maps each axis name to its size, as
    ``jax.sharding.Mesh.shape`` does."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...], home: torch.device):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D devices for axis names {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.home = home

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat(self) -> List[torch.device]:
        return list(self.devices.ravel())

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, devices={[str(d) for d in self.flat()]})"


def make_mesh(
    n_devices: Optional[int] = None,
    axis_name: str = "data",
    device: Union[str, torch.device, None] = None,
) -> Mesh:
    """1-D mesh over the first ``n_devices`` devices of ``device_pool(device)``
    (default: all)."""
    home = _canonical(resolve_device(device))
    devs = device_pool(home)
    if n_devices is not None:
        devs = devs[:n_devices]
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr, (axis_name,), home)


def make_mesh2d(
    shape: tuple,
    axis_names: tuple = ("data", "space"),
    device: Union[str, torch.device, None] = None,
) -> Mesh:
    """2-D mesh, e.g. (2, 4) = 2-way data x 4-way spatial (hybrid serving)."""
    n = int(np.prod(shape))
    home = _canonical(resolve_device(device))
    devs = device_pool(home)
    if len(devs) < n:
        raise ValueError(
            f"mesh shape {shape} needs {n} devices, only {len(devs)} available"
        )
    arr = np.empty(n, dtype=object)
    arr[:] = devs[:n]
    return Mesh(arr.reshape(tuple(shape)), tuple(axis_names), home)


def _slices(n_items: int, n_ways: int) -> List[slice]:
    if n_items % n_ways:
        raise ValueError(f"leading axis {n_items} not divisible by {n_ways} devices")
    b = n_items // n_ways
    return [slice(k * b, (k + 1) * b) for k in range(n_ways)]


def replicated(mesh: Mesh, x: torch.Tensor) -> List[torch.Tensor]:
    """``x`` on every mesh device, one copy per distinct device."""
    copies: Dict[torch.device, torch.Tensor] = {}
    return [copies.setdefault(d, x.to(d)) for d in mesh.flat()]


def batch_sharded(mesh: Mesh, x, axis_name: str = "data") -> List[torch.Tensor]:
    """``x``'s leading axis split contiguously over the ``axis_name``
    devices (the first device of every other axis): shard i on device i."""
    devs = list(np.moveaxis(mesh.devices, mesh.axis_names.index(axis_name), 0).reshape(
        mesh.shape[axis_name], -1)[:, 0])
    x = torch.as_tensor(x)
    return [x[s].to(d) for s, d in zip(_slices(x.shape[0], len(devs)), devs)]


def shard_batch(mesh: Mesh, batch: Any, axis_name: str = "data") -> Any:
    """``batch_sharded`` over every leaf of a dict (or one array)."""
    if isinstance(batch, dict):
        return {k: batch_sharded(mesh, v, axis_name) for k, v in batch.items()}
    return batch_sharded(mesh, batch, axis_name)


def _copy_to(model: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """A ``UNet`` or ``GAN`` of the same configuration and weights on ``device``."""
    m = type(model)(model.cfg, device=device)
    m.load_state_dict(model.state_dict())
    return m


def replica(model: Optional[torch.nn.Module], device: torch.device):
    """``model`` on ``device``: itself when it lives there, else a copy made
    once per state of its weights (``utils.derived``)."""
    if model is None:
        return None
    home = _canonical(next(model.parameters()).device)
    if home == device:
        return model
    return derived(model, f"replica/{device}", lambda m: _copy_to(m, device))


def _combine(outs: Sequence[Any], join: Callable):
    """``join`` over the matching tensors of ``outs`` (tensors, tuples or
    dicts of them, or None)."""
    first = outs[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return join(outs)
    if isinstance(first, dict):
        return {k: _combine([o[k] for o in outs], join) for k in first}
    return type(first)(_combine([o[i] for o in outs], join) for i in range(len(first)))


def _gather(outs: Sequence[Any], home: torch.device):
    """Per-device outputs concatenated along the leading axis on ``home``."""
    return _combine(outs, lambda ts: torch.cat([t.to(home) for t in ts], dim=0))


def frame_by_frame(fn: Callable) -> Callable:
    """A per-frame ``fn(model, *frame_args)`` as ``run(model, *slices)``
    over slices of frames, the outputs stacked."""
    return lambda model, *slices: _combine([fn(model, *args) for args in zip(*slices)], torch.stack)


def _dp_apply(mesh: Mesh, fn_for: Callable, model, *batches):
    """``fn_for(device)(replica, *slices)`` on each device's contiguous
    slice of ``batches`` (numpy arrays or tensors, leading axes equal and a
    multiple of the mesh size; each slice copied to its device), results
    gathered in order on ``mesh.home``."""
    devs = mesh.flat()
    batches = [torch.as_tensor(b) for b in batches]
    outs = []
    for dev, s in zip(devs, _slices(len(batches[0]), len(devs))):
        outs.append(fn_for(dev)(replica(model, dev), *[b[s].to(dev) for b in batches]))
    return _gather(outs, mesh.home)


def _per_device(make: Callable) -> Callable:
    """``make(device)`` built once per distinct device."""
    built: Dict[torch.device, Callable] = {}

    def fn_for(dev):
        if dev not in built:
            built[dev] = make(dev)
        return built[dev]

    return fn_for


def make_dp_train_step(make_step: Callable, mesh: Mesh) -> Callable:
    """The data-parallel form of a train step: ``make_step(mesh=...)`` with
    the batch sharded over the mesh for the forward; the loss, the
    gradient and the batch-norm statistics are those of the global batch,
    as the JAX package's jitted step over a sharded batch gives them (not
    per replica, as ``nn.DataParallel``'s statistics would be).
    ``make_step``: one of ``pipeline.train.make_*_train_step`` with its
    arguments bound (``functools.partial``)."""
    from sequitr_tpu_torch.parallel import spatial_train

    return make_step(mesh=spatial_train.TrainMesh(mesh, data_axis=mesh.axis_names[0]))


def make_dp_frame_inferrer(make_infer: Callable, mesh: Mesh) -> Callable:
    """Frames sharded over every device of the mesh through a per-device
    batch function.

    ``make_infer(device) -> infer(model, frames)``, returning a tensor or a
    tuple or dict of them (``infer.cached_batch_inferrer``'s ``(probs |
    None, labels)`` at the slice's size, the GAN enhancer, the denoiser,
    the flows and stars passes through ``frame_by_frame``), becomes
    ``batched(model, frames)`` over (D, *spatial[, C]) frames, D a multiple
    of the mesh size: every device normalizes and serves its own slice
    (one quantile pass a slice) with the weights copied to it, and the
    outputs come back in order on the job's device.
    """
    fn_for = _per_device(make_infer)
    return lambda model, frames: _dp_apply(mesh, fn_for, model, frames)


def make_dp_frame_mapper(fn: Callable, mesh: Mesh) -> Callable:
    """The data-parallel form of a single-output per-frame function.

    ``fn(model, frame) -> tensor`` becomes ``mapped(model, frames)`` over
    (D, *spatial[, C]) frames, D a multiple of the mesh size: each device
    maps its contiguous slice frame by frame with the weights copied to it
    (``model`` may be None), and the (D, ...) outputs come back stacked in
    order on the job's device; an ``fn`` that returns anything but one
    tensor is a TypeError.
    """
    run = frame_by_frame(fn)

    def mapped(model, frames):
        out = _dp_apply(mesh, lambda _dev: run, model, frames)
        if not isinstance(out, torch.Tensor):
            raise TypeError(f"make_dp_frame_mapper's fn must return one tensor, not {type(out).__name__}")
        return out

    return mapped


def make_dp_registerer(
    mesh: Mesh,
    *,
    subpixel: bool = True,
    window: bool = True,
    refine: int = 2,
    resample: bool = True,
) -> Callable:
    """DP first-frame-mode registration: ``registered(ref, frames) ->
    (shifts, responses, corrected)``; ``ref`` (H, W) copied to every
    device, ``frames`` (D, H, W) sharded; each device runs
    ``ops.registration.register_batch`` on its slice."""
    from sequitr_tpu_torch.ops import registration as reg

    def registered(ref, frames):
        ref = torch.as_tensor(ref)
        refs: Dict[torch.device, torch.Tensor] = {}

        def fn_for(dev):
            r = refs.setdefault(dev, ref.to(dev))
            return lambda _model, fr: reg.register_batch(
                r, fr, subpixel=subpixel, window=window, refine=refine, resample=resample,
            )

        return _dp_apply(mesh, fn_for, None, frames)

    return registered


def _localizer(mesh: Mesh, one: Callable) -> Callable:
    """``localize(frames, thresholds) -> (coords, valid, fits)`` with
    ``one(frame, threshold)`` run per frame on each device's slice."""
    run = frame_by_frame(lambda _model, frame, thr: one(frame, thr))
    return lambda frames, thresholds: _dp_apply(
        mesh, lambda dev: run, None, frames, torch.as_tensor(np.asarray(thresholds, np.float32))
    )


def make_dp_localizer(
    mesh: Mesh,
    *,
    max_peaks: int = 256,
    min_distance: int = 2,
    window: int = 7,
    sigma: float = 1.5,
) -> Callable:
    """DP single-molecule localization: ``localize(frames, thresholds)``
    with ``frames`` (D, H, W) and ``thresholds`` (D,) sharded; each device
    detects and fits its frames (``psf._detect_and_fit``). Returns ``(yx,
    valid, fits)``, each with the leading frame axis, on the job's device."""
    from sequitr_tpu_torch import psf

    return _localizer(mesh, lambda frame, thr: psf._detect_and_fit(
        frame, thr, max_peaks=max_peaks, min_distance=min_distance, window=window, sigma=sigma,
    ))


def make_dp_localizer3d(
    mesh: Mesh,
    *,
    max_peaks: int = 256,
    min_distance: int = 2,
    min_distance_z: int = 1,
    window: int = 7,
    window_z: int = 5,
    sigma: float = 1.5,
    sigma_z: float = 1.5,
) -> Callable:
    """DP volumetric localization over TIMEPOINTS: ``localize(volumes,
    thresholds)`` with volumes (D, Z, H, W); returns ``(zyx, valid, fits)``."""
    from sequitr_tpu_torch import psf

    return _localizer(mesh, lambda vol, thr: psf._detect_and_fit_3d(
        vol, thr, max_peaks=max_peaks, min_distance=min_distance, min_distance_z=min_distance_z,
        window=window, window_z=window_z, sigma=sigma, sigma_z=sigma_z,
    ))


def make_dp_localizer_astig(
    mesh: Mesh,
    calib,
    *,
    max_peaks: int = 256,
    min_distance: int = 2,
    window: Optional[int] = None,
    n_grid: int = 241,
) -> Callable:
    """DP astigmatic 3D-from-2D localization (detect, elliptical fits, z
    from the calibration curve a frame); ``window`` defaults to the
    calibration's own. Returns ``(yx, valid, fits)`` with ``fits["z"]``."""
    from sequitr_tpu_torch import psf

    win = calib.window if window is None else window
    return _localizer(mesh, lambda frame, thr: psf._detect_and_fit_astig(
        frame, thr, calib, max_peaks=max_peaks, min_distance=min_distance, window=win, n_grid=n_grid,
    ))


def make_dp_deconvolver(mesh: Mesh, kernel: torch.Tensor, iterations: int) -> Callable:
    """DP Richardson-Lucy: ``deconv(frames)`` with frames (D, H, W[, C])
    sharded; each device deconvolves its frames one at a time
    (``psf.richardson_lucy_frame``) against its copy of the PSF."""
    from sequitr_tpu_torch import psf

    def fn_for(dev):
        k = kernel.to(dev)
        return frame_by_frame(lambda _model, frame: psf.richardson_lucy_frame(frame, k, iterations))

    fn_for = _per_device(fn_for)
    return lambda frames: _dp_apply(mesh, fn_for, None, frames)


def make_dp_seam_correlator(
    mesh: Mesh,
    *,
    subpixel: bool = True,
    window: bool = True,
    refine: int = 2,
) -> Callable:
    """DP mosaic seam estimation (``mosaic.pair_offsets``'s ``correlate``):
    ``correlate(refs, movs) -> (shifts (P, 2), responses (P,))`` on the
    host, the pair axis sharded. Pair counts rarely divide the mesh, so the
    pairs are padded with copies of the last one (a real correlation) and
    the padding sliced off."""
    from sequitr_tpu_torch.ops import registration as reg_lib

    def run(_model, refs, movs):
        return reg_lib._correlate(refs, movs, 2, subpixel, window, refine)

    n_dev = mesh.size

    def correlate(refs, movs):
        refs = np.asarray(refs, np.float32)
        movs = np.asarray(movs, np.float32)
        p = refs.shape[0]
        pad = (-p) % n_dev
        if pad:
            refs = np.concatenate([refs, np.repeat(refs[-1:], pad, 0)])
            movs = np.concatenate([movs, np.repeat(movs[-1:], pad, 0)])
        refs_t = torch.from_numpy(refs)
        movs_t = torch.from_numpy(movs)
        shifts, resp = _dp_apply(mesh, lambda dev: run, None, refs_t, movs_t)
        return (
            shifts[:p].cpu().numpy().astype(np.float64),
            resp[:p].cpu().numpy().astype(np.float64),
        )

    return correlate
