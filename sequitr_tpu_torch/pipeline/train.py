"""The training steps (port of ``sequitr_tpu.pipeline.train``): U-Net,
GAN, Noise2Void, flows and stars.

records in -> augmentation on the device -> forward -> weighted CE ->
optax's Adam (``pipeline.optim``) -> batch-norm statistics, as the JAX
package's jitted step does, here as eager PyTorch on the card. Mixed
precision is the model's own: each conv casts its input and weights to
``cfg.compute_dtype`` as ``UNet._conv`` does, master weights, the loss and
the optimizer stay f32; no autocast, no loss scaling. A float32 model runs
its step inside ``utils.ieee_f32`` (no TF32).

``TrainConfig.polyphase`` trains through ``models.polyphase.apply_train``
(``apply3d_train`` for volumes): the same model, level 0 in the phase
domain. The GAN step (``make_gan_train_step``) is the JAX package's
pix2pix update: one train-mode generator forward a step, the
discriminator stepped on the detached fake, then the generator's loss
taken through the updated discriminator from the same fake.

The Noise2Void step (``make_n2v_train_step``) flips, masks (blind spot:
uniform neighbour or the N2V2 window median, structN2V segments) and
scores the masked MSE at the centres; the flows and stars steps flip with
the vector signs or ray permutations and take ``flows_loss`` /
``stars_loss``. As in ``ops.augment``, each random op is a *draw* from a
``torch.Generator`` and a deterministic *apply*; on the JAX package's own
draws the applies give its outputs bit for bit, a position drawn twice
taking its last write as XLA's serial scatter does. Checkpoints are PyTorch files in the directory layout of ``pipeline.fit``
in place of orbax.
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import os
import shutil
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from sequitr_tpu_torch.models import gan as gan_lib
from sequitr_tpu_torch.models import polyphase, unet
from sequitr_tpu_torch.ops import augment as aug
from sequitr_tpu_torch.ops import losses
from sequitr_tpu_torch.pipeline import optim
from sequitr_tpu_torch.utils import ieee_f32

__all__ = [
    "TrainConfig",
    "TrainState",
    "create_unet_state",
    "make_unet_train_step",
    "make_unet_distill_step",
    "N2VFlipDraws",
    "N2VMaskDraws",
    "N2VDraws",
    "n2v_draw_flip",
    "n2v_flip_batch",
    "n2v_draw_mask",
    "n2v_mask_apply",
    "n2v_mask_batch",
    "n2v_mask_batch_3d",
    "n2v_masked_mse",
    "make_n2v_train_step",
    "FlipDraws",
    "draw_flips",
    "flows_flip_batch",
    "flows_loss",
    "make_flows_train_step",
    "stars_flip_batch",
    "STARS_DIST_WEIGHT",
    "STARS_BG_REG",
    "stars_loss",
    "make_stars_train_step",
    "GANTrainState",
    "create_gan_state",
    "make_gan_train_step",
    "save_checkpoint",
    "restore_checkpoint",
]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The JAX package's ``TrainConfig``: the same fields and defaults."""

    learning_rate: float = 1e-4
    beta1: float = 0.9
    weight_decay: float = 0.0
    grad_clip: Optional[float] = 1.0
    augment: bool = True
    elastic_alpha: float = 20.0
    elastic_grid: int = 4
    p_elastic: float = 0.5
    gain_jitter: float = 0.0
    offset_jitter: float = 0.0
    noise_std: float = 0.0
    grad_accum: int = 1
    # recompute the forward in the backward pass (torch.utils.checkpoint)
    remat: bool = False
    lr_schedule: str = "constant"  # "constant" | "cosine" | "exponential"
    lr_warmup_steps: int = 0
    lr_decay_steps: int = 0
    lr_end_factor: float = 0.01
    polyphase: bool = False

    def learning_rate_schedule(self) -> Union[float, optim.Schedule]:
        """The peak rate, or a schedule of the applied-update count."""
        peak = self.learning_rate
        if self.lr_schedule == "constant":
            if not self.lr_warmup_steps:
                return peak
            sched = optim.constant_schedule(peak)
        elif self.lr_schedule == "cosine":
            sched = optim.cosine_decay_schedule(peak, max(1, self.lr_decay_steps), self.lr_end_factor)
        elif self.lr_schedule == "exponential":
            sched = optim.exponential_decay(peak, max(1, self.lr_decay_steps), self.lr_end_factor)
        else:
            raise ValueError(f"unknown lr_schedule {self.lr_schedule!r}")
        if self.lr_warmup_steps:
            warmup = optim.linear_schedule(0.0, peak, self.lr_warmup_steps)
            sched = optim.join_schedules([warmup, sched], [self.lr_warmup_steps])
        return sched

    def make_optimizer(self) -> optim.Optimizer:
        sched_cfg = self
        if self.grad_accum > 1 and self.lr_schedule != "constant":
            # the schedule counts applied updates; its horizons arrive in
            # micro-steps (the job's `steps`)
            ga = self.grad_accum
            sched_cfg = dataclasses.replace(
                self,
                lr_warmup_steps=-(-self.lr_warmup_steps // ga),
                lr_decay_steps=max(1, -(-self.lr_decay_steps // ga)),
            )
        return optim.Optimizer(
            sched_cfg.learning_rate_schedule(),
            b1=self.beta1,
            weight_decay=self.weight_decay,
            grad_clip=self.grad_clip,
            grad_accum=self.grad_accum,
        )


@dataclasses.dataclass
class TrainState:
    """The module (parameters and batch-norm statistics), the optimizer's
    state and the step count; updated in place by the train step."""

    model: unet.UNet
    opt_state: optim.OptState
    step: int = 0

    @property
    def params(self) -> List[torch.Tensor]:
        return list(self.model.parameters())


def create_unet_state(
    cfg: unet.UNetConfig,
    tc: TrainConfig,
    generator: Optional[torch.Generator] = None,
    device: Union[str, torch.device, None] = None,
    model: Optional[unet.UNet] = None,
) -> TrainState:
    """A fresh train state: ``unet.init`` from ``generator`` (or ``model``,
    e.g. weights carried across from the JAX package), parameters taking
    gradients, zero optimizer moments."""
    if model is None:
        model = unet.init(cfg, generator, device)
    model.requires_grad_(True)
    return TrainState(model, tc.make_optimizer().init(list(model.parameters())), 0)


def _augment_batch(generator, images, labels, weights, tc: TrainConfig, dims: int = 2):
    return aug.augment_batch(
        generator, images, labels, weights, dims=dims,
        elastic_alpha=tc.elastic_alpha, elastic_grid=tc.elastic_grid,
        p_elastic=tc.p_elastic, gain_jitter=tc.gain_jitter,
        offset_jitter=tc.offset_jitter, noise_std=tc.noise_std,
    )


def _prepare(batch: Dict[str, torch.Tensor], generator, tc: TrainConfig, dims: int):
    images, labels = batch["image"], batch["labels"]
    weights = batch.get("weights")
    if tc.augment:
        w_in = weights if weights is not None else torch.ones(labels.shape, device=labels.device)
        images, labels, w_out = _augment_batch(generator, images, labels, w_in, tc, dims)
        weights = w_out if weights is not None else None
    return images, labels, weights


def _train_forward(cfg: unet.UNetConfig, tc: TrainConfig, mesh=None) -> Callable:
    """``forward(model, images) -> (logits, statistics)`` honouring
    ``tc.polyphase`` (the JAX package's ``_train_forward``): a model outside
    the polyphase cover is refused here, when the step is built. ``mesh``
    (a ``parallel.spatial_train.TrainMesh``): the batch runs sharded over
    its devices with batch-norm statistics of the global batch
    (``spatial_train.forward_train_gathered``)."""
    if mesh is not None:
        if tc.polyphase:
            raise ValueError(
                "polyphase training does not run on a device mesh: train "
                "polyphase on one device, or data-parallel without polyphase"
            )
        from sequitr_tpu_torch.parallel import spatial_train

        def fwd(model, images):
            return spatial_train.forward_train_gathered(model, images, mesh)
    elif tc.polyphase:
        if (
            cfg.space_to_depth != 1 or cfg.upsample != "transpose"
            or cfg.depth < 2 or cfg.dims not in (2, 3)
        ):
            raise ValueError(
                "polyphase training requires a space_to_depth=1 "
                f"transpose-upsample model of depth >= 2; got "
                f"dims={cfg.dims} s2d={cfg.space_to_depth} "
                f"upsample={cfg.upsample!r} depth={cfg.depth}"
            )
        fwd = polyphase.apply3d_train if cfg.dims == 3 else polyphase.apply_train
    else:
        fwd = unet.UNet.forward_train
    if tc.remat:
        # the backward recomputes the forward; the running statistics of
        # the recomputation are dropped (the forwards write none)
        return lambda model, images: checkpoint(fwd, model, images, use_reentrant=False)
    return fwd


def _update(state: TrainState, optimizer, loss, stats) -> torch.Tensor:
    """Backward, the optimizer's update, the new batch-norm statistics and
    the step count; returns the raw gradients' global norm."""
    params = state.params
    grads = torch.autograd.grad(loss, params)
    grad_norm = optim.global_norm(grads)  # of the raw gradients, as optax.global_norm
    optimizer.update(params, grads, state.opt_state, grad_norm=grad_norm)
    state.model.set_bn_stats(stats)
    state.step += 1
    return grad_norm


def _finish(state: TrainState, optimizer, loss, logits, labels, stats, extra=None):
    grad_norm = _update(state, optimizer, loss, stats)
    with torch.no_grad():
        preds = torch.argmax(logits, dim=-1)
        metrics = {
            "loss": loss.detach(),
            "accuracy": (preds == labels).to(torch.float32).mean(),
            "grad_norm": grad_norm,
        }
    metrics.update(extra or {})
    return state, metrics


def make_unet_train_step(cfg: unet.UNetConfig, tc: TrainConfig, mesh=None) -> Callable:
    """``step(state, batch, generator) -> (state, metrics)``.

    ``batch``: ``image`` (N, *s, C) f32, ``labels`` (N, *s) integer,
    optional ``weights`` (N, *s), on the state's device; ``generator``
    draws the augmentation (unused with ``augment=False``). Metrics
    ``loss``, ``accuracy``, ``grad_norm``: 0-d tensors on the device.
    ``mesh``: the forward runs data-parallel (``parallel.make_dp_train_step``).
    """
    optimizer = tc.make_optimizer()
    forward = _train_forward(cfg, tc, mesh)

    def step(state: TrainState, batch, generator: Optional[torch.Generator] = None):
        with ieee_f32(cfg.compute_dtype == "float32"):
            images, labels, weights = _prepare(batch, generator, tc, cfg.dims)
            logits, stats = forward(state.model, images)
            loss = losses.weighted_softmax_cross_entropy(logits, labels, weights)
            return _finish(state, optimizer, loss, logits, labels, stats)

    return step


def make_unet_distill_step(
    cfg: unet.UNetConfig,
    teacher: unet.UNet,
    tc: TrainConfig,
    alpha: float = 0.5,
    temperature: float = 2.0,
    mesh=None,
) -> Callable:
    """Distillation step: ``alpha * weighted_CE(student, labels) + (1 -
    alpha) * T^2 * KL(softmax(teacher / T) || softmax(student / T))`` (the
    teacher's entropy dropped). The teacher (an inference-mode ``UNet``, BN
    folded or not) sees the augmented pixels. Metrics add ``ce`` and ``kd``.
    """
    optimizer = tc.make_optimizer()
    forward = _train_forward(cfg, tc, mesh)

    def step(state: TrainState, batch, generator: Optional[torch.Generator] = None):
        with ieee_f32(cfg.compute_dtype == "float32"):
            images, labels, weights = _prepare(batch, generator, tc, cfg.dims)
            with torch.no_grad():
                t_soft = torch.softmax(teacher(images).to(torch.float32) / temperature, dim=-1)
            logits, stats = forward(state.model, images)
            ce = losses.weighted_softmax_cross_entropy(logits, labels, weights)
            log_s = F.log_softmax(logits.to(torch.float32) / temperature, dim=-1)
            kd = -(temperature**2) * torch.mean(torch.sum(t_soft * log_s, dim=-1))
            loss = alpha * ce + (1.0 - alpha) * kd
            return _finish(
                state, optimizer, loss, logits, labels, stats,
                {"ce": ce.detach(), "kd": kd.detach()},
            )

    return step


# ---------------------------------------------------------------------------
# Noise2Void self-supervised denoising (blind-spot masking)
# ---------------------------------------------------------------------------


def _to(t: torch.Tensor, device) -> torch.Tensor:
    """A host draw on ``device``: on the card through pinned memory, so the
    copy needs no host sync."""
    device = torch.device(device)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _where(bits: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per sample: ``a`` where its bit is set, else ``b`` (bits (B,))."""
    return torch.where(bits.view((-1,) + (1,) * (a.ndim - 1)), a, b)


@dataclasses.dataclass
class N2VFlipDraws:
    """``flips``: (B, D) bools, one per spatial axis; ``transpose``: (B,)
    bools, or None where no transpose applies (a non-square plane, or a
    structN2V axis in the plane)."""

    flips: torch.Tensor
    transpose: Optional[torch.Tensor] = None


@dataclasses.dataclass
class N2VMaskDraws:
    """``centers``: (B, D, n_mask) scored positions; ``offsets``: (B, D,
    n_rep) neighbour offsets of the uniform mode (zero along a structN2V
    axis), None in the median mode."""

    centers: torch.Tensor
    offsets: Optional[torch.Tensor] = None


@dataclasses.dataclass
class N2VDraws:
    flip: Optional[N2VFlipDraws]
    mask: N2VMaskDraws


def n2v_draw_flip(generator: Optional[torch.Generator], shape: Sequence[int], transpose: bool = True) -> N2VFlipDraws:
    """Fair coins for each sample's flips of a (B, *spatial, C) batch, then
    its in-plane transpose when ``transpose`` and the plane is square."""
    b, spatial = shape[0], tuple(shape[1:-1])
    flips = torch.rand((b, len(spatial)), generator=generator) < 0.5
    ts = None
    if transpose and spatial[-1] == spatial[-2]:
        ts = torch.rand((b,), generator=generator) < 0.5
    return N2VFlipDraws(flips, ts)


def n2v_flip_batch(images: torch.Tensor, draws: N2VFlipDraws) -> torch.Tensor:
    """The JAX package's ``n2v_flip_batch`` on given draws: each sample
    flipped along every axis whose bit is set, then its trailing two
    spatial axes swapped where its transpose bit is set."""
    nd = images.ndim - 2
    flips = _to(draws.flips, images.device)
    out = images
    for ax in range(nd):
        out = _where(flips[:, ax], torch.flip(out, [ax + 1]), out)
    if draws.transpose is not None:
        out = _where(_to(draws.transpose, images.device), out.transpose(nd - 1, nd), out)
    return out


def _n2v_radii(radius, n_axes: int) -> Tuple[int, ...]:
    """Per-axis neighbour radii: an int broadcasts; a tuple is taken as-is.
    At least one axis must allow movement (radius >= 1)."""
    radii = (
        tuple(int(r) for r in radius)
        if isinstance(radius, (tuple, list))
        else (int(radius),) * n_axes
    )
    if len(radii) != n_axes:
        raise ValueError(f"radius {radius} must have {n_axes} axes")
    if any(r < 0 for r in radii) or max(radii) < 1:
        raise ValueError(
            f"radius {radius}: per-axis radii must be >= 0 with at least "
            "one axis >= 1 (the substitute must be able to move)"
        )
    return radii


def _n2v_struct(struct, radii, nd: int):
    """Validate a structN2V spec ``(axis, span)`` against the radii: the
    substitutes must be able to move along another axis."""
    if struct is None:
        return None
    s_ax, span = int(struct[0]), int(struct[1])
    if not 0 <= s_ax < nd:
        raise ValueError(f"struct axis {s_ax} out of range for {nd}D patches")
    if span < 1:
        raise ValueError(f"struct span {span} must be >= 1")
    if not any(r >= 1 for i, r in enumerate(radii) if i != s_ax):
        raise ValueError(
            f"structN2V along axis {s_ax} needs radius >= 1 on another "
            f"axis (got radii {radii}): substitutes must come from "
            "OUTSIDE the correlated line"
        )
    return s_ax, span


def _reflect(idx: torch.Tensor, extent: int) -> torch.Tensor:
    """Reflect out-of-bounds indices back inside [0, extent)."""
    n = torch.abs(idx)
    return torch.where(n > extent - 1, 2 * (extent - 1) - n, n)


def _n2v_plan(spatial: Sequence[int], radii, mode: str, struct):
    """The JAX package's checks of ``_n2v_mask_nd``, with their messages;
    returns (struct, fix axis, median window taps or None)."""
    nd = len(spatial)
    for r, s in zip(radii, spatial):
        if r >= s:
            # one reflection stays in bounds only for radius < extent
            raise ValueError(
                f"radius {tuple(radii)} must be < the patch extent {tuple(spatial)} "
                "on every axis"
            )
    if mode not in ("uniform", "median"):
        raise ValueError(f"mask mode {mode!r} must be 'uniform' or 'median'")
    struct = _n2v_struct(struct, radii, nd)
    if struct is not None and struct[1] >= spatial[struct[0]]:
        raise ValueError(
            f"struct span {struct[1]} must be < the patch extent "
            f"{spatial[struct[0]]} along axis {struct[0]}"
        )
    # the last non-struct axis that allows movement
    fix = max(i for i, r in enumerate(radii) if r >= 1 and (struct is None or i != struct[0]))
    window = None
    if mode == "median":
        # the centre (and, under struct, the correlated line) left out
        window = [
            o for o in itertools.product(*[range(-r, r + 1) for r in radii])
            if any(o) and (struct is None or any(o[a] for a in range(nd) if a != struct[0]))
        ]
    return struct, fix, window


def _window_median(vals: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` over axis 1: for an even count the mean of the two
    middle values, ``(lower + upper) * 0.5`` (``torch.median`` returns the
    lower middle)."""
    srt = torch.sort(vals, dim=1).values
    t = vals.shape[1]
    return (srt[:, (t - 1) // 2] + srt[:, t // 2]) * 0.5


def n2v_draw_mask(
    generator: Optional[torch.Generator],
    shape: Sequence[int],
    n_mask: int,
    radii,
    mode: str = "uniform",
    struct=None,
) -> N2VMaskDraws:
    """Uniform centres on every axis of a (B, *spatial, C) batch, then (in
    the uniform mode) uniform offsets in ``[-r, r]`` for each replaced
    position, zero along a structN2V axis."""
    b, spatial = shape[0], tuple(shape[1:-1])
    centers = torch.stack([torch.randint(0, s, (b, n_mask), generator=generator) for s in spatial], 1)
    offsets = None
    if mode == "uniform":
        n_rep = n_mask * (1 if struct is None else 2 * int(struct[1]) + 1)
        offsets = torch.stack([
            torch.zeros((b, n_rep), dtype=torch.int64)
            if struct is not None and a == int(struct[0])
            else torch.randint(-r, r + 1, (b, n_rep), generator=generator)
            for a, r in enumerate(radii)
        ], 1)
    return N2VMaskDraws(centers, offsets)


def n2v_mask_apply(
    images: torch.Tensor,
    draws: N2VMaskDraws,
    radii,
    mode: str = "uniform",
    struct=None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The JAX package's ``_n2v_mask_nd`` on given draws: ``(masked,
    coords)``, coords the D (B, n_mask) centres.

    Each centre (under ``struct``, its whole reflected +/-span segment
    along the struct axis) is replaced by a neighbour (uniform: the drawn
    offset, the all-zero one moved to +1 on the fix axis, reflected, a
    reflected self-hit moved one step off) or by the median of its window
    (the mean of the two middle values for an even count, as
    ``jnp.median``; taps reflected onto the blind region moved off it).
    Positions are drawn with replacement: a position written more than
    once takes its last write, as XLA's serial scatter does, whatever the
    order the device writes in (every write of a position carries the last
    one's value). No host sync, no data-dependent shape.
    """
    spatial = tuple(images.shape[1:-1])
    nd = len(spatial)
    b, c = images.shape[0], images.shape[-1]
    struct, fix, window = _n2v_plan(spatial, radii, mode, struct)
    dev = images.device
    centers = _to(draws.centers, dev)
    cs = [centers[:, a] for a in range(nd)]
    if struct is None:
        ps = cs
    else:
        s_ax, span = struct
        offs = torch.arange(-span, span + 1, device=dev)
        ps = [
            (_reflect(cc[:, :, None] + offs, spatial[a]) if a == s_ax
             else cc[:, :, None].expand(-1, -1, 2 * span + 1)).reshape(b, -1)
            for a, cc in enumerate(cs)
        ]
    n_rep = ps[0].shape[1]
    rows = torch.arange(b, device=dev)
    if mode == "median":
        taps = torch.tensor(window, dtype=torch.int64).t().contiguous()  # (D, T)
        taps = _to(taps, dev)
        idx = [_reflect(p[:, None, :] + taps[a][None, :, None], spatial[a]) for a, p in enumerate(ps)]
        blind = None
        for a in range(nd):
            if struct is not None and a == struct[0]:
                continue
            eq = idx[a] == ps[a][:, None, :]
            blind = eq if blind is None else blind & eq
        pf = ps[fix][:, None, :]
        idx[fix] = torch.where(blind, torch.where(pf > 0, pf - 1, pf + 1), idx[fix])
        sub = _window_median(images[(rows[:, None, None], *idx)])  # (B, T, n_rep, C) -> (B, n_rep, C)
    else:
        offsets = _to(draws.offsets, dev)
        ds = [
            torch.zeros_like(ps[a]) if struct is not None and a == struct[0] else offsets[:, a]
            for a in range(nd)
        ]
        all_zero = ds[0] == 0
        for d in ds[1:]:
            all_zero = all_zero & (d == 0)
        ds[fix] = torch.where(all_zero, 1, ds[fix])
        ns = [_reflect(p + d, s) for p, d, s in zip(ps, ds, spatial)]
        self_hit = ns[0] == ps[0]
        for n, p in zip(ns[1:], ps[1:]):
            self_hit = self_hit & (n == p)
        ns[fix] = torch.where(self_hit, torch.where(ps[fix] > 0, ps[fix] - 1, ps[fix] + 1), ns[fix])
        sub = images[(rows[:, None], *ns)]  # (B, n_rep, C)
    # the last write of each position wins: every write takes its value
    n_px = 1
    lin = torch.zeros_like(ps[0])
    for a in reversed(range(nd)):
        lin = lin + ps[a] * n_px
        n_px *= spatial[a]
    flat = (lin + rows[:, None] * n_px).reshape(-1)
    order = torch.arange(b * n_rep, device=dev)
    last = torch.full((b * n_px,), -1, dtype=torch.int64, device=dev)
    last.scatter_reduce_(0, flat, order, "amax")
    out = images.reshape(b * n_px, c).clone()
    out[flat] = sub.reshape(b * n_rep, c)[last[flat]]
    return out.reshape(images.shape), tuple(cs)


def n2v_mask_batch(generator, images, n_mask: int, radius, mode: str = "uniform", struct=None):
    """2D blind-spot masking on fresh draws: ``(masked, ys, xs)``."""
    radii = _n2v_radii(radius, 2)
    draws = n2v_draw_mask(generator, images.shape, n_mask, radii, mode, struct)
    masked, (ys, xs) = n2v_mask_apply(images, draws, radii, mode, struct)
    return masked, ys, xs


def n2v_mask_batch_3d(generator, volumes, n_mask: int, radius, mode: str = "uniform", struct=None):
    """Volumetric blind-spot masking over (B, Z, H, W, C) on fresh draws;
    ``radius`` an int or (rz, ry, rx). Returns ``(masked, zs, ys, xs)``."""
    radii = _n2v_radii(radius, 3)
    draws = n2v_draw_mask(generator, volumes.shape, n_mask, radii, mode, struct)
    masked, (zs, ys, xs) = n2v_mask_apply(volumes, draws, radii, mode, struct)
    return masked, zs, ys, xs


def n2v_masked_mse(pred: torch.Tensor, target: torch.Tensor, *coords: torch.Tensor) -> torch.Tensor:
    """Mean squared error (f32) at the D (B, n_mask) coordinates only; a
    centre drawn twice counts twice."""
    rows = torch.arange(pred.shape[0], device=pred.device)[:, None]
    p = pred.to(torch.float32)[(rows, *coords)]
    t = target.to(torch.float32)[(rows, *coords)]
    return torch.mean((p - t) ** 2)


def make_n2v_train_step(
    cfg: unet.UNetConfig,
    tc: TrainConfig,
    mask_frac: float = 0.005,
    radius=5,
    mask_mode: str = "uniform",
    struct=None,
    mesh=None,
) -> Callable:
    """``step(state, batch, generator=None, draws=None) -> (state, metrics)``.

    The JAX package's Noise2Void step: flips (and the in-plane transpose,
    dropped for an in-plane struct axis) when ``tc.augment``, the
    blind-spot mask of ``max(1, int(mask_frac * pixels))`` centres a
    sample, the train forward (standard or polyphase) of the masked
    batch, the masked MSE against the unmasked batch at the centres, then
    the optimizer. ``batch``: ``image`` (B, *spatial, C) f32 on the
    state's device. The flips, then the mask, are drawn from
    ``generator`` unless ``draws`` (an ``N2VDraws``) gives them. Metrics
    ``loss`` and ``grad_norm``.
    """
    if cfg.dims not in (2, 3):
        raise ValueError(f"Noise2Void training needs dims 2 or 3, got {cfg.dims}")
    if not 0.0 < mask_frac <= 0.5:
        raise ValueError(f"mask_frac={mask_frac} must be in (0, 0.5]")
    radii = _n2v_radii(radius, cfg.dims)
    if mask_mode not in ("uniform", "median"):
        raise ValueError(f"mask_mode {mask_mode!r} must be 'uniform' or 'median'")
    struct = _n2v_struct(struct, radii, cfg.dims)
    # a transpose would rotate an in-plane correlated-noise axis
    transpose = struct is None or struct[0] < cfg.dims - 2
    optimizer = tc.make_optimizer()
    forward = _train_forward(cfg, tc, mesh)

    def step(state: TrainState, batch, generator: Optional[torch.Generator] = None,
             draws: Optional[N2VDraws] = None):
        images = batch["image"]
        if images.ndim != cfg.dims + 2:
            raise ValueError(
                f"n2v batch must be (B, *spatial, C) with {cfg.dims} "
                f"spatial axes; got shape {tuple(images.shape)}"
            )
        n_mask = max(1, int(mask_frac * math.prod(images.shape[1:-1])))
        if draws is None:
            flip = n2v_draw_flip(generator, images.shape, transpose) if tc.augment else None
            draws = N2VDraws(flip, n2v_draw_mask(generator, images.shape, n_mask, radii, mask_mode, struct))
        with ieee_f32(cfg.compute_dtype == "float32"):
            if tc.augment:
                images = n2v_flip_batch(images, draws.flip)
            masked, coords = n2v_mask_apply(images, draws.mask, radii, mask_mode, struct)
            pred, stats = forward(state.model, masked)
            loss = n2v_masked_mse(pred, images, *coords)
            grad_norm = _update(state, optimizer, loss, stats)
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}

    return step


# ---------------------------------------------------------------------------
# flow-field and star-convex instance training
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class FlipDraws:
    """``flips``: (B, n_axes) bools; ``photometric``: a (gain, offset,
    noise) triple a sample (``aug.draw_photometric``), or None when every
    jitter is 0."""

    flips: torch.Tensor
    photometric: Optional[List[tuple]] = None


def draw_flips(generator: Optional[torch.Generator], shape: Sequence[int], n_axes: int, tc: TrainConfig) -> FlipDraws:
    """A fair coin for each sample's flip axes, then each sample's
    photometric draws when a jitter is above 0."""
    flips = torch.rand((shape[0], n_axes), generator=generator) < 0.5
    phot = None
    if tc.gain_jitter > 0 or tc.offset_jitter > 0 or tc.noise_std > 0:
        phot = [
            aug.draw_photometric(generator, shape[1:], tc.gain_jitter, tc.offset_jitter, tc.noise_std)
            for _ in range(shape[0])
        ]
    return FlipDraws(flips, phot)


def _photometric(images: torch.Tensor, phot) -> torch.Tensor:
    if phot is None:
        return images
    dev = images.device
    return torch.stack([
        aug.apply_photometric(x, *(None if t is None else _to(t, dev) for t in p))
        for x, p in zip(images, phot)
    ])


def flows_flip_batch(images, flow, prob, flips: torch.Tensor):
    """The JAX package's ``flows_flip_batch`` on given bits (B, D): flipping
    spatial axis ``ax`` flips the image, the field and the probability and
    negates flow component ``ax``."""
    nd = flow.shape[-1]
    flips = _to(flips, images.device)
    for ax in range(nd):
        bit = flips[:, ax]
        f = torch.flip(flow, [ax + 1])
        f = torch.cat([f[..., :ax], -f[..., ax:ax + 1], f[..., ax + 1:]], dim=-1)
        images = _where(bit, torch.flip(images, [ax + 1]), images)
        flow = _where(bit, f, flow)
        prob = _where(bit, torch.flip(prob, [ax + 1]), prob)
    return images, flow, prob


def flows_loss(out: torch.Tensor, flow: torch.Tensor, prob: torch.Tensor):
    """``(loss, flow_mse, prob_bce)`` of a flows head ``out`` (B, *s, D +
    1): the MSE of the first D channels against ``FLOW_SCALE * flow`` plus
    the mean sigmoid BCE of the last against ``prob``, in f32."""
    from sequitr_tpu_torch.ops.flows import FLOW_SCALE

    out = out.to(torch.float32)
    nd = flow.shape[-1]
    flow_mse = torch.mean((out[..., :nd] - FLOW_SCALE * flow) ** 2)
    prob_bce = losses.sigmoid_bce_with_logits(out[..., nd], prob)
    return flow_mse + prob_bce, flow_mse, prob_bce


def make_flows_train_step(cfg: unet.UNetConfig, tc: TrainConfig, mesh=None) -> Callable:
    """``step(state, batch, generator=None, draws=None) -> (state, metrics)``.

    The JAX package's flow-field step: flips (vector-aware) and the
    photometric jitter when ``tc.augment``, the train forward,
    ``flows_loss``, then the optimizer.
    ``batch``: ``image`` (B, *s, C), ``flow`` (B, *s, D), ``prob`` (B,
    *s). Draws from ``generator`` unless ``draws`` (a ``FlipDraws``) gives
    them. Metrics ``loss``, ``flow_mse``, ``prob_bce``, ``grad_norm``.
    """
    if cfg.num_classes != cfg.dims + 1:
        raise ValueError(
            f"flows training needs num_classes == dims + 1 "
            f"({cfg.dims + 1}), got {cfg.num_classes}"
        )
    optimizer = tc.make_optimizer()
    forward = _train_forward(cfg, tc, mesh)
    nd = cfg.dims

    def step(state: TrainState, batch, generator: Optional[torch.Generator] = None,
             draws: Optional[FlipDraws] = None):
        images, flow, prob = batch["image"], batch["flow"], batch["prob"]
        with ieee_f32(cfg.compute_dtype == "float32"):
            if tc.augment:
                if draws is None:
                    draws = draw_flips(generator, images.shape, nd, tc)
                images, flow, prob = flows_flip_batch(images, flow, prob, draws.flips)
                images = _photometric(images, draws.photometric)
            out, stats = forward(state.model, images)
            loss, flow_mse, prob_bce = flows_loss(out, flow, prob)
            grad_norm = _update(state, optimizer, loss, stats)
        return state, {
            "loss": loss.detach(), "flow_mse": flow_mse.detach(),
            "prob_bce": prob_bce.detach(), "grad_norm": grad_norm,
        }

    return step


def stars_flip_batch(images, dist, prob, flips: torch.Tensor, perms: torch.Tensor):
    """The JAX package's ``stars_flip_batch`` on given bits (B, 2): flipping
    axis ``ax`` flips the image, the distances and the probability and
    permutes the rays by ``perms[ax]`` (``stardist.ray_flip_perm``), axis 0
    first."""
    dev = images.device
    flips, perms = _to(flips, dev), _to(perms, dev)
    for ax in range(2):
        bit = flips[:, ax]
        images = _where(bit, torch.flip(images, [ax + 1]), images)
        dist = _where(bit, torch.flip(dist, [ax + 1]).index_select(-1, perms[ax]), dist)
        prob = _where(bit, torch.flip(prob, [ax + 1]), prob)
    return images, dist, prob


# the distance head's weight and the background regulariser (the JAX
# package's measured balance, sequitr_tpu/pipeline/train.py)
STARS_DIST_WEIGHT = 1.0
STARS_BG_REG = 1e-4


def stars_loss(out: torch.Tensor, dist: torch.Tensor, prob: torch.Tensor):
    """``(loss, dist_mae, prob_bce)`` of a stars head ``out`` (B, H, W, 1 +
    n_rays), in f32: the mean sigmoid BCE of channel 0 against ``prob``,
    plus ``STARS_DIST_WEIGHT`` x the distance MAE over ``prob > 0``, plus
    ``STARS_BG_REG`` x the background distances' mean magnitude."""
    out = out.to(torch.float32)
    n_rays = dist.shape[-1]
    prob_bce = losses.sigmoid_bce_with_logits(out[..., 0], prob)
    d_pred = out[..., 1:]
    fg = (prob > 0).to(torch.float32)[..., None]
    dist_mae = torch.sum(fg * torch.abs(d_pred - dist)) / (torch.sum(fg) * n_rays + 1e-8)
    bg = 1.0 - fg
    bg_reg = torch.sum(bg * torch.abs(d_pred)) / (torch.sum(bg) * n_rays + 1e-8)
    return prob_bce + STARS_DIST_WEIGHT * dist_mae + STARS_BG_REG * bg_reg, dist_mae, prob_bce


def make_stars_train_step(cfg: unet.UNetConfig, tc: TrainConfig, mesh=None) -> Callable:
    """``step(state, batch, generator=None, draws=None) -> (state, metrics)``.

    The JAX package's star-convex step (2D): flips (ray-permuting) and the
    photometric jitter when ``tc.augment``, the train forward,
    ``stars_loss`` (distances weighted by ``prob > 0``), then the
    optimizer. ``batch``: ``image`` (B, H, W, C), ``dist`` (B, H, W,
    n_rays), ``prob`` (B, H, W). Metrics ``loss``, ``dist_mae``,
    ``prob_bce``, ``grad_norm``.
    """
    from sequitr_tpu_torch.ops import stardist as sd

    if cfg.dims != 2:
        raise ValueError(
            f"star-convex training is 2D only (got dims={cfg.dims}); "
            f"volumetric instances are served by the flows family"
        )
    n_rays = cfg.num_classes - 1
    if n_rays < 4 or n_rays % 4:
        raise ValueError(
            f"stars training needs num_classes == 1 + n_rays with n_rays "
            f"a positive multiple of 4, got num_classes={cfg.num_classes}"
        )
    perms = torch.stack([torch.as_tensor(sd.ray_flip_perm(n_rays, ax), dtype=torch.int64) for ax in (0, 1)])
    optimizer = tc.make_optimizer()
    forward = _train_forward(cfg, tc, mesh)

    def step(state: TrainState, batch, generator: Optional[torch.Generator] = None,
             draws: Optional[FlipDraws] = None):
        images, dist, prob = batch["image"], batch["dist"], batch["prob"]
        with ieee_f32(cfg.compute_dtype == "float32"):
            if tc.augment:
                if draws is None:
                    draws = draw_flips(generator, images.shape, 2, tc)
                images, dist, prob = stars_flip_batch(images, dist, prob, draws.flips, perms)
                images = _photometric(images, draws.photometric)
            out, stats = forward(state.model, images)
            loss, dist_mae, prob_bce = stars_loss(out, dist, prob)
            grad_norm = _update(state, optimizer, loss, stats)
        return state, {
            "loss": loss.detach(), "dist_mae": dist_mae.detach(),
            "prob_bce": prob_bce.detach(), "grad_norm": grad_norm,
        }

    return step


# ---------------------------------------------------------------------------
# GAN training (the alternating D and G updates of one step)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class GANTrainState:
    """The ``GAN`` (generator and discriminator parameters, the generator's
    batch-norm statistics), one optimizer state each and the step count;
    updated in place by the train step."""

    model: gan_lib.GAN
    gen_opt_state: optim.OptState
    disc_opt_state: optim.OptState
    step: int = 0

    @property
    def params(self) -> List[torch.Tensor]:
        return list(self.model.parameters())


def create_gan_state(
    cfg: gan_lib.GANConfig,
    tc: TrainConfig,
    generator: Optional[torch.Generator] = None,
    device: Union[str, torch.device, None] = None,
    model: Optional[gan_lib.GAN] = None,
) -> GANTrainState:
    """A fresh GAN train state: ``gan.init`` from ``generator`` (or
    ``model``), parameters taking gradients, zero moments for the
    generator's and the discriminator's optimizers."""
    if model is None:
        model = gan_lib.init(cfg, generator, device)
    model.requires_grad_(True)
    opt = tc.make_optimizer()
    return GANTrainState(
        model, opt.init(list(model.gen.parameters())), opt.init(list(model.disc.parameters())), 0
    )


def make_gan_train_step(
    cfg: gan_lib.GANConfig, tc: TrainConfig, l1_weight: float = 100.0, mesh=None
) -> Callable:
    """``step(state, batch, generator=None) -> (state, metrics)``.

    ``batch``: ``input`` (N, H, W, C_in) raw and ``target`` (N, H, W,
    C_out) clean images on the state's device (``generator`` is unused:
    the GAN trains without augmentation). The generator runs its
    train-mode forward ONCE (``gan.generator_train``, or
    ``polyphase.apply_train`` plus the output activation under
    ``tc.polyphase``); the discriminator steps on (real, detached fake);
    the generator's loss (adversarial through the UPDATED discriminator +
    ``l1_weight`` * L1) backpropagates from that same fake, and only into
    the generator. Metrics ``d_loss``, ``g_loss``: 0-d tensors. ``mesh``:
    the generator's forward runs data-parallel with global batch-norm
    statistics; the discriminator (no normalization, one score a patch)
    scores the gathered batch on the job's device.
    """
    optimizer = tc.make_optimizer()
    gcfg = cfg.generator_config
    if tc.polyphase or mesh is not None:
        forward = _train_forward(gcfg, tc, mesh)

        def generate(model, x):
            y, stats = forward(model.gen, x)
            return gan_lib.activate(cfg, y), stats
    else:
        generate = gan_lib.generator_train

    def step(state: GANTrainState, batch, generator: Optional[torch.Generator] = None):
        model = state.model
        gen_params = list(model.gen.parameters())
        disc_params = list(model.disc.parameters())
        with ieee_f32(cfg.compute_dtype == "float32"):
            x, y_real = batch["input"], batch["target"]
            fake, stats = generate(model, x)

            # the discriminator's update: the generator frozen (detached fake)
            fake_d = fake.detach()
            d_loss = losses.gan_discriminator_loss(
                gan_lib.discriminator_apply(model, x, y_real),
                gan_lib.discriminator_apply(model, x, fake_d),
            )
            d_grads = torch.autograd.grad(d_loss, disc_params)
            optimizer.update(disc_params, d_grads, state.disc_opt_state)

            # the generator's update: the same fake through the new
            # discriminator, gradients taken for the generator alone
            g_loss = losses.gan_generator_loss(
                gan_lib.discriminator_apply(model, x, fake), fake, y_real, l1_weight
            )
            g_grads = torch.autograd.grad(g_loss, gen_params)
            optimizer.update(gen_params, g_grads, state.gen_opt_state)
            model.gen.set_bn_stats(stats)
        state.step += 1
        return state, {"d_loss": d_loss.detach(), "g_loss": g_loss.detach()}

    return step


# ---------------------------------------------------------------------------
# checkpoints: one PyTorch file a directory (pipeline.fit's layout)
# ---------------------------------------------------------------------------

_FILE = "state.pt"


def _opt_states(state) -> Dict[str, optim.OptState]:
    if isinstance(state, GANTrainState):
        return {"gen_opt": state.gen_opt_state, "disc_opt": state.disc_opt_state}
    return {"opt": state.opt_state}


def save_checkpoint(
    path: str, state: Union[TrainState, GANTrainState, Sequence[torch.Tensor]]
) -> None:
    """Save a ``TrainState`` or ``GANTrainState`` (module state dict,
    optimizer states, step) or a list of tensors (an EMA of parameters) as
    ``path/state.pt``, replacing ``path`` whole: written under a temporary
    name, then renamed."""
    if isinstance(state, (TrainState, GANTrainState)):
        obj = {"model": state.model.state_dict(), "step": int(state.step)}
        obj.update({k: o.state_dict() for k, o in _opt_states(state).items()})
    else:
        obj = {"tensors": [t.detach() for t in state]}
    tmp = f"{path}.tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(obj, os.path.join(tmp, _FILE))
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def restore_checkpoint(path: str, target):
    """Load ``path`` into ``target`` in place (a ``TrainState`` or
    ``GANTrainState``, or a list of tensors for an EMA) and return it."""
    is_state = isinstance(target, (TrainState, GANTrainState))
    device = next(target.model.parameters()).device if is_state else target[0].device
    obj = torch.load(os.path.join(path, _FILE), map_location=device, weights_only=True)
    with torch.no_grad():
        if is_state:
            target.model.load_state_dict(obj["model"])
            for key, opt_state in _opt_states(target).items():
                opt_state.load_state_dict(obj[key])
            target.step = int(obj["step"])
        else:
            for dst, src in zip(target, obj["tensors"]):
                dst.copy_(src)
    return target

