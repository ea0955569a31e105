"""U-Net and GAN training steps (port of the U-Net and GAN parts of
``sequitr_tpu.pipeline.train``).

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
taken through the updated discriminator from the same fake. The JAX
package's N2V, flows and stars steps are a later slice of the port.
Checkpoints are PyTorch files in the directory layout of ``pipeline.fit``
in place of orbax.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Callable, Dict, List, Optional, Sequence, Union

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


def _train_forward(cfg: unet.UNetConfig, tc: TrainConfig) -> Callable:
    """``forward(model, images) -> (logits, statistics)`` honouring
    ``tc.polyphase`` (the JAX package's ``_train_forward``): a model outside
    the polyphase cover is refused here, when the step is built."""
    if tc.polyphase:
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


def _finish(state: TrainState, optimizer, loss, logits, labels, stats, extra=None):
    params = state.params
    grads = torch.autograd.grad(loss, params)
    grad_norm = optim.global_norm(grads)  # of the raw gradients, as optax.global_norm
    optimizer.update(params, grads, state.opt_state, grad_norm=grad_norm)
    state.model.set_bn_stats(stats)
    state.step += 1
    with torch.no_grad():
        preds = torch.argmax(logits, dim=-1)
        metrics = {
            "loss": loss.detach(),
            "accuracy": (preds == labels).to(torch.float32).mean(),
            "grad_norm": grad_norm,
        }
    metrics.update(extra or {})
    return state, metrics


def make_unet_train_step(cfg: unet.UNetConfig, tc: TrainConfig) -> Callable:
    """``step(state, batch, generator) -> (state, metrics)``.

    ``batch``: ``image`` (N, *s, C) f32, ``labels`` (N, *s) integer,
    optional ``weights`` (N, *s), on the state's device; ``generator``
    draws the augmentation (unused with ``augment=False``). Metrics
    ``loss``, ``accuracy``, ``grad_norm``: 0-d tensors on the device.
    """
    optimizer = tc.make_optimizer()
    forward = _train_forward(cfg, tc)

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
) -> Callable:
    """Distillation step: ``alpha * weighted_CE(student, labels) + (1 -
    alpha) * T^2 * KL(softmax(teacher / T) || softmax(student / T))`` (the
    teacher's entropy dropped). The teacher (an inference-mode ``UNet``, BN
    folded or not) sees the augmented pixels. Metrics add ``ce`` and ``kd``.
    """
    optimizer = tc.make_optimizer()
    forward = _train_forward(cfg, tc)

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


def make_gan_train_step(cfg: gan_lib.GANConfig, tc: TrainConfig, l1_weight: float = 100.0) -> Callable:
    """``step(state, batch, generator=None) -> (state, metrics)``.

    ``batch``: ``input`` (N, H, W, C_in) raw and ``target`` (N, H, W,
    C_out) clean images on the state's device (``generator`` is unused:
    the GAN trains without augmentation). The generator runs its
    train-mode forward ONCE (``gan.generator_train``, or
    ``polyphase.apply_train`` plus the output activation under
    ``tc.polyphase``); the discriminator steps on (real, detached fake);
    the generator's loss (adversarial through the UPDATED discriminator +
    ``l1_weight`` * L1) backpropagates from that same fake, and only into
    the generator. Metrics ``d_loss``, ``g_loss``: 0-d tensors.
    """
    optimizer = tc.make_optimizer()
    gcfg = cfg.generator_config
    if tc.polyphase:
        forward = _train_forward(gcfg, tc)

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

