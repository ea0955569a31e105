"""pix2pix-style GAN for image enhancement (port of ``sequitr_tpu.models.gan``).

A U-Net generator maps a raw fluorescence patch to an enhanced one (the
2D ``UNet`` of ``GANConfig.generator_config`` plus an output activation),
and a PatchGAN discriminator scores (input, output) pairs: ``disc_layers``
k4 stride-2 SAME convs, a k4 stride-1 SAME penultimate conv and a k4
stride-1 SAME head to one logit a patch, leaky ReLU (0.2) between, no
normalization.

Numerics are ``unet._conv``'s (operands and conv output in
``compute_dtype``, bias added in f32). XLA's SAME padding is asymmetric
where the kernel is even: a k4 stride-1 conv pads (1, 2) on each axis, a
k4 stride-2 conv on an even axis (1, 1) — the discriminator pads
explicitly, per axis, as ``jax.lax.conv_general_dilated`` does.

The serving forward is the generator (``generator_apply``); training runs
the generator in train mode (``generator_train``: batch statistics, the
new running statistics returned) and the discriminator on (input, output)
pairs. A ``gan`` model's weights cross whole (flat keys ``gen/...``,
``disc/...`` and ``state/gen/...``, ``models.convert``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from sequitr_tpu_torch.models import unet as unet_lib
from sequitr_tpu_torch.utils import resolve_device

__all__ = [
    "GANConfig", "GAN", "init", "generator_apply", "generator_train",
    "discriminator_apply", "fold_generator",
]

_ACTIVATIONS = ("sigmoid", "tanh", "linear")


@dataclasses.dataclass(frozen=True)
class GANConfig:
    """GAN architecture configuration (``sequitr_tpu.models.gan.GANConfig``);
    ``compute_dtype`` is stored as its name, as in ``unet.UNetConfig``."""

    in_channels: int = 1
    out_channels: int = 1
    gen_depth: int = 4
    gen_base_features: int = 32
    disc_layers: int = 3  # strided conv layers => 70x70-receptive-field PatchGAN
    disc_base_features: int = 64
    compute_dtype: str = "bfloat16"
    # "sigmoid" | "tanh" | "linear": data is normalized to [0, 1], so the
    # default output range matches it
    output_activation: str = "sigmoid"
    # the generator's norm layer; serving folds it (``fold_generator``)
    gen_norm: str = "batch"

    def __post_init__(self):
        object.__setattr__(self, "compute_dtype", unet_lib._dtype_name(self.compute_dtype))
        if self.output_activation not in _ACTIVATIONS:
            raise ValueError(
                f"output_activation must be one of {_ACTIVATIONS}, got {self.output_activation!r}"
            )

    @property
    def generator_config(self) -> unet_lib.UNetConfig:
        return unet_lib.UNetConfig(
            in_channels=self.in_channels,
            num_classes=self.out_channels,
            depth=self.gen_depth,
            base_features=self.gen_base_features,
            norm=self.gen_norm,
            compute_dtype=self.compute_dtype,
        )

    @property
    def min_input_multiple(self) -> int:
        return max(self.generator_config.min_input_multiple, 2**self.disc_layers)


class _Discriminator(nn.Module):
    """PatchGAN weights (``convs``, ``penultimate``, ``head``), widths as
    ``gan.init``: base, doubling to at most 512, then the next width."""

    def __init__(self, cfg: GANConfig, device):
        super().__init__()
        c_in = cfg.in_channels + cfg.out_channels  # conditional: concat(x, y)
        c = cfg.disc_base_features
        self.convs = nn.ModuleList()
        for _ in range(cfg.disc_layers):
            self.convs.append(unet_lib._Conv(4, c_in, c, False, device))
            c_in, c = c, min(c * 2, 512)
        self.penultimate = unet_lib._Conv(4, c_in, c, False, device)
        self.head = unet_lib._Conv(4, c, 1, False, device)


class GAN(nn.Module):
    """Generator (``gen``, a 2D ``UNet``) and discriminator (``disc``) of
    ``cfg``. Parameters start at zero; ``models.convert.load_flat`` loads
    trained ones."""

    def __init__(self, cfg: GANConfig, device: Union[str, torch.device, None] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        self.gen = unet_lib.UNet(cfg.generator_config, device=device)
        self.disc = _Discriminator(cfg, device)


def init(
    cfg: GANConfig,
    generator: Optional[torch.Generator] = None,
    device: Union[str, torch.device, None] = None,
) -> GAN:
    """A ``GAN`` of ``cfg`` with the JAX package's initialisation
    (``gan.init``): the generator as ``unet.init`` draws it, then every
    discriminator kernel He-normal (``N(0, 1) * sqrt(2 / fan_in)``,
    ``fan_in = 16 * c_in``) in order (the strided convs, the penultimate,
    the head), biases zero. Draws come from ``generator`` on the CPU; the
    values differ from ``jax.random``'s."""
    model = GAN(cfg, device="cpu")
    with torch.no_grad():
        model.gen.load_state_dict(unet_lib.init(cfg.generator_config, generator, "cpu").state_dict())
        disc = model.disc
        for conv in [*disc.convs, disc.penultimate, disc.head]:
            shape = conv.w.shape
            fan_in = math.prod(shape[1:])
            draw = torch.randn(shape, generator=generator, dtype=torch.float32)
            conv.w.copy_(draw * math.sqrt(2.0 / fan_in))
    return model.to(resolve_device(device))


def generator_apply(model: GAN, x: torch.Tensor) -> torch.Tensor:
    """Enhance ``x`` (N, H, W, C_in) -> (N, H, W, C_out), f32."""
    return activate(model.cfg, model.gen(x))


def generator_train(model: GAN, x: torch.Tensor) -> Tuple[torch.Tensor, List[unet_lib.BNStats]]:
    """The generator in train mode (``generator_apply(train=True)``):
    ``(activated output, new running statistics)``, the statistics as
    ``UNet.forward_train`` returns them (``UNet.set_bn_stats`` commits them)."""
    y, stats = model.gen.forward_train(x)
    return activate(model.cfg, y), stats


def activate(cfg: GANConfig, y: torch.Tensor) -> torch.Tensor:
    """The generator's output activation on its f32 head output."""
    if cfg.output_activation == "tanh":
        return torch.tanh(y)
    if cfg.output_activation == "sigmoid":
        return torch.sigmoid(y)
    return y


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one axis: (low, high), the odd one high."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv_same(x: torch.Tensor, p, dtype: torch.dtype, stride: int) -> torch.Tensor:
    """SAME k4 conv + bias with ``unet._conv``'s casts, on NCHW."""
    w = p.w.to(dtype)
    k = w.shape[-1]
    (ht, hb), (wl, wr) = (_same_pads(s, k, stride) for s in x.shape[2:])
    xp = F.pad(x.to(dtype), (wl, wr, ht, hb))
    y = F.conv2d(xp, w, stride=stride)
    return y.to(torch.float32) + p.b.view(1, -1, 1, 1)


def discriminator_apply(model: GAN, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Patch logits (N, H', W', 1), f32, for the pair (input ``x``, output
    ``y``), both (N, H, W, C)."""
    dt = model.cfg.generator_config.torch_dtype
    disc = model.disc
    h = torch.movedim(torch.cat([x, y], dim=-1), -1, 1)

    def lrelu(t):
        return torch.where(t >= 0, t, 0.2 * t)

    for p in disc.convs:
        h = lrelu(_conv_same(h, p, dt, 2))
    h = lrelu(_conv_same(h, disc.penultimate, dt, 1))
    return torch.movedim(_conv_same(h, disc.head, dt, 1), 1, -1).to(torch.float32)


def fold_generator(model: GAN) -> GAN:
    """The generator's inference-mode batch norm folded into its convs
    (``unet.fold_batchnorm``); an equivalent ``gen_norm='none'`` GAN (the
    input model itself if it has none). The discriminator is shared, not
    copied."""
    if model.cfg.gen_norm != "batch":
        return model
    folded = GAN.__new__(GAN)
    nn.Module.__init__(folded)
    folded.cfg = dataclasses.replace(model.cfg, gen_norm="none")
    folded.gen = unet_lib.fold_batchnorm(model.gen)
    folded.disc = model.disc
    return folded
