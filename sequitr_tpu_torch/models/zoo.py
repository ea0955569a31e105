"""Named model presets (port of ``sequitr_tpu.models.zoo``).

The same 14 names and fields as the JAX package's table, copied here so the
port imports nothing of it; ``compute_dtype`` is the port's string
``"bfloat16"``. ``get(name)`` returns a ready config; ``create(name,
generator, device)`` also builds the model through ``unet.init`` /
``gan.init``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import torch

from sequitr_tpu_torch.models import gan as gan_lib
from sequitr_tpu_torch.models import unet

__all__ = ["PRESETS", "get", "create", "names"]


def _unet(**kw) -> unet.UNetConfig:
    base: Dict[str, Any] = dict(
        in_channels=1, num_classes=3, depth=4, base_features=32,
        norm="batch", compute_dtype="bfloat16",
    )
    base.update(kw)
    return unet.UNetConfig(**base)


PRESETS: Dict[str, Any] = {
    # binary, 3-class and 5-class cell segmentation
    "unet2d_binary": _unet(num_classes=2),
    "unet2d_3class": _unet(num_classes=3),
    "unet2d_5class": _unet(num_classes=5),
    # volumetric segmentation over z-stacks (shallower)
    "unet3d_binary": _unet(num_classes=2, dims=3, depth=3, features_cap=256),
    "unet3d_3class": _unet(num_classes=3, dims=3, depth=3, features_cap=256),
    # the pix2pix enhancement GAN
    "gan_enhance": gan_lib.GANConfig(compute_dtype="bfloat16"),
    # space-to-depth x2 / x4 input with doubled base width: trained as
    # their own models
    "unet2d_3class_fast": _unet(num_classes=3, space_to_depth=2, base_features=64),
    "unet2d_binary_fast": _unet(num_classes=2, space_to_depth=2, base_features=64),
    "unet2d_3class_fast4": _unet(num_classes=3, space_to_depth=4, base_features=64),
    "unet2d_binary_fast4": _unet(num_classes=2, space_to_depth=4, base_features=64),
    # Noise2Void regression U-Net (num_classes = output channels, raw head)
    "n2v_denoise": _unet(num_classes=1, depth=3, features_cap=256),
    "n2v_denoise_fast": _unet(
        num_classes=1, depth=3, features_cap=256, space_to_depth=2, base_features=64,
    ),
    # flow-field instances: (dy, dx) x FLOW_SCALE + a probability logit
    "flows_cells": _unet(num_classes=3),
    # star-convex instances: a probability logit + 32 ray distances
    "stars_cells": _unet(num_classes=33),
}


def names():
    return sorted(PRESETS)


def get(name: str):
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; available: {names()}")
    return PRESETS[name]


def create(
    name: str,
    generator: Optional[torch.Generator] = None,
    device: Union[str, torch.device, None] = None,
) -> Tuple[Any, torch.nn.Module]:
    """``(config, model)`` of a named preset, initialised from ``generator``
    on ``device`` (the card unless the caller asks for the CPU)."""
    cfg = get(name)
    if isinstance(cfg, gan_lib.GANConfig):
        return cfg, gan_lib.init(cfg, generator, device)
    return cfg, unet.init(cfg, generator, device)
