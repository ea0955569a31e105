"""The committed trained-checkpoint fixtures, read with numpy.

The checkpoints live in the JAX package's data directory,
``sequitr_tpu/fixtures/<name>.npz`` with ``manifest.json`` beside them
(float16 weights, f32 batch-norm statistics, in the flat interchange layout
of ``models.convert``). They are read here by path, as data: nothing of the
JAX package is imported.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Tuple, Union

import numpy as np
import torch

import torch.nn as nn

from sequitr_tpu_torch.models import convert as convert_lib
from sequitr_tpu_torch.models.gan import GANConfig
from sequitr_tpu_torch.models.unet import UNetConfig

__all__ = ["fixture_dir", "names", "load", "manifest"]

_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "sequitr_tpu", "fixtures"
)

# model kinds whose config is a UNetConfig (regression heads included)
UNET_KINDS = ("unet", "n2v", "flows", "stars")
KINDS = UNET_KINDS + ("gan",)


def config_class(kind: str):
    """The configuration class of a model kind; KeyError for an unknown one."""
    if kind == "gan":
        return GANConfig
    if kind in UNET_KINDS:
        return UNetConfig
    raise KeyError(f"unknown model kind {kind!r}; known: {list(KINDS)}")


def fixture_dir() -> str:
    return os.path.abspath(_DIR)


def manifest() -> Dict[str, Any]:
    path = os.path.join(fixture_dir(), "manifest.json")
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def names():
    return sorted(manifest())


def load(
    name: str,
    compute_dtype=None,
    device: Union[str, torch.device, None] = None,
) -> Tuple[str, Any, nn.Module, Dict[str, Any]]:
    """Load a committed fixture: ``(kind, cfg, model, meta)``.

    ``cfg`` is a ``UNetConfig`` (a ``GANConfig`` for kind ``gan``) and
    ``model`` its ``UNet`` (``GAN``). ``compute_dtype`` ("bfloat16" /
    "float32") overrides the stored one. Weights load as f32 either way;
    the dtype only sets the casts inside the forward. The model is returned
    unfolded (``unet.fold_batchnorm``, ``gan.fold_generator``).
    """
    meta = manifest().get(name)
    if meta is None:
        raise KeyError(f"unknown fixture {name!r}; available: {names()}")
    kind = meta["kind"]
    cfg = config_class(kind)(**meta["config"])
    if compute_dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    with np.load(os.path.join(fixture_dir(), f"{name}.npz")) as npz:
        flat = {k: npz[k] for k in npz.files}
    return kind, cfg, convert_lib.load_flat(cfg, flat, device=device), meta
