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

from sequitr_tpu_torch.models import convert as convert_lib
from sequitr_tpu_torch.models.unet import UNet, UNetConfig

__all__ = ["fixture_dir", "names", "load", "manifest"]

_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "sequitr_tpu", "fixtures"
)

# model kinds whose config is a UNetConfig (regression heads included)
UNET_KINDS = ("unet", "n2v", "flows", "stars")


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
) -> Tuple[str, UNetConfig, UNet, Dict[str, Any]]:
    """Load a committed fixture: ``(kind, cfg, model, meta)``.

    ``compute_dtype`` ("bfloat16" / "float32") overrides the stored one.
    Weights load as f32 either way; the dtype only sets the casts inside
    the forward. The model is returned unfolded (``unet.fold_batchnorm``).
    """
    meta = manifest().get(name)
    if meta is None:
        raise KeyError(f"unknown fixture {name!r}; available: {names()}")
    kind = meta["kind"]
    if kind not in UNET_KINDS:
        raise NotImplementedError(
            f"fixture {name!r} is a {kind!r} model: only U-Net kinds are "
            "ported so far (the GAN is a later slice of the port)"
        )
    cfg = UNetConfig(**meta["config"])
    if compute_dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    with np.load(os.path.join(fixture_dir(), f"{name}.npz")) as npz:
        flat = {k: npz[k] for k in npz.files}
    return kind, cfg, convert_lib.load_flat(cfg, flat, device=device), meta
