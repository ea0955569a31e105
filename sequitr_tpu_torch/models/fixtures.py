"""Trained-checkpoint fixtures: the committed ones read with numpy, new
ones written in the same layout.

The committed checkpoints live in the JAX package's data directory,
``sequitr_tpu/fixtures/<name>.npz`` with ``manifest.json`` beside them
(float16 weights, f32 batch-norm statistics, in the flat interchange layout
of ``models.convert``). They are read here by path, as data: nothing of the
JAX package is imported. ``load``, ``manifest`` and ``names`` read another
directory of the same layout when given one; ``save`` writes one, and never
the committed directory (``python -m sequitr_tpu_torch.tools.make_fixtures``
trains the fixtures into a directory of its own).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch

import torch.nn as nn

from sequitr_tpu_torch.models import convert as convert_lib
from sequitr_tpu_torch.models.cpnet import CPnetConfig
from sequitr_tpu_torch.models.gan import GANConfig
from sequitr_tpu_torch.models.unet import UNetConfig

__all__ = ["fixture_dir", "names", "load", "save", "manifest"]

_DIR = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "..", "..", "sequitr_tpu", "fixtures"
)

# model kinds whose config is a UNetConfig (regression heads included)
UNET_KINDS = ("unet", "n2v", "flows", "stars")
KINDS = UNET_KINDS + ("gan", "cpnet")


def config_class(kind: str):
    """The configuration class of a model kind; KeyError for an unknown one."""
    if kind == "gan":
        return GANConfig
    if kind == "cpnet":
        return CPnetConfig
    if kind in UNET_KINDS:
        return UNetConfig
    raise KeyError(f"unknown model kind {kind!r}; known: {list(KINDS)}")


def fixture_dir() -> str:
    """The committed fixtures' directory."""
    return os.path.abspath(_DIR)


def _manifest_path(directory: Optional[str]) -> str:
    return os.path.join(directory or fixture_dir(), "manifest.json")


def manifest(directory: Optional[str] = None) -> Dict[str, Any]:
    """The manifest of ``directory`` (default the committed fixtures'); {}
    where it has none."""
    path = _manifest_path(directory)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return json.load(f)


def names(directory: Optional[str] = None):
    return sorted(manifest(directory))


def load(
    name: str,
    compute_dtype=None,
    device: Union[str, torch.device, None] = None,
    directory: Optional[str] = None,
) -> Tuple[str, Any, nn.Module, Dict[str, Any]]:
    """Load a fixture: ``(kind, cfg, model, meta)``, from ``directory``
    (default the committed fixtures').

    ``cfg`` is a ``UNetConfig`` (a ``GANConfig`` for kind ``gan``) and
    ``model`` its ``UNet`` (``GAN``). ``compute_dtype`` ("bfloat16" /
    "float32") overrides the stored one. Weights load as f32 either way;
    the dtype only sets the casts inside the forward. The model is returned
    unfolded (``unet.fold_batchnorm``, ``gan.fold_generator``).
    """
    meta = manifest(directory).get(name)
    if meta is None:
        raise KeyError(f"unknown fixture {name!r}; available: {names(directory)}")
    kind = meta["kind"]
    cfg = config_class(kind)(**meta["config"])
    if compute_dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    with np.load(os.path.join(directory or fixture_dir(), f"{name}.npz")) as npz:
        flat = {k: npz[k] for k in npz.files}
    return kind, cfg, convert_lib.load_flat(cfg, flat, device=device), meta


def save(
    name: str, kind: str, cfg, model: nn.Module, meta: Dict[str, Any], directory: str
) -> str:
    """Write ``model`` as fixture ``name`` of ``kind`` into ``directory``:
    ``<name>.npz`` (``np.savez_compressed``) and its ``manifest.json``
    entry ``{"kind", "config", **meta}``, the JAX package's layout
    (``sequitr_tpu/models/fixtures.py::save``) key for key.

    The parameters are stored float16 under their flat paths, kernels HWIO;
    the batch-norm running statistics stay f32 under ``state/`` (running
    variances span ~1e-4..1e4 and the normalizer divides by them, so a
    float16 cast there could visibly move outputs). The arrays are written
    in the order of the JAX package's pytree flattening, parameters first.

    Unlike the JAX ``save``, which writes only the committed directory,
    ``directory`` is required and may not be the committed fixtures'
    directory: those are the reference's files, which the port never
    overwrites. Returns the npz path.
    """
    directory = os.path.abspath(directory)
    if os.path.realpath(directory) == os.path.realpath(fixture_dir()):
        raise ValueError(
            f"refusing to write into the committed fixtures' directory {fixture_dir()}; "
            "give save another directory"
        )
    os.makedirs(directory, exist_ok=True)
    arrays = {
        k: v if k.startswith("state/") else v.astype(np.float16)
        for k, v in convert_lib.to_flat(model).items()
    }
    path = os.path.join(directory, f"{name}.npz")
    np.savez_compressed(path, **arrays)
    # the configs keep compute_dtype as its name already
    data = manifest(directory)
    data[name] = {"kind": kind, "config": dataclasses.asdict(cfg), **meta}
    tmp = _manifest_path(directory) + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=2, sort_keys=True)
    os.replace(tmp, _manifest_path(directory))
    return path
