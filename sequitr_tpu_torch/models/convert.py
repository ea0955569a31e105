"""Weight interchange: the flat npz layout <-> ``UNet`` and ``GAN`` modules.

The interchange format is the JAX package's (``sequitr_tpu.models.convert``):
a flat dict of numpy arrays keyed by the parameter path joined with '/'
(``enc/0/conv1/w``, ``dec/1/bn2/scale``, ``up/0/w``, ``head/b``; a GAN's
under ``gen/`` and ``disc/``), conv kernels in HWIO (``(kh, kw, c_in,
c_out)``; DHWIO for 3D; the transposed conv's too), and batch-norm running
statistics under a ``state/`` prefix (``state/enc/0/bn1/mean``,
``state/gen/enc/0/bn1/mean``). It is what the JAX ``flatten_params`` gives,
what the committed fixtures store and what ``python -m sequitr_tpu
export-model`` writes; here ``to_flat`` writes it and ``load_flat`` reads
it, and ``flatten_params`` / ``unflatten_like`` / ``load_npz_weights`` are
the JAX names over the parameters alone.

The path names are the module's own state-dict names with '/' for '.';
only the kernels change layout: a conv's HWIO (DHWIO) kernel becomes
torch's (c_out, c_in, k...), the transposed conv's becomes (c_in, c_out,
k...) with no spatial flip (``sequitr_tpu/models/torch_reference.py``
documents both maps in 2D; 3D adds the depth axis in front).

``from_layout`` reads a flat npz exported from TF or torch whose kernels
keep their source layout (``import-model --layout tf|torch``): the JAX
package's three kernel maps, copied, on the same keys.
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, Mapping, Optional, Union

import numpy as np
import torch
import torch.nn as nn

from sequitr_tpu_torch.models.gan import GAN, GANConfig
from sequitr_tpu_torch.models.unet import UNet, UNetConfig
from sequitr_tpu_torch.utils import resolve_device

__all__ = [
    "build", "load_flat", "to_flat", "flatten_params", "unflatten_like", "load_npz_weights", "nest_flat", "load_train_state", "conv_to_torch",
    "conv_from_torch", "pack_conv3x3", "tf_transpose_kernel_to_jax", "torch_kernel_to_jax",
    "torch_transpose_kernel_to_jax", "from_layout", "LAYOUTS",
]

_STATE = "state/"
_BUFFERS = ("mean", "var")

# HWIO / DHWIO -> torch layout, per kernel rank and kind
_CONV_AXES = (3, 2, 0, 1)  # (kh, kw, ci, co) -> (co, ci, kh, kw)
_CONVT_AXES = (2, 3, 0, 1)  # (kh, kw, ci, co) -> (ci, co, kh, kw)
_CONV3D_AXES = (4, 3, 0, 1, 2)  # (kd, kh, kw, ci, co) -> (co, ci, kd, kh, kw)
_CONVT3D_AXES = (3, 4, 0, 1, 2)  # (kd, kh, kw, ci, co) -> (ci, co, kd, kh, kw)
_AXES = {
    (4, False): _CONV_AXES, (4, True): _CONVT_AXES,
    (5, False): _CONV3D_AXES, (5, True): _CONVT3D_AXES,
}


def conv_to_torch(w_hwio: np.ndarray) -> torch.Tensor:
    """A conv's HWIO kernel ``(kh, kw, c_in, c_out)`` as torch's OIHW tensor."""
    return torch.tensor(np.transpose(np.asarray(w_hwio), _CONV_AXES))


def conv_from_torch(w: torch.Tensor) -> np.ndarray:
    """The inverse of ``conv_to_torch``: an OIHW tensor as an HWIO array."""
    arr = w.detach().cpu().numpy()
    return np.ascontiguousarray(np.transpose(arr, _inverse(_CONV_AXES)))


def pack_conv3x3(
    w_hwio: np.ndarray,
    b: np.ndarray,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device, None] = None,
):
    """HWIO ``(3, 3, C_in, C_out)`` weights and ``(C_out,)`` bias as the 3x3
    conv kernels take them (``ops.kernels.conv3x3.pack_weights``):
    ``(9*C_in, C_out)`` in ``dtype`` and an f32 bias, on ``device``."""
    from sequitr_tpu_torch.ops.kernels import conv3x3

    device = resolve_device(device)
    w = torch.tensor(np.asarray(w_hwio, dtype=np.float32), device=device)
    bias = torch.tensor(np.asarray(b, dtype=np.float32), device=device)
    return conv3x3.pack_weights(w, bias, dtype)


def tf_transpose_kernel_to_jax(w: np.ndarray) -> np.ndarray:
    """TF conv*_transpose kernel [k..., c_out, c_in] -> HWIO [k..., c_in, c_out]."""
    axes = list(range(w.ndim))
    axes[-2], axes[-1] = axes[-1], axes[-2]
    return np.transpose(w, axes)


def torch_kernel_to_jax(w: np.ndarray) -> np.ndarray:
    """torch conv kernel [c_out, c_in, k...] -> HWIO [k..., c_in, c_out]."""
    nd = w.ndim
    return np.transpose(w, tuple(range(2, nd)) + (1, 0))


def torch_transpose_kernel_to_jax(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose kernel [c_in, c_out, k...] -> HWIO [k..., c_in, c_out]."""
    nd = w.ndim
    return np.transpose(w, tuple(range(2, nd)) + (0, 1))


LAYOUTS = ("jax", "tf", "torch")


def from_layout(flat: Mapping[str, np.ndarray], layout: str) -> Dict[str, np.ndarray]:
    """A flat dict whose kernels are in ``layout``'s form as the canonical
    flat dict (HWIO kernels), the JAX CLI's ``import-model --layout`` maps:
    ``tf`` transposes the transposed-conv kernels (``/up/`` keys); ``torch``
    those and every other ``*/w`` of 4 or more dimensions; ``jax`` changes
    nothing. ``state/`` entries pass through."""
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}: use one of {LAYOUTS}")
    out = {}
    for key, w in flat.items():
        kernel = (
            layout != "jax" and not key.startswith(_STATE)
            and key.endswith("/w") and np.ndim(w) >= 4
        )
        if kernel and "/up/" in f"/{key}/":
            w = (tf_transpose_kernel_to_jax if layout == "tf" else torch_transpose_kernel_to_jax)(w)
        elif kernel and layout == "torch":
            w = torch_kernel_to_jax(w)
        out[key] = w
    return out


def _flat_key(sd_key: str) -> str:
    key = sd_key.replace(".", "/")
    return _STATE + key if key.rsplit("/", 1)[-1] in _BUFFERS else key


def _axes(model: nn.Module, sd_key: str, ndim: int):
    if ndim not in (4, 5) or not sd_key.endswith(".w"):
        return None
    conv = model.get_submodule(sd_key[: -len(".w")])
    return _AXES[ndim, conv.transpose]


def _inverse(axes):
    return tuple(int(i) for i in np.argsort(axes))


def build(cfg: Union[UNetConfig, GANConfig], device=None) -> nn.Module:
    """The zero-initialised module of ``cfg``: a ``UNet`` or a ``GAN``."""
    return GAN(cfg, device=device) if isinstance(cfg, GANConfig) else UNet(cfg, device=device)


def load_flat(
    cfg: Union[UNetConfig, GANConfig],
    flat: Mapping[str, np.ndarray],
    device: Union[str, torch.device, None] = None,
) -> nn.Module:
    """Build the ``UNet`` (or ``GAN``) of ``cfg`` from the flat interchange dict.

    Every parameter and buffer must be present with its shape (float16
    storage is read as f32); raises ValueError listing what is missing or
    mismatched. Extra keys are ignored, as ``unflatten_like`` does.
    """
    model = build(cfg, device="cpu")
    sd = model.state_dict()
    new_sd: Dict[str, torch.Tensor] = {}
    problems = []
    for key, ref in sd.items():
        name = _flat_key(key)
        if name not in flat:
            problems.append(f"missing: {name}")
            continue
        arr = np.asarray(flat[name], dtype=np.float32)
        axes = _axes(model, key, arr.ndim)
        if axes is not None:
            arr = np.transpose(arr, axes)
        if tuple(arr.shape) != tuple(ref.shape):
            problems.append(
                f"shape mismatch at {name}: got {np.asarray(flat[name]).shape}"
            )
            continue
        new_sd[key] = torch.tensor(arr)
    if problems:
        raise ValueError("weight conversion failed:\n  " + "\n  ".join(problems))
    model.load_state_dict(new_sd)
    return model.to(resolve_device(device))


def _tree_key(name: str):
    """The place of a flat path in the JAX package's pytree flattening:
    dict keys in sorted order, list items by index."""
    return tuple((0, int(p), "") if p.isdigit() else (1, 0, p) for p in name.split("/"))


def to_flat(model: nn.Module) -> Dict[str, np.ndarray]:
    """The inverse of ``load_flat``: {flat/path: f32 numpy array}, the
    parameters then the ``state/`` statistics, each in the order the JAX
    package flattens its pytrees."""
    flat = {}
    for key, t in model.state_dict().items():
        arr = t.detach().to("cpu", torch.float32).numpy()
        axes = _axes(model, key, arr.ndim)
        if axes is not None:
            arr = np.transpose(arr, _inverse(axes))
        flat[_flat_key(key)] = np.ascontiguousarray(arr)
    params = sorted((k for k in flat if not k.startswith(_STATE)), key=_tree_key)
    state = sorted((k for k in flat if k.startswith(_STATE)), key=_tree_key)
    return {k: flat[k] for k in params + state}


def flatten_params(model: nn.Module) -> Dict[str, np.ndarray]:
    """The parameters alone as the flat dict (``sequitr_tpu.models.convert.
    flatten_params`` of the JAX params pytree): f32, kernels HWIO, no
    ``state/`` statistics."""
    return {k: v for k, v in to_flat(model).items() if not k.startswith(_STATE)}


def unflatten_like(model: nn.Module, flat: Mapping[str, np.ndarray]) -> nn.Module:
    """A copy of ``model`` with its parameters taken from the flat dict
    (kernels HWIO; a parameter keeps its dtype); the batch-norm statistics
    stay the model's (``load_flat`` reads both). Every parameter must be
    present with its shape: raises ValueError listing each missing or
    mis-shaped name. Extra keys are ignored. ``model`` is left as it was."""
    out = copy.deepcopy(model)
    problems = []
    with torch.no_grad():
        # in the JAX pytree's order, so the problems are listed as it lists them
        for key, p in sorted(out.named_parameters(), key=lambda kv: _tree_key(_flat_key(kv[0]))):
            name = _flat_key(key)
            axes = _axes(out, key, p.ndim)
            want = tuple(p.shape) if axes is None else tuple(p.shape[i] for i in _inverse(axes))
            if name not in flat:
                problems.append(f"missing: {name} {want}")
                continue
            arr = np.asarray(flat[name])
            if arr.shape != want:
                problems.append(f"shape mismatch at {name}: got {arr.shape}, want {want}")
                continue
            if axes is not None:
                arr = np.transpose(arr, axes)
            p.copy_(torch.as_tensor(np.ascontiguousarray(arr)).to(p.dtype))
    if problems:
        raise ValueError("weight conversion failed:\n  " + "\n  ".join(problems))
    return out


def load_npz_weights(
    npz_path: str,
    model: nn.Module,
    name_map: Optional[Callable[[str], Optional[str]]] = None,
    kernel_map: Optional[Callable[[str, np.ndarray], np.ndarray]] = None,
) -> nn.Module:
    """Load a flat npz of reference weights into a copy of ``model``'s
    parameters (``unflatten_like``). ``name_map``: external name ->
    canonical path (None drops the entry), identity by default.
    ``kernel_map(path, array)``: a transform of each entry on its canonical
    path, the array still in the npz's layout (e.g.
    ``tf_transpose_kernel_to_jax`` on ``up/*`` kernels); what it returns is
    read as canonical (HWIO kernels)."""
    flat: Dict[str, np.ndarray] = {}
    with np.load(npz_path) as raw:
        for name in raw.files:
            target = name_map(name) if name_map else name
            if target is None:
                continue
            arr = raw[name]
            if kernel_map is not None:
                arr = kernel_map(target, arr)
            flat[target] = arr
    return unflatten_like(model, flat)


def nest_flat(flat: Mapping[str, np.ndarray]):
    """The flat interchange dict as the JAX package's nested pytrees:
    ``(params, state)``, '/'-paths split into dicts, numeric components
    into lists (``enc/0/conv1/w`` -> ``params["enc"][0]["conv1"]["w"]``),
    arrays as stored (HWIO kernels); ``state/`` keys go to ``state``."""

    def insert(tree: dict, parts, value):
        for part in parts[:-1]:
            tree = tree.setdefault(part, {})
        tree[parts[-1]] = value

    def listify(tree):
        if not isinstance(tree, dict):
            return tree
        out = {k: listify(v) for k, v in tree.items()}
        if out and all(k.isdigit() for k in out):
            return [out[str(i)] for i in range(len(out))]
        return out

    params: dict = {}
    state: dict = {}
    for key, value in flat.items():
        if key.startswith(_STATE):
            insert(state, key[len(_STATE):].split("/"), np.asarray(value))
        else:
            insert(params, key.split("/"), np.asarray(value))
    return listify(params), listify(state)


_OPT = "opt/"


def load_train_state(cfg: UNetConfig, tc, flat: Mapping[str, np.ndarray], device=None):
    """A ``pipeline.train.TrainState`` from a JAX ``TrainState`` carried
    across in the flat layout: the parameters and ``state/`` statistics as
    ``load_flat`` takes them, Adam's moments under ``opt/mu/<path>`` and
    ``opt/nu/<path>`` (the parameter's path and layout) and the update count
    as ``opt/count``; the step as ``opt/step`` (default ``opt/count``).
    Without ``opt/`` keys the optimizer starts fresh, as ``create_unet_state``
    does; a ``MultiSteps`` window always starts empty. ``tc``: the
    ``TrainConfig`` whose optimizer resumes."""
    from sequitr_tpu_torch.pipeline import train as train_lib

    device = resolve_device(device)
    model = load_flat(cfg, flat, device=device)
    state = train_lib.create_unet_state(cfg, tc, model=model)
    if _OPT + "count" not in flat:
        return state
    from sequitr_tpu_torch.pipeline import optim

    names = [k for k, _ in model.named_parameters()]
    params = list(model.parameters())
    problems = []
    for which, flat_moment in (("mu", state.opt_state.mu), ("nu", state.opt_state.nu)):
        for key, dst in zip(names, optim.unflatten(flat_moment, params)):
            name = f"{_OPT}{which}/{_flat_key(key)}"
            if name not in flat:
                problems.append(f"missing: {name}")
                continue
            arr = np.asarray(flat[name], dtype=np.float32)
            axes = _axes(model, key, arr.ndim)
            if axes is not None:
                arr = np.transpose(arr, axes)
            if tuple(arr.shape) != tuple(dst.shape):
                problems.append(f"shape mismatch at {name}: got {np.asarray(flat[name]).shape}")
                continue
            with torch.no_grad():
                dst.copy_(torch.tensor(arr))
    if problems:
        raise ValueError("optimizer state conversion failed:\n  " + "\n  ".join(problems))
    state.opt_state.count = int(np.asarray(flat[_OPT + "count"]))
    state.step = int(np.asarray(flat.get(_OPT + "step", flat[_OPT + "count"])))
    return state
