"""A configuration's weights: a trained net embedded in the published widths.

The published U-Net comes without weights, and weights drawn at random label
a cell frame with pixel noise: a label boundary at a fifth to a third of the
pixels, against 0.6% for a trained net, which the deflate writer compresses
5 to 18 times slower than a trained net's labels, by an amount that changes
with the draw. So the served network computes a trained net's labels at the
published widths. The trained net (the configuration's ``weights.embed``,
checked by its sha256, its batch norm folded here in float32) takes the
first channels of each layer at its level; a published level deeper than
the trained net's deepest passes that level's features through by identity
3^d convs; every other channel gets He-normal weights (``std = sqrt(2 /
fan_in)``, the initialization of Ronneberger et al. 2015; ``sqrt(1 /
C_in)`` for the transposed convs and the head, which no ReLU follows) and
biases of std ``BIAS_STD``, drawn from the run's seed on the device in one
call. Those channels read every channel, and no channel that the labels
depend on reads them: the labels are the trained net's, and every conv runs
at the published width on non-zero data.

The weights are cut into the flat npz layout (``enc/<l>/conv<i>/w`` HWIO or
DHWIO, ``up/<i>/w``, ``head/w``; float16) that the job server loads and the
plain reference reads: both sides read the one file.
"""

from __future__ import annotations

import hashlib
import math
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

__all__ = ["BIAS_STD", "layout", "make_flat", "fold", "trained"]

BIAS_STD = 0.05


def _feat(model: Dict, level: int) -> int:
    return min(int(model["base_features"]) * 2 ** level, int(model["features_cap"]))


def layout(model: Dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """``(key, shape, std)`` of every array of a configuration's ``model``
    block without batch norm, in the order they are drawn."""
    d = int(model["dims"])
    k3, k2 = (3,) * d, (2,) * d
    out = []

    def block(prefix: str, c_in: int, c: int) -> None:
        for i, ci in ((1, c_in), (2, c)):
            out.append((f"{prefix}/conv{i}/w", k3 + (ci, c), math.sqrt(2.0 / (3 ** d * ci))))
            out.append((f"{prefix}/conv{i}/b", (c,), BIAS_STD))

    depth = int(model["depth"])
    c_prev = int(model["in_channels"])
    for lvl in range(depth):
        block(f"enc/{lvl}", c_prev, _feat(model, lvl))
        c_prev = _feat(model, lvl)
    for i, lvl in enumerate(reversed(range(depth - 1))):
        c = _feat(model, lvl)
        out.append((f"up/{i}/w", k2 + (c_prev, c), math.sqrt(1.0 / c_prev)))
        out.append((f"up/{i}/b", (c,), BIAS_STD))
        block(f"dec/{i}", 2 * c, c)
        c_prev = c
    k = int(model["num_classes"])
    out.append(("head/w", (1,) * d + (c_prev, k), math.sqrt(1.0 / c_prev)))
    out.append(("head/b", (k,), BIAS_STD))
    return out


def fold(flat: Dict[str, np.ndarray], model: Dict) -> Dict[str, np.ndarray]:
    """Float32 weights with batch norm folded into each conv (``w * g``,
    ``(b - mean) * g + beta``, ``g = scale / sqrt(var + eps)``) and the
    batch-norm keys gone."""
    f32 = {k: np.asarray(v, np.float32) for k, v in flat.items()}
    batch_norm = model.get("norm", "batch") == "batch"
    eps = np.float32(model.get("bn_eps", 1e-5))
    out = {}
    for key, v in f32.items():
        if "/bn" in key or key.startswith("state/"):
            continue
        prefix, _, leaf = key.rpartition("/")
        block, _, conv = prefix.rpartition("/")
        if batch_norm and conv.startswith("conv") and block != "":
            bn = f"{block}/bn{conv[4:]}"
            g = f32[f"{bn}/scale"] / np.sqrt(f32[f"state/{bn}/var"] + eps)
            v = v * g if leaf == "w" else (v - f32[f"state/{bn}/mean"]) * g + f32[f"{bn}/bias"]
        out[key] = v
    return out


def trained(config: Dict, root: str) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """``(model, folded float32 weights)`` of the configuration's trained
    net, refused unless the file's sha256 is the recorded one."""
    embed = config["weights"]["embed"]
    path = os.path.join(root, embed["path"])
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != embed["sha256"]:
        raise ValueError(f"{embed['path']}: sha256 {digest} is not the configuration's "
                         f"{embed['sha256']}")
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return embed["model"], fold(flat, embed["model"])


def _identity(c: int, d: int) -> np.ndarray:
    w = np.zeros((3,) * d + (c, c), np.float32)
    w[(1,) * d + (np.arange(c), np.arange(c))] = 1.0
    return w


def make_flat(config: Dict, seed: int, device, root: str) -> Dict[str, np.ndarray]:
    """The flat float16 weights of ``seed`` for a configuration: its trained
    net embedded in its ``model``'s widths, the other channels drawn from
    the seed on ``device``. The same seed and device give the same weights."""
    model = config["model"]
    t_model, t = trained(config, root)
    d, depth, t_depth = int(model["dims"]), int(model["depth"]), int(t_model["depth"])
    if (model.get("norm", "batch") != "none" or d != int(t_model["dims"])
            or model["num_classes"] != t_model["num_classes"] or t_depth > depth
            or any(_feat(t_model, lvl) > _feat(model, lvl) for lvl in range(t_depth))):
        raise ValueError("the trained net does not fit inside the configuration's widths")
    entries = layout(model)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    total = sum(math.prod(shape) for _, shape, _ in entries)
    draw = torch.randn(total, generator=gen, device=device, dtype=torch.float32).cpu().numpy()
    flat, at = {}, 0
    for key, shape, std in entries:
        n = math.prod(shape)
        flat[key] = draw[at:at + n].reshape(shape) * np.float32(std)
        at += n

    def place(key: str, wb: Tuple[np.ndarray, np.ndarray], in_map: Sequence[int]) -> None:
        """The trained conv ``wb`` into the first outputs of ``key``,
        reading the inputs ``in_map``; nothing else reaches those outputs."""
        w, b = flat[f"{key}/w"], flat[f"{key}/b"]
        n = wb[0].shape[-1]
        w[..., :n] = 0.0
        w[..., list(in_map), :n] = wb[0]
        b[:n] = wb[1]

    def of(key: str) -> Tuple[np.ndarray, np.ndarray]:
        return t[f"{key}/w"], t[f"{key}/b"]

    for lvl in range(t_depth):
        c_in = int(model["in_channels"]) if lvl == 0 else _feat(t_model, lvl - 1)
        place(f"enc/{lvl}/conv1", of(f"enc/{lvl}/conv1"), range(c_in))
        place(f"enc/{lvl}/conv2", of(f"enc/{lvl}/conv2"), range(_feat(t_model, lvl)))
    for i, lvl in enumerate(reversed(range(depth - 1))):
        if lvl >= t_depth:
            continue
        c, ct = _feat(model, lvl), _feat(t_model, lvl)
        if lvl == t_depth - 1:  # the trained bottleneck's features, passed through
            ident = (_identity(ct, d), np.zeros(ct, np.float32))
            place(f"dec/{i}/conv1", ident, range(ct))
            place(f"dec/{i}/conv2", ident, range(ct))
        else:
            j = t_depth - 2 - lvl
            place(f"up/{i}", of(f"up/{j}"), range(_feat(t_model, lvl + 1)))
            place(f"dec/{i}/conv1", of(f"dec/{j}/conv1"), [*range(ct), *range(c, c + ct)])
            place(f"dec/{i}/conv2", of(f"dec/{j}/conv2"), range(ct))
    place("head", of("head"), range(_feat(t_model, 0)))
    return {k: v.astype(np.float16) for k, v in flat.items()}
