"""Plain float32 U-Net (2D and 3D) from the flat weight file.

The architecture of sequitr's U-Net (Ronneberger et al. 2015; Cicek et al.
2016 for 3D): two SAME 3^d convs, each with inference batch norm and ReLU, a
level; 2^d max-pool down; a kernel-2 stride-2 transposed conv up; the skip
concatenated before the upsampled map; a 1x1 head. Weights come from the
flat npz (``enc/<l>/conv1/w`` HWIO or DHWIO, ``state/.../mean``), batch norm
is folded into its conv here, in float32: ``w * g`` and ``(b - mean) * g +
beta`` with ``g = scale / sqrt(var + eps)``. Every op is float32 with TF32
off.

``fp8=True`` is the control: each conv's input and weights are rounded to
float8 e4m3 with a per-tensor scale (amax to 448) before the float32 conv,
the precision step below the bfloat16 the configuration serves in.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["Weights", "load_weights", "forward", "float32_exact"]

E4M3_MAX = 448.0


class Weights:
    """Folded float32 weights on one device, in torch's conv layouts."""

    def __init__(self, model: Dict, enc: List, dec: List, up: List, head: Tuple):
        self.model = model
        self.enc, self.dec, self.up, self.head = enc, dec, up, head


def _conv_w(w: np.ndarray) -> torch.Tensor:
    d = w.ndim - 2  # HWIO / DHWIO -> (out, in, k...)
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w, (d + 1, d) + tuple(range(d)))))


def _up_w(w: np.ndarray) -> torch.Tensor:
    d = w.ndim - 2  # HWIO / DHWIO -> (in, out, k...), no spatial flip
    return torch.from_numpy(np.ascontiguousarray(np.transpose(w, (d, d + 1) + tuple(range(d)))))


def load_weights(flat: Dict[str, np.ndarray], model: Dict, device) -> Weights:
    """Fold and place the flat weights of a configuration's ``model``."""
    f32 = {k: np.asarray(v, np.float32) for k, v in flat.items()}
    eps = float(model.get("bn_eps", 1e-5))
    batch_norm = model.get("norm", "batch") == "batch"

    def block(prefix: str):
        convs = []
        for i in (1, 2):
            w = _conv_w(f32[f"{prefix}/conv{i}/w"])
            b = torch.from_numpy(f32[f"{prefix}/conv{i}/b"])
            if batch_norm:
                mean = torch.from_numpy(f32[f"state/{prefix}/bn{i}/mean"])
                var = torch.from_numpy(f32[f"state/{prefix}/bn{i}/var"])
                g = torch.from_numpy(f32[f"{prefix}/bn{i}/scale"]) / torch.sqrt(var + eps)
                w = w * g.view((-1,) + (1,) * (w.ndim - 1))
                b = (b - mean) * g + torch.from_numpy(f32[f"{prefix}/bn{i}/bias"])
            convs.append((w.to(device), b.to(device)))
        return convs

    depth = int(model["depth"])
    enc = [block(f"enc/{lvl}") for lvl in range(depth)]
    dec = [block(f"dec/{i}") for i in range(depth - 1)]
    up = [
        (_up_w(f32[f"up/{i}/w"]).to(device), torch.from_numpy(f32[f"up/{i}/b"]).to(device))
        for i in range(depth - 1)
    ]
    head = (_conv_w(f32["head/w"]).to(device), torch.from_numpy(f32["head/b"]).to(device))
    return Weights(model, enc, dec, up, head)


@contextlib.contextmanager
def float32_exact():
    """TF32 off for cuDNN and matmuls inside the block."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def _fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.abs().amax().clamp_min(1e-30)
    s = E4M3_MAX / amax
    return (t * s).to(torch.float8_e4m3fn).to(torch.float32) / s


def _conv(x, wb, fp8: bool, transpose: bool = False):
    w, b = wb
    if fp8:
        x, w = _fp8(x), _fp8(w)
    d = x.ndim - 2
    if transpose:
        y = (F.conv_transpose3d if d == 3 else F.conv_transpose2d)(x, w, stride=2)
    else:
        y = (F.conv3d if d == 3 else F.conv2d)(x, w, padding=w.shape[-1] // 2)
    return y + b.view((1, -1) + (1,) * d)


def forward(wts: Weights, x: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    """(N, C_in, *spatial) float32 -> (N, num_classes, *spatial) logits."""
    d = x.ndim - 2
    pool = F.max_pool3d if d == 3 else F.max_pool2d
    skips = []
    for lvl, blk in enumerate(wts.enc):
        if lvl:
            x = pool(x, 2)
        for wb in blk:
            x = torch.relu(_conv(x, wb, fp8))
        skips.append(x)
    skips.pop()
    for blk, upw in zip(wts.dec, wts.up):
        x = torch.cat([skips.pop(), _conv(x, upw, fp8, transpose=True)], dim=1)
        for wb in blk:
            x = torch.relu(_conv(x, wb, fp8))
    return _conv(x, wts.head, fp8)
