"""Plain float32 CPnet (Cellpose) from the flat weight file.

``CPnet`` of ``cellpose/resnet_torch.py`` (github.com/MouseLand/cellpose;
Stringer et al., Nature Methods 18:100-106, 2021), rebuilt from
``torch.nn`` modules in its own structure: ``batchconv`` (BatchNorm2d ->
ReLU -> Conv2d), ``batchconv0`` (BatchNorm2d -> Conv2d), ``resdown``,
``resup`` with ``batchconvstyle`` (a ``Linear`` of the style added to the
input, broadcast over space), ``make_style`` (global average, L2
normalised), MaxPool2d(2) down, Upsample(nearest, x2) up, the skip added
(Cellpose's default, ``concatenation=False``), residual and style on. The
weights come from the flat npz the benchmark hands the program too: convs
``<path>/conv/w`` (HWIO) and ``/b``, batch norms ``<path>/bn/scale``,
``/bias`` and ``state/<path>/bn/mean``, ``/var``, style maps
``<path>/full/w`` ((in, out)) and ``/b``; ``<path>`` is
``down/<n>/{proj,conv0..conv3}``, ``up/<n>/{proj,conv0..conv3}`` (``up/<n>``
is Cellpose's ``upsample.up[n]``) and ``output``. Batch norm runs in eval
mode. Every op is float32 with TF32 off.

Departures from Cellpose: none in the forward; the ``diam_mean`` and
``diam_labels`` parameters (used only to rescale images) are not held.

``fp8=True`` is the control: every conv's input and weights are rounded to
float8 e4m3 with a per-tensor scale (amax to 448) before the float32 conv,
the precision step below the bfloat16 the configuration serves in.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.unet import float32_exact

__all__ = ["CPnet", "load", "head"]

E4M3_MAX = 448.0


def _fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.abs().amax().clamp_min(1e-30)
    s = E4M3_MAX / amax
    return (t * s).to(torch.float8_e4m3fn).to(torch.float32) / s


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (SAME padding) that rounds its input and weights to
    float8 e4m3 when ``fp8`` is set."""

    fp8 = False

    def forward(self, x):
        if not self.fp8:
            return super().forward(x)
        return F.conv2d(_fp8(x), _fp8(self.weight), self.bias, padding=self.padding)


def batchconv(cin: int, cout: int, sz: int) -> nn.Sequential:
    return nn.Sequential(nn.BatchNorm2d(cin, eps=1e-5), nn.ReLU(),
                         Conv2d(cin, cout, sz, padding=sz // 2))


def batchconv0(cin: int, cout: int, sz: int) -> nn.Sequential:
    return nn.Sequential(nn.BatchNorm2d(cin, eps=1e-5), Conv2d(cin, cout, sz, padding=sz // 2))


class resdown(nn.Module):
    def __init__(self, cin: int, cout: int, sz: int):
        super().__init__()
        self.conv = nn.Sequential(*[batchconv(cin if t == 0 else cout, cout, sz) for t in range(4)])
        self.proj = batchconv0(cin, cout, 1)

    def forward(self, x):
        x = self.proj(x) + self.conv[1](self.conv[0](x))
        return x + self.conv[3](self.conv[2](x))


class batchconvstyle(nn.Module):
    def __init__(self, cin: int, cout: int, style_channels: int, sz: int):
        super().__init__()
        self.conv = batchconv(cin, cout, sz)
        self.full = nn.Linear(style_channels, cout)

    def forward(self, style, x, y=None):
        if y is not None:
            x = x + y
        feat = self.full(style)
        return self.conv(x + feat.unsqueeze(-1).unsqueeze(-1))


class resup(nn.Module):
    def __init__(self, cin: int, cout: int, style_channels: int, sz: int):
        super().__init__()
        self.conv = nn.Sequential(
            batchconv(cin, cout, sz),
            batchconvstyle(cout, cout, style_channels, sz),
            batchconvstyle(cout, cout, style_channels, sz),
            batchconvstyle(cout, cout, style_channels, sz),
        )
        self.proj = batchconv0(cin, cout, 1)

    def forward(self, x, y, style):
        x = self.proj(x) + self.conv[1](style, self.conv[0](x), y=y)
        return x + self.conv[3](style, self.conv[2](style, x))


def make_style(x0: torch.Tensor) -> torch.Tensor:
    style = F.avg_pool2d(x0, kernel_size=(x0.shape[-2], x0.shape[-1])).flatten(1)
    return style / torch.sum(style ** 2, dim=1, keepdim=True) ** 0.5


class CPnet(nn.Module):
    """``forward(x)``: (N, nbase[0], H, W) float32 -> ((N, nout, H, W), style)."""

    def __init__(self, nbase: Sequence[int], nout: int, sz: int):
        super().__init__()
        nbase = list(nbase)
        self.down = nn.ModuleList(resdown(nbase[n], nbase[n + 1], sz) for n in range(len(nbase) - 1))
        self.maxpool = nn.MaxPool2d(2, 2)
        nbaseup = nbase[1:] + [nbase[-1]]
        self.up = nn.ModuleList(resup(nbaseup[n], nbaseup[n - 1], nbaseup[-1], sz)
                                for n in range(1, len(nbaseup)))
        self.upsampling = nn.Upsample(scale_factor=2, mode="nearest")
        self.output = batchconv(nbaseup[0], nout, 1)

    def set_fp8(self, on: bool) -> None:
        for m in self.modules():
            if isinstance(m, Conv2d):
                m.fp8 = on

    def forward(self, x):
        xd = []
        for n, block in enumerate(self.down):
            xd.append(block(self.maxpool(xd[n - 1]) if n else x))
        style = make_style(xd[-1])
        x = self.up[-1](xd[-1], xd[-1], style)
        for n in range(len(self.up) - 2, -1, -1):
            x = self.up[n](self.upsampling(x), xd[n], style)
        return self.output(x), style


def _set_bn(bn: nn.BatchNorm2d, f32: Dict[str, np.ndarray], path: str) -> None:
    bn.weight.copy_(torch.from_numpy(f32[f"{path}/bn/scale"]))
    bn.bias.copy_(torch.from_numpy(f32[f"{path}/bn/bias"]))
    bn.running_mean.copy_(torch.from_numpy(f32[f"state/{path}/bn/mean"]))
    bn.running_var.copy_(torch.from_numpy(f32[f"state/{path}/bn/var"]))


def _set_conv(conv: nn.Conv2d, f32: Dict[str, np.ndarray], path: str) -> None:
    w = f32[f"{path}/conv/w"]  # HWIO -> OIHW
    conv.weight.copy_(torch.from_numpy(np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))))
    conv.bias.copy_(torch.from_numpy(f32[f"{path}/conv/b"]))


def _set_seq(seq: nn.Sequential, f32, path: str) -> None:
    """A ``batchconv`` ([BN, ReLU, conv]) or ``batchconv0`` ([BN, conv])."""
    _set_bn(seq[0], f32, path)
    _set_conv(seq[-1], f32, path)


def load(flat: Dict[str, np.ndarray], model: Dict, device) -> CPnet:
    """The CPnet of a configuration's ``model`` block (``nbase``, ``nout``,
    ``sz``) with the flat weights, in eval mode, on ``device``."""
    f32 = {k: np.asarray(v, np.float32) for k, v in flat.items()}
    net = CPnet(model["nbase"], int(model["nout"]), int(model["sz"]))
    with torch.no_grad():
        for kind, blocks in (("down", net.down), ("up", net.up)):
            for n, blk in enumerate(blocks):
                base = f"{kind}/{n}"
                _set_seq(blk.proj, f32, f"{base}/proj")
                for t, m in enumerate(blk.conv):
                    path = f"{base}/conv{t}"
                    if isinstance(m, batchconvstyle):
                        _set_seq(m.conv, f32, path)
                        m.full.weight.copy_(torch.from_numpy(f32[f"{path}/full/w"].T.copy()))
                        m.full.bias.copy_(torch.from_numpy(f32[f"{path}/full/b"]))
                    else:
                        _set_seq(m, f32, path)
        _set_seq(net.output, f32, "output")
    return net.eval().to(device)


def head(net: CPnet, x: torch.Tensor, fp8: bool = False) -> torch.Tensor:
    """(N, nout, H, W) float32 head of (N, nbase[0], H, W) tiles, with
    ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` False (``fp8``: the control)."""
    net.set_fp8(fp8)
    try:
        with torch.no_grad(), float32_exact():
            return net(x)[0]
    finally:
        net.set_fp8(False)
