"""Cellpose's CPnet, the model kind ``cpnet``.

The network of Stringer, Wang, Michaelos & Pachitariu, "Cellpose: a
generalist algorithm for cellular segmentation", Nature Methods 18,
100-106 (2021): ``CPnet`` in ``cellpose/resnet_torch.py``, published at
``nbase = [2, 32, 64, 128, 256]``, ``nout = 3``, ``sz = 3``. With
``batchconv(ci, co, k)`` = BN -> ReLU -> k x k SAME conv and the
projection ``batchconv0(ci, co)`` = BN -> 1x1 conv:

* down: a ``resdown(nbase[n], nbase[n + 1])`` a level, a 2x2 max-pool
  before every level but the first:
  ``x = proj(x) + c1(c0(x)); x = x + c3(c2(x))``;
* style: the deepest map's global average over space, L2-normalised, one
  vector a tile (``style_channels = nbase[-1]``);
* up: ``resup(ci, co)`` over ``nbaseup = nbase[1:] + [nbase[-1]]``,
  deepest first with the deepest down map as its skip, a nearest x2
  upsampling before each other level:
  ``x = proj(x) + s1(c0(x) + skip); x = x + s3(s2(x))``, where
  ``s(x) = batchconv(x + Linear(style))``, the linear map's output
  broadcast over space;
* head: ``batchconv(nbase[1], nout, 1)``: (dy, dx, cell-probability logit).

``CPnet`` holds the weights as stored (flat keys ``down/<n>/conv<t>/bn/...``,
``down/<n>/conv<t>/conv/{w,b}``, ``down/<n>/proj/...``, the same under
``up/<n>/`` with ``up/<n>/conv<t>/full/{w,b}`` for t = 1..3, ``output/...``;
convs HWIO, the linear maps (in, out), running statistics under
``state/``; ``models.convert``). Its ``forward`` computes the equations
above op for op. Serving runs ``fold(model)``, a ``ServingCPnet``: every
batch norm becomes a per-channel affine (it cannot fold into the conv
after it, a ReLU lies between), each projection's batch norm folds into
its 1x1 conv exactly, the twelve style maps run as one matrix product
with the affines folded in, and the conv weights are cast once.

Numerics: convs take their input and weights in ``compute_dtype`` and emit
it (cuDNN accumulates in f32); the bias, the batch-norm affines, ReLU,
residual and style adds, max-pool, upsampling and the style vector run in
f32 (``models/unet.py``'s rounding points).

Layout: ``forward`` takes (N, H, W, C_in) and returns f32 (N, H, W, nout),
like the U-Net; inside, channels-last NCHW views. H and W must be
multiples of ``min_input_multiple``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from sequitr_tpu_torch.models import unet as unet_lib
from sequitr_tpu_torch.models.unet import _BatchNorm, _Conv, channels_last
from sequitr_tpu_torch.utils import f32_entry, resolve_device

__all__ = ["CPnetConfig", "CPnet", "ServingCPnet", "fold", "init", "param_count"]


@dataclasses.dataclass(frozen=True)
class CPnetConfig:
    """CPnet architecture configuration. ``nbase[0]`` is the input
    channels (2: cytoplasm, nucleus); ``compute_dtype`` is stored as its
    name, as ``UNetConfig`` stores it."""

    nbase: Tuple[int, ...] = (2, 32, 64, 128, 256)
    nout: int = 3
    sz: int = 3
    dims: int = 2
    compute_dtype: str = "bfloat16"
    bn_eps: float = 1e-5

    def __post_init__(self):
        object.__setattr__(self, "nbase", tuple(int(c) for c in self.nbase))
        object.__setattr__(self, "compute_dtype", unet_lib._dtype_name(self.compute_dtype))
        if self.dims != 2:
            raise ValueError(f"CPnet is 2D, got dims={self.dims}")
        if len(self.nbase) < 3:
            raise ValueError(f"nbase needs the input and at least two levels, got {self.nbase}")

    @property
    def in_channels(self) -> int:
        return self.nbase[0]

    @property
    def num_classes(self) -> int:
        """The head's channels, under the name the flows serving reads."""
        return self.nout

    @property
    def style_channels(self) -> int:
        return self.nbase[-1]

    @property
    def levels(self) -> int:
        return len(self.nbase) - 1

    @property
    def min_input_multiple(self) -> int:
        return 2 ** (self.levels - 1)

    @property
    def torch_dtype(self) -> torch.dtype:
        return unet_lib._DTYPES[self.compute_dtype]

    def up_widths(self) -> List[Tuple[int, int]]:
        """(c_in, c_out) of the ``resup`` blocks, ``up/<n>`` for n = 0..,
        shallowest first (the forward runs them deepest first)."""
        up = list(self.nbase[1:]) + [self.nbase[-1]]
        return [(up[n], up[n - 1]) for n in range(1, len(up))]


class _Linear(nn.Module):
    """``y = x @ w + b`` with ``w`` (in, out), the flat layout's."""

    def __init__(self, c_in: int, c_out: int, device):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(c_in, c_out, device=device), requires_grad=False)
        self.b = nn.Parameter(torch.zeros(c_out, device=device), requires_grad=False)


class _BatchConv(nn.Module):
    """BN -> [ReLU] -> k x k conv; ``style``: a linear map of the style
    added to the input first (``batchconvstyle``)."""

    def __init__(self, c_in: int, c_out: int, k: int, device, style: int = 0):
        super().__init__()
        self.bn = _BatchNorm(c_in, device)
        self.conv = _Conv(k, c_in, c_out, False, device)
        if style:
            self.full = _Linear(style, c_in, device)


class _Res(nn.Module):
    """``resdown`` (``style == 0``) or ``resup``: four 3x3 batchconvs and
    the 1x1 projection; in ``resup`` the last three take the style."""

    def __init__(self, c_in: int, c_out: int, sz: int, device, style: int = 0):
        super().__init__()
        self.proj = _BatchConv(c_in, c_out, 1, device)
        self.conv0 = _BatchConv(c_in, c_out, sz, device)
        for t in (1, 2, 3):
            setattr(self, f"conv{t}", _BatchConv(c_out, c_out, sz, device, style))


def _affine(bn: _BatchNorm, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference batch norm as ``x * a + c`` over channels, f32."""
    a = bn.scale * torch.rsqrt(bn.var + eps)
    return a, bn.bias - bn.mean * a


def _ch(t: torch.Tensor) -> torch.Tensor:
    """(C,) or (N, C) -> broadcastable over (N, C, H, W)."""
    return t.view(t.shape + (1, 1)) if t.ndim == 2 else t.view(1, -1, 1, 1)


def _style(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C): the global average, L2-normalised."""
    s = x.mean(dim=(2, 3))
    return s / torch.sqrt(torch.sum(s * s, dim=1, keepdim=True))


class CPnet(nn.Module):
    """CPnet of ``cfg`` with its weights as stored (zero until loaded:
    ``models.convert.load_flat``). ``forward`` returns the head;
    ``forward_with_style`` returns ``(head, style)``."""

    def __init__(self, cfg: CPnetConfig, device: Union[str, torch.device, None] = None):
        super().__init__()
        device = resolve_device(device)
        self.cfg = cfg
        nb, sz = cfg.nbase, cfg.sz
        self.down = nn.ModuleList(
            _Res(nb[n], nb[n + 1], sz, device) for n in range(cfg.levels)
        )
        self.up = nn.ModuleList(
            _Res(ci, co, sz, device, cfg.style_channels) for ci, co in cfg.up_widths()
        )
        self.output = _BatchConv(nb[1], cfg.nout, 1, device)

    def _bconv(self, x: torch.Tensor, m: _BatchConv, relu: bool = True,
               style: Optional[torch.Tensor] = None) -> torch.Tensor:
        if style is not None:
            x = x + _ch(style @ m.full.w + m.full.b)
        a, c = _affine(m.bn, self.cfg.bn_eps)
        h = x.to(torch.float32) * _ch(a) + _ch(c)
        if relu:
            h = torch.relu(h)
        return unet_lib.conv(self.cfg, h, m.conv.w, m.conv.b)

    def _res(self, x, blk: _Res, skip=None, style=None):
        y = self._bconv(x, blk.conv0)
        if skip is not None:
            y = y + skip
        x = self._bconv(x, blk.proj, relu=False) + self._bconv(y, blk.conv1, style=style)
        return x + self._bconv(self._bconv(x, blk.conv2, style=style), blk.conv3, style=style)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_with_style(x)[0]

    @f32_entry
    def forward_with_style(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        _check_spatial(self.cfg, x)
        x = torch.movedim(x, -1, 1)
        xd = []
        for n, blk in enumerate(self.down):
            xd.append(self._res(F.max_pool2d(xd[-1], 2) if n else x, blk))
        style = _style(xd[-1])
        x = self._res(xd[-1], self.up[-1], skip=xd[-1], style=style)
        for n in range(len(self.up) - 2, -1, -1):
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = self._res(x, self.up[n], skip=xd[n], style=style)
        head = self._bconv(x, self.output)
        return torch.movedim(head, 1, -1).to(torch.float32), style


def _check_spatial(cfg: CPnetConfig, x: torch.Tensor) -> None:
    for d in x.shape[1:-1]:
        if d % cfg.min_input_multiple:
            raise ValueError(f"spatial dim {d} not divisible by {cfg.min_input_multiple}")


class _Step(nn.Module):
    """One serving conv: ``conv(relu(x * a + c))`` (``a`` None: a folded
    projection, the conv alone), weights in the compute dtype, f32 bias."""

    def __init__(self, w, b, a=None, c=None):
        super().__init__()
        self.register_buffer("w", w)
        self.register_buffer("b", b.view(1, -1, 1, 1))
        self.register_buffer("a", None if a is None else _ch(a))
        self.register_buffer("c", None if c is None else _ch(c))

    def forward(self, x: torch.Tensor, shift: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.a is not None:
            c = self.c if shift is None else _ch(shift)
            x = torch.relu_(torch.addcmul(c, x, self.a))
        y = F.conv2d(x.to(self.w.dtype), self.w, padding=self.w.shape[-1] // 2)
        return torch.add(y, self.b)


class ServingCPnet(nn.Module):
    """The folded CPnet that serving runs (``fold``): the same head as
    ``CPnet.forward`` on the same weights, up to float reassociation."""

    def __init__(self, model: CPnet):
        super().__init__()
        cfg = self.cfg = model.cfg
        dt, eps = cfg.torch_dtype, cfg.bn_eps

        def step(m: _BatchConv, relu: bool = True) -> _Step:
            a, c = _affine(m.bn, eps)
            w = channels_last(m.conv.w.to(dt))
            if relu:
                return _Step(w, m.conv.b.clone(), a, c)
            # BN -> 1x1 conv folds exactly: W (x a + c) + b
            w32 = m.conv.w[:, :, 0, 0]
            return _Step(channels_last((w32 * a)[:, :, None, None].to(dt)),
                         m.conv.b + w32 @ c)

        def steps(blk: _Res) -> nn.ModuleList:
            return nn.ModuleList([step(blk.proj, False)]
                                 + [step(getattr(blk, f"conv{t}")) for t in range(4)])

        self.down = nn.ModuleList(steps(blk) for blk in model.down)
        self.up = nn.ModuleList(steps(blk) for blk in model.up)
        self.output = step(model.output)
        # the twelve style shifts c + a * (style @ w + b) as one product
        ws, bs, self.widths = [], [], []
        for blk in model.up:
            for t in (1, 2, 3):
                m = getattr(blk, f"conv{t}")
                a, c = _affine(m.bn, eps)
                ws.append(m.full.w * a)
                bs.append(c + m.full.b * a)
                self.widths.append(a.numel())
        self.register_buffer("style_w", torch.cat(ws, dim=1).contiguous())
        self.register_buffer("style_b", torch.cat(bs))

    def _res(self, x, steps, skip=None, shifts=None):
        proj, c0, c1, c2, c3 = steps
        s1, s2, s3 = shifts if shifts is not None else (None, None, None)
        y = c0(x)
        if skip is not None:
            y = y + skip
        x = proj(x) + c1(y, s1)
        return x + c3(c2(x, s2), s3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_with_style(x)[0]

    @f32_entry
    def forward_with_style(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        _check_spatial(self.cfg, x)
        x = torch.movedim(x, -1, 1)
        xd = []
        for n, steps in enumerate(self.down):
            xd.append(self._res(F.max_pool2d(xd[-1], 2) if n else x, steps))
        style = _style(xd[-1])
        shifts = torch.addmm(self.style_b, style, self.style_w).split(self.widths, dim=1)
        per_level = [shifts[3 * n:3 * n + 3] for n in range(len(self.up))]
        x = self._res(xd[-1], self.up[-1], xd[-1], per_level[-1])
        for n in range(len(self.up) - 2, -1, -1):
            x = F.interpolate(x, scale_factor=2, mode="nearest")
            x = self._res(x, self.up[n], xd[n], per_level[n])
        return torch.movedim(self.output(x), 1, -1).to(torch.float32), style


def fold(model: Union[CPnet, ServingCPnet]) -> ServingCPnet:
    """The serving form of a CPnet (a ``ServingCPnet`` is returned as it is)."""
    if isinstance(model, ServingCPnet):
        return model
    with torch.no_grad():
        return ServingCPnet(model)


def param_count(cfg: CPnetConfig) -> int:
    """Trained values of ``cfg``'s CPnet (batch-norm scales and biases
    counted, running statistics not), from the configuration alone."""

    def bconv(ci: int, co: int, k: int, style: int = 0) -> int:
        return 2 * ci + k * k * ci * co + co + (style * ci + ci if style else 0)

    def res(ci: int, co: int, style: int = 0) -> int:
        return (bconv(ci, co, 1) + bconv(ci, co, cfg.sz)
                + 3 * bconv(co, co, cfg.sz, style))

    nb = cfg.nbase
    return (sum(res(nb[n], nb[n + 1]) for n in range(cfg.levels))
            + sum(res(ci, co, cfg.style_channels) for ci, co in cfg.up_widths())
            + bconv(nb[1], cfg.nout, 1))


def init(cfg: CPnetConfig, generator: Optional[torch.Generator] = None,
         device: Union[str, torch.device, None] = None) -> CPnet:
    """A CPnet with PyTorch's default initialisation of ``Conv2d`` and
    ``Linear`` (uniform in +-1/sqrt(fan_in), weights and biases), batch
    norm at scale 1, bias 0, mean 0, variance 1; drawn from ``generator``
    on the CPU in module order."""
    model = CPnet(cfg, device="cpu")
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (_Conv, _Linear)):
                fan_in = m.w[0].numel() if isinstance(m, _Conv) else m.w.shape[0]
                bound = fan_in ** -0.5
                for p in (m.w, m.b):
                    p.copy_((torch.rand(p.shape, generator=generator) * 2 - 1) * bound)
    return model.to(resolve_device(device))
