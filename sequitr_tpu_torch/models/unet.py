"""2D/3D U-Net for cell segmentation (port of ``sequitr_tpu.models.unet``).

Same topology and numerics as the JAX package: two SAME 3x3 (3x3x3) convs
(+ eval batch norm) + ReLU per level, 2x2 (2x2x2) VALID max-pool down, a
kernel-2 stride-2 transposed conv up, concat in ``[skip, up]`` order, a 1x1
head, and the optional space-to-depth wrapper (2D only).

Numerics follow ``unet.py``'s rounding points: inputs and weights are cast
to ``cfg.compute_dtype``, the conv emits that dtype (cuDNN accumulates in
f32), and the bias is added after the upcast to f32; batch norm, ReLU,
max-pool and the concat run in f32.

Training: ``UNet.forward_train`` is ``unet.apply(train=True)``: batch norm
normalizes with the batch's biased variance and returns each layer's new
running statistics (``m * old + (1 - m) * batch``, the same biased
variance) instead of writing them, so a recomputed forward
(``torch.utils.checkpoint``) cannot update them twice; ``set_bn_stats``
commits them. Parameters are built with ``requires_grad=False`` (serving);
a trainer turns them on. ``init`` is the JAX package's He init.

Layout: ``UNet.forward`` takes and returns NHWC (NDHWC for ``dims=3``) like
``unet.apply``; inside, the channels-last tensor is viewed as NCHW (NCDHW)
with channels_last (channels_last_3d) strides, no copy, the layout cuDNN
prefers. Weights live in torch layouts: convs (c_out, c_in, k...), the
transposed conv (c_in, c_out, k...) — the stored HWIO (DHWIO) kernel
transposed with no spatial flip (``models.convert``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from sequitr_tpu_torch.utils import f32_entry, resolve_device

__all__ = [
    "UNetConfig", "UNet", "conv", "block_shards", "up_block_shards", "fold_batchnorm", "init",
    "param_count",
]

BNStats = Tuple[torch.Tensor, torch.Tensor]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        for name, dt in _DTYPES.items():
            if dt == dtype:
                return name
    name = str(getattr(dtype, "name", dtype))
    if name not in _DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_DTYPES)}, got {dtype!r}")
    return name


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    """U-Net architecture configuration (``sequitr_tpu.models.unet.UNetConfig``).

    ``compute_dtype`` is stored as its name, ``"bfloat16"`` or ``"float32"``
    (the strings model ``config.json`` files carry); a ``torch.dtype`` is
    accepted and converted.
    """

    in_channels: int = 1
    num_classes: int = 3
    depth: int = 4  # encoder levels incl. bottleneck (depth-1 poolings)
    base_features: int = 32
    features_cap: int = 512
    dims: int = 2
    norm: str = "batch"  # "batch" | "none"
    upsample: str = "transpose"  # "transpose" | "resize"
    compute_dtype: str = "bfloat16"
    bn_momentum: float = 0.9
    bn_eps: float = 1e-5
    # space-to-depth factor (2D only): the net runs at (H/s, W/s) with
    # s^2 x input channels and an s^2 x num_classes head rearranged back
    space_to_depth: int = 1

    def __post_init__(self):
        object.__setattr__(self, "compute_dtype", _dtype_name(self.compute_dtype))

    def features(self, level: int) -> int:
        return min(self.base_features * (2**level), self.features_cap)

    @property
    def min_input_multiple(self) -> int:
        """Spatial size must be divisible by this (pool factor x s2d)."""
        return self.space_to_depth * 2 ** (self.depth - 1)

    @property
    def torch_dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]


def channels_last(t: torch.Tensor) -> torch.Tensor:
    """``t`` in the channels-last memory format of its rank (4-D or 5-D)."""
    fmt = torch.channels_last if t.ndim == 4 else torch.channels_last_3d
    return t.contiguous(memory_format=fmt)


class _Conv(nn.Module):
    """Conv weights in torch layout plus a bias (``w``/``b``, as the flat keys)."""

    def __init__(self, k: int, c_in: int, c_out: int, transpose: bool, device, dims: int = 2):
        super().__init__()
        shape = ((c_in, c_out) if transpose else (c_out, c_in)) + (k,) * dims
        self.transpose = transpose
        # channels-last weights make cuDNN keep activations channels-last end
        # to end (an NCHW weight leads it to transpose every input and output)
        w = channels_last(torch.zeros(shape, device=device))
        self.w = nn.Parameter(w, requires_grad=False)
        self.b = nn.Parameter(torch.zeros(c_out, device=device), requires_grad=False)


class _BatchNorm(nn.Module):
    """Inference-mode batch norm: learned scale/bias, running mean/var buffers."""

    def __init__(self, c: int, device):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c, device=device), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(c, device=device), requires_grad=False)
        self.register_buffer("mean", torch.zeros(c, device=device))
        self.register_buffer("var", torch.ones(c, device=device))

    def forward(self, x: torch.Tensor, eps: float) -> torch.Tensor:
        def ch(t):
            return t.view((1, -1) + (1,) * (x.ndim - 2))

        inv = torch.rsqrt(self.var + eps)
        return (x.to(torch.float32) - ch(self.mean)) * ch(inv) * ch(self.scale) + ch(self.bias)

    def forward_train(self, x: torch.Tensor, eps: float, momentum: float):
        """Batch statistics over all but the channel axis (biased variance,
        as ``jnp.var``); returns ``(y, (new_mean, new_var))`` with the
        running statistics moved ``momentum`` of the way to the old ones."""

        def ch(t):
            return t.view((1, -1) + (1,) * (x.ndim - 2))

        x32 = x.to(torch.float32)
        var, mean = torch.var_mean(x32, dim=[0] + list(range(2, x.ndim)), correction=0)
        with torch.no_grad():
            stats = (
                momentum * self.mean + (1 - momentum) * mean,
                momentum * self.var + (1 - momentum) * var,
            )
        inv = torch.rsqrt(var + eps)
        return (x32 - ch(mean)) * ch(inv) * ch(self.scale) + ch(self.bias), stats


class _Block(nn.Module):
    """conv -> norm -> relu, twice."""

    def __init__(self, c_in: int, c_out: int, norm: str, device, dims: int = 2):
        super().__init__()
        self.conv1 = _Conv(3, c_in, c_out, False, device, dims)
        self.conv2 = _Conv(3, c_out, c_out, False, device, dims)
        if norm == "batch":
            self.bn1 = _BatchNorm(c_out, device)
            self.bn2 = _BatchNorm(c_out, device)


def conv(
    cfg: UNetConfig,
    x: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    transpose: bool = False,
    padding: Optional[Tuple[int, ...]] = None,
) -> torch.Tensor:
    """One U-Net conv on NC[D]HW ``x`` at ``unet.py``'s rounding points:
    input and weights in ``cfg.compute_dtype``, the conv's output in that
    dtype, the bias added in f32. A transposed conv is kernel 2, stride 2;
    any other is SAME (``padding`` overrides it: the halo convs of
    ``block_shards`` pad only the unsharded axes)."""
    dt = cfg.torch_dtype
    w = w.to(dt)
    three = cfg.dims == 3
    if transpose:
        conv_t = F.conv_transpose3d if three else F.conv_transpose2d
        y = conv_t(x.to(dt), w, stride=2)
    else:
        conv_fn = F.conv3d if three else F.conv2d
        y = conv_fn(x.to(dt), w, padding=w.shape[-1] // 2 if padding is None else padding)
    return y.to(torch.float32) + b.view((1, -1) + (1,) * cfg.dims)


# The forward over a grid of NC[D]HW shards, x[i][j] = batch slice i, axis-0
# slice j (each on its device), layer by layer, every shard of a layer before
# the next layer: the halo-exchanged forwards of ``parallel.spatial`` and the
# middle levels of the polyphase training forward on a mesh. ``wt(t,
# device)`` is the weight ``t`` on a shard's device; ``norm(grid, bn)`` the
# train-mode batch norm of the whole grid (None: no norm layers).


def _neighbor_rows(row: List[torch.Tensor], j: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(last row of shard j-1, first row of shard j+1) on shard j's device;
    the edge shards get zero rows, reproducing SAME zero padding globally.
    The sharded axis is dim 2."""
    x = row[j]
    zero = torch.zeros_like(x[:, :, :1])
    top = row[j - 1][:, :, -1:].to(x.device) if j > 0 else zero
    bot = row[j + 1][:, :, :1].to(x.device) if j < len(row) - 1 else zero
    return top, bot


def _conv3x3_halo(cfg: UNetConfig, row: List[torch.Tensor], j: int, w, b) -> torch.Tensor:
    """SAME 3^dims conv of shard j: the sharded axis padded with the
    neighbours' rows (VALID there), SAME (1, 1) on the rest. A row of one
    shard is the plain SAME conv."""
    if len(row) == 1:
        return conv(cfg, row[0], w, b)
    top, bot = _neighbor_rows(row, j)
    padded = channels_last(torch.cat([top, row[j], bot], dim=2))
    return conv(cfg, padded, w, b, padding=(0,) + (1,) * (cfg.dims - 1))


def block_shards(cfg: UNetConfig, x, blk, wt, norm=None):
    """``UNet._block`` over a grid: conv -> [norm] -> relu, twice, every
    conv with its halo exchange."""
    for i in (1, 2):
        c = getattr(blk, f"conv{i}")
        x = [
            [_conv3x3_halo(cfg, row, j, wt(c.w, t.device), wt(c.b, t.device)) for j, t in enumerate(row)]
            for row in x
        ]
        if norm is not None:
            x = norm(x, getattr(blk, f"bn{i}"))
        x = [[torch.relu(t) for t in row] for row in x]
    return x


def up_block_shards(cfg: UNetConfig, x, skip, up, blk, wt, norm=None):
    """A decoder level over a grid: each shard's transposed up-conv (kernel
    2, stride 2: rows map to rows, no halo), the concat after its skip
    shard, then ``block_shards``."""
    x = [
        [torch.cat([s, conv(cfg, t, wt(up.w, t.device), wt(up.b, t.device), transpose=True).to(s.dtype)], dim=1)
         for s, t in zip(srow, row)]
        for srow, row in zip(skip, x)
    ]
    del skip  # the concat holds it: free the grid before the block
    return block_shards(cfg, x, blk, wt, norm)


def _space_to_depth(x: torch.Tensor, s: int) -> torch.Tensor:
    """(N, C, H, W) -> (N, s*s*C, H/s, W/s), channel index (sy*s + sx)*C + c
    — the channel order of the JAX package's NHWC ``_space_to_depth``."""
    n, c, h, w = x.shape
    x = x.reshape(n, c, h // s, s, w // s, s)
    return x.permute(0, 3, 5, 1, 2, 4).reshape(n, s * s * c, h // s, w // s)


def _depth_to_space(x: torch.Tensor, s: int) -> torch.Tensor:
    """(N, s*s*C, h, w) -> (N, C, h*s, w*s) — inverse of ``_space_to_depth``."""
    n, cs, h, w = x.shape
    c = cs // (s * s)
    x = x.reshape(n, s, s, c, h, w)
    return x.permute(0, 3, 4, 1, 5, 2).reshape(n, c, h * s, w * s)


class UNet(nn.Module):
    """The U-Net of ``cfg``. ``forward``: (N, *spatial, C_in) -> f32 logits
    (N, *spatial, num_classes), spatial (H, W) or (Z, H, W) by ``cfg.dims``,
    each divisible by ``cfg.min_input_multiple``.

    Parameters start at zero; ``models.convert.load_flat`` loads trained
    ones.
    """

    def __init__(self, cfg: UNetConfig, device: Union[str, torch.device, None] = None):
        super().__init__()
        if cfg.space_to_depth > 1 and cfg.dims != 2:
            raise ValueError("space_to_depth is 2D-only")
        if cfg.upsample not in ("transpose", "resize"):
            raise ValueError(f"unknown upsample {cfg.upsample!r}")
        device = resolve_device(device)
        self.cfg = cfg
        s2d, dims = cfg.space_to_depth, cfg.dims
        self.enc = nn.ModuleList()
        self.dec = nn.ModuleList()
        self.up = nn.ModuleList()
        c_prev = cfg.in_channels * s2d * s2d
        for lvl in range(cfg.depth):
            c = cfg.features(lvl)
            self.enc.append(_Block(c_prev, c, cfg.norm, device, dims))
            c_prev = c
        for lvl in reversed(range(cfg.depth - 1)):
            c_skip = cfg.features(lvl)
            if cfg.upsample == "transpose":
                self.up.append(_Conv(2, c_prev, c_skip, True, device, dims))
            else:
                self.up.append(_Conv(1, c_prev, c_skip, False, device, dims))
            self.dec.append(_Block(c_skip * 2, c_skip, cfg.norm, device, dims))
            c_prev = c_skip
        self.head = _Conv(1, c_prev, cfg.num_classes * s2d * s2d, False, device, dims)

    def _conv(self, x: torch.Tensor, p: _Conv) -> torch.Tensor:
        return conv(self.cfg, x, p.w, p.b, p.transpose)

    def _block(
        self, x: torch.Tensor, blk: _Block, stats: Optional[List[BNStats]] = None
    ) -> torch.Tensor:
        """conv -> norm -> relu, twice; with ``stats`` (a list) the norms
        run in train mode and append their new running statistics."""
        for i in (1, 2):
            x = self._conv(x, getattr(blk, f"conv{i}"))
            if self.cfg.norm == "batch":
                bn = getattr(blk, f"bn{i}")
                if stats is None:
                    x = bn(x, self.cfg.bn_eps)
                else:
                    x, new = bn.forward_train(x, self.cfg.bn_eps, self.cfg.bn_momentum)
                    stats.append(new)
            x = torch.relu(x)
        return x

    def _upsample(self, x: torch.Tensor, p: _Conv) -> torch.Tensor:
        if self.cfg.upsample == "transpose":
            return self._conv(x, p)
        # nearest 2x resize (index i -> i // 2, as jax.image.resize) + 1x1 conv
        return self._conv(F.interpolate(x.to(torch.float32), scale_factor=2), p)

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        return F.max_pool3d(x, 2) if self.cfg.dims == 3 else F.max_pool2d(x, 2)

    @f32_entry
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._forward(x, None)

    @f32_entry
    def forward_train(self, x: torch.Tensor) -> Tuple[torch.Tensor, List[BNStats]]:
        """``unet.apply(train=True)``: ``(logits, new running statistics)``,
        one ``(mean, var)`` pair per batch norm in ``bn_layers`` order; the
        module's own statistics are left as they are (``set_bn_stats``)."""
        stats: List[BNStats] = []
        return self._forward(x, stats), stats

    def bn_layers(self) -> List[_BatchNorm]:
        """The batch norms in the order ``forward_train`` visits them."""
        return [m for m in self.modules() if isinstance(m, _BatchNorm)]

    @torch.no_grad()
    def set_bn_stats(self, stats: List[BNStats]) -> None:
        layers = self.bn_layers()
        if len(layers) != len(stats):
            raise ValueError(f"{len(stats)} statistics for {len(layers)} batch norms")
        if not layers:  # norm "none": nothing to commit
            return
        torch._foreach_copy_(
            [t for bn in layers for t in (bn.mean, bn.var)], [t for pair in stats for t in pair]
        )

    def _forward(self, x: torch.Tensor, stats: Optional[List[BNStats]]) -> torch.Tensor:
        cfg = self.cfg
        for d in x.shape[1:-1]:
            if d % cfg.min_input_multiple:
                raise ValueError(
                    f"spatial dim {d} not divisible by {cfg.min_input_multiple}"
                )
        # NHWC -> NCHW (NDHWC -> NCDHW) view with channels-last strides
        x = torch.movedim(x, -1, 1)
        s2d = cfg.space_to_depth
        if s2d > 1:
            x = _space_to_depth(x, s2d)
        skips = []
        for lvl in range(cfg.depth):
            if lvl > 0:
                x = self._pool(x)
            x = self._block(x, self.enc[lvl], stats)
            if lvl < cfg.depth - 1:
                skips.append(x)
        for i, lvl in enumerate(reversed(range(cfg.depth - 1))):
            skip = skips[lvl]
            x = self._upsample(x, self.up[i])
            x = torch.cat([skip, x.to(skip.dtype)], dim=1)
            x = self._block(x, self.dec[i], stats)
        logits = self._conv(x, self.head)
        if s2d > 1:
            logits = _depth_to_space(logits, s2d)
        return torch.movedim(logits, 1, -1).to(torch.float32)


def param_count(model: nn.Module) -> int:
    """The number of trained values: parameters, not the batch norms'
    running statistics (buffers), as ``unet.param_count`` counts the params
    pytree."""
    return sum(p.numel() for p in model.parameters())


def fold_batchnorm(model: UNet) -> UNet:
    """Inference-mode batch norm folded into the preceding convs, in f32.

    BN(conv(x; w, b)) == conv(x; w*g, (b-mean)*g + beta) with
    g = scale / sqrt(var + eps) over the output channels. Returns an
    equivalent ``norm='none'`` U-Net (the input model itself if it has no
    batch norm). The JAX package refolds inside every call; the port folds
    once, when a model is loaded.
    """
    cfg = model.cfg
    if cfg.norm != "batch":
        return model
    device = next(model.parameters()).device
    folded = UNet(dataclasses.replace(cfg, norm="none"), device=device)
    with torch.no_grad():
        for src_blocks, dst_blocks in ((model.enc, folded.enc), (model.dec, folded.dec)):
            for src, dst in zip(src_blocks, dst_blocks):
                for i in (1, 2):
                    conv, bn = getattr(src, f"conv{i}"), getattr(src, f"bn{i}")
                    g = bn.scale * torch.rsqrt(bn.var + cfg.bn_eps)
                    out = getattr(dst, f"conv{i}")
                    out.w.copy_(conv.w * g.view((-1,) + (1,) * (conv.w.ndim - 1)))
                    out.b.copy_((conv.b - bn.mean) * g + bn.bias)
        folded.up.load_state_dict(model.up.state_dict())
        folded.head.load_state_dict(model.head.state_dict())
    return folded


def init(
    cfg: UNetConfig,
    generator: Optional[torch.Generator] = None,
    device: Union[str, torch.device, None] = None,
) -> UNet:
    """A ``UNet`` of ``cfg`` with the JAX package's initialisation
    (``unet.init``): every kernel He-normal, ``N(0, 1) * sqrt(2 / fan_in)``
    with ``fan_in = k**dims * c_in``, biases zero, batch norm scale 1,
    bias 0, running mean 0 and variance 1. Draws come from ``generator``
    on the CPU, kernel by kernel in module order; the same seed gives the
    same weights on every device (the values differ from ``jax.random``'s)."""
    device = resolve_device(device)
    model = UNet(cfg, device="cpu")
    with torch.no_grad():
        for conv in model.modules():
            if isinstance(conv, _Conv):
                shape = conv.w.shape
                fan_in = math.prod(shape[2:]) * (shape[0] if conv.transpose else shape[1])
                draw = torch.randn(shape, generator=generator, dtype=torch.float32)
                conv.w.copy_(draw * math.sqrt(2.0 / fan_in))
    return model.to(device)
