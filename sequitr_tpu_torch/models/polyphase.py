"""Polyphase serving forward: the exact space-to-depth reformulation.

Port of the serving half of ``sequitr_tpu/models/polyphase.py``, 2D and
volumetric. The two
thin full-resolution levels of the U-Net (``enc0`` and ``dec0``) run at half
resolution with four times the channels, on the SAME weights rearranged,
exactly up to float reassociation:

* a stride-1 3x3 conv on (2H, 2W, C) == a 3x3 conv on the (H, W, 4C)
  space-to-depth phase tensor with a structured-zero rearranged kernel
  (tap dy contributes to block offset s where dy = 2s + p - a);
* the 2x2-stride-2 up-conv == ONE 1x1 phase conv (no tap overlap);
* 2x2 max-pool == max over the 4 phase groups (no spatial op);
* the 1x1 head == a 1x1 conv per phase;
* bias and ReLU are per-channel elementwise, phase channels are relabeled
  pixels;
* the skip connection stays in the phase domain: the serving graph never
  materializes a full-resolution intermediate.

The dense phase conv spends 4x the multiply-adds of the thin conv (9 of
every 36 tap/phase-pair slots are nonzero), traded against wider channels.
``studies/polyphase_conv.py`` measures the trade on the card.

Volumes (``Polyphase3d``, ``apply3d``) use the phase factor (1, 2, 2): z is
never phased. The 3x3x3 convs are rearranged on their (H, W) taps, z taps
pass through; the 2x2x2 pool is the max over the 4 (H, W) phase groups,
then a stride-2 max over z; the 2x2x2 up-conv is two 1x1x1 phase maps,
one per output z parity, interleaved along z.

In the port's idiom: ``Polyphase`` / ``Polyphase3d`` are modules built once
from a folded ``UNet``; the phase kernels are rearranged when it is built,
not per call. ``apply(model, x)`` / ``apply3d(model, x)`` reuse the module
built for ``model``. Inside, tensors are NCHW (NCDHW) with channels-last
strides and phase-channel order ``(p*2 + q)*C + c``
(``unet._space_to_depth``); casts and roundings sit where ``UNet._conv``
has them, so the up-conv and the head round their output to the compute
dtype where the JAX package's einsums keep f32.

Training (``apply_train``, ``apply3d_train``) takes an unfolded model with
batch norm and builds the phase kernels from its live parameters on each
call, inside autograd; it returns ``(logits, statistics)`` as
``UNet.forward_train`` does, and its up-conv and head keep their f32
products unrounded, as the JAX package's training einsums do.
``apply_train_shards`` runs the same forward over batch shards on several
devices in lockstep, its batch norms over every shard
(``parallel.spatial_train``'s data-parallel step).
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from sequitr_tpu_torch.models import unet as unet_lib
from sequitr_tpu_torch.models.unet import BNStats, UNet, UNetConfig
from sequitr_tpu_torch.utils import derived, f32_entry, ieee_f32

__all__ = [
    "eligible", "eligible3d", "phase_kernel", "phase_up_kernel",
    "phase_kernel3d", "phase_up_kernel3d", "Polyphase", "Polyphase3d",
    "serving", "apply", "apply_train", "apply3d", "apply3d_train", "apply_train_shards",
]


def eligible(cfg: UNetConfig, spatial: Tuple[int, ...]) -> bool:
    """True when the polyphase forward covers this serving config: 2D, no
    model-level space-to-depth, transposed-conv upsampling, folded or absent
    norm, and even spatial dims (phase factor 2)."""
    return (
        cfg.dims == 2
        and cfg.depth >= 2  # level 0's pool/up/skip/dec structure
        and cfg.space_to_depth == 1
        and cfg.upsample == "transpose"
        and cfg.norm == "none"
        and all(s % 2 == 0 for s in spatial)
    )


def eligible3d(cfg: UNetConfig, spatial: Tuple[int, ...]) -> bool:
    """True when the volumetric polyphase forward covers this serving
    config: 3D, transposed-conv upsampling, folded or absent norm, even H
    and W (z is never phased). ``spatial`` is (Z, H, W), or () to judge
    the model alone."""
    return (
        cfg.dims == 3
        and cfg.depth >= 2
        and cfg.upsample == "transpose"
        and cfg.norm == "none"
        and len(spatial) in (0, 3)
        and all(s % 2 == 0 for s in spatial[1:])
    )


def _phase_tap_index() -> torch.Tensor:
    """(4, 4, 3, 3) source tap of each slot of the phase kernel: slot
    (a*2 + b, p*2 + q, sy + 1, sx + 1) takes tap (dy + 1)*3 + (dx + 1) with
    dy = 2*sy + p - a, dx = 2*sx + q - b, or 9 (a zero) when the tap falls
    outside the 3x3 kernel."""
    idx = torch.full((4, 4, 3, 3), 9, dtype=torch.long)
    for sy in (-1, 0, 1):
        for sx in (-1, 0, 1):
            for p in (0, 1):
                for q in (0, 1):
                    for a in (0, 1):
                        for b in (0, 1):
                            dy = 2 * sy + p - a
                            dx = 2 * sx + q - b
                            if dy in (-1, 0, 1) and dx in (-1, 0, 1):
                                idx[a * 2 + b, p * 2 + q, sy + 1, sx + 1] = (dy + 1) * 3 + dx + 1
    return idx


_TAP_INDEX = {}


def _tap_index(device: torch.device) -> torch.Tensor:
    """``_phase_tap_index`` flattened, on ``device``, made there once: a
    copy from pageable host memory on every call would wait for the card's
    queue. Made outside inference mode whoever asks first, so the training
    forward can save it for its backward."""
    idx = _TAP_INDEX.get(device)
    if idx is None:
        with torch.inference_mode(False):
            idx = _TAP_INDEX.setdefault(device, _phase_tap_index().reshape(-1).to(device))
    return idx


def _phase_taps(w: torch.Tensor, c_out: int, c_in: int) -> torch.Tensor:
    """The (H, W) phase rearrangement of a kernel whose last two axes are
    the 3x3 (H, W) taps: (C_out, C_in, *lead, 3, 3) -> (4C_out, 4C_in,
    *lead, 3, 3), leading tap axes (z) passed through.

    One gather of the taps (and a zero) into the 144 nonzero slots, so it is
    differentiable: the training forward builds its phase kernels from the
    live weights with it, and gradients flow back to them.
    """
    lead = tuple(w.shape[2:-2])
    taps = w.reshape((c_out, c_in) + lead + (9,))
    taps = torch.cat([taps, taps.new_zeros(taps.shape[:-1] + (1,))], dim=-1)
    g = taps[..., _tap_index(w.device)]
    g = g.reshape((c_out, c_in) + lead + (4, 4, 3, 3))
    k = len(lead)
    # (C_out, C_in, *lead, ab, pq, 3, 3) -> (ab, C_out, pq, C_in, *lead, 3, 3)
    g = g.permute((2 + k, 0, 3 + k, 1) + tuple(range(2, 2 + k)) + (4 + k, 5 + k))
    return g.reshape((4 * c_out, 4 * c_in) + lead + (3, 3))


def phase_kernel(w: torch.Tensor) -> torch.Tensor:
    """(C_out, C_in, 3, 3) stride-1 kernel -> (4C_out, 4C_in, 3, 3).

    The OIHW image of the JAX package's HWIO ``phase_kernel``: input phase
    blocks ``(p*2 + q)*C_in + c`` on axis 1, output phase blocks
    ``(a*2 + b)*C_out + o`` on axis 0, block offsets (sy, sx) on the taps.
    """
    if tuple(w.shape[2:]) != (3, 3):
        raise ValueError(f"phase_kernel expects a 3x3 kernel, got {tuple(w.shape)}")
    return _phase_taps(w, *w.shape[:2])


def phase_kernel3d(w: torch.Tensor) -> torch.Tensor:
    """(C_out, C_in, 3, 3, 3) -> (4C_out, 4C_in, 3, 3, 3): the 2D phase
    rearrangement on the (H, W) taps, z taps passed through (the OIDHW
    image of the JAX package's DHWIO ``phase_kernel3d``)."""
    if tuple(w.shape[2:]) != (3, 3, 3):
        raise ValueError(f"phase_kernel3d expects a 3x3x3 kernel, got {tuple(w.shape)}")
    return _phase_taps(w, *w.shape[:2])


def phase_up_kernel(w: torch.Tensor) -> torch.Tensor:
    """(C_in, C_out, 2, 2) stride-2 transposed-conv kernel -> the 1x1 conv
    weight (4C_out, C_in, 1, 1): kernel-2 stride-2 has no tap overlap, so
    output phase (a, b) is the 1x1 map ``w[:, :, a, b]``."""
    if tuple(w.shape[2:]) != (2, 2):
        raise ValueError(f"phase_up_kernel expects a 2x2 kernel, got {tuple(w.shape)}")
    c_in, c_out = w.shape[:2]
    return w.permute(2, 3, 1, 0).reshape(4 * c_out, c_in, 1, 1)


def phase_up_kernel3d(w: torch.Tensor) -> torch.Tensor:
    """(C_in, C_out, 2, 2, 2) stride-2 transposed-conv kernel -> ONE 1x1x1
    conv weight (8C_out, C_in, 1, 1, 1): output z parity ``az`` and (H, W)
    phase (a, b) is the 1x1x1 map ``w[:, :, az, a, b]``, at channel block
    ``az*4 + a*2 + b`` (the JAX package's two per-parity maps, stacked)."""
    if tuple(w.shape[2:]) != (2, 2, 2):
        raise ValueError(f"phase_up_kernel3d expects a 2x2x2 kernel, got {tuple(w.shape)}")
    c_in, c_out = w.shape[:2]
    return w.permute(2, 3, 4, 1, 0).reshape(8 * c_out, c_in, 1, 1, 1)


_channels_last = unet_lib.channels_last


class Polyphase(nn.Module):
    """Serving forward equal to ``model(x)`` with level 0 — both thin
    full-resolution blocks, the pool, the up-conv, the skip and the head —
    in the phase domain. ``forward``: (N, H, W, C_in), H and W even and
    divisible by the model's pooling multiple -> f32 logits (N, H, W, K).

    Built from a folded 2D transpose-upsample ``UNet`` (``eligible``);
    raises ValueError otherwise. The rearranged level-0 weights are buffers
    of this module; the middle levels are the model's own.
    """

    def __init__(self, model: UNet):
        super().__init__()
        cfg = model.cfg
        if not eligible(cfg, ()):
            raise ValueError(
                "polyphase requires a folded 2D transpose-upsample model "
                f"without model-level space_to_depth; got {cfg}"
            )
        self.net = model
        enc0, dec0 = model.enc[0], model.dec[-1]
        with torch.no_grad():
            for name, conv in (
                ("enc1", enc0.conv1), ("enc2", enc0.conv2),
                ("dec1", dec0.conv1), ("dec2", dec0.conv2),
            ):
                self.register_buffer(f"{name}_w", _channels_last(phase_kernel(conv.w)))
                self.register_buffer(f"{name}_b", conv.b.repeat(4))
            self.register_buffer("up_w", _channels_last(phase_up_kernel(model.up[-1].w)))
            self.register_buffer("up_b", model.up[-1].b.repeat(4))
            self.register_buffer("head_w", model.head.w.repeat(4, 1, 1, 1))
            self.register_buffer("head_b", model.head.b.repeat(4))

    def _conv(self, x, w: torch.Tensor, b: torch.Tensor, groups: int = 1) -> torch.Tensor:
        """Phase conv + bias with the casts of ``UNet._conv``."""
        dt = self.net.cfg.torch_dtype
        y = F.conv2d(x.to(dt), w.to(dt), padding=w.shape[-1] // 2, groups=groups)
        return y.to(torch.float32) + b.view(1, -1, 1, 1)

    @property
    def cfg(self) -> UNetConfig:
        return self.net.cfg

    @f32_entry
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        net, cfg = self.net, self.net.cfg
        for d in x.shape[1:-1]:
            if d % 2 or d % cfg.min_input_multiple:
                raise ValueError(
                    f"spatial dim {d} must be even and divisible by "
                    f"{cfg.min_input_multiple}"
                )
        relu = torch.relu
        x = x.permute(0, 3, 1, 2).to(torch.float32)
        # enc0 in the phase domain: (N, 4C_in, H/2, W/2) -> (N, 4f0, ...)
        xp = unet_lib._space_to_depth(x, 2).contiguous(memory_format=torch.channels_last)
        e0 = relu(self._conv(xp, self.enc1_w, self.enc1_b))
        e0 = relu(self._conv(e0, self.enc2_w, self.enc2_b))
        n, c4, h, w = e0.shape
        f0 = c4 // 4
        # phase groups as an axis of their own, on the NHWC view (no copy
        # for channels_last tensors): (N, h, w, 4, f0)
        e0_p = e0.permute(0, 2, 3, 1).reshape(n, h, w, 4, f0)
        # pool = max over the 4 phase groups
        xmid = e0_p.amax(dim=3).permute(0, 3, 1, 2)

        # middle of the net: the model's own path
        skips = []
        for lvl in range(1, cfg.depth):
            if lvl > 1:
                xmid = F.max_pool2d(xmid, 2)
            xmid = net._block(xmid, net.enc[lvl])
            if lvl < cfg.depth - 1:
                skips.append(xmid)
        for i, lvl in enumerate(reversed(range(1, cfg.depth - 1))):
            skip = skips[lvl - 1]
            xmid = net._upsample(xmid, net.up[i])
            xmid = torch.cat([skip, xmid.to(skip.dtype)], dim=1)
            xmid = net._block(xmid, net.dec[i])

        # up-conv into the phase domain: one 1x1 conv making all 4 phases
        up = self._conv(xmid, self.up_w, self.up_b)
        up_p = up.permute(0, 2, 3, 1).reshape(n, h, w, 4, f0)
        # phase-aware concat: [skip, up] within each phase group
        cat = torch.cat([e0_p, up_p], dim=-1).reshape(n, h, w, 8 * f0)
        cat = cat.permute(0, 3, 1, 2)
        d0 = relu(self._conv(cat, self.dec1_w, self.dec1_b))
        d0 = relu(self._conv(d0, self.dec2_w, self.dec2_b))

        # head: the model's 1x1 conv on each phase group (one grouped conv),
        # then depth-to-space on the class maps
        logits_p = self._conv(d0, self.head_w, self.head_b, groups=4)
        logits = unet_lib._depth_to_space(logits_p, 2)
        return logits.permute(0, 2, 3, 1).to(torch.float32)


def _space_to_depth_hw(x: torch.Tensor) -> torch.Tensor:
    """(N, C, Z, H, W) -> (N, 4C, Z, H/2, W/2), phase-major channels (the
    2D ``unet._space_to_depth`` layout on the trailing axes only)."""
    n, c, z, h, w = x.shape
    x = x.reshape(n, c, z, h // 2, 2, w // 2, 2)
    return x.permute(0, 4, 6, 1, 2, 3, 5).reshape(n, 4 * c, z, h // 2, w // 2)


def _depth_to_space_hw(x: torch.Tensor) -> torch.Tensor:
    """Inverse of ``_space_to_depth_hw``."""
    n, c4, z, h, w = x.shape
    c = c4 // 4
    x = x.reshape(n, 2, 2, c, z, h, w)
    return x.permute(0, 3, 4, 5, 1, 6, 2).reshape(n, c, z, 2 * h, 2 * w)


class Polyphase3d(nn.Module):
    """Volumetric serving forward equal to ``model(x)`` with level 0 in the
    (1, 2, 2) phase domain. ``forward``: (N, Z, H, W, C_in), H and W even,
    every axis divisible by the model's pooling multiple -> f32 logits
    (N, Z, H, W, K).

    Built from a folded 3D transpose-upsample ``UNet`` (``eligible3d``);
    raises ValueError otherwise.
    """

    def __init__(self, model: UNet):
        super().__init__()
        cfg = model.cfg
        if not eligible3d(cfg, ()):
            raise ValueError(
                "polyphase.apply3d requires a folded 3D transpose-upsample "
                f"model; got {cfg}"
            )
        self.net = model
        enc0, dec0 = model.enc[0], model.dec[-1]
        with torch.no_grad():
            for name, conv in (
                ("enc1", enc0.conv1), ("enc2", enc0.conv2),
                ("dec1", dec0.conv1), ("dec2", dec0.conv2),
            ):
                self.register_buffer(f"{name}_w", _channels_last(phase_kernel3d(conv.w)))
                self.register_buffer(f"{name}_b", conv.b.repeat(4))
            self.register_buffer("up_w", _channels_last(phase_up_kernel3d(model.up[-1].w)))
            self.register_buffer("up_b", model.up[-1].b.repeat(8))
            self.register_buffer("head_w", model.head.w.repeat(4, 1, 1, 1, 1))
            self.register_buffer("head_b", model.head.b.repeat(4))

    def _conv(self, x, w: torch.Tensor, b: torch.Tensor, groups: int = 1) -> torch.Tensor:
        """Phase conv + bias with the casts of ``UNet._conv``."""
        dt = self.net.cfg.torch_dtype
        y = F.conv3d(x.to(dt), w.to(dt), padding=w.shape[-1] // 2, groups=groups)
        return y.to(torch.float32) + b.view(1, -1, 1, 1, 1)

    @property
    def cfg(self) -> UNetConfig:
        return self.net.cfg

    @f32_entry
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        net, cfg = self.net, self.net.cfg
        for i, d in enumerate(x.shape[1:-1]):
            if (i and d % 2) or d % cfg.min_input_multiple:
                raise ValueError(
                    f"spatial dims {tuple(x.shape[1:-1])}: H and W must be even "
                    f"and every axis divisible by {cfg.min_input_multiple}"
                )
        relu = torch.relu
        x = x.permute(0, 4, 1, 2, 3).to(torch.float32)
        xp = _channels_last(_space_to_depth_hw(x))
        e0 = relu(self._conv(xp, self.enc1_w, self.enc1_b))
        e0 = relu(self._conv(e0, self.enc2_w, self.enc2_b))
        n, c4, z, h, w = e0.shape
        f0 = c4 // 4
        # phase groups as an axis of their own on the NDHWC view: (N, Z, h, w, 4, f0)
        e0_p = e0.permute(0, 2, 3, 4, 1).reshape(n, z, h, w, 4, f0)
        # 2x2x2 pool: max over the (H, W) phase groups, then stride-2 over z
        xmid = e0_p.amax(dim=4).reshape(n, z // 2, 2, h, w, f0).amax(dim=2)
        xmid = xmid.permute(0, 4, 1, 2, 3)

        skips = []
        for lvl in range(1, cfg.depth):
            if lvl > 1:
                xmid = net._pool(xmid)
            xmid = net._block(xmid, net.enc[lvl])
            if lvl < cfg.depth - 1:
                skips.append(xmid)
        for i, lvl in enumerate(reversed(range(1, cfg.depth - 1))):
            skip = skips[lvl - 1]
            xmid = net._upsample(xmid, net.up[i])
            xmid = torch.cat([skip, xmid.to(skip.dtype)], dim=1)
            xmid = net._block(xmid, net.dec[i])

        # up-conv into the phase domain: one 1x1x1 conv making both z
        # parities' four phases, then the parities interleaved along z
        up = self._conv(xmid, self.up_w, self.up_b)
        up_p = up.permute(0, 2, 3, 4, 1).reshape(n, z // 2, h, w, 2, 4, f0)
        up_p = up_p.permute(0, 1, 4, 2, 3, 5, 6).reshape(n, z, h, w, 4, f0)
        cat = torch.cat([e0_p, up_p], dim=-1).reshape(n, z, h, w, 8 * f0)
        cat = cat.permute(0, 4, 1, 2, 3)
        d0 = relu(self._conv(cat, self.dec1_w, self.dec1_b))
        d0 = relu(self._conv(d0, self.dec2_w, self.dec2_b))

        logits_p = self._conv(d0, self.head_w, self.head_b, groups=4)
        logits = _depth_to_space_hw(logits_p)
        return logits.permute(0, 2, 3, 4, 1).to(torch.float32)


def serving(model: UNet) -> nn.Module:
    """The ``Polyphase`` (``Polyphase3d`` for a 3D model) module of a
    folded ``model``, built at first use and held on ``model`` itself: it
    is built anew when the model's weights change in place and freed with
    the model (``utils.derived``).
    """
    return derived(model, "polyphase", lambda m: Polyphase3d(m) if m.cfg.dims == 3 else Polyphase(m))


def apply(model: UNet, x: torch.Tensor) -> torch.Tensor:
    """Serving forward equal to ``model(x)`` (f32 logits), level 0 in the
    phase domain. ``x``: (N, H, W, C_in), H and W even. Raises ValueError
    for configs outside ``eligible``'s cover."""
    if model.cfg.dims != 2:
        raise ValueError("polyphase.apply serves 2D models; use apply3d")
    return serving(model)(x)


def apply3d(model: UNet, x: torch.Tensor) -> torch.Tensor:
    """Volumetric serving forward equal to ``model(x)`` (f32 logits), level
    0 in the (1, 2, 2) phase domain. ``x``: (N, Z, H, W, C_in), H and W
    even. Raises ValueError for configs outside ``eligible3d``'s cover."""
    if model.cfg.dims != 3:
        raise ValueError("polyphase.apply3d serves 3D models; use apply")
    return serving(model)(x)


# ---------------------------------------------------------------------------
# training forward: the same reformulation under autograd
# ---------------------------------------------------------------------------


class _FirstMax(torch.autograd.Function):
    """``x.amax(dim)`` whose gradient goes to the FIRST maximal element along
    ``dim`` (XLA's select-and-scatter, the JAX package's ``_phase_max``);
    ``amax``'s own gradient splits ties evenly, and ReLU outputs tie at zero
    all the time."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int) -> torch.Tensor:
        m = x.amax(dim)
        ctx.save_for_backward(x, m)
        ctx.dim = dim
        return m

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, m = ctx.saved_tensors
        dim = ctx.dim
        is_max = x == m.unsqueeze(dim)
        first = is_max & (torch.cumsum(is_max, dim) == 1)
        return torch.where(first, g.unsqueeze(dim), g.new_zeros(())), None


def _first_max(x: torch.Tensor, dim: int) -> torch.Tensor:
    return _FirstMax.apply(x, dim)


def _check_train(model: UNet, x: torch.Tensor, dims: int) -> None:
    cfg = model.cfg
    if dims == 2:
        if cfg.dims != 2 or cfg.space_to_depth != 1 or cfg.depth < 2:
            raise ValueError(
                "polyphase.apply_train covers 2D space_to_depth=1 models of "
                f"depth >= 2; got dims={cfg.dims} s2d={cfg.space_to_depth} "
                f"depth={cfg.depth}"
            )
        if cfg.upsample != "transpose":
            raise ValueError("polyphase.apply_train requires upsample='transpose'")
        if any(d % 2 for d in x.shape[1:-1]):
            raise ValueError(f"even spatial dims required, got {tuple(x.shape)}")
    else:
        if cfg.dims != 3 or cfg.depth < 2 or cfg.upsample != "transpose":
            raise ValueError(
                "polyphase.apply3d_train covers 3D transpose-upsample models "
                f"of depth >= 2; got dims={cfg.dims} depth={cfg.depth} "
                f"upsample={cfg.upsample!r}"
            )
        if any(d % 2 for d in x.shape[2:-1]):
            raise ValueError(f"even H/W required, got {tuple(x.shape)}")
    for d in x.shape[1:-1]:
        if d % cfg.min_input_multiple:
            raise ValueError(f"spatial dim {d} not divisible by {cfg.min_input_multiple}")


class _PhaseTrain:
    """The training forward of one model, 2D or 3D: level 0 in the phase
    domain, its phase kernels built from the model's live parameters on each
    call (a linear rearrangement, so gradients reach the original weights).
    Activations are NC[D]HW views with channels-last strides, phase channel
    ``(a*2 + b)*C + c``.

    It runs over a list of batch shards, layer by layer, every shard of a
    layer before the next layer (one shard: the plain training forward).
    ``wt(t, device)`` is the weight ``t`` on a shard's device (default ``t``
    itself); ``norm(shards, bn, groups)`` is the train-mode batch norm of the
    shards together, ``groups`` blocks of the norm's channels on the channel
    axis (4 in the phase domain), returning ``(shards, (new_mean,
    new_var))`` (default: one shard's own statistics)."""

    def __init__(self, model: UNet, stats: List[BNStats], wt=None, norm=None):
        self.net, self.cfg, self.stats = model, model.cfg, stats
        self.three = model.cfg.dims == 3
        self.sp = (1,) * model.cfg.dims  # trailing singleton axes of a channel vector
        self.wt = wt or (lambda t, device: t)
        self.norm = norm or self._norm_one

    def _conv(self, xs: List[torch.Tensor], w: torch.Tensor, b: torch.Tensor) -> List[torch.Tensor]:
        """3x3 phase conv + bias with the casts of ``UNet._conv``."""
        dt = self.cfg.torch_dtype
        kernel = _channels_last(phase_kernel3d(w) if self.three else phase_kernel(w))
        bias = b.repeat(4).view((1, -1) + self.sp)
        conv = F.conv3d if self.three else F.conv2d
        return [
            conv(x.to(dt), self.wt(kernel, x.device).to(dt), padding=1).to(torch.float32)
            + self.wt(bias, x.device)
            for x in xs
        ]

    def _matmul(self, xs: List[torch.Tensor], w: torch.Tensor, b: torch.Tensor, groups: int = 1) -> List[torch.Tensor]:
        """A 1x1 conv on compute-dtype inputs with an f32 result, unrounded:
        the JAX package's ``einsum(..., preferred_element_type=f32)``. Run on
        the inputs rounded to the compute dtype and widened to f32 (the
        products of two bf16 values are exact in f32)."""
        dt = self.cfg.torch_dtype
        conv = F.conv3d if self.three else F.conv2d
        w = w.to(dt).to(torch.float32)
        bias = b.view((1, -1) + self.sp)
        return [
            conv(x.to(dt).to(torch.float32), self.wt(w, x.device), groups=groups) + self.wt(bias, x.device)
            for x in xs
        ]

    def _norm_one(self, xs: List[torch.Tensor], bn, groups: int):
        """The batch norm of one shard: ``UNet``'s own at full resolution;
        in the phase domain per channel over (N, phase, *spatial), the same
        pixels as the full-resolution tensor's (N, *spatial); biased
        variance, momentum ``bn_momentum``."""
        (y,) = xs
        if groups == 1:
            y, stats = bn.forward_train(y, self.cfg.bn_eps, self.cfg.bn_momentum)
            return [y], stats
        n, c4 = y.shape[:2]
        c = c4 // 4
        y5 = y.reshape((n, 4, c) + tuple(y.shape[2:]))
        var, mean = torch.var_mean(y5, dim=[0, 1] + list(range(3, y5.ndim)), correction=0)
        m = self.cfg.bn_momentum
        with torch.no_grad():
            stats = (m * bn.mean + (1 - m) * mean, m * bn.var + (1 - m) * var)

        def ch(t):
            return t.view((1, 1, -1) + self.sp)

        inv = torch.rsqrt(var + self.cfg.bn_eps)
        out = (y5 - ch(mean)) * ch(inv) * ch(bn.scale) + ch(bn.bias)
        return [out.reshape(y.shape)], stats

    def _relu_norm(self, xs: List[torch.Tensor], bn, groups: int) -> List[torch.Tensor]:
        if self.cfg.norm == "batch":
            xs, stats = self.norm(xs, bn, groups)
            self.stats.append(stats)
        return [torch.relu(x) for x in xs]

    def _block(self, xs: List[torch.Tensor], blk) -> List[torch.Tensor]:
        """conv -> norm -> relu, twice, in the phase domain."""
        for i in (1, 2):
            conv = getattr(blk, f"conv{i}")
            xs = self._relu_norm(self._conv(xs, conv.w, conv.b), getattr(blk, f"bn{i}", None), 4)
        return xs

    def _grid_norm(self, grid, bn):
        """``norm`` at full resolution on a grid of one-shard rows (the form
        ``unet.block_shards`` takes)."""
        xs, stats = self.norm([row[0] for row in grid], bn, 1)
        self.stats.append(stats)
        return [[x] for x in xs]

    def __call__(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        net, cfg = self.net, self.cfg
        three = self.three
        # NHWC (NDHWC) -> the phase tensor, NC[D]HW with channels-last strides
        xp = []
        for x in xs:
            x = torch.movedim(x.to(torch.float32), -1, 1)
            xp.append(_channels_last(_space_to_depth_hw(x) if three else unet_lib._space_to_depth(x, 2)))
        e0 = self._block(xp, net.enc[0])
        e0_p, xmid = [], []
        for e in e0:
            n, c4 = e.shape[:2]
            sp = tuple(e.shape[2:])  # (h, w) or (Z, h, w)
            f0 = c4 // 4
            # phase groups as an axis of their own on the channels-last view
            p = torch.movedim(e, 1, -1).reshape((n,) + sp + (4, f0))
            m = _first_max(p, -2)  # the 2x2 pool: max over the phase groups
            if three:
                # the z half of the 2x2x2 pool: first tie over z pairs; composed
                # with the phase max it routes to the window's row-major first tie
                m = _first_max(m.reshape((n, sp[0] // 2, 2) + sp[1:] + (f0,)), 2)
            e0_p.append(p)
            xmid.append(torch.movedim(m, -1, 1))
        del e0

        # middle levels: the model's own train-mode path, one shard a row
        norm = self._grid_norm if cfg.norm == "batch" else None
        grid, skips = [[x] for x in xmid], []
        for lvl in range(1, cfg.depth):
            if lvl > 1:
                grid = [[net._pool(x)] for (x,) in grid]
            grid = unet_lib.block_shards(cfg, grid, net.enc[lvl], self.wt, norm)
            if lvl < cfg.depth - 1:
                skips.append(grid)
        for i, lvl in enumerate(reversed(range(1, cfg.depth - 1))):
            grid = unet_lib.up_block_shards(cfg, grid, skips[lvl - 1], net.up[i], net.dec[i], self.wt, norm)
        xmid = [x for (x,) in grid]

        # up-conv into the phase domain: one 1x1 map making every phase
        up0 = net.up[-1]
        if three:
            ups = self._matmul(xmid, phase_up_kernel3d(up0.w), up0.b.repeat(8))
        else:
            ups = self._matmul(xmid, phase_up_kernel(up0.w), up0.b.repeat(4))
        cats = []
        for up, p in zip(ups, e0_p):
            n, sp, f0 = p.shape[0], tuple(p.shape[1:-2]), p.shape[-1]
            if three:
                up_p = torch.movedim(up, 1, -1).reshape((n, sp[0] // 2) + sp[1:] + (2, 4, f0))
                up_p = torch.movedim(up_p, -3, 2).reshape((n,) + sp + (4, f0))
            else:
                up_p = torch.movedim(up, 1, -1).reshape((n,) + sp + (4, f0))
            # phase-aware concat: [skip, up] within each phase group
            cat = torch.cat([p, up_p], dim=-1).reshape((n,) + sp + (8 * f0,))
            cats.append(torch.movedim(cat, -1, 1))
        d0 = self._block(cats, net.dec[-1])

        # head: the model's 1x1 conv on each phase group, then depth-to-space
        head = net.head
        reps = (4,) + (1,) * (head.w.ndim - 1)
        out = []
        for logits_p in self._matmul(d0, head.w.repeat(reps), head.b.repeat(4), groups=4):
            logits = _depth_to_space_hw(logits_p) if three else unet_lib._depth_to_space(logits_p, 2)
            out.append(torch.movedim(logits, 1, -1).to(torch.float32))
        return out


def apply_train(model: UNet, x: torch.Tensor) -> Tuple[torch.Tensor, List[BNStats]]:
    """Training forward equal to ``model.forward_train(x)`` — ``(f32
    logits, new running statistics)`` in ``bn_layers`` order — with level 0
    in the phase domain. ``x``: (N, H, W, C_in), H and W even.

    Unlike the serving ``Polyphase`` it takes batch norm (the phase-group
    reduction reproduces full-resolution statistics) and builds its phase
    kernels from the live parameters on every call, so autograd through it
    trains the same model. The pool's gradient goes to the first maximal
    phase (the standard pool's tie rule); the up-conv and the head return
    their compute-dtype products in f32 without rounding, as the JAX
    package's einsums do. Raises ValueError for models outside its cover.
    """
    _check_train(model, x, 2)
    (logits,), stats = apply_train_shards(model, [x])
    return logits, stats


def apply3d_train(model: UNet, x: torch.Tensor) -> Tuple[torch.Tensor, List[BNStats]]:
    """Volumetric training forward equal to ``model.forward_train(x)`` with
    level 0 in the (1, 2, 2) phase domain. ``x``: (N, Z, H, W, C_in), H and
    W even. The pool is the first-tie (H, W) phase max then a first-tie max
    over z pairs: together they route the gradient to the 2x2x2 window's
    first maximum in row-major order, as the standard pool does."""
    _check_train(model, x, 3)
    (logits,), stats = apply_train_shards(model, [x])
    return logits, stats


def apply_train_shards(
    model: UNet, xs: List[torch.Tensor], wt=None, norm=None
) -> Tuple[List[torch.Tensor], List[BNStats]]:
    """``apply_train`` / ``apply3d_train`` over batch shards ``xs`` (NHWC /
    NDHWC, each on its device) in lockstep: the f32 logits of each shard on
    its device and the new running statistics. ``wt`` places a weight on a
    shard's device and ``norm`` is the batch norm over every shard
    (``_PhaseTrain``; ``parallel.spatial_train`` gives the mesh's). The
    caller checks the shapes (``_check_train``)."""
    stats: List[BNStats] = []
    with ieee_f32(model.cfg.compute_dtype == "float32"):
        return _PhaseTrain(model, stats, wt, norm)(xs), stats
