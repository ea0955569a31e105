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
dtype where the JAX package's einsums keep f32. ``apply_train`` and
``apply3d_train`` belong to the training slice of the port and raise.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from sequitr_tpu_torch.models import unet as unet_lib
from sequitr_tpu_torch.models.unet import UNet, UNetConfig
from sequitr_tpu_torch.utils import derived, f32_entry

__all__ = [
    "eligible", "eligible3d", "phase_kernel", "phase_up_kernel",
    "phase_kernel3d", "phase_up_kernel3d", "Polyphase", "Polyphase3d",
    "serving", "apply", "apply_train", "apply3d", "apply3d_train",
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


def _phase_taps(w: torch.Tensor, c_out: int, c_in: int) -> torch.Tensor:
    """The (H, W) phase rearrangement of a kernel whose last two axes are
    the 3x3 (H, W) taps: (C_out, C_in, *lead, 3, 3) -> (4C_out, 4C_in,
    *lead, 3, 3), leading tap axes (z) passed through."""
    lead = tuple(w.shape[2:-2])
    pw = w.new_zeros((4, c_out, 4, c_in) + lead + (3, 3))
    for sy in (-1, 0, 1):
        for sx in (-1, 0, 1):
            for p in (0, 1):
                for q in (0, 1):
                    for a in (0, 1):
                        for b in (0, 1):
                            dy = 2 * sy + p - a
                            dx = 2 * sx + q - b
                            if dy in (-1, 0, 1) and dx in (-1, 0, 1):
                                pw[a * 2 + b, :, p * 2 + q, ..., sy + 1, sx + 1] = (
                                    w[..., dy + 1, dx + 1]
                                )
    return pw.reshape((4 * c_out, 4 * c_in) + lead + (3, 3))


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


def _later(name: str, slice_name: str):
    def fn(*args, **kwargs):
        raise NotImplementedError(
            f"polyphase.{name} is not ported yet: it belongs to the "
            f"{slice_name} slice of the port"
        )

    fn.__name__ = name
    fn.__doc__ = f"Not ported yet ({slice_name} slice); raises NotImplementedError."
    return fn


apply_train = _later("apply_train", "polyphase training")
apply3d_train = _later("apply3d_train", "polyphase training")
