"""PyTorch re-derivation of the U-Net and the PatchGAN: a parity target
that shares no code with the port's ``models.unet.UNet`` and ``models.gan``.

A copy of ``sequitr_tpu.models.torch_reference`` (the JAX package's second
independent parity target), kept a re-derivation: the architecture is
rebuilt from the configuration with plain ``nn.Conv2d``/``nn.Conv3d``,
``nn.BatchNorm``, ``nn.ConvTranspose`` and ``nn.MaxPool`` modules, and the
weights are injected from the nested (params, state) pytrees of the
interchange layout (``models.convert.nest_flat``). ``parity_check`` runs
the port's ``UNet`` (or ``GAN``) and this module on identical weights.

Semantics mirrored from the U-Net specification:
* 3x3 SAME convs with bias (torch ``padding=1``), ReLU;
* inference-mode batch norm using the running stats (torch ``eval()``);
* 2x2 max pool;
* kernel-2 stride-2 transposed conv (no cross-window overlap, so the
  TF-exact geometry maps 1:1 onto torch's ConvTranspose semantics);
* 1x1 head conv.

torch is only imported inside functions; nothing else depends on it.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from sequitr_tpu_torch.models.unet import UNetConfig

__all__ = [
    "build_torch_unet",
    "inject_weights_torch",
    "build_torch_patchgan",
    "inject_patchgan_weights_torch",
    "torch_forward",
]


def build_torch_unet(cfg: UNetConfig):
    """torch.nn.Module mirroring the U-Net forward (2D and 3D)."""
    import torch
    import torch.nn as nn

    if cfg.space_to_depth > 1:
        raise NotImplementedError("torch reference covers s2d=1 configs")
    if cfg.upsample != "transpose":
        raise NotImplementedError(
            "torch reference covers transpose-upsample configs"
        )
    if cfg.dims == 2:
        Conv, ConvT, Pool, BN = nn.Conv2d, nn.ConvTranspose2d, nn.MaxPool2d, nn.BatchNorm2d
    elif cfg.dims == 3:
        Conv, ConvT, Pool, BN = nn.Conv3d, nn.ConvTranspose3d, nn.MaxPool3d, nn.BatchNorm3d
    else:
        raise NotImplementedError(f"dims={cfg.dims}")

    class Block(nn.Module):
        def __init__(self, c_in, c_out):
            super().__init__()
            self.conv1 = Conv(c_in, c_out, 3, padding=1)
            self.conv2 = Conv(c_out, c_out, 3, padding=1)
            if cfg.norm == "batch":
                self.bn1 = BN(c_out, eps=cfg.bn_eps)
                self.bn2 = BN(c_out, eps=cfg.bn_eps)

        def forward(self, x):
            for i in (1, 2):
                x = getattr(self, f"conv{i}")(x)
                if cfg.norm == "batch":
                    x = getattr(self, f"bn{i}")(x)
                x = torch.relu(x)
            return x

    class TorchUNet(nn.Module):
        def __init__(self):
            super().__init__()
            self.enc = nn.ModuleList()
            c_prev = cfg.in_channels
            for lvl in range(cfg.depth):
                c = cfg.features(lvl)
                self.enc.append(Block(c_prev, c))
                c_prev = c
            self.pool = Pool(2)
            self.up = nn.ModuleList()
            self.dec = nn.ModuleList()
            for i, lvl in enumerate(reversed(range(cfg.depth - 1))):
                c_skip = cfg.features(lvl)
                self.up.append(ConvT(c_prev, c_skip, 2, stride=2))
                self.dec.append(Block(2 * c_skip, c_skip))
                c_prev = c_skip
            self.head = Conv(c_prev, cfg.num_classes, 1)

        def forward(self, x):
            skips = []
            for lvl in range(cfg.depth):
                if lvl > 0:
                    x = self.pool(x)
                x = self.enc[lvl](x)
                if lvl < cfg.depth - 1:
                    skips.append(x)
            for i, lvl in enumerate(reversed(range(cfg.depth - 1))):
                x = self.up[i](x)
                x = torch.cat([skips[lvl], x], dim=1)
                x = self.dec[i](x)
            return self.head(x)

    model = TorchUNet()
    model.eval()
    return model


def inject_weights_torch(model, cfg: UNetConfig, params: Any, state: Any) -> None:
    """Copy a nested (params, state) pytree into the torch model.

    Layouts: our conv kernels are (k..., c_in, c_out); torch convs want
    (c_out, c_in, k...), torch transposed convs want (c_in, c_out, k...).
    BN maps scale/bias/mean/var onto weight/bias/running_mean/running_var.
    """
    import torch

    def t32(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())

    def set_conv(mod, p):
        w = np.asarray(p["w"], np.float32)
        axes = (w.ndim - 1, w.ndim - 2) + tuple(range(w.ndim - 2))
        mod.weight.data = t32(np.transpose(w, axes))
        mod.bias.data = t32(p["b"])

    def set_convT(mod, p):
        w = np.asarray(p["w"], np.float32)
        axes = (w.ndim - 2, w.ndim - 1) + tuple(range(w.ndim - 2))
        mod.weight.data = t32(np.transpose(w, axes))
        mod.bias.data = t32(p["b"])

    def set_bn(mod, p, s):
        mod.weight.data = t32(p["scale"])
        mod.bias.data = t32(p["bias"])
        mod.running_mean.data = t32(s["mean"])
        mod.running_var.data = t32(s["var"])

    for lvl in range(cfg.depth):
        blk = model.enc[lvl]
        for i in (1, 2):
            set_conv(getattr(blk, f"conv{i}"), params["enc"][lvl][f"conv{i}"])
            if cfg.norm == "batch":
                set_bn(
                    getattr(blk, f"bn{i}"),
                    params["enc"][lvl][f"bn{i}"],
                    state["enc"][lvl][f"bn{i}"],
                )
    for i in range(cfg.depth - 1):
        set_convT(model.up[i], params["up"][i])
        blk = model.dec[i]
        for j in (1, 2):
            set_conv(getattr(blk, f"conv{j}"), params["dec"][i][f"conv{j}"])
            if cfg.norm == "batch":
                set_bn(
                    getattr(blk, f"bn{j}"),
                    params["dec"][i][f"bn{j}"],
                    state["dec"][i][f"bn{j}"],
                )
    set_conv(model.head, params["head"])


def build_torch_patchgan(gcfg):
    """torch mirror of the PatchGAN discriminator."""
    import torch
    import torch.nn as nn

    class TorchPatchGAN(nn.Module):
        def __init__(self):
            super().__init__()
            c_in = gcfg.in_channels + gcfg.out_channels
            self.convs = nn.ModuleList()
            c = gcfg.disc_base_features
            for _ in range(gcfg.disc_layers):
                # stride-2 k=4 SAME on even inputs pads (1, 1) — torch's
                # symmetric padding=1 matches XLA exactly
                self.convs.append(nn.Conv2d(c_in, c, 4, stride=2, padding=1))
                c_in, c = c, min(c * 2, 512)
            # widths mirror the GAN's init exactly: penultimate widens
            # c_in -> c (the next doubled width), head maps c -> 1.
            # stride-1 k=4 SAME pads (1, 2) ASYMMETRICALLY; torch Conv2d
            # only pads symmetrically, so these convs pad manually
            self.penultimate = nn.Conv2d(c_in, c, 4, padding=0)
            self.head = nn.Conv2d(c, 1, 4, padding=0)
            self.lrelu = nn.LeakyReLU(0.2)

        def forward(self, x):
            import torch.nn.functional as F

            for conv in self.convs:
                x = self.lrelu(conv(x))
            x = self.lrelu(self.penultimate(F.pad(x, (1, 2, 1, 2))))
            return self.head(F.pad(x, (1, 2, 1, 2)))

    model = TorchPatchGAN()
    model.eval()
    return model


def inject_patchgan_weights_torch(model, gcfg, params) -> None:
    """Copy a GAN's nested discriminator pytree into the torch PatchGAN."""
    import torch

    def t32(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())

    def set_conv(mod, p):
        w = np.asarray(p["w"], np.float32)
        axes = (w.ndim - 1, w.ndim - 2) + tuple(range(w.ndim - 2))
        wt = np.transpose(w, axes)
        if tuple(mod.weight.shape) != wt.shape:
            # .data assignment would silently accept a mismatched tensor;
            # fail loudly if the torch mirror ever drifts from the stored widths
            raise ValueError(
                f"kernel shape {wt.shape} does not match torch module "
                f"{tuple(mod.weight.shape)}"
            )
        mod.weight.data = t32(wt)
        mod.bias.data = t32(p["b"])

    disc = params["disc"]
    for mod, p in zip(model.convs, disc["convs"]):
        set_conv(mod, p)
    set_conv(model.penultimate, disc["penultimate"])
    set_conv(model.head, disc["head"])


def torch_forward(model, x: np.ndarray) -> np.ndarray:
    """Inference-mode forward: (N, *s, C) channel-last in/out logits."""
    import torch

    nd = x.ndim - 2  # spatial rank
    perm_in = (0, x.ndim - 1) + tuple(range(1, x.ndim - 1))
    with torch.no_grad():
        t = torch.from_numpy(
            np.ascontiguousarray(np.transpose(np.asarray(x, np.float32), perm_in))
        )
        y = model(t).numpy()
    perm_out = (0,) + tuple(range(2, nd + 2)) + (1,)
    return np.transpose(y, perm_out)
