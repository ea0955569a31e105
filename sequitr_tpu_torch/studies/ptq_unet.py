"""Post-training int8 quantization (PTQ) of the U-Net (port of
``sequitr_tpu.studies.ptq_unet``): the full recipe, on the hand-written int8
conv kernel of ``ops.kernels.qconv``.

A study, as in the JAX package: no job serves a quantized model. Whether
int8 pays on the card is what ``studies.int8_conv`` and ``chip_smoke.py
--phases quant`` measure (``PERF.md``); run those first.

Scheme, the JAX package's (the standard production PTQ recipe):

* weights: symmetric per-output-channel int8 (``scale_c = max|w[..., c]| /
  127``), from the BN-FOLDED weights, so the quantization sees what serving
  runs;
* activations: symmetric per-tensor int8 with STATIC scales from offline
  calibration (a high quantile of |x| at every conv input over
  representative normalized patches);
* accumulation in int32, dequantized once per conv with the folded
  ``x_scale * w_scale`` product, bias (and the block's ReLU) in f32.

Every conv is ``qconv``: on the card the kernel with its dequantizing
epilogue (the block's ReLU fused into it), on the CPU its exact plain
version. The quantize of each conv input, the pools, the concats, the
nearest resize and space-to-depth stay f32 tensor ops, NHWC (NDHWC)
throughout. Each rounds where the JAX package rounds: ``x * (1 / x_s)``
with the f32 reciprocal taken first, half-to-even rounding, the dequant's
product and sum each rounded once; so the logits are bit-equal to the JAX
package's ``apply`` run eagerly on the same qparams (``from_jax``), on the
CPU and on the card.

The quantized parameters keep the JAX package's tree: ``{"enc": [{"conv1":
qc, "conv2": qc}, ...], "up": [qc, ...], "dec": [...], "head": qc}`` with
``qc = {"w_q": int8 ([k,] k, k, C_in, C_out), "w_s": f32 (C_out,), "b": f32
(C_out,), "x_s": f32 ()}``, the kernels in HWIO (DHWIO) layout, the
transposed up-conv's too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from sequitr_tpu_torch.models import unet
from sequitr_tpu_torch.ops.kernels.qconv import qconv
from sequitr_tpu_torch.ops.normalize import quantile_linear
from sequitr_tpu_torch.utils import ieee_f32

Params = Dict[str, Any]

__all__ = ["quantize", "apply", "template", "calibrate", "from_jax", "QMIN", "QMAX"]

QMAX = 127.0
QMIN = -127.0  # symmetric: -128 is never produced


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def _quantize_tensor(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """float32 -> int8 with a (scalar) scale: q = clip(round(x * (1 / s)))."""
    q = torch.clamp(torch.round(x * (1.0 / scale)), QMIN, QMAX)
    return q.to(torch.int8)


def _quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8: returns (w_q, scale[c_out]); the
    division ``w / scale`` is one f32 division, as the JAX package's."""
    amax = torch.amax(torch.abs(w), dim=tuple(range(w.ndim - 1)))
    scale = torch.clamp_min(amax / QMAX, 1e-12).to(torch.float32)
    w_q = torch.clamp(torch.round(w / scale), QMIN, QMAX).to(torch.int8)
    return w_q, scale


def _qconv(x: torch.Tensor, qc: Params, transpose: bool = False, relu: bool = False) -> torch.Tensor:
    """Quantize -> int8 conv (int32 sums) -> ``acc * (x_s * w_s) + b`` in
    f32 (ReLU'd if ``relu``). ``x``: the f32 NHWC (NDHWC) activation."""
    xq = _quantize_tensor(x, qc["x_s"])
    return qconv(xq, qc["w_q"], transpose, "dequant", qc["x_s"] * qc["w_s"], qc["b"], relu)


def _q_block(x: torch.Tensor, bp: Params) -> torch.Tensor:
    for i in (1, 2):
        x = _qconv(x, bp[f"conv{i}"], relu=True)
    return x


def _resize2(x: torch.Tensor) -> torch.Tensor:
    """Nearest 2x upsampling of NHWC (NDHWC): index i takes i // 2, as
    ``jax.image.resize(method="nearest")`` does at scale 2."""
    for ax in range(1, x.ndim - 1):
        x = torch.repeat_interleave(x, 2, dim=ax)
    return x


def _q_upsample(x: torch.Tensor, qc: Params, cfg: unet.UNetConfig) -> torch.Tensor:
    if cfg.upsample == "transpose":
        return _qconv(x, qc, transpose=True)
    return _qconv(_resize2(x), qc)


def _maxpool(x: torch.Tensor) -> torch.Tensor:
    """2^d max pool, VALID, of NHWC (NDHWC)."""
    n, *sp, c = x.shape
    split = [d for s in sp for d in (s // 2, 2)]
    return torch.amax(x.reshape(n, *split, c), dim=tuple(range(2, 2 * len(sp) + 1, 2)))


def _space_to_depth(x: torch.Tensor, s: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, H/s, W/s, C*s*s), the JAX package's NHWC layout."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // s, s, w // s, s, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // s, w // s, s * s * c)


def _depth_to_space(x: torch.Tensor, s: int) -> torch.Tensor:
    """(N, h, w, C*s*s) -> (N, h*s, w*s, C), inverse of ``_space_to_depth``."""
    n, h, w, cs = x.shape
    c = cs // (s * s)
    x = x.reshape(n, h, w, s, s, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h * s, w * s, c)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def apply(cfg: unet.UNetConfig, qparams: Params, x: torch.Tensor) -> torch.Tensor:
    """int8 forward. ``x``: (N, *spatial, C_in) float, on the qparams'
    device. Returns f32 logits (N, *spatial, num_classes).

    ``unet``'s inference forward (batch norm folded at quantization time)
    with every conv and transposed conv on ``qconv``; pools, concats and
    ReLUs on the f32 values between conv sites.
    """
    for d in x.shape[1:-1]:
        if d % cfg.min_input_multiple:
            raise ValueError(
                f"spatial dim {d} not divisible by {cfg.min_input_multiple}"
            )
    x = x.to(torch.float32)
    s2d = cfg.space_to_depth
    if s2d > 1:
        x = _space_to_depth(x, s2d)
    x = x.contiguous()
    skips = []
    for lvl in range(cfg.depth):
        if lvl > 0:
            x = _maxpool(x)
        x = _q_block(x, qparams["enc"][lvl])
        if lvl < cfg.depth - 1:
            skips.append(x)
    for i, lvl in enumerate(reversed(range(cfg.depth - 1))):
        x = _q_upsample(x, qparams["up"][i], cfg)
        x = torch.cat([skips[lvl], x], dim=-1)
        x = _q_block(x, qparams["dec"][i])
    logits = _qconv(x, qparams["head"])
    if s2d > 1:
        logits = _depth_to_space(logits, s2d)
    return logits.to(torch.float32)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


def _site_forward(model: unet.UNet, x: torch.Tensor, record: Callable) -> torch.Tensor:
    """The folded f32 forward with a ``record(site, conv_input)`` hook at
    every conv site, the calibration twin of ``apply`` (site keys match the
    qparams layout): convs in f32 whatever the model's compute dtype."""
    cfg = dataclasses.replace(model.cfg, compute_dtype="float32")
    x = torch.movedim(x.to(torch.float32), -1, 1)
    s2d = cfg.space_to_depth
    if s2d > 1:
        x = unet._space_to_depth(x, s2d)

    def block(x, blk, key):
        for i in (1, 2):
            record(f"{key}/conv{i}", x)
            c = getattr(blk, f"conv{i}")
            x = torch.relu(unet.conv(cfg, x, c.w, c.b))
        return x

    skips = []
    for lvl in range(cfg.depth):
        if lvl > 0:
            x = model._pool(x)
        x = block(x, model.enc[lvl], f"enc{lvl}")
        if lvl < cfg.depth - 1:
            skips.append(x)
    for i, lvl in enumerate(reversed(range(cfg.depth - 1))):
        record(f"up{i}", x)
        up = model.up[i]
        if cfg.upsample == "transpose":
            x = unet.conv(cfg, x, up.w, up.b, transpose=True)
        else:
            x = unet.conv(cfg, F.interpolate(x, scale_factor=2), up.w, up.b)
        x = torch.cat([skips[lvl], x], dim=1)
        x = block(x, model.dec[i], f"dec{i}")
    record("head", x)
    return unet.conv(cfg, x, model.head.w, model.head.b)


def calibrate(model: unet.UNet, batches, quantile: float = 0.9999) -> Dict[str, float]:
    """Per-site activation scales from representative NORMALIZED patches.

    ``model`` must already be BN-folded (norm 'none', ``unet.fold_batchnorm``).
    ``batches``: iterable of (N, *patch, C_in) float arrays or tensors, the
    tensors serving will see (normalized, tiled). Per batch, each conv
    input's |x| quantile is measured (``jnp.quantile``'s linear method,
    ``ops.normalize.quantile_linear``); scales take the running max over
    batches. Returns {site: scale}, each ``max(amax / 127, 1e-12)`` in
    float64 (``_pack`` rounds it to f32).
    """
    if model.cfg.norm != "none":
        raise ValueError("calibrate takes a BN-folded model (unet.fold_batchnorm)")
    q = float(quantile)
    device = next(model.parameters()).device
    scales: Dict[str, float] = {}
    n = 0
    with torch.no_grad(), ieee_f32(True):
        for batch in batches:
            got: Dict[str, torch.Tensor] = {}

            def record(site, t):
                got[site] = quantile_linear(torch.abs(t).to(torch.float32).reshape(-1), [q])[0]

            _site_forward(model, torch.as_tensor(batch, device=device), record)
            n += 1
            for site, amax in got.items():
                scales[site] = max(scales.get(site, 0.0), float(amax))
    if n == 0:
        raise ValueError("calibration needs at least one batch")
    return {site: max(a / QMAX, 1e-12) for site, a in scales.items()}


# ---------------------------------------------------------------------------
# quantization + interchange
# ---------------------------------------------------------------------------


def _hwio(conv) -> torch.Tensor:
    """A ``unet._Conv``'s kernel in the JAX package's ([k,] k, k, C_in,
    C_out) layout (torch keeps (C_out, C_in, k..), transposed (C_in, C_out,
    k..))."""
    w = conv.w
    lead = tuple(range(2, w.ndim))
    return w.permute(lead + ((0, 1) if conv.transpose else (1, 0))).contiguous()


def _pack(conv: Params, x_scale: float) -> Params:
    """One conv site's qparams from its folded f32 ``w`` (HWIO) and ``b``."""
    w = torch.as_tensor(conv["w"]).to(torch.float32)
    w_q, w_s = _quantize_weight(w)
    return {
        "w_q": w_q,
        "w_s": w_s,
        "b": torch.as_tensor(conv["b"], device=w.device).to(torch.float32),
        "x_s": torch.tensor(np.float32(x_scale), device=w.device),
    }


def quantize(
    model: unet.UNet, calib_batches, quantile: float = 0.9999
) -> Tuple[unet.UNetConfig, Params]:
    """Fold BN, calibrate activation scales, quantize weights.

    Returns ``(qcfg, qparams)``: the folded (norm 'none') config and the
    quantized tree (int8 weights, per-channel weight scales, per-site
    activation scales, f32 biases) on the model's device.
    """
    folded = unet.fold_batchnorm(model)
    scales = calibrate(folded, calib_batches, quantile=quantile)
    with torch.no_grad():

        def pack(conv, site):
            return _pack({"w": _hwio(conv), "b": conv.b}, scales[site])

        qparams: Params = {
            "enc": [
                {"conv1": pack(bp.conv1, f"enc{lvl}/conv1"), "conv2": pack(bp.conv2, f"enc{lvl}/conv2")}
                for lvl, bp in enumerate(folded.enc)
            ],
            "up": [pack(p, f"up{i}") for i, p in enumerate(folded.up)],
            "dec": [
                {"conv1": pack(bp.conv1, f"dec{i}/conv1"), "conv2": pack(bp.conv2, f"dec{i}/conv2")}
                for i, bp in enumerate(folded.dec)
            ],
            "head": pack(folded.head, "head"),
        }
    return folded.cfg, qparams


def _map_tree(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def from_jax(qparams, device=None) -> Params:
    """The JAX package's qparams (arrays of any kind, numpy or JAX, in its
    tree) as this module's: tensors of the same dtypes and layouts on
    ``device`` (default the CPU)."""
    return _map_tree(lambda a: torch.as_tensor(np.array(a)).to(device or "cpu"), qparams)


def template(cfg: unet.UNetConfig) -> Params:
    """Zeroed qparams tree (structure, shapes and dtypes) of ``cfg``, on the CPU."""
    model = unet.UNet(dataclasses.replace(cfg, norm="none"), device="cpu")

    def zpack(conv):
        shape = tuple(_hwio(conv).shape)
        return {
            "w_q": torch.zeros(shape, dtype=torch.int8),
            "w_s": torch.ones((shape[-1],), dtype=torch.float32),
            "b": torch.zeros((shape[-1],), dtype=torch.float32),
            "x_s": torch.tensor(1.0, dtype=torch.float32),
        }

    return {
        "enc": [{"conv1": zpack(bp.conv1), "conv2": zpack(bp.conv2)} for bp in model.enc],
        "up": [zpack(p) for p in model.up],
        "dec": [{"conv1": zpack(bp.conv1), "conv2": zpack(bp.conv2)} for bp in model.dec],
        "head": zpack(model.head),
    }
