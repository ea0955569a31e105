"""int8 conv throughput at the U-Net's conv shapes: the quantization case
(port of ``sequitr_tpu.studies.int8_conv``).

Per conv shape of the 1024x1024 forward (``SHAPES``, the JAX package's
table), on the card:

* ``bf16_ms``: the bf16 conv as the served forward runs it (cuDNN,
  channels-last, bf16 out: PyTorch returns the conv's own dtype where the
  JAX study asks XLA for an f32 out);
* ``int8_ms``: the raw int8 conv on the hand-written kernel
  (``ops.kernels.qconv``, int32 out);
* ``ptq_layer_ms``: the quantized layer a PTQ forward runs, the same kernel
  with its fused epilogue (f32 rescale + bias + ReLU, requantized to int8
  for the next layer);
* ``int_mm_ms``: a library yardstick, the im2col of the int8 input and one
  ``torch._int_mm`` (cuBLASLt's int8 GEMM) where its shape rules allow
  (M > 16, K and N multiples of 8: K is zero-padded), else None;
* ``bound_ms`` / ``bound_ptq_ms``: the least time the card could take, the
  larger of the bytes (input, weights and the int32 or int8 output, each
  once) at 3.35 TB/s and the int8 operations at 1979 TOPS dense (H100 SXM
  data sheet), with ``bound_by``.

Times are per call from one CUDA graph of ``iters`` calls
(``roofline._rate_graph``, the counterpart of the JAX study's shared
``_rate_scan``). On the CPU the same rows come from host clocks over the
kernel's plain version and say nothing of the card.

Run on the card:  python -m sequitr_tpu_torch.studies.int8_conv [--iters 32]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from sequitr_tpu_torch.ops.kernels.qconv import qconv
from sequitr_tpu_torch.studies.roofline import _rate_graph
from sequitr_tpu_torch.utils import resolve_device

__all__ = ["run", "SHAPES", "bound_ms"]

# (label, spatial, cin, cout) — the parity graph's conv population by level
# (roofline table, BASELINE.md round 4)
SHAPES = [
    ("enc0a 1024² 1→32", (1024, 1024), 1, 32),
    ("enc0b 1024² 32→32", (1024, 1024), 32, 32),
    ("dec0a 1024² 64→32", (1024, 1024), 64, 32),
    ("enc1 512² 64→64", (512, 512), 64, 64),
    ("dec1 512² 128→64", (512, 512), 128, 64),
    ("enc2 256² 128→128", (256, 256), 128, 128),
    ("enc3 128² 256→256", (128, 128), 256, 256),
]

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
INT8_OPS_PER_S = 1979e12  # H100 SXM, dense


def bound_ms(spatial, cin: int, cout: int, out_bytes: int, k: int = 3):
    """(ms, "bytes" | "operations") for a k^d conv of int8 input and weights
    with ``out_bytes`` an output value: each byte once at the memory rate,
    2 * k^d * cin * cout an output pixel at the int8 rate."""
    pixels = float(np.prod(spatial))
    moved = pixels * cin + k ** len(spatial) * cin * cout + pixels * cout * out_bytes
    ops = 2.0 * k ** len(spatial) * cin * cout * pixels
    t_bytes, t_ops = moved / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _im2col_int_mm(x, wmat, k_pad):
    """The 3x3 SAME conv of int8 NHWC ``x`` (batch 1) as im2col + one int8
    GEMM: (H*W, 9*C_in zero-padded to ``k_pad``) @ (k_pad, C_out) -> int32."""
    _, h, w, c = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    cols = [xp[:, dy:dy + h, dx:dx + w, :] for dy in range(3) for dx in range(3)]
    if k_pad > 9 * c:
        cols.append(torch.zeros((1, h, w, k_pad - 9 * c), dtype=x.dtype, device=x.device))
    return torch._int_mm(torch.cat(cols, dim=-1).reshape(h * w, k_pad), wmat)


def run(iters: int = 32, device=None, shapes=SHAPES):
    """One row a shape (the module docstring's keys), printed as a JSON line
    as it is measured; returns the rows."""
    device = resolve_device(device)
    rng = np.random.default_rng(0)
    rows = []
    for label, spatial, cin, cout in shapes:
        h, w = spatial
        flops = 2.0 * 9 * cin * cout * h * w
        xf = rng.normal(size=(1, h, w, cin)).astype(np.float32)
        wf = rng.normal(size=(3, 3, cin, cout)).astype(np.float32) * 0.1
        bf = rng.normal(size=(cout,)).astype(np.float32) * 0.01

        # bf16 conv as served: channels-last NCHW view, bf16 out
        xb = torch.movedim(torch.as_tensor(xf, device=device), -1, 1).to(torch.bfloat16)
        wb = torch.as_tensor(np.transpose(wf, (3, 2, 0, 1)), device=device).to(torch.bfloat16)
        wb = wb.contiguous(memory_format=torch.channels_last)
        t_bf16 = _rate_graph(lambda x_, w_: F.conv2d(x_, w_, padding=1), (xb, wb), iters)

        # raw int8 conv -> int32
        xi = torch.as_tensor(np.clip(np.round(xf * 30), -127, 127).astype(np.int8), device=device)
        wi = torch.as_tensor(np.clip(np.round(wf * 300), -127, 127).astype(np.int8), device=device)
        t_int8 = _rate_graph(lambda x_, w_: qconv(x_, w_), (xi, wi), iters)

        # the PTQ layer: int8 conv -> per-channel rescale + bias + relu ->
        # requantize to int8 for the next layer, one kernel
        scale = torch.as_tensor(rng.uniform(1e-4, 1e-3, (cout,)).astype(np.float32), device=device)
        bias = torch.as_tensor(bf, device=device)
        t_ptq = _rate_graph(
            lambda x_, w_, s_, b_: qconv(x_, w_, epilogue="requant", scale=s_, bias=b_, relu=True, inv_next=25.0),
            (xi, wi, scale, bias), iters,
        )

        # library yardstick: im2col + cuBLASLt int8 GEMM
        k_pad = -(-9 * cin // 8) * 8
        t_mm = None
        if device.type == "cuda" and h * w > 16 and cout % 8 == 0:
            wmat = torch.zeros((k_pad, cout), dtype=torch.int8, device=device)
            wmat[: 9 * cin] = wi.reshape(9 * cin, cout)
            t_mm = _rate_graph(lambda x_, w_: _im2col_int_mm(x_, w_, k_pad), (xi, wmat), iters)

        b_raw, by_raw = bound_ms(spatial, cin, cout, 4)
        b_ptq, by_ptq = bound_ms(spatial, cin, cout, 1)
        row = {
            "shape": label,
            "bf16_ms": t_bf16 * 1e3,
            "int8_ms": t_int8 * 1e3,
            "ptq_layer_ms": t_ptq * 1e3,
            "int_mm_ms": None if t_mm is None else t_mm * 1e3,
            "bound_ms": b_raw,
            "bound_by": by_raw,
            "bound_ptq_ms": b_ptq,
            "bound_ptq_by": by_ptq,
            "bf16_tflops": flops / t_bf16 / 1e12,
            "int8_tops": flops / t_int8 / 1e12,
            "speedup_raw": t_bf16 / t_int8,
            "speedup_ptq": t_bf16 / t_ptq,
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        }
        rows.append(row)
        print(json.dumps(row), flush=True)

    print("\n| shape | bf16 ms | int8 ms | ptq ms | _int_mm ms | bound ms (int32 / int8 out) | raw× | ptq× |")
    print("|---|---|---|---|---|---|---|---|")
    for r in rows:
        mm = "-" if r["int_mm_ms"] is None else f"{r['int_mm_ms']:.5f}"
        print(
            f"| {r['shape']} | {r['bf16_ms']:.5f} | {r['int8_ms']:.5f} | {r['ptq_layer_ms']:.5f} | {mm} | "
            f"{r['bound_ms']:.5f} / {r['bound_ptq_ms']:.5f} | {r['speedup_raw']:.3f} | {r['speedup_ptq']:.3f} |"
        )
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args()
    run(iters=args.iters, device=args.device)
