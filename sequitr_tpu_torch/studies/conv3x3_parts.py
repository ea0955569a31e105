"""Where the tensor-core conv kernels' time goes, by leaving parts out.

    python -m sequitr_tpu_torch.studies.conv3x3_parts [--size 1024] [--iters 60]

Needs an NVIDIA Hopper card and ``nvcc``. ``csrc/conv3x3.cu`` is built six
times, whole and with parts compiled out by its ``CONV3X3_WITHOUT_*``
switches (the products, the stores, the flat kernel's transposition, and
combinations down to "the loads alone"); each build's NHWC kernel and flat
kernel (row stride W+8) are timed on packed weights at ``size`` x ``size``,
32 -> 32 channels, bf16 (CUDA events, median, the stream held while the
calls queue). A part whose removal changes nothing is hidden behind the
others; what remains when everything but the loads is gone is what the
card's memory takes to deliver the input. The outputs of the cut builds are
wrong by design and are not looked at.

Beside them, two yardsticks of the card itself: a device-to-device copy of
the input's bytes (as many bytes read and written as the NHWC conv moves),
and the rate at which the tensor cores take ``mma.sync.m16n8k16`` from
registers alone (``csrc/mma_rate.cu``), against the data sheet's 989
TFLOP/s that only ``wgmma`` reaches.

Prints one line a reading and one JSON object at the end.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

import torch

from sequitr_tpu_torch.ops.kernels import build, conv3x3
from sequitr_tpu_torch.studies import conv2d_gemm
from sequitr_tpu_torch.utils import device_median_ms

__all__ = ["VARIANTS", "run", "main"]

# name -> switches of csrc/conv3x3.cu that are set for it
VARIANTS = {
    "whole": (),
    "without_products": ("CONV3X3_WITHOUT_PRODUCTS",),
    "without_stores": ("CONV3X3_WITHOUT_STORES",),
    "without_transpose": ("CONV3X3_WITHOUT_TRANSPOSE",),
    "without_products_and_stores": ("CONV3X3_WITHOUT_PRODUCTS", "CONV3X3_WITHOUT_STORES"),
    "loads_alone": (
        "CONV3X3_WITHOUT_PRODUCTS", "CONV3X3_WITHOUT_STORES", "CONV3X3_WITHOUT_TRANSPOSE",
    ),
}


def _load(item) -> ctypes.CDLL:
    name, defines = item
    return conv3x3.bind(build.load("conv3x3", defines=defines, variant=name if defines else ""))


def _mma_rate(iters: int) -> Dict[str, float]:
    lib = build.load("mma_rate")
    lib.seq_mma_rate.restype = ctypes.c_int
    lib.seq_mma_rate.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    loops = 4096
    out = {}
    for warps in (4, 8, 12, 16):
        buf = torch.empty(sms * warps * 32, device="cuda")
        stream = torch.cuda.current_stream().cuda_stream

        def launch():
            rc = lib.seq_mma_rate(buf.data_ptr(), sms, warps, loops, stream)
            if rc:
                raise RuntimeError(f"mma_rate launch failed: CUDA error {rc}")

        ms = device_median_ms(launch, max(iters // 3, 10))
        out[f"{warps}_warps_an_sm"] = sms * warps * 16 * loops * 4096 / ms / 1e9  # TFLOP/s
    return out


def run(size: int = 1024, iters: int = 60) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this study times kernels on the card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:  # one nvcc a variant, together
        libs = dict(zip(VARIANTS, pool.map(_load, VARIANTS.items())))
    gen = torch.Generator().manual_seed(3)
    c = 32
    x = torch.randn((size, size, c), generator=gen).to(torch.bfloat16).cuda()
    w = torch.randn((3, 3, c, c), generator=gen) * 0.1
    wk, bk = conv3x3.pack_weights(w.cuda(), torch.randn((c,), generator=gen).cuda(), torch.bfloat16)
    xf = conv2d_gemm.flatten_chw(x).contiguous()
    wb = size + 8
    y = torch.empty((size, size, c), dtype=torch.bfloat16, device="cuda")
    yf = torch.empty((c, size * wb), dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    result = {"card": card, "size": size, "channels": c, "ms": {}}
    for name, lib in libs.items():
        def nhwc():
            rc = lib.seq_conv3x3_nhwc(
                x.data_ptr(), wk.data_ptr(), bk.data_ptr(), y.data_ptr(), size, size, c, c,
                1, 1, 1, stream,
            )
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")

        def flat():
            rc = lib.seq_conv3x3_flat_chw(
                xf.data_ptr(), wk.data_ptr(), bk.data_ptr(), yf.data_ptr(), size, size, wb,
                conv2d_gemm.MARGIN, c, c, 1, 1, 1, stream,
            )
            if rc:
                raise RuntimeError(f"{name}: CUDA error {rc}")

        times = {"nhwc": device_median_ms(nhwc, iters), "flat": device_median_ms(flat, iters)}
        result["ms"][name] = times
        print(f"{name}: nhwc {times['nhwc']:.5f} ms, flat {times['flat']:.5f} ms")
    copy = device_median_ms(lambda: y.copy_(x), iters)
    result["device_copy_ms"] = copy
    print(f"device-to-device copy of {x.numel() * 2} bytes: {copy:.5f} ms")
    result["mma_sync_tflops"] = _mma_rate(iters)
    for key, rate in result["mma_sync_tflops"].items():
        print(f"mma.sync.m16n8k16 bf16 from registers, {key}: {rate:.1f} TFLOP/s")
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--size", type=int, default=1024)
    parser.add_argument("--iters", type=int, default=60)
    args = parser.parse_args(argv)
    print(json.dumps(run(args.size, args.iters)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
