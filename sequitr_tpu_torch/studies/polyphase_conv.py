"""Standard against polyphase serving forward: error and time.

Counterpart of ``sequitr_tpu/studies/polyphase_conv.py``. The transform
itself lives in ``models.polyphase`` (it serves jobs, ``polyphase: true``);
this module is the A/B that says what it buys on a card:

    python -m sequitr_tpu_torch.studies.polyphase_conv [--size 1024] [--iters 24]

For f32 (TF32 off) and bf16 it runs the folded ``unet2d_cells`` fixture both
ways on one ``size`` x ``size`` frame and prints the relative error, the
argmax agreement and the median time of each forward from CUDA events (host
clock on the CPU), then one JSON line. The arithmetic ledger, stated up
front: the dense phase conv spends 4x the multiply-adds of the thin conv it
replaces, traded against four times the channels per pixel and a quarter of
the pixels for every elementwise pass of level 0.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Union

import numpy as np
import torch

from sequitr_tpu_torch.models import fixtures, polyphase, unet
from sequitr_tpu_torch.models.polyphase import phase_kernel, phase_up_kernel
from sequitr_tpu_torch.utils import resolve_device

__all__ = ["phase_kernel", "phase_up_kernel", "polyphase_apply", "median_ms", "run", "main"]


def polyphase_apply(model: unet.UNet, x: torch.Tensor) -> torch.Tensor:
    """Study-facing alias of ``models.polyphase.apply``."""
    return polyphase.apply(model, x)


def median_ms(fn: Callable[[], object], iters: int, device: torch.device) -> float:
    """Median time of ``fn()`` in ms over ``iters`` calls after 3 warm-ups:
    CUDA events around each call on a card, the host clock on the CPU."""
    for _ in range(3):
        fn()
    if device.type != "cuda":
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[iters // 2]
    torch.cuda.synchronize(device)
    events = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(iters)
    ]
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize(device)
    return sorted(s.elapsed_time(e) for s, e in events)[iters // 2]


def run(
    size: int = 1024, iters: int = 24, device: Union[str, torch.device, None] = None
) -> dict:
    """Measure the standard and the polyphase forward on ``device`` (default
    the CUDA card). Returns timings and exactness per compute dtype."""
    device = resolve_device(device)
    # the f32 comparison is about reassociation, not TF32 rounding
    tf32 = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    results: dict = {
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "size": size,
    }
    x = torch.tensor(
        np.random.default_rng(0).gamma(2.0, 100.0, (1, size, size, 1)).astype(np.float32)
    )
    x = (x / x.max()).to(device)
    try:
        for dtype_name in ("float32", "bfloat16"):
            _, _, model, _ = fixtures.load(
                "unet2d_cells", compute_dtype=dtype_name, device=device
            )
            model = unet.fold_batchnorm(model)
            poly = polyphase.Polyphase(model)
            with torch.inference_mode():
                yb, yp = model(x), poly(x)
                err = float((yb - yp).abs().max())
                scale = float(yb.abs().max())
                agree = float((yb.argmax(-1) == yp.argmax(-1)).float().mean())
                t_base = median_ms(lambda: model(x), iters, device)
                t_poly = median_ms(lambda: poly(x), iters, device)
            results[dtype_name] = {
                "max_abs_err": err,
                "rel_err": err / max(scale, 1e-9),
                "argmax_agree": agree,
                "base_ms": t_base,
                "poly_ms": t_poly,
                "speedup": t_base / t_poly,
            }
            print(
                f"[{dtype_name}] rel_err {err / max(scale, 1e-9):.2e} "
                f"argmax agree {agree:.6f}  base {t_base:.4f} ms vs "
                f"poly {t_poly:.4f} ms ({t_base / t_poly:.3f}x) on {results['device']}",
                flush=True,
            )
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    res = run(args.size, args.iters, args.device)
    res["wall_s"] = round(time.perf_counter() - t0, 1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
