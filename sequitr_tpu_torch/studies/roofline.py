"""Whole-graph per-level roofline of the 1024x1024 U-Net forward (port of
``sequitr_tpu.studies.roofline``).

It slices the folded inference graph of the U-Net (depth 4, base 32; bf16
on the card, f32 on the CPU) into its pipeline stages, the JAX package's
nine: the normalize (``infer._normalize``: on the card the quantile-pass
kernel of ``csrc/histogram.cu``), each encoder level (pool + two 3x3
convs), each decoder level (2x2 transposed conv + concat + two 3x3 convs)
and the head (1x1 conv + softmax + argmax); times each stage on its own,
on activations made once by the stages before it; and reports per stage:

* the time per frame and the analytic GFLOP (2 * K^d * C_in * C_out * H * W
  a conv, the JAX package's count) and the achieved TFLOP/s;
* the stage's measured ceiling: the summed times of its raw convs (cuDNN,
  compute dtype in and out, no bias or cast) alone at identical shapes, and
  the stage's share of it;
* the coverage check: the sum of the stage times against the whole
  frame inferrer's (``infer.make_frame_inferrer``) per-call time.

Timing. The JAX package amortizes dispatch by running a stage ``iters``
times under one ``lax.scan`` in one jit (``_rate_scan``). Its counterpart on
the card is one CUDA graph that holds ``iters`` calls of the stage,
captured once and replayed, timed by CUDA events around one replay
(``_rate_graph``): like the scan, the replay issues every call with no host
launch between them, so a stage of 0.01 ms is timed as the card runs it,
not as Python queues it, and the calls run back to back on the inputs the
previous stages left, warm in L2 when they fit, as in the scan. The whole
frame inferrer is timed per call with a sync (``_rate``), as the JAX package
times its fused graph. On the CPU both are host clocks and measure the
CPU's kernels, not the card's.

Run on the card (JSON lines and a markdown table to stdout):

    python -m sequitr_tpu_torch.studies.roofline [--iters 24] [--size 1024]
"""

from __future__ import annotations

import argparse
import functools
import json
import time
from typing import Callable, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from sequitr_tpu_torch.utils import resolve_device

__all__ = ["run", "main"]


def _rate(step: Callable, iters: int, warmup: int = 3) -> float:
    """Seconds per call of ``step()``, synced after the last call (the
    whole frame inferrer: the JAX package's per-dispatch method)."""
    for _ in range(warmup):
        step()
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    _sync()
    return (time.perf_counter() - t0) / iters


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _rate_graph(fn: Callable, args: Sequence[torch.Tensor], iters: int) -> float:
    """Seconds per call of ``fn(*args)`` with the launches amortized: on
    the card one CUDA graph of ``iters`` calls, replayed once warm and once
    between two events; on the CPU a host clock around ``iters`` calls."""
    if not args[0].is_cuda:
        fn(*args)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm: libraries, kernels, scratch
        for _ in range(3):
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn(*args)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end)
    del graph
    return ms / 1e3 / iters


def _conv_flops(k: int, cin: int, cout: int, spatial) -> float:
    return 2.0 * (k ** len(spatial)) * cin * cout * float(np.prod(spatial))


def run(size: int = 1024, iters: int = 24, device=None):
    """The stage table of a ``size`` x ``size`` frame: ``(rows, summary)``
    with the JAX package's keys and stage names (rows: ``stage``, ``ms``,
    ``gflop``, ``tflops``, ``ceiling_ms``, ``pct_of_ceiling``; the summary:
    ``ms``, ``fused_ms``, ``gflop``, ``tflops_fused``, ``coverage_pct``).
    ``device`` defaults to the card; the weights are ``unet.init``'s from
    seed 0, the frame gamma(2, 100) noise from numpy seed 0."""
    from sequitr_tpu_torch.models import unet
    from sequitr_tpu_torch.pipeline import infer as infer_lib

    device = resolve_device(device)
    cfg = unet.UNetConfig(
        in_channels=1, num_classes=3, depth=4, base_features=32,
        compute_dtype="bfloat16" if device.type == "cuda" else "float32",
    )
    model = unet.init(cfg, torch.Generator().manual_seed(0), device)
    net = unet.fold_batchnorm(model)
    cdt = cfg.torch_dtype

    rng = np.random.default_rng(0)
    frame = torch.as_tensor(rng.gamma(2.0, 100.0, (size, size)).astype(np.float32), device=device)
    tc = infer_lib.TileConfig(patch=(size, size), overlap=(0, 0))

    # ---- the whole frame inferrer (reference total) ----
    full = infer_lib.make_frame_inferrer(cfg, tc, (size, size), device)
    with torch.inference_mode():
        t_full = _rate(lambda: full(net, frame), iters)

    # ---- stage slices (the model's own functions), NCHW channels-last views ----
    feats = [cfg.features(lvl) for lvl in range(cfg.depth)]  # [32, 64, 128, 256]

    def stage_norm(f):
        x = infer_lib._normalize(f[None, ..., None], tc)
        return torch.movedim(x, -1, 1).to(cdt)

    def block_stage(x, blk):
        return net._block(x, blk)

    def pool_block_stage(x, blk):
        return net._block(net._pool(x), blk)

    def dec_stage(x, skip, up, blk):
        y = net._upsample(x, up)
        return net._block(torch.cat([skip, y.to(skip.dtype)], dim=1), blk)

    def stage_head(x):
        logits = net._conv(x, net.head).to(torch.float32)
        return torch.softmax(logits, dim=1), torch.argmax(logits, dim=1).to(torch.int32)

    rows = []
    with torch.inference_mode():
        # materialized inter-stage activations
        acts: Dict[str, torch.Tensor] = {}
        x = stage_norm(frame)
        acts["enc0_in"] = x
        x = block_stage(x, net.enc[0])
        acts["enc0"] = x
        for lvl in (1, 2, 3):
            x = pool_block_stage(x, net.enc[lvl])
            acts[f"enc{lvl}"] = x
        skips = [acts["enc0"], acts["enc1"], acts["enc2"]]
        for i, lvl in enumerate((2, 1, 0)):
            x = dec_stage(x, skips[lvl], net.up[i], net.dec[i])
            acts[f"dec{lvl}"] = x

        # ---- isolated raw-conv ceilings (same timing) ----
        conv_cache: Dict = {}

        def raw(spatial, cin):
            xx = torch.randn((1, cin, *spatial), generator=torch.Generator().manual_seed(cin), dtype=torch.float32)
            return unet.channels_last(xx.to(device=device, dtype=cdt))

        def conv_time(spatial, cin, cout, k=3) -> float:
            key = (tuple(spatial), cin, cout, k)
            if key not in conv_cache:
                w = unet.channels_last(torch.randn((cout, cin, k, k), dtype=torch.float32).to(device, cdt))
                conv_cache[key] = _rate_graph(
                    lambda x_, w_: F.conv2d(x_, w_, padding=k // 2), (raw(spatial, cin), w), iters
                )
            return conv_cache[key]

        def tconv_time(spatial_in, cin, cout) -> float:
            key = ("t", tuple(spatial_in), cin, cout)
            if key not in conv_cache:
                w = unet.channels_last(torch.randn((cin, cout, 2, 2), dtype=torch.float32).to(device, cdt))
                conv_cache[key] = _rate_graph(
                    lambda x_, w_: F.conv_transpose2d(x_, w_, stride=2), (raw(spatial_in, cin), w), iters
                )
            return conv_cache[key]

        def add_row(name, fn, args, flops, ceiling_s):
            t = _rate_graph(fn, args, iters)
            rows.append({
                "stage": name,
                "ms": t * 1e3,
                "gflop": round(flops / 1e9, 2),
                "tflops": flops / t / 1e12,
                "ceiling_ms": ceiling_s * 1e3,
                "pct_of_ceiling": 100 * ceiling_s / t if ceiling_s else 0.0,
            })

        add_row("normalize", stage_norm, (frame,), 0.0, 0.0)
        s0 = (size, size)
        add_row(
            "enc0 (1024², 1→32→32)",
            lambda x: block_stage(x, net.enc[0]),
            (acts["enc0_in"],),
            _conv_flops(3, 1, 32, s0) + _conv_flops(3, 32, 32, s0),
            conv_time(s0, 1, 32) + conv_time(s0, 32, 32),
        )
        for lvl in (1, 2, 3):
            sp = (size >> lvl, size >> lvl)
            cin, cout = feats[lvl - 1], feats[lvl]
            add_row(
                f"enc{lvl} ({sp[0]}², {cin}→{cout}→{cout})",
                functools.partial(pool_block_stage, blk=net.enc[lvl]),
                (acts[f"enc{lvl - 1}"],),
                _conv_flops(3, cin, cout, sp) + _conv_flops(3, cout, cout, sp),
                conv_time(sp, cin, cout) + conv_time(sp, cout, cout),
            )
        for i, lvl in enumerate((2, 1, 0)):
            sp = (size >> lvl, size >> lvl)
            sp_in = (size >> (lvl + 1), size >> (lvl + 1))
            cin = feats[lvl + 1]  # channels arriving from below
            cskip = cout = feats[lvl]
            src = acts[f"enc{lvl + 1}"] if i == 0 else acts[f"dec{lvl + 1}"]
            add_row(
                f"dec{lvl} ({sp[0]}², up{cin}→{cout} ⊕{cskip} →{cout})",
                functools.partial(dec_stage, up=net.up[i], blk=net.dec[i]),
                (src, skips[lvl]),
                2.0 * 4 * cin * cout * float(np.prod(sp_in))
                + _conv_flops(3, cskip + cout, cout, sp)
                + _conv_flops(3, cout, cout, sp),
                tconv_time(sp_in, cin, cout) + conv_time(sp, cskip + cout, cout) + conv_time(sp, cout, cout),
            )
        add_row(
            "head (1x1→3 + softmax/argmax)",
            stage_head, (acts["dec0"],),
            _conv_flops(1, feats[0], cfg.num_classes, s0),
            0.0,
        )

        # the sliced chain is the forward: its labels against the model's own
        chain = stage_head(acts["dec0"])[1]
        whole = torch.argmax(net(torch.movedim(acts["enc0_in"], 1, -1)), dim=-1)
        agreement = float((chain[0] == whole[0]).to(torch.float32).mean())

    total_ms = sum(r["ms"] for r in rows)
    total_gflop = sum(r["gflop"] for r in rows)
    summary = {
        "stage": "TOTAL (sliced) vs fused",
        "ms": total_ms,
        "fused_ms": t_full * 1e3,
        "gflop": round(total_gflop, 2),
        "tflops_fused": total_gflop / 1e3 / t_full,
        # whole/sliced: the share of the sliced sum the whole inferrer needs
        "coverage_pct": 100 * (t_full * 1e3) / total_ms,
        "chain_argmax_agreement": agreement,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }
    return rows, summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--size", type=int, default=1024)
    ap.add_argument("--device", default=None, help="default: the CUDA card")
    args = ap.parse_args(argv)
    rows, summary = run(args.size, args.iters, args.device)
    for r in rows:
        print(json.dumps(r))
    print(json.dumps(summary))
    print()
    print("| stage | ms | GFLOP | TFLOP/s | ceiling ms | % of ceiling |")
    print("|---|---|---|---|---|---|")
    for r in rows:
        print(
            f"| {r['stage']} | {r['ms']:.5f} | {r['gflop']} | {r['tflops']:.3f} "
            f"| {r['ceiling_ms']:.5f} | {r['pct_of_ceiling']:.1f} |"
        )
    print(
        f"| TOTAL sliced {summary['ms']:.5f} ms vs whole {summary['fused_ms']:.5f} ms "
        f"| {summary['gflop']} GFLOP | whole {summary['tflops_fused']:.3f} TFLOP/s "
        f"| coverage {summary['coverage_pct']:.1f}% | |"
    )


if __name__ == "__main__":
    main()
