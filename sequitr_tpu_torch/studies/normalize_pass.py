"""What the percentile normalize costs on the card, for one checkout's port.

    python sequitr_tpu_torch/studies/normalize_pass.py
    python sequitr_tpu_torch/studies/normalize_pass.py --root <other checkout>

Imports ``sequitr_tpu_torch`` from ``--root`` (default: the checkout that
holds this file) and times, on one 1024x1024 f32 frame of gamma(2, 60)
pixels: ``histogram_2d`` with lo and scale given, ``kernel_quantiles`` as
called, and ``torch.histc`` as a yardstick; ``histogram_2d`` again on
uniform pixels and on a flat background (nearly every pixel in two bins);
then ``infer._normalize`` on a 1024x1024 uint16 frame of
``synthetic.cells_frame``: its CUDA-event time and, under
``torch.profiler``, its device operations and device time per frame. It
uses only entry points that every checkout of the port has, so two
checkouts run in one call compare on one card. The frames are timed warm
in L2, as the served path finds them (the frame was just cast on the card).
``--parts`` (this checkout's kernels only) builds ``csrc/histogram.cu``
with parts left out by its ``HISTOGRAM_*`` switches, and at other block
shapes, grids and accumulator copies, and times each build (the results of
a cut build are wrong by design and are not looked at).
Needs a CUDA card; prints one line per number.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

QS = [0.05, 0.995]


def _gamma(torch, gen, n, scale):
    e = torch.empty((1, n, 2)).exponential_(generator=gen)
    return (e.sum(-1) * scale).to(torch.float32)


def _profile(torch, fn, reps=20):
    """Device operations a call, device ms a call (the sum of the
    operations' own durations: no launch gaps) and that sum by name."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in ops:
        key = e.name.split("(")[0][-40:]
        by_name[key] = by_name.get(key, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / reps
    return len(ops) / reps, sum(by_name.values()), by_name


def _by_name(by_name):
    return ", ".join(f"{k} {v:.5f}" for k, v in sorted(by_name.items(), key=lambda kv: -kv[1]))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    parser.add_argument("--root", default=here, help="checkout whose sequitr_tpu_torch to import")
    parser.add_argument("--parts", action="store_true", help="time builds with parts left out")
    parser.add_argument("--calls", type=int, default=100, help="calls a median is taken over")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("normalize_pass: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    import sequitr_tpu_torch
    from sequitr_tpu_torch.data import synthetic
    from sequitr_tpu_torch.ops.kernels import histogram as hist
    from sequitr_tpu_torch.pipeline import infer
    from sequitr_tpu_torch.utils import device_median_ms

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    tag = f"[{os.path.dirname(os.path.dirname(os.path.abspath(sequitr_tpu_torch.__file__)))}; {smi}]"
    gen = torch.Generator().manual_seed(20_261_016)
    n = 1024 * 1024
    x = _gamma(torch, gen, n, 60.0).cuda()
    lo, hi = torch.aminmax(x, dim=1)
    d = torch.clamp_min(hi - lo, 1e-20)
    scale = torch.full_like(d, 1023) / d
    lo_f, hi_f = float(lo), float(hi)
    calls = args.calls

    # CUDA events around each call, the stream held while the calls queue;
    # a call of many operations is timed over fewer calls, so that the
    # queued launches do not outgrow the launch queue and wait for the host
    for name, fn in (
        ("histogram_2d 1024x1024 f32, 1024 bins, lo and scale given", lambda: hist.histogram_2d(x, lo, scale)),
        ("kernel_quantiles 1024x1024 f32, 1024 bins, as called", lambda: hist.kernel_quantiles(x, QS)),
    ):
        ms = device_median_ms(fn, calls)
        few_ms = device_median_ms(fn, 20)
        ops, dev_ms, by_name = _profile(torch, fn)
        print(
            f"normalize_pass {name}: {ms:.5f} ms ({calls} calls), {few_ms:.5f} ms (20 calls); "
            f"{ops:.1f} device ops, {dev_ms:.5f} device ms a call ({_by_name(by_name)}) {tag}"
        )
    histc_ms = device_median_ms(lambda: torch.histc(x, bins=1024, min=lo_f, max=hi_f), calls)
    print(f"normalize_pass torch.histc 1024x1024 f32, 1024 bins: {histc_ms:.5f} ms {tag}")
    for name, y in (
        ("uniform pixels", torch.rand((1, n), generator=gen).cuda()),
        # a flat background: all but 1% of the pixels in two bins of 1024
        ("flat background", (100.0 + (torch.rand((1, n), generator=gen) < 0.5).float()
                             + 900.0 * (torch.rand((1, n), generator=gen) < 0.01).float()).cuda()),
    ):
        y_lo, y_hi = torch.aminmax(y, dim=1)
        y_d = torch.clamp_min(y_hi - y_lo, 1e-20)
        y_scale = torch.full_like(y_d, 1023) / y_d
        y_ms = device_median_ms(lambda: hist.histogram_2d(y, y_lo, y_scale), calls)
        print(f"normalize_pass histogram_2d 1024x1024 {name}: {y_ms:.5f} ms {tag}")

    frame, _ = synthetic.cells_frame(424_000, (1024, 1024))
    frames = torch.from_numpy(frame.clip(0, 65535).astype("uint16"))[None, ..., None].cuda()
    tc = infer.TileConfig()
    norm_ms = device_median_ms(lambda: infer._normalize(frames, tc), 20)
    ops, dev_ms, by_name = _profile(torch, lambda: infer._normalize(frames, tc))
    print(
        f"normalize_pass infer._normalize 1024x1024 uint16 (auto: the kernels): {norm_ms:.5f} ms "
        f"as called (20 calls), {ops:.1f} device ops and {dev_ms:.5f} device ms a frame "
        f"(torch.profiler, 20 frames) {tag}"
    )
    print(f"normalize_pass infer._normalize by operation: {_by_name(by_name)}")

    if args.parts:
        _parts(torch, hist, x, lo, scale, calls, tag)
    return 0


def _time_pair(torch, hist, what, calls, tag, counting, whole_pass):
    """histogram_2d and the quantile pass: CUDA-event medians and the
    kernels' own device time (profiler)."""
    from sequitr_tpu_torch.utils import device_median_ms

    out = []
    for fn in (counting, whole_pass):
        ms = device_median_ms(fn, calls)
        _, dev_ms, by_name = _profile(torch, fn)
        out.append(f"{ms:.5f} ms, kernels {dev_ms:.5f} ms ({_by_name(by_name)})")
    print(f"normalize_pass {what}: histogram_2d {out[0]}; quantile_pass {out[1]} {tag}")


# name -> switches of csrc/histogram.cu that are set for it
PARTS = {
    "empty": ("HISTOGRAM_EMPTY",),
    "without_ticket": ("HISTOGRAM_WITHOUT_TICKET",),
    "without_tail": ("HISTOGRAM_WITHOUT_TAIL",),
    "without_merge": ("HISTOGRAM_WITHOUT_MERGE",),
    "without_count": ("HISTOGRAM_WITHOUT_COUNT",),
    "loads_alone": ("HISTOGRAM_WITHOUT_COUNT", "HISTOGRAM_WITHOUT_MERGE", "HISTOGRAM_WITHOUT_TICKET"),
    "one_copy": ("HISTOGRAM_COPIES=1",),
    "copies_8": ("HISTOGRAM_COPIES=8",),
    "threads_1024": ("HISTOGRAM_THREADS=1024",),
    "two_blocks_an_sm_of_256": ("HISTOGRAM_THREADS=256", "HISTOGRAM_BLOCKS_PER_SM=2"),
}


def _parts(torch, hist, x, lo, scale, calls, tag):
    """Each build of PARTS in place of the kernels' library, on a scratch
    of its own (a cut build may leave it dirty)."""
    from concurrent.futures import ThreadPoolExecutor

    from sequitr_tpu_torch.ops.kernels import build

    def load(item):
        name, defines = item
        lib = build.load("histogram", defines=defines, variant=name)
        hist._bind(lib)
        return lib

    with ThreadPoolExecutor(len(PARTS)) as pool:  # one nvcc a build, together
        libs = dict(zip(PARTS, pool.map(load, PARTS.items())))
    whole, scratch = hist._library(), dict(hist._SCRATCH)
    try:
        for name, lib in [("whole", whole)] + list(libs.items()):
            hist._lib = lib
            hist._SCRATCH.clear()
            _time_pair(
                torch, hist, f"parts {name}", calls, tag,
                lambda: hist.histogram_2d(x, lo, scale), lambda: hist.quantile_pass(x, QS),
            )
    finally:
        hist._lib = whole
        hist._SCRATCH.clear()
        hist._SCRATCH.update(scratch)


if __name__ == "__main__":
    sys.exit(main())
