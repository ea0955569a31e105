#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``sequitr_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card and
``nvcc``. Imports nothing of JAX or of ``sequitr_tpu``. Phases, each fatal
on failure:

1. the card's name and power limit;
2. build the port's CUDA kernel from ``sequitr_tpu_torch/csrc``;
3. kernel phase: each kernel against its plain PyTorch version on the card,
   at the main path's shape and at ragged ones, then timed (CUDA events,
   median of many) beside its bound, its plain version and a one-call
   PyTorch yardstick;
4. model phase: ``unet2d_cells`` at f32 on the card against the CPU
   (TF32 off), logits within 1e-3 (cuDNN sums in other orders);
5. profile phase: where a served frame's time goes (torch.profiler);
6. serve phase: the ``segmentation_unet2d`` job served by ``ImageServer``
   on the card for two jobs over a 4-frame 1024x1024 uint16 stack, one at
   a time, the kernel's launch count reset just before each job and read
   just after (job (a), the default job, is the main path: its count goes
   in the ``kernels`` line), and job (a)'s labels held against the port's
   f32 exact-normalize path (mIoU >= 0.997).

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA device or
outside a checkout of the repository.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

MIOU_BAR = 0.997
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores, H100 SXM data sheet


def _fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 2


def _median_ms(fn, n: int = 100) -> float:
    """Median device time of ``fn()`` over ``n`` calls, from CUDA events.

    A sleep kernel first holds the stream for twice the time the host takes
    to queue all ``n`` calls, so the events see back-to-back device time,
    not launch overhead.
    """
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    events = [
        (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        for _ in range(n)
    ]
    # cycles at up to 2 GHz: a slower clock only sleeps longer
    torch.cuda._sleep(int(2e9 * (2 * n * enqueue_s + 0.01)))
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    times = sorted(s.elapsed_time(e) for s, e in events)
    return times[n // 2]


def _miou(a, b, k: int) -> float:
    import numpy as np

    ious = []
    for c in range(k):
        p, t = a == c, b == c
        union = np.logical_or(p, t).sum()
        ious.append(1.0 if union == 0 else np.logical_and(p, t).sum() / union)
    return float(np.mean(ious))


def kernel_phase(torch, hist):
    """Histogram kernel vs its plain version: counts integer-equal,
    quantiles equal; then timed at the main path's shape."""
    gen = torch.Generator().manual_seed(20_261_016)

    def gamma(shape, scale):
        # gamma(2, scale) pixels, like fluorescence background, made on the CPU
        e = torch.empty(shape + (2,)).exponential_(generator=gen)
        return (e.sum(-1) * scale).to(torch.float32)

    cases = {
        "frame 1024x1024": gamma((1, 1024 * 1024), 60.0),
        "ragged 1000x1500": gamma((1, 1000 * 1500), 60.0),
        "odd 333x517": gamma((1, 333 * 517), 60.0),
        "volume (4, 32, 500)": gamma((1, 4 * 32 * 500), 1.0),
        "two channels 512x768": torch.cat([gamma((1, 512 * 768), 1.0), gamma((1, 512 * 768), 500.0)]),
        "batch 8 x 256x256": gamma((8, 256 * 256), 60.0),
    }
    max_err = 0
    for name, x_cpu in cases.items():
        x = x_cpu.cuda()
        lo, hi = torch.aminmax(x, dim=1)
        scale = 1023 / torch.clamp_min(hi - lo, 1e-20)
        got = hist.histogram_2d(x, lo, scale)
        want = hist.histogram_2d_reference(x, lo, scale)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        if err or int(got.sum()) != x.numel():
            raise AssertionError(f"histogram counts differ on {name}: max |diff| {err}")
        q_kernel = hist.kernel_quantiles(x, [0.05, 0.995]).cpu()
        q_plain = hist.kernel_quantiles(x_cpu, [0.05, 0.995])
        if not torch.equal(q_kernel, q_plain):
            raise AssertionError(f"quantiles differ on {name}: {q_kernel} vs {q_plain}")
        print(f"kernel histogram_2d {name}: counts equal, quantiles equal {q_kernel.tolist()}")

    x = cases["frame 1024x1024"].cuda()
    lo, hi = torch.aminmax(x, dim=1)
    scale = 1023 / torch.clamp_min(hi - lo, 1e-20)
    lo_f, hi_f = float(lo), float(hi)
    ms = _median_ms(lambda: hist.histogram_2d(x, lo, scale))
    plain_ms = _median_ms(lambda: hist.histogram_2d_reference(x, lo, scale), n=30)
    library_ms = _median_ms(lambda: torch.histc(x, bins=1024, min=lo_f, max=hi_f))
    # the same size with pixels spread evenly over the bins: how much of the
    # time is shared-memory atomics piling onto the background's few bins
    u = torch.rand((1, 1024 * 1024), generator=gen).cuda()
    u_lo, u_hi = torch.aminmax(u, dim=1)
    u_scale = 1023 / torch.clamp_min(u_hi - u_lo, 1e-20)
    u_ms = _median_ms(lambda: hist.histogram_2d(u, u_lo, u_scale))
    print(f"kernel histogram_2d 1024x1024 uniform pixels, 1024 bins: {u_ms:.5f} ms")
    n = x.numel()
    bytes_moved = n * 4 + 2 * 4 + 1024 * 4  # pixels read, lo+scale read, counts written
    ops = n * 4  # subtract, multiply, two clamps per pixel (f32, CUDA cores)
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_FLOPS * 1e3
    entry = {
        "name": "histogram_2d",
        "route": "cuda",
        "source": "sequitr_tpu_torch/csrc/histogram.cu",
        "replaces": "sequitr_tpu/ops/pallas/histogram.py:27",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": library_ms,
    }
    print(
        f"kernel histogram_2d 1024x1024 f32, 1024 bins: {ms:.5f} ms, plain "
        f"{plain_ms:.5f} ms, torch.histc {library_ms:.5f} ms, bound "
        f"{entry['bound_ms']:.5f} ms ({entry['bound_by']})"
    )
    return entry


def model_phase(torch, fixtures, unet):
    """unet2d_cells at f32: the card against the CPU, and its bf16 time."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    _, _, cpu_model, _ = fixtures.load("unet2d_cells", compute_dtype="float32", device="cpu")
    _, _, gpu_model, _ = fixtures.load("unet2d_cells", compute_dtype="float32", device="cuda")
    x = torch.rand((1, 256, 256, 1), generator=torch.Generator().manual_seed(7))
    with torch.inference_mode():
        want = cpu_model(x)
        got = gpu_model(x.cuda()).cpu()
    err = float((got - want).abs().max())
    print(f"model unet2d_cells f32 256x256: card vs CPU max |logit diff| {err:.3g}")
    if not err < 1e-3:
        raise AssertionError(f"card and CPU logits differ by {err}")
    _, _, bf16_model, _ = fixtures.load("unet2d_cells", device="cuda")
    bf16_model = unet.fold_batchnorm(bf16_model)
    frame = torch.rand((1, 1024, 1024, 1), device="cuda")
    with torch.inference_mode():
        fwd_ms = _median_ms(lambda: bf16_model(frame), n=20)
    print(f"model unet2d_cells bf16 folded, 1x1024x1024: forward {fwd_ms:.4f} ms")


def profile_phase(torch, fixtures, unet):
    """Where a served frame's time goes: the labels-only whole-frame path
    (the default job) streaming 1024x1024 uint16 frames, under
    torch.profiler: wall time per frame, the card's busy share, kernels."""
    import numpy as np

    from sequitr_tpu_torch.pipeline import infer

    _, cfg, model, _ = fixtures.load("unet2d_cells", device="cuda")
    model = unet.fold_batchnorm(model)
    tc = infer.TileConfig(
        patch=(1024, 1024), overlap=(0, 0), emit_probs=False, labels_dtype="uint16"
    )
    fn = infer.make_frame_inferrer(cfg, tc, (1024, 1024), device="cuda")
    rng = np.random.default_rng(5)
    frames = [rng.gamma(2.0, 60.0, (1024, 1024)).astype(np.uint16) for _ in range(8)]

    def run():
        for r in infer.infer_stack(fn, model, iter(frames), device="cuda"):
            np.asarray(r.labels)

    run()  # warm up
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [
        e for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    n = len(frames)
    print(
        f"profile labels-only 1024x1024 uint16 x{n}: {wall / n * 1e3:.4f} ms/frame wall, "
        f"card busy {busy / 1e3 / n:.4f} ms/frame ({busy / (wall * 1e6):.3f} of wall), "
        f"{len(kernels) / n:.1f} device ops/frame"
    )
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"profile {us / 1e3 / n:.4f} ms/frame {name[:110]}")


def serve_phase(torch, hist, smi_line):
    """Two segmentation_unet2d jobs through ImageServer on the card."""
    import numpy as np

    from sequitr_tpu_torch import __main__ as cli
    from sequitr_tpu_torch.config import ServerConfiguration
    from sequitr_tpu_torch.data import synthetic, tiff
    from sequitr_tpu_torch.models import fixtures
    from sequitr_tpu_torch.pipeline import infer
    from sequitr_tpu_torch.server import ImageServer, submit_job

    # the dtypes the served path relies on, on the card
    probe = torch.tensor([0, 1, 65535], dtype=torch.int32).to(torch.uint16).cuda()
    if probe.to(torch.float32).cpu().tolist() != [0.0, 1.0, 65535.0]:
        raise AssertionError("uint16 -> float32 on the card")
    if torch.tensor([2, 7], device="cuda").to(torch.uint16).cpu().numpy().tolist() != [2, 7]:
        raise AssertionError("label cast to uint16 on the card")

    with tempfile.TemporaryDirectory() as tmp:
        jobs, models = os.path.join(tmp, "jobs"), os.path.join(tmp, "models")
        arch = os.path.join(tmp, "arch.json")
        with open(arch, "w") as f:
            json.dump(fixtures.manifest()["unet2d_cells"]["config"], f)
        npz = os.path.join(fixtures.fixture_dir(), "unet2d_cells.npz")
        if cli.main(["import-model", "--models-dir", models, "--npz", npz, "--arch", arch, "unet2d_cells"]):
            raise AssertionError("import-model failed")
        scenes = [synthetic.cells_frame(424_000 + i, (1024, 1024)) for i in range(4)]
        frames = np.stack([img for img, _ in scenes]).clip(0, 65535).astype(np.uint16)
        truth_labels = [lab for _, lab in scenes]
        stack = os.path.join(tmp, "stack.tif")
        tiff.write_stack(stack, frames)
        specs = {
            "a": {"localize": False},
            "b": {"localize": False, "save_probs": True, "patch": [512, 512], "overlap": [64, 64]},
        }
        server = ImageServer(ServerConfiguration(jobs_dir=jobs, models_dir=models, device="cuda"))
        launches = {}
        labels_a = None
        # one job at a time, each with its own launch count: job (a) is
        # the main path, job (b) the tiled save_probs path
        for name, params in specs.items():
            submit_job(jobs, {
                "module": "segmentation_unet2d",
                "params": dict(model="unet2d_cells", **params),
                "input": [stack],
                "output": os.path.join(tmp, f"out_{name}"),
            })
            torch.cuda.synchronize()
            hist.histogram_2d.launches = 0
            if not server.poll_once():
                raise AssertionError(f"job {name}: no job to run")
            torch.cuda.synchronize()
            launches[name] = hist.histogram_2d.launches
            with open(os.path.join(tmp, f"out_{name}", "status.json")) as f:
                status = json.load(f)
            if status["state"] != "complete":
                raise AssertionError(f"job {name}: {status.get('error')}")
            labels = tiff.read_stack(status["outputs"]["labels"])
            if labels.shape != (4, 1024, 1024) or labels.dtype != np.uint16:
                raise AssertionError(f"job {name}: labels {labels.shape} {labels.dtype}")
            metrics = json.loads(status["outputs"]["metrics"])
            print(
                f"serve job {name} {json.dumps(params_summary(params))}: "
                f"frames_per_sec {metrics.get('frames_per_sec')} on {smi_line} "
                f"(metrics {json.dumps(metrics)})"
            )
            print(
                f"serve job {name} histogram_2d launches {launches[name]} for "
                f"{metrics['n_frames']} served frames"
            )
            if launches[name] < metrics["n_frames"]:
                raise AssertionError(
                    f"job {name}: histogram kernel launched {launches[name]} times "
                    f"for {metrics['n_frames']} frames"
                )
            if name == "a":
                labels_a = labels
            else:
                probs = tiff.read_stack(status["outputs"]["probs"])
                if probs.shape != (12, 1024, 1024) or not np.isfinite(probs).all():
                    raise AssertionError(f"job b: probs {probs.shape}")

        # reference: the port's f32 exact-normalize path on the card; two
        # more paths split the served path's disagreement between its bf16
        # compute and its 1024-bin kernel normalize
        from sequitr_tpu_torch.models import unet

        def labels_of(dtype, normalize):
            _, cfg, model, _ = fixtures.load("unet2d_cells", compute_dtype=dtype, device="cuda")
            tc = infer.TileConfig(
                patch=(1024, 1024), overlap=(0, 0), normalize=normalize, emit_probs=False
            )
            fn = infer.make_frame_inferrer(cfg, tc, (1024, 1024), device="cuda")
            model = unet.fold_batchnorm(model)
            return cfg.num_classes, [
                fn(model, torch.from_numpy(f).cuda())[1].cpu().numpy() for f in frames
            ]

        k, ref = labels_of("float32", "exact")
        miou = float(np.mean([_miou(a, b, k) for a, b in zip(labels_a, ref)]))
        print(f"serve job a miou_vs_ref {miou:.6f} (bar {MIOU_BAR}; ref: f32, exact normalize, on the card)")
        for dtype, normalize in (("bfloat16", "exact"), ("float32", "pallas")):
            _, other = labels_of(dtype, normalize)
            part = float(np.mean([_miou(a, b, k) for a, b in zip(other, ref)]))
            print(f"serve fidelity split: {dtype} + {normalize} normalize vs ref miou {part:.6f}")
        truth = float(np.mean([_miou(a, b, k) for a, b in zip(labels_a, truth_labels)]))
        truth_ref = float(np.mean([_miou(a, b, k) for a, b in zip(ref, truth_labels)]))
        print(f"serve job a miou_truth {truth:.6f}, ref miou_truth {truth_ref:.6f}")
        if miou < MIOU_BAR:
            raise AssertionError(f"miou_vs_ref {miou} < {MIOU_BAR}")
        return launches["a"]


def params_summary(params):
    return {k: v for k, v in params.items() if k != "localize"}


def main() -> int:
    try:
        import torch
    except ImportError:
        return _fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        return _fail("no CUDA device")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from sequitr_tpu_torch.models import fixtures, unet
        from sequitr_tpu_torch.ops.kernels import build
        from sequitr_tpu_torch.ops.kernels import histogram as hist
    except ImportError as e:
        return _fail(f"run from a checkout of the repository ({e})")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    smi_line = smi[0].strip()
    print(smi_line)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    log = build.build("histogram", force=True)
    print(f"build: histogram in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "ptxas info" in line:
            print(f"build histogram: {line.strip()}")

    entry = kernel_phase(torch, hist)
    model_phase(torch, fixtures, unet)
    profile_phase(torch, fixtures, unet)
    entry["launches"] = serve_phase(torch, hist, smi_line)
    if entry["launches"] < 1:
        raise AssertionError("histogram_2d was not launched on the main path")
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
