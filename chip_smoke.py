#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``sequitr_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA Hopper card and
``nvcc``. Imports nothing of JAX or of ``sequitr_tpu``. Phases, each fatal
on failure:

1. the card's name and power limit;
2. build the port's CUDA kernels from ``sequitr_tpu_torch/csrc``, one
   ``nvcc`` per source, all started together;
3. kernel phase: each kernel against its plain PyTorch version on the card,
   at its path's shapes and at ragged ones, then timed (CUDA events, median
   of many) beside its bound, its plain version and a PyTorch yardstick;
4. studies phase: ``enc0`` of the folded bf16 ``unet2d_cells`` (1 -> 32 ->
   32 channels) on a normalized 1024x1024 frame, chained through each of the
   three conv study entry points, the launch counts reset before each chain
   and read after it, each result held against the ``UNet``'s own block;
5. model phase: ``unet2d_cells`` at f32 on the card against the CPU
   (TF32 off), logits within 1e-3 (cuDNN sums in other orders);
6. polyphase phase: ``models.polyphase`` against the standard forward on
   the card, f32 (TF32 off) at 256x256 and bf16 at 1024x1024, both timed;
7. profile phase: where a served frame's time goes (torch.profiler);
8. serve phase: the ``segmentation_unet2d`` job served by ``ImageServer``
   on the card for three jobs over a 4-frame 1024x1024 uint16 stack, one at
   a time, every kernel's launch count reset just before each job and read
   just after (job (a), the default job, is the served main path: its
   histogram count goes in the ``kernels`` line; it launches the conv study
   kernels 0 times, as the JAX package's server never reaches its study
   kernels), job (a)'s labels held against the port's f32 exact-normalize
   path (mIoU >= 0.997), and job (c), ``polyphase: true``, held against
   job (a)'s labels.

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
H100_BF16_FLOPS = 989e12  # bf16 tensor cores, dense, H100 SXM data sheet
F32_CONV_BAR = 1e-4  # sums of <= 576 products of unit-scale values, reordered
BF16_EQUAL_BAR = 0.999  # share of outputs bit-equal to the plain version's
BF16_STEPS_BAR = 2  # and no output further than this many bf16 values away
POLY_AGREE_BAR = 0.999


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


def _bf16_steps(torch, got, want):
    """|got - want| in bf16 steps of the larger value (a step is at most
    2^-7 of it), after taking off the 1e-4 that the f32 sums behind the two
    roundings may differ by: near zero a representable-value count would
    call 1e-7 against 0 thousands of steps."""
    g, w = got.float(), want.float()
    scale = torch.maximum(g.abs(), w.abs()) * 2.0**-7
    excess = ((g - w).abs() - F32_CONV_BAR).clamp_min(0.0)
    return torch.where(excess > 0, excess / scale.clamp_min(1e-30), excess)


def _hold_bf16(torch, what, got, want):
    """The bf16 bar: >= 99.9% of outputs bit-equal, none over two steps."""
    equal = float((got == want).float().mean())
    worst = float(_bf16_steps(torch, got, want).max())
    if equal < BF16_EQUAL_BAR or worst > BF16_STEPS_BAR:
        raise AssertionError(
            f"{what}: {equal:.6f} of outputs equal (bar {BF16_EQUAL_BAR}), "
            f"worst {worst:.3g} bf16 steps (bar {BF16_STEPS_BAR})"
        )
    return equal, worst


def _conv_entries(torch):
    """The three conv study entry points behind one calling convention:
    name -> (run(x_hwc, w, b) -> (H, W, C_out), flat-layout pieces or None)."""
    from sequitr_tpu_torch.studies import conv2d, conv2d_gemm as g, conv2d_gemm2 as g2

    def flat(flatten, conv, unflatten):
        def run(x, w, b):
            h, w_img = x.shape[:2]
            return unflatten(conv(flatten(x), w, b, h, w_img), h, w_img)

        return run

    return {
        "conv3x3_bias_act": (conv2d.conv3x3_bias_act, None),
        "conv3x3_gemm": (
            flat(g.flatten_chw, g.conv3x3_gemm, g.unflatten_chw),
            (g.flatten_chw, g.conv3x3_gemm, g.repad_chw, g.unflatten_chw, lambda w: w + 8),
        ),
        "conv3x3_gemm2": (
            flat(g2.flatten_chw2, g2.conv3x3_gemm2, g2.unflatten_chw2),
            (g2.flatten_chw2, g2.conv3x3_gemm2, g2.repad_chw2, g2.unflatten_chw2, g2.wb2),
        ),
    }


REPLACES = {
    "conv3x3_bias_act": "sequitr_tpu/studies/pallas_conv2d.py:43",
    "conv3x3_gemm": "sequitr_tpu/studies/pallas_conv2d_gemm.py:75",
    "conv3x3_gemm2": "sequitr_tpu/studies/pallas_conv2d_gemm2.py:67",
}


def conv_kernel_phase(torch, conv):
    """Each conv entry point against its plain version on the card (TF32
    off), at the shapes of the CPU tests, ragged ones, C_in = 1 and the
    full-width bf16 shapes; then timed at 1024x1024 32 -> 32 bf16, ReLU."""
    import torch.nn.functional as F

    from sequitr_tpu_torch.studies import conv2d_gemm as g

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(20_261_017)
    cases = [
        (64, 128, 16, 8, torch.float32),
        (64, 64, 32, 16, torch.float32),
        (32, 120, 16, 8, torch.float32),
        (333, 517, 3, 5, torch.float32),
        (1024, 1024, 1, 32, torch.float32),
        (1024, 1024, 32, 32, torch.bfloat16),
        (1024, 1024, 64, 32, torch.bfloat16),
    ]
    entries = _conv_entries(torch)
    max_err = {name: 0.0 for name in entries}
    timed = wide = None
    for h, w_img, c_in, c_out, dtype in cases:
        x = torch.randn((h, w_img, c_in), generator=gen).to(dtype).cuda()
        w = (torch.randn((3, 3, c_in, c_out), generator=gen) * 0.1).cuda()
        b = torch.randn((c_out,), generator=gen).cuda()
        wk, bk = conv.pack_weights(w, b, dtype)
        shape = f"{h}x{w_img} {c_in}->{c_out} {str(dtype).split('.')[-1]}"
        if (h, c_in, c_out, dtype) == (1024, 32, 32, torch.bfloat16):
            timed = (x, w, b, wk, bk)
        if (h, c_in, c_out, dtype) == (1024, 64, 32, torch.bfloat16):
            wide = (x, w, b)
        for name, (run, flat) in entries.items():
            if flat is None:
                got = run(x, w, b)
                want = conv.conv3x3_nhwc_reference(x, wk, bk)
            else:
                flatten, conv_fn, _, _, wb_of = flat
                wb = wb_of(w_img)
                xf = flatten(x)
                got = conv_fn(xf, w, b, h, w_img)
                want = conv.conv3x3_flat_chw_reference(xf, wk, bk, h, w_img, wb, g.MARGIN)
                cols = got.reshape(c_out, h, wb)
                if bool((cols[:, :, 0] != 0).any()) or bool((cols[:, :, w_img + 1:] != 0).any()):
                    raise AssertionError(f"{name} {shape}: pad columns are not zero")
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != dtype:
                raise AssertionError(f"{name} {shape}: {got.shape} {got.dtype}")
            if dtype == torch.float32:
                err = float((got - want).abs().max())
                max_err[name] = max(max_err[name], err)
                if not err <= F32_CONV_BAR:
                    raise AssertionError(f"{name} {shape}: max |diff| {err} > {F32_CONV_BAR}")
                print(f"kernel {name} {shape}: max |diff| vs plain {err:.3g} (bar {F32_CONV_BAR})")
            else:
                equal, worst = _hold_bf16(torch, f"{name} {shape}", got, want)
                print(
                    f"kernel {name} {shape}: {equal:.6f} of outputs equal to plain "
                    f"(bar {BF16_EQUAL_BAR}), worst {worst:.3g} bf16 steps (bar {BF16_STEPS_BAR})"
                )

    # timing at the full-width shape of the studies: 1024x1024, 32 -> 32, bf16
    x, w, b, wk, bk = timed
    h, w_img, c_in = x.shape
    c_out = w.shape[-1]
    xc = x.permute(2, 0, 1)[None]  # NCHW view with channels_last strides
    wc = w.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)

    def library():
        # the ops the served U-Net uses for the same function
        y = F.conv2d(xc, wc, padding=1)
        return torch.relu(y.to(torch.float32) + b.view(1, -1, 1, 1)).to(torch.bfloat16)

    # cuDNN's conv alone (no bias, no ReLU, bf16 out): what the fused kernel's
    # product is up against, beside the whole chain it replaces
    conv_only_ms = _median_ms(lambda: F.conv2d(xc, wc, padding=1))
    print(f"kernel yardstick 1024x1024 32->32 bf16: F.conv2d alone {conv_only_ms:.5f} ms")
    ops = 2 * 9 * c_in * c_out * h * w_img
    out = []
    for name, (run, flat) in entries.items():
        if flat is None:
            ms = _median_ms(lambda: run(x, w, b))
            plain_ms = _median_ms(lambda: conv.conv3x3_nhwc_reference(x, wk, bk), n=20)
            in_elems, out_elems = x.numel(), h * w_img * c_out
        else:
            flatten, conv_fn, _, _, wb_of = flat
            wb = wb_of(w_img)
            xf = flatten(x)
            ms = _median_ms(lambda: conv_fn(xf, w, b, h, w_img))
            plain_ms = _median_ms(
                lambda: conv.conv3x3_flat_chw_reference(xf, wk, bk, h, w_img, wb, g.MARGIN), n=20
            )
            in_elems, out_elems = xf.numel(), c_out * h * wb
        library_ms = _median_ms(library)
        # each input read once, each output written once, padding included
        bytes_moved = 2 * (in_elems + out_elems + wk.numel()) + 4 * bk.numel()
        t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
        t_ops = ops / H100_BF16_FLOPS * 1e3
        entry = {
            "name": name,
            "route": "cuda",
            "source": "sequitr_tpu_torch/csrc/conv3x3.cu",
            "replaces": REPLACES[name],
            "launches": None,
            "max_abs_err": max_err[name],
            "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": library_ms,
        }
        print(
            f"kernel {name} 1024x1024 32->32 bf16 relu: {ms:.5f} ms, plain {plain_ms:.5f} ms, "
            f"F.conv2d + cast + bias + relu + cast {library_ms:.5f} ms, bound "
            f"{entry['bound_ms']:.5f} ms ({entry['bound_by']}: {bytes_moved} bytes, {ops} operations)"
        )
        out.append(entry)
    # the wider level-0 conv (dec0's first: 64 -> 32), kernel times only
    x, w, b = wide
    for name, (run, flat) in entries.items():
        xin = x if flat is None else flat[0](x)
        fn = run if flat is None else (lambda xf, w_, b_, f=flat[1]: f(xf, w_, b_, h, w_img))
        print(f"kernel {name} 1024x1024 64->32 bf16 relu: {_median_ms(lambda: fn(xin, w, b)):.5f} ms")
    return out


def studies_phase(torch, fixtures, unet, conv):
    """This slice's path at full width: enc0 of the folded bf16
    unet2d_cells on a normalized 1024x1024 frame, chained through each conv
    study entry point. Returns {entry name: kernel launches of its chain}."""
    from sequitr_tpu_torch.data import synthetic
    from sequitr_tpu_torch.pipeline import infer

    _, _, model, _ = fixtures.load("unet2d_cells", device="cuda")
    model = unet.fold_batchnorm(model)
    frame, _ = synthetic.cells_frame(424_010, (1024, 1024))
    frames = torch.from_numpy(frame.clip(0, 65535).astype("uint16"))[None, ..., None].cuda()
    x32 = infer._normalize(frames, infer.TileConfig())  # (1, H, W, 1) f32, the served normalize
    blk = model.enc[0]
    with torch.inference_mode():
        want = model._block(x32.permute(0, 3, 1, 2), blk)[0].permute(1, 2, 0).to(torch.bfloat16)
    x = x32[0].to(torch.bfloat16)
    h, w_img = x.shape[:2]
    layers = [
        (c.w.permute(2, 3, 1, 0).contiguous(), c.b) for c in (blk.conv1, blk.conv2)
    ]  # OIHW -> HWIO
    # the same chain through the plain version: the kernels' own rounding points
    plain = x
    for w, b in layers:
        plain = conv.conv3x3_nhwc_reference(plain, *conv.pack_weights(w, b, torch.bfloat16))
    launches = {}
    for name, (run, flat) in _conv_entries(torch).items():
        torch.cuda.synchronize()
        conv.conv3x3_nhwc.launches = 0
        conv.conv3x3_flat_chw.launches = 0
        if flat is None:
            y = x
            for w, b in layers:
                y = run(y, w, b)
        else:
            flatten, conv_fn, repad, unflatten, _ = flat
            y = conv_fn(flatten(x), *layers[0], h, w_img)
            # the first output, re-padded as the layout contract says
            y = conv_fn(repad(y, w_img), *layers[1], h, w_img)
            y = unflatten(y, h, w_img)
        torch.cuda.synchronize()
        launches[name] = conv.conv3x3_nhwc.launches + conv.conv3x3_flat_chw.launches
        if tuple(y.shape) != (h, w_img, 32) or not bool(torch.isfinite(y.float()).all()):
            raise AssertionError(f"studies {name}: output {tuple(y.shape)}")
        if launches[name] != 2:
            raise AssertionError(f"studies {name}: {launches[name]} launches, expected 2")
        # Two bars. Against the plain chain (the kernels' own rounding
        # points): >= 99.9% of outputs bit-equal. Against the UNet's block,
        # which rounds each conv's output to bf16 before its f32 bias add
        # and again at the next conv's input, where the kernel rounds once,
        # after bias and ReLU: no share is asked. Both: no output further
        # away than two bf16 steps at the scale of the block's largest
        # output. (Steps of an output's own size are no measure here: a
        # one-step change of a layer-1 output moves a layer-2 sum that
        # cancels to near zero by many times its own size.)
        bar = BF16_STEPS_BAR * 2.0**-7 * float(want.float().abs().max())
        equal = float((y == plain).float().mean())
        err_plain = float((y.float() - plain.float()).abs().max())
        u_equal = float((y == want).float().mean())
        err = float((y.float() - want.float()).abs().max())
        print(
            f"studies {name} enc0 1024x1024 1->32->32 bf16: {launches[name]} launches; vs the "
            f"plain chain {equal:.6f} of outputs equal (bar {BF16_EQUAL_BAR}), max |diff| "
            f"{err_plain:.4g}; vs the UNet's enc0 block {u_equal:.6f} equal, max |diff| {err:.4g}; "
            f"bar on both {bar:.4g} ({BF16_STEPS_BAR} bf16 steps of the largest output)"
        )
        if equal < BF16_EQUAL_BAR or err_plain > bar:
            raise AssertionError(f"studies {name}: differs from the plain chain")
        if err > bar:
            raise AssertionError(f"studies {name}: enc0 differs from the UNet block by {err} > {bar}")
    return launches


def polyphase_phase(torch, fixtures, unet):
    """models.polyphase against the standard forward on the card."""
    from sequitr_tpu_torch.models import polyphase

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(11)
    for dtype, size, n in (("float32", 256, 20), ("bfloat16", 1024, 20)):
        _, _, model, _ = fixtures.load("unet2d_cells", compute_dtype=dtype, device="cuda")
        model = unet.fold_batchnorm(model)
        poly = polyphase.Polyphase(model)
        x = torch.rand((1, size, size, 1), generator=gen).cuda()
        with torch.inference_mode():
            base, got = model(x), poly(x)
            rel = float((got - base).abs().max() / base.abs().max())
            agree = float((got.argmax(-1) == base.argmax(-1)).float().mean())
            base_ms = _median_ms(lambda: model(x), n=n)
            poly_ms = _median_ms(lambda: poly(x), n=n)
        print(
            f"polyphase unet2d_cells {dtype} {size}x{size}: rel err {rel:.3g}, argmax agreement "
            f"{agree:.6f}, standard {base_ms:.4f} ms, polyphase {poly_ms:.4f} ms "
            f"({base_ms / poly_ms:.3f}x)"
        )
        if dtype == "float32" and not rel < 1e-5:
            raise AssertionError(f"polyphase f32 relative error {rel} >= 1e-5")
        if agree < POLY_AGREE_BAR:
            raise AssertionError(f"polyphase {dtype} argmax agreement {agree} < {POLY_AGREE_BAR}")


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


def serve_phase(torch, hist, conv, smi_line):
    """Three segmentation_unet2d jobs through ImageServer on the card."""
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
            "c": {"localize": False, "polyphase": True},
        }
        server = ImageServer(ServerConfiguration(jobs_dir=jobs, models_dir=models, device="cuda"))
        launches = {}
        labels_a = labels_c = None
        # one job at a time, each with its own launch counts: job (a) is
        # the main path, job (b) the tiled save_probs path, job (c) the
        # polyphase forward
        for name, params in specs.items():
            submit_job(jobs, {
                "module": "segmentation_unet2d",
                "params": dict(model="unet2d_cells", **params),
                "input": [stack],
                "output": os.path.join(tmp, f"out_{name}"),
            })
            torch.cuda.synchronize()
            hist.histogram_2d.launches = 0
            conv.conv3x3_nhwc.launches = 0
            conv.conv3x3_flat_chw.launches = 0
            if not server.poll_once():
                raise AssertionError(f"job {name}: no job to run")
            torch.cuda.synchronize()
            launches[name] = hist.histogram_2d.launches
            conv_launches = conv.conv3x3_nhwc.launches + conv.conv3x3_flat_chw.launches
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
                f"{metrics['n_frames']} served frames; conv3x3 study kernels "
                f"launched {conv_launches} times (the served graph does not use them)"
            )
            if conv_launches:
                raise AssertionError(f"job {name}: served path launched a study kernel")
            if launches[name] < metrics["n_frames"]:
                raise AssertionError(
                    f"job {name}: histogram kernel launched {launches[name]} times "
                    f"for {metrics['n_frames']} frames"
                )
            if name == "a":
                labels_a = labels
            elif name == "c":
                labels_c = labels
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
        agree = float(np.mean(labels_c == labels_a))
        miou_c = float(np.mean([_miou(a, b, k) for a, b in zip(labels_c, ref)]))
        print(
            f"serve job c (polyphase) labels equal to job a's on {agree:.6f} of pixels "
            f"(bar {POLY_AGREE_BAR}), miou_vs_ref {miou_c:.6f}"
        )
        if agree < POLY_AGREE_BAR:
            raise AssertionError(f"polyphase job agrees with job a on {agree} < {POLY_AGREE_BAR}")
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
        from sequitr_tpu_torch.ops.kernels import conv3x3 as conv
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

    # one nvcc per source, all started together
    from concurrent.futures import ThreadPoolExecutor

    names = ("histogram", "conv3x3")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        logs = list(pool.map(lambda name: build.build(name, force=True), names))
    print(f"build: {', '.join(names)} in {time.perf_counter() - t0:.2f} s")
    for name, log in zip(names, logs):
        for line in log.splitlines():
            if "ptxas info" in line:
                print(f"build {name}: {line.strip()}")

    entry = kernel_phase(torch, hist)
    conv_entries = conv_kernel_phase(torch, conv)
    studies_launches = studies_phase(torch, fixtures, unet, conv)
    model_phase(torch, fixtures, unet)
    polyphase_phase(torch, fixtures, unet)
    profile_phase(torch, fixtures, unet)
    entry["launches"] = serve_phase(torch, hist, conv, smi_line)
    if entry["launches"] < 1:
        raise AssertionError("histogram_2d was not launched on the main path")
    for e in conv_entries:
        e["launches"] = studies_launches[e["name"]]
    print(
        "kernels: histogram_2d launches are those of served job a; the conv3x3 "
        "entries' launches are those of the studies path (enc0 chained through "
        "each entry point); served job a launches the conv3x3 kernels 0 times"
    )
    print(json.dumps({"kernels": [entry] + conv_entries}))
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
