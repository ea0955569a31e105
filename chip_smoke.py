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
   at its path's shapes and at ragged ones (for the quantile pass: lo, scale
   and quantiles equal to the CPU's, counts integer-equal, on the main
   path's frame, ragged and batched shapes and the frames of the two
   division faults; no host sync under ``set_sync_debug_mode("error")``, 1
   or 2 device operations a call, the normalize's device operations a
   frame; for the conv kernels: shapes that
   reach every body and every branch of the tensor-core bodies, with the body
   the launcher picks printed and held to the alignment rule), then timed
   (CUDA events, median of many) beside its bound, its plain version and a
   PyTorch yardstick; the conv entries carry ``ms`` (as a user calls the
   entry point, weights packed inside the call) and ``kernel_ms`` (the kernel
   alone on packed weights), and the timed shapes must have run the
   pipelined tensor-core body;
4. studies phase: ``enc0`` of the folded bf16 ``unet2d_cells`` (1 -> 32 ->
   32 channels) on a normalized 1024x1024 frame, chained through each of the
   three conv study entry points, the launch counts reset before each chain
   and read after it, each result held against the ``UNet``'s own block;
5. model phase: ``unet2d_cells`` at f32 on the card against the CPU
   (TF32 off), logits within 1e-3 (cuDNN sums in other orders);
6. polyphase phase: ``models.polyphase`` against the standard forward on
   the card, f32 (TF32 off) at 256x256 and bf16 at 1024x1024, both timed;
7. volume phase: ``unet3d_cells`` at f32 on the card against the CPU (TF32
   off), then ``polyphase.apply3d`` against the standard 3D forward, f32 at
   8x64x64 and bf16 at 32x512x512, both timed, with their peak memory and
   device operations (and any layout transposes among them);
8. enhance phase: the folded ``gan_denoise`` generator and ``n2v_cells`` at
   1024x1024, the card against the CPU at f32, then timed at bf16;
9. profile phase: where a served item's time goes (torch.profiler): 2D
   frames, volumes (the default tiling and the whole-volume polyphase
   path) and GAN frames, streamed: wall, busy share, device ops, peak
   memory, kernels;
10. instances phase (TF32 off): ``flows_cells`` and ``stars_cells`` at f32 on
   a 1024x1024 ``synthetic.instances_frame``, card against CPU (prob within
   1e-4, stars distances within 1e-3, flow positions within 1 px on >=
   99.9% of foreground pixels, instances at ap50 1.0); the doubling
   integrator's indices card against CPU; fidelity (``fidelity.py``'s flows
   and stars meters): the bf16 kernel-normalize path against the f32 exact
   path on 2 frames, ap50_vs_ref >= 0.99; the Euler kernel ``torch.equal``
   to the eager loop on the card (one launch a call) on the 1024x1024 field
   and at job (m)'s 32x256x256 volume shape; then the forward, the Euler
   kernel and its eager loop, the doubling integrator (device ms, device
   ops, wall ms) and the host grouping and NMS timed at 1024x1024, the
   kernel beside its bound (the ``follow_flows`` entry of the kernels line);
11. serve phase: jobs served by ``ImageServer`` on the card one at a time,
   every kernel's launch count reset just before each job and read just
   after: (a)-(c) ``segmentation_unet2d`` over a 4-frame 1024x1024 uint16
   stack (job (a), the default job, is the served main path: its histogram
   count goes in the ``kernels`` line; the served jobs launch the conv
   study kernels 0 times, as the JAX package's server never reaches its
   study kernels), job (a)'s labels held against the port's f32
   exact-normalize path (mIoU >= 0.997), job (c), ``polyphase: true``,
   against job (a)'s labels; (d)-(f) ``segmentation_unet3d`` on 32x512x512
   uint16 z-stacks from ``synthetic.cells_volume`` (the default tiled job,
   the whole-volume polyphase job, a 2-timepoint timelapse through ``z``),
   held against the port's f32 exact-normalize path (mIoU >= 0.99) and (e)
   against (d); (g) ``enhancement_gan`` and (h) ``denoise`` (``normalize:
   "none"``, as ``fidelity.py::n2v_fidelity``) on 4-frame 1024x1024 stacks,
   held against the port's f32 path by PSNR (>= 40 dB), and (i) ``denoise``
   with the kernel normalize, held against the same bf16 path called
   directly; (j)-(m) the instance jobs on 1024x1024 ``instances_frame``
   stacks: ``segment_flows`` with the Euler and the doubling integrator,
   ``segment_stars`` with ``polyphase: true`` (held to the f32 path by
   ap50_vs_ref >= 0.99), and ``segment_flows`` on a 2-timepoint
   32x256x256 volume file (``z: 32``) with a ``unet.init`` model of
   ``unet3d_cells``' architecture and a flows head (held to its pass called
   directly; its f32 positions card against CPU on a crop); (j) and (m)
   launch the Euler kernel once a frame or volume, every other job never.
   The fidelity numbers (mIoU, ap50, PSNR) are
   ``sequitr_tpu_torch/fidelity.py``'s measures, and the instances phase
   calls its flows and stars meters;
12. evaluate phase: the evaluation and parity jobs through ``ImageServer``,
   each beside its serving twin (served again in this phase) and with its
   own launch counts: (n) ``evaluate_unet2d`` on job (a)'s stack with its
   ``cells_frame`` labels (``save_labels``, ``per_frame``), (n')
   the same with ``ignore_label`` on a sparse truth (one frame wholly
   unannotated), (o) ``evaluate_unet3d`` on one 32x512x512 volume (default
   tiling), (p) ``evaluate_gan`` with ``gan_fidelity``'s targets, (q)
   ``evaluate_denoise`` with ``normalize: "none"`` and (q') with the kernel
   normalize, (q'') its volumetric branch (a ``unet.init`` 3D N2V model, 2
   volumes of 32x256x256), (r) ``evaluate_flows`` and (r') its volumetric
   branch (job (m)'s model), (s) ``evaluate_stars`` (``polyphase: true``),
   (t) ``parity_check`` against the torch re-derivation for five fixtures,
   a copy with one kernel scaled by 1e6 (must fail with the JobError) and
   the keras reference (passes, or reports itself unavailable). Each job's
   metrics equal the same recomputed on the host from its saved outputs or
   its twin's (counts equal, floats within 1e-6), saved labels agree with
   the twin's on >= 0.9999 of pixels, and quantile passes are one a
   normalized frame or volume: (n) 4, (n') 4, (o) 1, (p) 8, (q) 0, (q') 8
   (the denoiser hands back its normalized input, so the noisy side is
   normalized once), (q'') 4 (2 a volume), (r) 4, (r') 2, (s) 4, (t) 0;
13. train phase (U-Net training), with PyTorch's own TF32 defaults restored
   first: an f32 ``unet2d_cells`` job served on the card and on the CPU
   (probabilities within 1e-4); three f32 train steps at ``unet2d_cells``'
   width on 8x256x256 batches, card against CPU (loss, grad_norm, weights),
   with the standard and the polyphase forward; the tied max-pool gradient,
   and the polyphase pool's; the augmentation's apply at the same draws;
   a fold that follows an in-place update; the bf16 step's time split,
   device ops, peak memory and largest kernels in 2D (8x256x256) and 3D
   (2x16x64x64), standard and polyphase; then ``build_records`` ->
   ``train_unet2d`` -> ``segmentation_unet2d`` in one server process (the
   served labels equal the registered weights served directly), the same
   with ``polyphase: true``, and ``build_records`` -> ``train_unet3d``,
   each job's launch counts read on its own;
14. gan_train phase (GAN training, PyTorch's TF32 defaults): three f32 GAN
   steps (4x128x128, ``GANConfig()`` widths) card against CPU from the same
   weights (d_loss, g_loss, weights); the bf16 step at ``bench_gan_train``'s
   shape (8x256x256, ``GANConfig()`` defaults), standard and polyphase, with
   its split (generator forward, D step, G step), device ops and peak
   memory; then ``build_gan_pairs`` -> ``train_gan`` (30 steps) ->
   ``enhancement_gan`` (bit-equal to the registered weights served
   directly) -> ``evaluate_gan`` in one server process.

15. family_train phase (N2V, flows and stars training, PyTorch's TF32
   defaults; the f32 steps enter ``utils.ieee_f32``): the N2V masking's
   apply on the card bit-equal to the CPU's on the same draws, under
   ``set_sync_debug_mode("error")`` (uniform, median, structN2V, 2D
   16x64x64 and 3D 16x8x64x64 with radius (2, 5, 5), and forced
   duplicate centres); three f32 steps of N2V 2D and 3D, flows and stars
   (the jobs' presets) card against CPU from the same weights and draws
   (the train phase's bars on step 1 and on the updates after 3 steps,
   and for flows and stars on every step; N2V's steps 2-3 at
   ``FAMILY_N2V_LATER_BAR``, see the phase), two card runs printed; the bf16
   step at each job's default shape and preset (``n2v_denoise`` 16x64x64
   and 16x8x64x64, ``flows_cells`` and ``stars_cells`` 16x64x64), standard
   and polyphase, with its split, device ops, busy share and peak memory;
   then in one server process ``train_n2v`` (30 steps) on 4 noisy
   1024x1024 ``denoise_pair`` frames -> ``denoise`` -> ``evaluate_denoise``,
   ``train_n2v`` ``dims: 3`` on 2x32x256x256 -> ``denoise``,
   ``train_flows`` on 4 256x256 ``instances_frame``s -> ``segment_flows``
   -> ``evaluate_flows``, ``train_stars`` -> ``segment_stars`` ->
   ``evaluate_stars``, ``train_flows`` ``dims: 3`` on 2x16x64x64
   (instances from ``cells_volume`` by ``scipy.ndimage.label``) ->
   ``segment_flows``; each served output (denoised frames or volumes,
   ``save_prob``'s probabilities) equal to the registered weights served
   directly the job's way; quantile passes 0 in every train job, 4 in
   each 4-frame serve and in evaluate_flows / evaluate_stars, 8 in
   evaluate_denoise, 2 in each 2-volume serve.
16. geometry phase: ``register_stack`` (2D, first mode with
   ``frame_batch``, integer mode, ``dims: 3``), ``stitch_mosaic`` (device
   and cpu backends, a timelapse) and ``correct_illumination`` (exp,
   ratio) through ``ImageServer``, held to the known truth, to the port on
   the CPU and to each other; the geometry meters on the card and the CPU;
17. optics phase: (y) ``localize_emitters`` on 256 uint16 frames of
   512x512 (120 emitters a frame), the first 8 frames' rows held to the
   port on the CPU (count, order, positions), frame 0's raw fits card
   against CPU within 1e-4 px, ``emitter_fidelity`` at the JAX tests'
   bars, where a localized frame's time goes and no sync before its one
   fetch; (z) ``dims: 3`` on 4 volumes of 16x512x512, volume 0 card against
   CPU, ``emitter3d_fidelity``; (aa) ``calibrate_astigmatism`` on a
   17-plane bead scan -> ``localize_emitters`` with ``astigmatism`` (its
   output directory, by ``depends_on``) on 64 frames of 512x512, the
   coefficients card against CPU within 1e-5 relative and z within 1e-3 of
   the range, ``astig_fidelity``; (bb) ``deconvolve`` on 64 frames of
   1024x1024 (20 iterations), ``dims: 3`` on a 32x512x512 volume and a
   2-timepoint timelapse, card against CPU within 5e-6 of the largest
   value, an RL frame's device ms and its cuFFT share; then the exact
   normalize's repair: a slice past 2^24 values on the card, lo/hi card =
   CPU, ``seg_fidelity``'s reference side on a 65x512x512 volume. Every job
   launches none of the four kernels;
18. quantify phase: (cc) ``qc_stack`` on 64 uint16 frames of 1024x1024 with
   faults injected by index (4 blurred, 3 dark, 2 saturated): the flagged
   frames equal the injected set, every frame's metrics card against the
   port on the CPU (p01/p99/sat_frac equal, the whole-frame sums within
   ``QUANT_QC_RTOL``), the flags equal, a 2-channel run, where a QC frame's
   time goes; ``dims: 3`` on 4 volumes of 32x512x512 whose sharpest plane
   drifts one plane a volume: ``best_z`` equal to the truth and to the CPU
   port's; (dd) ``project_stack`` on 8 such volumes with each method (edof
   in blend and in select with ``save_height``), card against the CPU port
   on 2 volumes (selection methods equal in uint16, the float methods
   within ``QUANT_PROJ_RTOL``, projection.csv and the height map equal),
   each method's volumes/s, device ms, device ops and busy share; (ee) the
   chain ``project_stack`` (max, 4 volumes of 16x1024x1024) ->
   ``segmentation_unet2d`` (4 quantile passes, as job (a)) ->
   ``measure_objects`` -> ``export_ctc`` (tracks by the copied tracker) by
   ``depends_on``, the host jobs' files byte-equal to the CPU port's;
   (ff) ``count_spots`` (a ``localize_emitters`` emitters.csv) and
   ``measure_tracks`` byte-equal to the CPU port's, the tracker's frames/s
   at ``bench.py::bench_tracking``'s scene and ``tracking_fidelity`` at the
   JAX tests' bars. Only the segmentation job launches a kernel of the four.
19. ops phase, the operations surface through ``python -m sequitr_tpu_torch``
   subprocesses: (a) ``doctor`` (exit 0, ``cuda x1 (<name>)``, the probe's
   ``init_s`` and ``matmul_s``) and ``info``, beside a probe that a trace
   left running on another thread neither fails the next profiled block
   nor crashes the process; (b) ``unet2d_cells`` import -> export ->
   import -> export, bit-equal at each step; (c) ``serve --workers 2
   --device cuda`` (both workers on the one card) and ``submit --follow``
   of ``segmentation_unet2d`` (``profile: true``) -> ``measure_objects``:
   labels.tif byte-equal to the same job in this process, the job's own
   trace holding ``minmax_kernel`` and ``count_kernel`` 4 times each (its
   launch count in the ``kernels`` line); (d) ``cancel`` of a running
   ``__test_slow__`` job (cancelled within 5 s), then ``drain --wait``
   with both workers busy and a job queued (the running jobs complete, the
   supervisor exits 0, the queued job stays), ``queue`` and ``stats``; the
   profile's overhead on the warm 4-frame job; (e) eight 4-frame jobs under
   ``--workers 1`` and ``--workers 2``: jobs/s from the ledger's
   ``finished`` span, the workers' boot and the idle drain; (f) every
   example whose optional packages are present (``REQUIRES``), 4 at a
   time, ``SEQUITR_EXAMPLE_STEPS=20``.
20. parallel phase, every job that shards served by ``ImageServer`` inside
   ``parallel.virtual_devices(4)`` (a pool of 4 devices over the one card:
   real shards and halo exchanges, the copies within one device), each
   line with its wall time, peak GB and device ms (a profiled run): (a)
   ``segmentation_unet2d`` ``spatial_parallel: true`` on one 8192x8192
   ``cells_frame`` (4 x 2048 rows) against one untiled whole-frame forward
   of the same normalized frame (mIoU >= 0.997, pixel agreement printed),
   one quantile pass, the halo rows a frame counted and held to 2 x 3 a
   3x3 conv; (b) ``spatial_parallel: 2`` (2 data x 2 space) on 4 frames
   of 2048x2048, each held the same way, a pass a chunk of 2 frames; (c)
   ``segmentation_unet3d`` Z-sharded on a 64x512x512 volume against the
   whole volume; (d) ``enhancement_gan`` ``spatial_parallel: true`` at
   2048x2048 against the whole-frame generator (PSNR >= 40 dB); (e)
   ``data_parallel`` through segmentation_unet2d, segment_flows,
   enhancement_gan, denoise, localize_emitters (2D, 3D, astigmatic),
   deconvolve, register_stack and stitch_mosaic, each against the same job
   on the card alone (files byte-equal where each device serves the frames
   the single-device job serves one at a time, else at the job's bars:
   CSVs to their decimals and the geometry phase's 1e-3 px); (f)
   ``finetune_spatial`` with ``unet2d_cells``' architecture on 2048x2048
   frames, 3 steps, 4 ways against 1 from one seeded init: at f32 compute
   every hold of the train phase, at bf16 loss, accuracy and grad_norm at
   those bars and the weights at the bf16 bars, which lie between the bf16
   noise floor (1 way at bf16 against 1 way at f32) and a planted fault
   (zeroed halos), both printed and the fault required beyond the bars; the
   bf16 spatial step timed at 1 and 4 ways; (g) ``train_unet2d``
   ``data_parallel`` at f32, batch 8 on 4 ways against 1 (global
   batch-norm statistics), the train phase's holds; (h) a mesh of two
   distinct devices, cuda:0 and the CPU (the weight copies, cross-device
   halos, gathers and gradient returns of a multi-card pool): the spatial
   forward and data-parallel serving at 512x512 against the card alone,
   and the data-parallel and spatial train steps, 3 each, at the train
   phase's bars; (i) ``train_unet2d`` ``polyphase`` + ``data_parallel`` at
   f32, 4 ways against 1 (the phase-domain forward shard by shard, its
   batch norms over the global batch): loss within 1e-5, statistics within
   1e-4; its step's wall ms at 1 and 4 ways and at 1 way on batch 2.
21. quant phase, the int8 kernel ``csrc/qconv.cu`` and the quantization
   studies: ``qconv`` against its plain version on the card (float64
   cuDNN, exact) with int32 sums equal on every ``int8_conv.SHAPES`` shape,
   ragged 2D and 3D shapes, the 2D and 3D transposed convs and the head,
   the dequant and requant epilogues bit-equal; the ``int8_conv`` rows and
   the ``roofline`` table at 1024x1024 (CUDA-graph timing); PTQ of the
   folded ``unet2d_cells`` calibrated on 4 normalized ``cells_frame``s, its
   1024x1024 int8 forward (the main path: ``qconv``'s launch count read
   around it) bit-equal to the port's forward on the CPU on the same
   qparams and input, its labels against the f32 folded forward's (>=
   0.98), its time against the bf16 forward's.
22. fixtures phase, the fixture factory: ``python -m
   sequitr_tpu_torch.tools.make_fixtures --quick`` through its ``main``,
   all eight recipes at bf16 on the card into a temporary directory (each
   fixture's steps, wall seconds, median step ms and holdout metrics
   printed beside the committed manifest's; every metric finite), each
   fixture loaded back through ``fixtures.load(directory=...)`` and run on
   the card, the committed ``gan_denoise`` and ``n2v_cells`` scored by the
   factory's scorers at bf16 (within 1 dB of their manifest), the quick
   ``unet2d_cells`` served through
   ``segmentation_unet2d`` on one 1024x1024 ``cells_frame`` (one quantile
   pass: the histogram kernel launched, counted as job (a)'s are), all
   within ``FIXTURES_BUDGET_S``.

Prints the whole command's time, then a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA device or
outside a checkout of the repository.

    python3 chip_smoke.py --phases conv,studies

runs only the named phases (of ``histogram``, ``conv``, ``studies``,
``model``, ``polyphase``, ``volume``, ``enhance``, ``profile``,
``instances``, ``serve``, ``evaluate``, ``train``, ``gan_train``,
``family_train``, ``geometry``, ``optics``, ``quantify``, ``ops``,
``parallel``, ``quant``, ``fixtures``) after the build, for work on one kernel or path, and prints neither of the
two closing lines.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

T_START = time.perf_counter()

MIOU_BAR = 0.997
H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12  # f32 outside the tensor cores, H100 SXM data sheet
H100_BF16_FLOPS = 989e12  # bf16 tensor cores, dense, H100 SXM data sheet
F32_CONV_BAR = 1e-4  # sums of <= 576 products of unit-scale values, reordered
BF16_EQUAL_BAR = 0.999  # share of outputs bit-equal to the plain version's
BF16_STEPS_BAR = 2  # and no output further than this many bf16 values away
POLY_AGREE_BAR = 0.999
MIOU3D_BAR = 0.99  # served volume labels against the f32 exact-normalize path
PSNR_BAR_DB = 40.0  # GAN / N2V served output against the f32 path
PSNR_DIRECT_BAR_DB = 80.0  # a served output against the same path called directly
VOLUME = (32, 512, 512)  # the JAX bench's z-stack (bench.py::bench_unet3d)
TRAIN_LR = 1e-4  # TrainConfig's default learning rate
TRAIN_STEPS_EXACT = 3
TRAIN_LOSS_RTOL = 1e-4  # a mean of 524,288 per-pixel CEs; cuDNN and the CPU sum the convs in other orders
TRAIN_GRAD_NORM_RTOL = 2e-3  # grows with the steps: the weights part a little each step (PERF.md)
TRAIN_UPDATE_BAR = 0.2  # relative L2 difference of the 3 steps' updates, card vs CPU (PERF.md)
TRAIN_STATS_BAR = 1e-3  # BN running statistics, relative to each tensor's largest value, beyond
# the TRAIN_STEPS_EXACT * TRAIN_LR a running mean takes from its conv's BN-nulled bias
AUG_BAR = 1e-5  # augmented image and weights, card against CPU at the same draws
INSTANCE_FRAME = (1024, 1024)
INSTANCE_SEED = 717_000  # fidelity.py::flows_fidelity / stars_fidelity's frames
AP50_BAR = 0.99  # instances, bf16 kernel-normalize path against the f32 exact path; first card run 0.999-1.0 (PERF.md)
INST_PROB_BAR = 1e-4  # f32 card against CPU: flows and stars probabilities
INST_DIST_BAR = 1e-3  # f32 card against CPU: stars ray distances (up to ~60 px)
INST_FINAL_PX = 1.0  # f32 card against CPU: converged flow positions, on
INST_FINAL_SHARE = 0.999  # at least this share of foreground pixels
INST_VOLUME = (32, 256, 256)  # job (m)'s volumes
EVAL_FLOAT_BAR = 1e-6  # an evaluate job's float metrics against the same recomputed on the host
EVAL_LABELS_BAR = 0.9999  # an evaluate job's saved labels against its serving twin's
GAN_LR = 2e-4  # train_gan's default learning rate (Adam, beta1 0.5)
GAN_LOSS_RTOL = 1e-4  # d_loss and g_loss, f32 card against CPU (TRAIN_LOSS_RTOL's bar; first card run: <= 3.5e-6)


def _fail(msg: str) -> int:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    return 2


def _median_ms(fn, n: int = 100) -> float:
    """Median device time of ``fn()`` over ``n`` calls: the package's timer
    (CUDA events, the stream held while the host queues the calls)."""
    from sequitr_tpu_torch.utils import device_median_ms

    return device_median_ms(fn, n)


QS = [0.05, 0.995]
ULP_SEED = 98  # gamma(2, 100, (64, 256)): 1023 / t is an ulp off the quotient here


def _quantile_cases(torch, gen):
    """name -> (slices, n) f32 on the CPU: the main path's frame, ragged and
    batched shapes, and the two frames of the division faults."""
    import numpy as np

    def gamma(shape, scale):
        # gamma(2, scale) pixels, like fluorescence background, made on the CPU
        e = torch.empty(shape + (2,)).exponential_(generator=gen)
        return (e.sum(-1) * scale).to(torch.float32)

    ulp = np.random.default_rng(ULP_SEED).gamma(2.0, 100.0, (64, 256)).astype(np.float32)
    return {
        "frame 1024x1024": gamma((1, 1024 * 1024), 60.0),
        "ragged 1000x1500": gamma((1, 1000 * 1500), 60.0),
        "odd 333x517": gamma((1, 333 * 517), 60.0),
        "volume (4, 32, 500)": gamma((1, 4 * 32 * 500), 1.0),
        "two channels 512x768": torch.cat([gamma((1, 512 * 768), 1.0), gamma((1, 512 * 768), 500.0)]),
        "batch 8 x 256x256": gamma((8, 256 * 256), 60.0),
        "ragged slices 3 x 1001": gamma((3, 1001), 60.0),
        f"ulp frame 64x256 (seed {ULP_SEED})": torch.from_numpy(ulp.reshape(1, -1)),
        "tie frame 10x10": torch.cat([torch.zeros(5), torch.linspace(1.0, 100.0, 95)])[None],
        "volume 32x512x512": gamma((1, 32 * 512 * 512), 60.0),
    }


def _device_events(torch, fn, reps):
    """The device operations of ``reps`` calls of ``fn`` after a warm-up
    call (torch.profiler). A window in which the profiler caught no device
    operation at all is taken again (seen once on the card: a trace of ten
    kernel launches came back empty)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        if ops:
            return ops
    raise AssertionError("torch.profiler caught no device operation in three windows")


def _ms(events, reps) -> float:
    return sum(e.time_range.end - e.time_range.start for e in events) / 1e3 / reps


def _device_ops(torch, fn, reps=10):
    """Device operations and device ms per call of ``fn``, and their names."""
    ops = _device_events(torch, fn, reps)
    return len(ops) / reps, _ms(ops, reps), sorted({e.name[:60] for e in ops})


EULER_LAUNCHES = {}  # {job: Euler kernel launches}: every served job's, for the kernels line


def _euler():
    """The Euler kernel's wrapper; its ``launches`` are reset before each
    served job and read after it, as the histogram's and the convs' are."""
    from sequitr_tpu_torch.ops.kernels import flows as flow_kernels

    return flow_kernels.euler


def _euler_want(module, params, units):
    """The Euler launches a job must make: one a frame or volume for a
    flows job on the Euler integrator, none for any other."""
    euler = module in ("segment_flows", "evaluate_flows") and params.get("integrator", "euler") == "euler"
    return units if euler else 0


def _euler_read(job, want=None):
    """Job ``job``'s Euler launches since the reset, kept in
    ``EULER_LAUNCHES`` and held to ``want`` where it is given."""
    n = EULER_LAUNCHES[job] = _euler().launches
    if want is not None and n != want:
        raise AssertionError(f"job {job}: the Euler kernel launched {n} times, expected {want}")
    return n


def kernel_phase(torch, hist):
    """The quantile pass against its plain version: lo, scale and quantiles
    equal to the CPU's (the plain version on the card too), counts
    integer-equal, the counting launch alone (``histogram_2d``) the same,
    the scratch zero after every call; no host sync and 1 or 2 device
    operations a call; then timed at the main path's shape."""
    from sequitr_tpu_torch.ops import normalize as norm
    from sequitr_tpu_torch.data import synthetic
    from sequitr_tpu_torch.pipeline import infer

    gen = torch.Generator().manual_seed(20_261_016)
    cases = _quantile_cases(torch, gen)
    max_err = 0
    for name, x_cpu in cases.items():
        x = x_cpu.cuda()
        got = hist.quantile_pass(x, QS)
        want = hist.quantile_pass(x_cpu, QS)  # the plain version on the CPU
        plain_card = hist.quantile_pass_reference(x, QS)
        counts = hist.histogram_2d(x, want[0].cuda(), want[1].cuda())
        torch.cuda.synchronize()
        err = int((got[2].cpu().long() - want[2].long()).abs().max())
        max_err = max(max_err, err, int((counts.cpu().long() - want[2].long()).abs().max()))
        if max_err or int(got[2].sum()) != x.numel():
            raise AssertionError(f"histogram counts differ on {name}: max |diff| {max_err}")
        for i, what in ((0, "lo"), (1, "scale"), (3, "quantiles")):
            if not torch.equal(got[i].cpu(), want[i]):
                raise AssertionError(f"{what} differ on {name}: kernel {got[i]} vs CPU {want[i]}")
            if not torch.equal(plain_card[i].cpu(), want[i]):
                raise AssertionError(f"{what} of the plain version differ on {name}: card {plain_card[i]} vs CPU {want[i]}")
        if any(int(b.abs().sum()) for b in hist._SCRATCH.values()):
            raise AssertionError(f"{name}: the scratch is not zero after the pass")
        print(
            f"kernel quantile_pass {name}: counts equal, lo, scale and quantiles equal to the "
            f"CPU's (and the plain version's on the card) {got[3].cpu().tolist()}"
        )
    # the fault the tensor divisor repairs: a host-scalar divisor is
    # multiplied in as its reciprocal on the card
    five = torch.tensor([5.0], device="cuda")
    by_scalar = float((five / 100)[0])
    by_tensor = float((five / torch.full((), 100.0, device="cuda"))[0])
    print(
        f"kernel tie frame on the card: 5 / 100 by a host scalar {by_scalar!r}, by an f32 tensor "
        f"{by_tensor!r}, f32(0.05) {float(torch.tensor(0.05))!r}"
    )

    # no host sync, and the pass is the only device work of kernel_quantiles
    x = cases["frame 1024x1024"].cuda()
    frame, _ = synthetic.cells_frame(424_000, (1024, 1024))
    frames = torch.from_numpy(frame.clip(0, 65535).astype("uint16"))[None, ..., None].cuda()
    tc = infer.TileConfig()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        hist.kernel_quantiles(x, QS)
        norm.percentile_normalize_pallas(x.reshape(1024, 1024))
        infer._normalize(frames, tc)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    print("kernel quantile_pass: kernel_quantiles, percentile_normalize_pallas and infer._normalize ran with no host sync")
    pass_ops, pass_dev_ms, pass_names = _device_ops(torch, lambda: hist.kernel_quantiles(x, QS))
    if pass_ops not in (1.0, 2.0):
        raise AssertionError(f"kernel_quantiles makes {pass_ops} device operations a call: {pass_names}")
    norm_ops, norm_dev_ms, norm_names = _device_ops(torch, lambda: infer._normalize(frames, tc))
    norm_ms = _median_ms(lambda: infer._normalize(frames, tc), n=20)
    print(f"kernel quantile_pass: {pass_ops:.0f} device ops a call ({'; '.join(pass_names)})")
    print(
        f"normalize infer._normalize 1024x1024 uint16: {norm_ops:.1f} device ops, {norm_dev_ms:.5f} "
        f"device ms a frame (torch.profiler), {norm_ms:.5f} ms as called ({'; '.join(norm_names)})"
    )

    lo, scale = hist.quantile_pass(x, QS)[:2]
    lo_f, hi_f = float(lo), float(x.max())
    ms = _median_ms(lambda: hist.histogram_2d(x, lo, scale))
    quantiles_ms = _median_ms(lambda: hist.kernel_quantiles(x, QS))
    # calls of many operations over fewer calls: the queued launches must
    # fit the launch queue, or the timer waits for the host
    plain_ms = _median_ms(lambda: hist.histogram_2d_reference(x, lo, scale), n=20)
    quantiles_plain_ms = _median_ms(lambda: hist.quantile_pass_reference(x, QS), n=20)
    kernel_ms = _device_ops(torch, lambda: hist.histogram_2d(x, lo, scale))[1]
    library_ms = _median_ms(lambda: torch.histc(x, bins=1024, min=lo_f, max=hi_f))
    # the same size with pixels spread evenly over the bins: how much of the
    # time is shared-memory atomics piling onto the background's few bins
    u = torch.rand((1, 1024 * 1024), generator=gen).cuda()
    u_lo, u_scale = hist.quantile_pass(u, QS)[:2]
    u_ms = _median_ms(lambda: hist.histogram_2d(u, u_lo, u_scale))
    print(f"kernel histogram_2d 1024x1024 uniform pixels, 1024 bins: {u_ms:.5f} ms")
    n = x.numel()
    # each pixel read once; lo + scale read, counts written (histogram_2d);
    # counts, lo, scale and the quantiles written (the pass)
    t_bytes = (n * 4 + 2 * 4 + 1024 * 4) / H100_BYTES_PER_S * 1e3
    t_ops = n * 4 / H100_F32_FLOPS * 1e3  # subtract, multiply, two clamps a pixel
    q_bytes = (n * 4 + 1024 * 4 + 2 * 4 + len(QS) * 4) / H100_BYTES_PER_S * 1e3
    q_ops = n * 6 / H100_F32_FLOPS * 1e3  # and a min and a max a pixel
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
        "quantiles_ms": quantiles_ms,
        "quantiles_bound_ms": max(q_bytes, q_ops),
        "quantiles_plain_ms": quantiles_plain_ms,
        "quantiles_device_ops": pass_ops,
        "quantiles_kernel_ms": pass_dev_ms,
        "kernel_ms": kernel_ms,
        "blocks_per_slice": hist.blocks_per_slice(n, 1),
        "normalize_device_ops": norm_ops,
        "normalize_device_ms": norm_dev_ms,
    }
    print(
        f"kernel histogram_2d 1024x1024 f32, 1024 bins, lo and scale given: {ms:.5f} ms "
        f"({entry['bound_ms'] / ms:.3f} of its bound; {entry['blocks_per_slice']} blocks of 512 threads; "
        f"the kernel's own device time {kernel_ms:.5f} ms), "
        f"plain {plain_ms:.5f} ms, torch.histc {library_ms:.5f} ms, bound {entry['bound_ms']:.5f} ms "
        f"({entry['bound_by']}; the frame is warm in L2, as on the served path)"
    )
    print(
        f"kernel kernel_quantiles 1024x1024 f32, 1024 bins, as called: {quantiles_ms:.5f} ms "
        f"({entry['quantiles_bound_ms'] / quantiles_ms:.3f} of its bound {entry['quantiles_bound_ms']:.5f} ms; "
        f"the two kernels' own device time {pass_dev_ms:.5f} ms), "
        f"plain {quantiles_plain_ms:.5f} ms; no single PyTorch call computes it"
    )

    # the 3D jobs' shape: a whole volume is one slice of 32*512*512 values
    v = cases["volume 32x512x512"].cuda()
    v_lo, v_scale = hist.quantile_pass(v, QS)[:2]
    v_lo_f, v_hi_f = float(v_lo), float(v.max())
    nv = v.numel()
    v_ms = _median_ms(lambda: hist.histogram_2d(v, v_lo, v_scale))
    v_q_ms = _median_ms(lambda: hist.kernel_quantiles(v, QS))
    v_plain_ms = _median_ms(lambda: hist.histogram_2d_reference(v, v_lo, v_scale), n=20)
    v_q_plain_ms = _median_ms(lambda: hist.quantile_pass_reference(v, QS), n=20)
    v_kernel_ms = _device_ops(torch, lambda: hist.histogram_2d(v, v_lo, v_scale))[1]
    v_q_ops, v_q_dev_ms, _ = _device_ops(torch, lambda: hist.kernel_quantiles(v, QS))
    v_lib_ms = _median_ms(lambda: torch.histc(v, bins=1024, min=v_lo_f, max=v_hi_f))
    vt_bytes = (nv * 4 + 2 * 4 + 1024 * 4) / H100_BYTES_PER_S * 1e3
    vt_ops = nv * 4 / H100_F32_FLOPS * 1e3
    vq_bytes = (nv * 4 + 1024 * 4 + 2 * 4 + len(QS) * 4) / H100_BYTES_PER_S * 1e3
    vq_ops = nv * 6 / H100_F32_FLOPS * 1e3
    vol_u16 = (cases["volume 32x512x512"].reshape((1,) + VOLUME + (1,)).clamp(0, 65535)
               .to(torch.int32).to(torch.uint16).cuda())
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        infer._normalize(vol_u16, tc)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    v_norm_ops, v_norm_dev_ms, _ = _device_ops(torch, lambda: infer._normalize(vol_u16, tc), reps=5)
    entry.update({
        "volume_shape": list(VOLUME),
        "volume_ms": v_ms,
        "volume_kernel_ms": v_kernel_ms,
        "volume_bound_ms": max(vt_bytes, vt_ops),
        "volume_plain_ms": v_plain_ms,
        "volume_library_ms": v_lib_ms,
        "volume_quantiles_ms": v_q_ms,
        "volume_quantiles_kernel_ms": v_q_dev_ms,
        "volume_quantiles_device_ops": v_q_ops,
        "volume_quantiles_bound_ms": max(vq_bytes, vq_ops),
        "volume_quantiles_plain_ms": v_q_plain_ms,
        "volume_blocks_per_slice": hist.blocks_per_slice(nv, 1),
        "volume_normalize_device_ops": v_norm_ops,
        "volume_normalize_device_ms": v_norm_dev_ms,
    })
    print(
        f"kernel histogram_2d volume {VOLUME} ({nv} values, one slice) f32, 1024 bins: {v_ms:.5f} ms "
        f"by events, own device time {v_kernel_ms:.5f} ms ({entry['volume_bound_ms'] / v_ms:.3f} of its "
        f"bound {entry['volume_bound_ms']:.5f} ms by events, {entry['volume_bound_ms'] / v_kernel_ms:.3f} "
        f"by own time), plain {v_plain_ms:.5f} ms, torch.histc {v_lib_ms:.5f} ms"
    )
    print(
        f"kernel kernel_quantiles volume {VOLUME}: {v_q_ms:.5f} ms as called, {v_q_ops:.0f} device ops, "
        f"the two kernels' own time {v_q_dev_ms:.5f} ms, bound {entry['volume_quantiles_bound_ms']:.5f} ms, "
        f"plain {v_q_plain_ms:.5f} ms; infer._normalize of a uint16 volume: {v_norm_ops:.1f} device ops, "
        f"{v_norm_dev_ms:.5f} device ms, no host sync"
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


def _expected_body(torch, name, w_img, c_in, dtype, wb):
    """The launchers' rule, from the arguments alone: the tensor cores take
    bf16 input whose channels fill k = 16 steps; their tiles are copied
    asynchronously in 16-byte pieces where every piece is aligned (fresh
    allocations are; the flat layout's row stride must be a multiple of 8)."""
    if dtype != torch.bfloat16 or c_in % 16:
        return "cuda_cores"
    if name != "conv3x3_bias_act" and wb % 8:
        return "mma_synchronous"
    return "mma_pipelined"


def conv_kernel_phase(torch, conv):
    """Each conv entry point against its plain version on the card (TF32
    off), at the shapes of the CPU tests, ragged ones, C_in = 1, bf16 shapes
    that reach every branch of the tensor-core bodies and the full-width bf16
    shapes; then timed at 1024x1024 32 -> 32 bf16, ReLU."""
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
        # ragged: partial tiles; W+8 = 108 is no multiple of 8, so conv3x3_gemm
        # gathers its tiles synchronously
        (70, 100, 32, 32, torch.bfloat16),
        (72, 104, 16, 8, torch.bfloat16),  # aligned and ragged
        (40, 72, 48, 40, torch.bfloat16),  # a second, partial block of channels
        (5, 7, 16, 8, torch.bfloat16),  # smaller than one tile
        (8, 56, 32, 32, torch.bfloat16),  # fewer tiles (2) than ring stages
        (1024, 1024, 32, 32, torch.bfloat16),
        (1024, 1024, 64, 32, torch.bfloat16),
    ]
    entries = _conv_entries(torch)
    max_err = {name: 0.0 for name in entries}
    timed = wide = None
    timed_bodies = {}
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
                wb = 0
                body = conv.conv3x3_nhwc_body(x, wk)
                got = run(x, w, b)
                want = conv.conv3x3_nhwc_reference(x, wk, bk)
            else:
                flatten, conv_fn, _, _, wb_of = flat
                wb = wb_of(w_img)
                xf = flatten(x)
                body = conv.conv3x3_flat_chw_body(xf, wk, h, w_img, wb, g.MARGIN)
                got = conv_fn(xf, w, b, h, w_img)
                want = conv.conv3x3_flat_chw_reference(xf, wk, bk, h, w_img, wb, g.MARGIN)
                cols = got.reshape(c_out, h, wb)
                if bool((cols[:, :, 0] != 0).any()) or bool((cols[:, :, w_img + 1:] != 0).any()):
                    raise AssertionError(f"{name} {shape}: pad columns are not zero")
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != dtype:
                raise AssertionError(f"{name} {shape}: {got.shape} {got.dtype}")
            if body["body"] != _expected_body(torch, name, w_img, c_in, dtype, wb):
                raise AssertionError(f"{name} {shape}: the launcher picked {body}")
            if timed is not None and x is timed[0]:
                timed_bodies[name] = body
            ran = (
                f"body {body['body']}{' by TMA' if body['tma'] else ''}, {body['stages']} tiles in flight, "
                f"{body['blocks_per_sm']} blocks an SM, {body['smem_bytes']} B shared"
            )
            if dtype == torch.float32:
                err = float((got - want).abs().max())
                max_err[name] = max(max_err[name], err)
                if not err <= F32_CONV_BAR:
                    raise AssertionError(f"{name} {shape}: max |diff| {err} > {F32_CONV_BAR}")
                print(f"kernel {name} {shape}: max |diff| vs plain {err:.3g} (bar {F32_CONV_BAR}); {ran}")
            else:
                equal, worst = _hold_bf16(torch, f"{name} {shape}", got, want)
                print(
                    f"kernel {name} {shape}: {equal:.6f} of outputs equal to plain "
                    f"(bar {BF16_EQUAL_BAR}), worst {worst:.3g} bf16 steps (bar {BF16_STEPS_BAR}); {ran}"
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
    # a device-to-device copy of x: as many bytes read and written as the NHWC
    # conv moves, at the rate the card's memory gives a mixed stream
    y_copy = torch.empty_like(x)
    copy_ms = _median_ms(lambda: y_copy.copy_(x))
    print(
        f"kernel yardstick device-to-device copy of {x.numel() * 2} bytes: {copy_ms:.5f} ms "
        f"({2 * x.numel() * 2 / copy_ms / 1e9:.3f} TB/s read + written)"
    )
    ops = 2 * 9 * c_in * c_out * h * w_img
    out = []
    for name, (run, flat) in entries.items():
        body = timed_bodies[name]
        if body["body"] != "mma_pipelined" or body["stages"] < 2:
            raise AssertionError(f"{name}: the timed shape ran {body}, not the pipelined body")
        # ms: the entry point as a user calls it (it packs the weights: two
        # small cast kernels); kernel_ms: the kernel alone on packed weights
        if flat is None:
            ms = _median_ms(lambda: run(x, w, b))
            kernel_ms = _median_ms(lambda: conv.conv3x3_nhwc(x, wk, bk))
            plain_ms = _median_ms(lambda: conv.conv3x3_nhwc_reference(x, wk, bk), n=20)
            in_elems, out_elems = x.numel(), h * w_img * c_out
        else:
            flatten, conv_fn, _, _, wb_of = flat
            wb = wb_of(w_img)
            xf = flatten(x)
            ms = _median_ms(lambda: conv_fn(xf, w, b, h, w_img))
            kernel_ms = _median_ms(
                lambda: conv.conv3x3_flat_chw(xf, wk, bk, h, w_img, wb, g.MARGIN)
            )
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
            "kernel_ms": kernel_ms,
            "body": body["body"],
            "stages": body["stages"],
            "blocks_per_sm": body["blocks_per_sm"],
            "tma": body["tma"],
        }
        print(
            f"kernel {name} 1024x1024 32->32 bf16 relu: {ms:.5f} ms as called, {kernel_ms:.5f} ms "
            f"the kernel alone ({entry['bound_ms'] / kernel_ms:.3f} of its bound), body "
            f"{body['body']}{' by TMA' if body['tma'] else ''} with {body['stages']} tiles in flight and {body['blocks_per_sm']} "
            f"blocks an SM, plain {plain_ms:.5f} ms, "
            f"F.conv2d + cast + bias + relu + cast {library_ms:.5f} ms, bound "
            f"{entry['bound_ms']:.5f} ms ({entry['bound_by']}: {bytes_moved} bytes, {ops} operations)"
        )
        out.append(entry)
    # the wider level-0 conv (dec0's first: 64 -> 32), times as called only
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


def _profiled(torch, fn, reps=2):
    """``_device_ops``' count and ms per call of ``fn``, the layout
    transposes among its operations, and its six costliest kernels."""
    ops = _device_events(torch, fn, reps)
    layout_ops = [
        e for e in ops if any(w in e.name.lower() for w in ("tonchw", "tonhwc", "transpose"))
    ]
    layout = sorted({e.name[:80] for e in layout_ops})
    if layout:
        layout = [
            f"{len(layout_ops) / reps:.0f} a call, {_ms(layout_ops, reps):.4f} device ms: "
            + "; ".join(layout)
        ]
    by_name = {}
    for e in ops:
        by_name.setdefault(e.name, []).append(e)
    top = sorted(by_name.items(), key=lambda kv: -_ms(kv[1], reps))[:6]
    return len(ops) / reps, _ms(ops, reps), layout, [(n[:90], _ms(es, reps)) for n, es in top]


def _peak_gb(torch, fn):
    """``fn()``'s result and the card's peak allocated memory during it, GB."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 1e9


def volume_phase(torch, fixtures, unet):
    """unet3d_cells on the card: f32 against the CPU, then the volumetric
    polyphase forward against the standard one, f32 at 8x64x64 and bf16 at
    the served 32x512x512, timed, with peak memory and device operations."""
    from sequitr_tpu_torch.models import polyphase

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(13)
    _, _, cpu_model, _ = fixtures.load("unet3d_cells", compute_dtype="float32", device="cpu")
    _, _, gpu_model, _ = fixtures.load("unet3d_cells", compute_dtype="float32", device="cuda")
    x = torch.rand((1, 8, 64, 64, 1), generator=gen)
    with torch.inference_mode():
        want = cpu_model(x)
        got = gpu_model(x.cuda()).cpu()
    err = float((got - want).abs().max())
    print(f"volume unet3d_cells f32 8x64x64: card vs CPU max |logit diff| {err:.3g}")
    if not err < 1e-3:
        raise AssertionError(f"3D card and CPU logits differ by {err}")
    out = {}
    for dtype, shape, n in (("float32", (8, 64, 64), 20), ("bfloat16", VOLUME, 5)):
        _, _, model, _ = fixtures.load("unet3d_cells", compute_dtype=dtype, device="cuda")
        model = unet.fold_batchnorm(model)
        poly = polyphase.Polyphase3d(model)
        x = torch.rand((1,) + shape + (1,), generator=gen).cuda()
        with torch.inference_mode():
            base, base_gb = _peak_gb(torch, lambda: model(x))
            got, poly_gb = _peak_gb(torch, lambda: poly(x))
            rel = float((got - base).abs().max() / base.abs().max())
            agree = float((got.argmax(-1) == base.argmax(-1)).float().mean())
            del base, got
            base_ms = _median_ms(lambda: model(x), n=n)
            poly_ms = _median_ms(lambda: poly(x), n=n)
            ops, dev_ms, layout, top = _profiled(torch, lambda: model(x))
            p_ops, p_dev_ms, p_layout, p_top = _profiled(torch, lambda: poly(x))
        mvox = shape[0] * shape[1] * shape[2] / 1e6
        print(
            f"volume unet3d_cells {dtype} {'x'.join(map(str, shape))}: polyphase rel err {rel:.3g}, "
            f"argmax agreement {agree:.6f}; standard {base_ms:.4f} ms ({mvox / base_ms * 1e3:.1f} Mvox/s), "
            f"peak {base_gb:.3f} GB, {ops:.0f} device ops ({dev_ms:.4f} device ms), layout transposes "
            f"{layout or 'none'}; polyphase {poly_ms:.4f} ms ({mvox / poly_ms * 1e3:.1f} Mvox/s), peak "
            f"{poly_gb:.3f} GB, {p_ops:.0f} device ops ({p_dev_ms:.4f} device ms), layout transposes "
            f"{p_layout or 'none'}"
        )
        for which, rows in (("standard", top), ("polyphase", p_top)):
            for name, ms in rows:
                print(f"volume {dtype} {which} {ms:.4f} ms/forward {name}")
        if dtype == "bfloat16":
            # which convs of the standard forward bring layout transposes
            calls, conv_fn = [], model._conv
            model._conv = lambda t, p: calls.append((t, p)) or conv_fn(t, p)
            with torch.inference_mode():
                model(x)
            del model._conv
            for i, (t, p) in enumerate(calls):
                with torch.inference_mode():
                    n_ops, _, t_layout, _ = _profiled(torch, lambda: model._conv(t, p), reps=1)
                if t_layout:
                    print(
                        f"volume bf16 conv {i} (weight {tuple(p.w.shape)}, input "
                        f"{tuple(t.shape)} {t.dtype}): {t_layout[0]}"
                    )
            del calls
        if dtype == "float32" and not rel < 1e-5:
            raise AssertionError(f"3D polyphase f32 relative error {rel} >= 1e-5")
        if agree < POLY_AGREE_BAR:
            raise AssertionError(f"3D polyphase {dtype} argmax agreement {agree} < {POLY_AGREE_BAR}")
        out[dtype] = dict(standard_ms=base_ms, polyphase_ms=poly_ms, standard_gb=base_gb,
                          polyphase_gb=poly_gb, ops=ops, polyphase_ops=p_ops)
    return out


def enhance_phase(torch, fixtures, unet):
    """The folded gan_denoise generator and n2v_cells at 1024x1024: the card
    against the CPU at f32 (TF32 off), then timed at bf16."""
    from sequitr_tpu_torch.models import gan

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(17)
    x = torch.rand((1, 1024, 1024, 1), generator=gen)

    def served(name, dtype, device):
        kind, _, model, _ = fixtures.load(name, compute_dtype=dtype, device=device)
        if kind == "gan":
            model = gan.fold_generator(model)
            return lambda t: gan.generator_apply(model, t)
        model = unet.fold_batchnorm(model)
        return model

    for name in ("gan_denoise", "n2v_cells"):
        with torch.inference_mode():
            want = served(name, "float32", "cpu")(x)
            got = served(name, "float32", "cuda")(x.cuda()).cpu()
            err = float((got - want).abs().max())
            fwd = served(name, "bfloat16", "cuda")
            xc = x.cuda()
            ms = _median_ms(lambda: fwd(xc), n=20)
            ops, dev_ms, layout, _ = _profiled(torch, lambda: fwd(xc))
        print(
            f"enhance {name} 1024x1024: f32 card vs CPU max |diff| {err:.3g}; bf16 folded forward "
            f"{ms:.4f} ms ({1e3 / ms:.2f} frames/s), {ops:.0f} device ops ({dev_ms:.4f} device ms), "
            f"layout transposes {layout or 'none'}"
        )
        if not err < 1e-3:
            raise AssertionError(f"{name}: card and CPU differ by {err}")


def _profile_stream(torch, label, run, n, unit, top=10):
    """One warm ``run()`` (``n`` items streamed to the host) under
    torch.profiler: wall ms an item, the card's busy time (the union of its
    kernels' spans), device ops an item, peak memory, and the costliest
    kernels; and the wall time of a run without the profiler, over which
    the busy share is taken (the profiler's own host work once tripled a
    stream's wall time). Returns the plain wall (s), the busy time (us),
    device ops an item and the kernels' device time by name (us)."""
    run()  # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
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
    print(
        f"profile {label} x{n}: {plain_wall / n * 1e3:.4f} ms/{unit} wall "
        f"({wall / n * 1e3:.4f} under the profiler), card busy {busy / 1e3 / n:.4f} ms/{unit} "
        f"({busy / (plain_wall * 1e6):.3f} of the wall), "
        f"{len(kernels) / n:.1f} device ops/{unit}, peak {peak_gb:.3f} GB"
    )
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        print(f"profile {us / 1e3 / n:.4f} ms/{unit} {name[:110]}")
    return plain_wall, busy, len(kernels) / n, by_name


def profile_phase(torch, fixtures, unet):
    """Where a served item's time goes, under torch.profiler: the
    labels-only whole-frame path (the default 2D job) streaming 1024x1024
    uint16 frames; the default 3D job's tiled path and the whole-volume
    polyphase path streaming 32x512x512 uint16 volumes; the GAN enhancer
    streaming 1024x1024 frames."""
    import numpy as np

    from sequitr_tpu_torch.models import gan
    from sequitr_tpu_torch.pipeline import infer

    rng = np.random.default_rng(5)

    def streamed(fn, model, items, labels=True):
        def run():
            if labels:
                for r in infer.infer_stack(fn, model, iter(items), device="cuda"):
                    np.asarray(r.labels)
            else:
                for out in infer.stream_frames(
                    lambda f: fn(model, f), iter(items),
                    prefetch_host=infer._copy_to_host_async, device="cuda",
                ):
                    np.asarray(out)

        return run

    _, cfg, model, _ = fixtures.load("unet2d_cells", device="cuda")
    model = unet.fold_batchnorm(model)
    tc = infer.TileConfig(
        patch=(1024, 1024), overlap=(0, 0), emit_probs=False, labels_dtype="uint16"
    )
    fn = infer.make_frame_inferrer(cfg, tc, (1024, 1024), device="cuda")
    frames = [rng.gamma(2.0, 60.0, (1024, 1024)).astype(np.uint16) for _ in range(8)]
    _profile_stream(torch, "labels-only 1024x1024 uint16", streamed(fn, model, frames), 8, "frame")

    _, cfg3, model3, _ = fixtures.load("unet3d_cells", device="cuda")
    model3 = unet.fold_batchnorm(model3)
    vols = [rng.gamma(2.0, 60.0, VOLUME).astype(np.uint16) for _ in range(2)]
    for label, kw in (
        ("volume default tiling 16x128x128/4x32x32", dict(patch=(16, 128, 128), overlap=(4, 32, 32))),
        ("volume whole, polyphase", dict(patch=VOLUME, overlap=(0, 0, 0), polyphase=True)),
    ):
        tc3 = infer.TileConfig(emit_probs=False, labels_dtype="uint16", **kw)
        fn3 = infer.make_frame_inferrer(cfg3, tc3, VOLUME, device="cuda")
        _profile_stream(
            torch, f"{label} 32x512x512 uint16", streamed(fn3, model3, vols), 2, "volume", top=8
        )

    _, gcfg, gmodel, _ = fixtures.load("gan_denoise", device="cuda")
    gmodel = gan.fold_generator(gmodel)
    gtc = infer.TileConfig(patch=(1024, 1024), overlap=(0, 0))
    enhance = infer.make_gan_enhancer(gcfg, gtc, (1024, 1024), device="cuda")
    _profile_stream(
        torch, "enhancement_gan 1024x1024 uint16", streamed(enhance, gmodel, frames, labels=False),
        8, "frame", top=8,
    )


def instances_phase(torch, smi_line):
    """The instance families on the card (TF32 off): f32 against the CPU,
    the Euler kernel against the eager loop on the card (bit for bit),
    fidelity of the bf16 device path (fidelity.py's flows and stars meters),
    then where the time goes at 1024x1024 under torch.profiler: the forward,
    the Euler kernel and its eager loop, the doubling integrator and the
    host grouping. Returns the ``follow_flows`` entry of the kernels line
    (its launches are filled from the served jobs)."""
    import numpy as np

    from sequitr_tpu_torch import fidelity
    from sequitr_tpu_torch.data import synthetic
    from sequitr_tpu_torch.models import fixtures, unet
    from sequitr_tpu_torch.ops import flows, stardist
    from sequitr_tpu_torch.ops.kernels import flows as flow_kernels

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    img, truth = synthetic.instances_frame(INSTANCE_SEED, INSTANCE_FRAME)
    frame = img.clip(0, 65535).astype(np.uint16)

    # (1) f32, the card against the CPU on one 1024x1024 frame
    for name in ("flows_cells", "stars_cells"):
        t0 = time.perf_counter()
        a_card, b_card = fidelity.instance_pass(name, "float32", "exact", "cuda")(frame)
        a_cpu, b_cpu = fidelity.instance_pass(name, "float32", "exact", "cpu")(frame)
        cpu_s = time.perf_counter() - t0
        ap = fidelity.ap50(fidelity.instances_of(name, a_cpu, b_cpu), fidelity.instances_of(name, a_card, b_card))
        if name == "flows_cells":
            prob_err = float(np.abs(b_card - b_cpu).max())
            fg = b_cpu > 0.5
            near = float(np.mean(np.abs(a_card - a_cpu).max(-1)[fg] <= INST_FINAL_PX))
            print(
                f"instances f32 flows_cells 1024x1024 card vs CPU: max |prob diff| {prob_err:.3g} (bar "
                f"{INST_PROB_BAR}), final positions within {INST_FINAL_PX} px on {near:.6f} of foreground "
                f"pixels (bar {INST_FINAL_SHARE}), group_sinks ap50 {ap} (both passes {cpu_s:.1f} s)"
            )
            ok = prob_err <= INST_PROB_BAR and near >= INST_FINAL_SHARE
        else:
            prob_err = float(np.abs(a_card - a_cpu).max())
            dist_err = float(np.abs(b_card - b_cpu).max())
            print(
                f"instances f32 stars_cells 1024x1024 card vs CPU: max |prob diff| {prob_err:.3g} (bar "
                f"{INST_PROB_BAR}), max |dist diff| {dist_err:.3g} (bar {INST_DIST_BAR}), "
                f"instances_from_rays ap50 {ap} (both passes {cpu_s:.1f} s)"
            )
            ok = prob_err <= INST_PROB_BAR and dist_err <= INST_DIST_BAR
        if not (ok and ap == 1.0):
            raise AssertionError(f"instances: {name} f32 card and CPU disagree")
    # the doubling integrator's indices on one field, card against CPU
    field, fprob = flows.flow_targets(truth)
    field = field + np.random.default_rng(7).normal(size=field.shape).astype(np.float32) * 0.2
    mask = fprob > 0.5
    d_card = flows.follow_flows_doubling(field, mask, n_iter=200, device="cuda").cpu().numpy()
    d_cpu = flows.follow_flows_doubling(field, mask, n_iter=200, device="cpu").numpy()
    print(f"instances follow_flows_doubling 1024x1024 (200 -> 256 steps): card equal to CPU {np.array_equal(d_card, d_cpu)}")
    if not np.array_equal(d_card, d_cpu):
        raise AssertionError("follow_flows_doubling: card and CPU indices differ")
    # the Euler kernel against the eager loop on the card, one launch a call:
    # this 1024x1024 field, then job (m)'s volume shape with a random field
    # under a random mask and under the cells' foreground
    dev_field = torch.from_numpy(field).cuda()
    dev_mask = torch.from_numpy(mask).cuda()
    rng = np.random.default_rng(8)
    vol_field = rng.normal(size=INST_VOLUME + (3,)).astype(np.float32)
    vol_cells = synthetic.cells_volume(31_700, INST_VOLUME)[1] > 0
    cases = [
        ("1024x1024", dev_field, dev_mask),
        (f"{INST_VOLUME} random mask", vol_field, rng.random(INST_VOLUME) < 0.4),
        (f"{INST_VOLUME} the cells' foreground", vol_field, vol_cells),
    ]
    for label, f, m in cases:
        f, m = torch.as_tensor(f, device="cuda"), torch.as_tensor(m, device="cuda")
        before = flow_kernels.euler.launches
        kernel_pos = flows.follow_flows(f, m, n_iter=200)
        eager_pos = flows.follow_flows_reference(f, m, n_iter=200)
        torch.cuda.synchronize()
        same = torch.equal(kernel_pos, eager_pos)
        launched = flow_kernels.euler.launches - before
        print(
            f"instances follow_flows {label} 200 steps ({float(m.float().mean()):.4%} foreground): Euler "
            f"kernel equal to the eager loop on the card {same}, {launched} launch"
        )
        if not same or launched != 1:
            raise AssertionError(f"follow_flows {label}: the Euler kernel and the eager loop differ on the card")

    # (2) fidelity.py's flows and stars meters: the bf16 device path with the
    # kernel normalize against the f32 exact-normalize path on the card, and
    # against the truth; stars serve through polyphase, as the meter and
    # bench_stars do
    meters = {}
    for name, meter in (("flows_cells", fidelity.flows_fidelity), ("stars_cells", fidelity.stars_fidelity)):
        r = meter(frame_shape=INSTANCE_FRAME, n=2, seed0=INSTANCE_SEED, device="cuda")
        meters[name] = r["ap50_vs_ref"]
        print(
            f"instances fidelity {name} 2 frames 1024x1024 (seeds {INSTANCE_SEED}+i): ap50_vs_ref "
            f"{r['ap50_vs_ref']:.6f} (bar {AP50_BAR}; ref: f32, exact normalize, on the card), ap50_truth "
            f"{r['ap50_truth']:.6f}, matched_iou_truth {r['matched_iou_truth']:.6f} (fidelity.py)"
        )
    if min(meters.values()) < AP50_BAR:
        raise AssertionError(f"instances fidelity {meters} < {AP50_BAR}")

    # (3) where the time goes, bf16 at 1024x1024
    _, cfg, model, _ = fixtures.load("flows_cells", device="cuda")
    model = unet.fold_batchnorm(model)
    x = torch.rand((1, 1024, 1024, 1), device="cuda")

    # no host sync: the integrators alone must not make one (an error), and
    # the serving pass of a frame already on the card is watched for any
    import warnings

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        flows.follow_flows(dev_field, dev_mask, n_iter=200)
        flows.follow_flows_doubling(dev_field, dev_mask, n_iter=200)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    from sequitr_tpu_torch.pipeline import infer

    _, fcfg, fmodel, _ = fixtures.load("flows_cells", device="cuda")
    fn = infer.make_flows_segmenter(
        fcfg, infer.TileConfig(patch=INSTANCE_FRAME, overlap=(0, 0)), INSTANCE_FRAME, device="cuda"
    )
    dev_frame = torch.from_numpy(frame).cuda()
    fn(fmodel, dev_frame)  # built, folded and warm
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn(fmodel, dev_frame)
            fn(fmodel, dev_frame)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [str(w.message)[:80] for w in caught if "synchroniz" in str(w.message)]
    print(
        f"instances no-sync: follow_flows and follow_flows_doubling ran under set_sync_debug_mode('error'); "
        f"the flows serving pass of a frame on the card made {len(syncs)} synchronizing calls in two frames "
        f"(after its first){': ' + '; '.join(sorted(set(syncs))) if syncs else ''}"
    )

    def timed(label, fn, reps):
        with torch.inference_mode():
            n_ops, dev_ms, _, top = _profiled(torch, fn, reps=reps)
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / reps * 1e3
        print(
            f"instances time {label}: {wall:.4f} ms wall, {dev_ms:.4f} device ms, {n_ops:.0f} device ops "
            f"a call on {smi_line}; largest: " + "; ".join(f"{n} {ms:.4f}" for n, ms in top[:3])
        )
        return wall, dev_ms, n_ops

    times = {
        "forward": timed("flows_cells bf16 forward 1x1024x1024", lambda: model(x), 5),
        "euler": timed(
            "follow_flows euler 200 steps 1024x1024 (the kernel)",
            lambda: flows.follow_flows(dev_field, dev_mask, n_iter=200), 20,
        ),
        "euler_plain": timed(
            "follow_flows_reference euler 200 steps 1024x1024 (the eager loop)",
            lambda: flows.follow_flows_reference(dev_field, dev_mask, n_iter=200), 2,
        ),
        "doubling": timed(
            "follow_flows_doubling 200 (256) steps 1024x1024",
            lambda: flows.follow_flows_doubling(dev_field, dev_mask, n_iter=200), 5,
        ),
    }
    a, b = fidelity.instance_pass("flows_cells", "bfloat16", "auto", "cuda")(frame)
    p, d = fidelity.instance_pass("stars_cells", "bfloat16", "auto", "cuda", polyphase=True)(frame)
    host = {}
    for label, fn in (("group_sinks", lambda: flows.group_sinks(a, b > 0.5)),
                      ("instances_from_rays", lambda: stardist.instances_from_rays(p, d))):
        fn()
        t0 = time.perf_counter()
        for _ in range(3):
            fn()
        host[label] = (time.perf_counter() - t0) / 3 * 1e3
    print(
        f"instances host per 1024x1024 frame: group_sinks {host['group_sinks']:.4f} ms, "
        f"instances_from_rays {host['instances_from_rays']:.4f} ms (host CPU of the card's machine)"
    )
    euler, fwd = times["euler"], times["forward"]
    # the bound euler_roofline takes: 32 FLOP a foreground pixel-step at the
    # f32 peak, or 1 B a pixel and 16 B a foreground pixel at 3.35 TB/s
    fg = float(mask.sum())
    t_ops = 1e3 * 32 * 200 * fg / 66.9e12
    t_bytes = 1e3 * (mask.size + 16 * fg) / H100_BYTES_PER_S
    bound_ms = max(t_ops, t_bytes)
    print(
        f"instances Euler kernel: {euler[1]:.4f} device ms a frame against its bound {bound_ms:.6f} ms "
        f"({100 * bound_ms / euler[1]:.4f}% of it), {euler[2]:.0f} launch a frame; the eager loop "
        f"{times['euler_plain'][1]:.4f} device ms, {times['euler_plain'][2]:.0f} launches a frame"
    )
    print(
        f"instances: Euler integration {euler[1]:.4f} device ms / {euler[0]:.4f} ms wall against the "
        f"forward's {fwd[1]:.4f} device ms / {fwd[0]:.4f} ms wall ({euler[0] / fwd[0]:.2f}x by wall)"
    )
    return {
        "name": "follow_flows",
        "route": "cuda",
        "source": "sequitr_tpu_torch/csrc/flows.cu",
        "replaces": "none: the JAX package's lax.scan (sequitr_tpu/ops/flows.py::follow_flows)",
        "launches": None,
        "max_abs_err": 0,
        "ms": euler[0],
        "kernel_ms": euler[1],
        "plain_ms": times["euler_plain"][1],
        "plain_launches": times["euler_plain"][2],
        "bound_ms": bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "shape": f"1024x1024, 200 steps, {fg / mask.size:.4%} foreground",
    }


def serve_phase(torch, hist, conv, smi_line):
    """The served jobs through ImageServer on the card, one at a time, each
    with its own launch counts. Returns {job: (histogram_2d launches,
    quantile passes)}."""
    import numpy as np

    from sequitr_tpu_torch import __main__ as cli
    from sequitr_tpu_torch import fidelity
    from sequitr_tpu_torch.config import ServerConfiguration
    from sequitr_tpu_torch.data import synthetic, tiff
    from sequitr_tpu_torch.models import fixtures, unet
    from sequitr_tpu_torch.pipeline import infer
    from sequitr_tpu_torch.server import ImageServer, submit_job
    from sequitr_tpu_torch.server.server import load_model, save_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # the dtypes the served path relies on, on the card
    probe = torch.tensor([0, 1, 65535], dtype=torch.int32).to(torch.uint16).cuda()
    if probe.to(torch.float32).cpu().tolist() != [0.0, 1.0, 65535.0]:
        raise AssertionError("uint16 -> float32 on the card")
    if torch.tensor([2, 7], device="cuda").to(torch.uint16).cpu().numpy().tolist() != [2, 7]:
        raise AssertionError("label cast to uint16 on the card")

    with tempfile.TemporaryDirectory() as tmp:
        jobs, models = os.path.join(tmp, "jobs"), os.path.join(tmp, "models")
        for name in ("unet2d_cells", "unet3d_cells", "gan_denoise", "n2v_cells", "flows_cells", "stars_cells"):
            meta = fixtures.manifest()[name]
            arch = os.path.join(tmp, f"{name}.json")
            with open(arch, "w") as f:
                json.dump(dict(meta["config"], __kind__=meta["kind"]), f)
            npz = os.path.join(fixtures.fixture_dir(), f"{name}.npz")
            if cli.main(["import-model", "--models-dir", models, "--npz", npz, "--arch", arch, name]):
                raise AssertionError(f"import-model {name} failed")

        def write(name, arr):
            path = os.path.join(tmp, name)
            tiff.write_stack(path, arr)
            return path

        scenes = [synthetic.cells_frame(424_000 + i, (1024, 1024)) for i in range(4)]
        frames = np.stack([img for img, _ in scenes]).clip(0, 65535).astype(np.uint16)
        truth_labels = [lab for _, lab in scenes]
        stack = write("stack.tif", frames)
        vols = [synthetic.cells_volume(31_600 + t, VOLUME)[0] for t in range(2)]
        vols = np.stack(vols).clip(0, 65535).astype(np.uint16)
        volume = write("volume.tif", vols[0])
        paged = write("paged.tif", vols.reshape((-1,) + VOLUME[1:]))
        gan_frames = np.stack(
            [synthetic.cells_frame(434_000 + i, (1024, 1024))[0] for i in range(4)]
        ).clip(0, 65535).astype(np.uint16)
        gan_stack = write("gan_stack.tif", gan_frames)
        pairs = [synthetic.denoise_pair(515_000 + i, (1024, 1024)) for i in range(4)]
        noisy = np.stack([n for _, n in pairs]).astype(np.float32)
        clean = np.stack([c for c, _ in pairs])
        noisy_stack = write("noisy.tif", noisy)
        inst_scenes = [synthetic.instances_frame(INSTANCE_SEED + i, INSTANCE_FRAME) for i in range(4)]
        inst_frames = np.stack([img for img, _ in inst_scenes]).clip(0, 65535).astype(np.uint16)
        inst_stack = write("instances.tif", inst_frames)
        inst_vols = np.stack(
            [synthetic.cells_volume(31_700 + t, INST_VOLUME)[0] for t in range(2)]
        ).clip(0, 65535).astype(np.uint16)
        inst_paged = write("instances_paged.tif", inst_vols.reshape((-1,) + INST_VOLUME[1:]))
        # job (m)'s model: unet3d_cells' architecture with a flows head, from unet.init
        cfg_m = unet.UNetConfig(
            dims=3, depth=3, base_features=32, features_cap=256, num_classes=4, norm="batch"
        )
        save_model(models, "flows3d", "flows", cfg_m, unet.init(cfg_m, torch.Generator().manual_seed(17), device="cpu"))

        specs = {
            "a": ("segmentation_unet2d", "unet2d_cells", stack, {"localize": False}),
            "b": ("segmentation_unet2d", "unet2d_cells", stack,
                  {"localize": False, "save_probs": True, "patch": [512, 512], "overlap": [64, 64]}),
            "c": ("segmentation_unet2d", "unet2d_cells", stack, {"localize": False, "polyphase": True}),
            "d": ("segmentation_unet3d", "unet3d_cells", volume, {"localize": False}),
            "e": ("segmentation_unet3d", "unet3d_cells", volume,
                  {"localize": False, "patch": list(VOLUME), "overlap": [0, 0, 0], "polyphase": True}),
            "f": ("segmentation_unet3d", "unet3d_cells", paged, {"localize": False, "z": VOLUME[0]}),
            "g": ("enhancement_gan", "gan_denoise", gan_stack, {}),
            "h": ("denoise", "n2v_cells", noisy_stack, {"normalize": "none"}),
            "i": ("denoise", "n2v_cells", noisy_stack, {}),
            "j": ("segment_flows", "flows_cells", inst_stack, {"localize": False}),
            "k": ("segment_flows", "flows_cells", inst_stack, {"localize": False, "integrator": "doubling"}),
            "l": ("segment_stars", "stars_cells", inst_stack, {"localize": False, "polyphase": True}),
            "m": ("segment_flows", "flows3d", inst_paged, {"localize": False, "z": INST_VOLUME[0]}),
        }
        units = {
            "a": 4, "b": 4, "c": 4, "d": 1, "e": 1, "f": 2, "g": 4, "h": 4, "i": 4,
            "j": 4, "k": 4, "l": 4, "m": 2,
        }
        server = ImageServer(ServerConfiguration(jobs_dir=jobs, models_dir=models, device="cuda"))
        counts, outputs, peaks = {}, {}, {}
        for name, (module, model, path, params) in specs.items():
            submit_job(jobs, {
                "module": module, "params": dict(model=model, **params),
                "input": [path], "output": os.path.join(tmp, f"out_{name}"),
            })
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            hist.histogram_2d.launches = 0
            hist.quantile_pass.launches = 0
            conv.conv3x3_nhwc.launches = 0
            conv.conv3x3_flat_chw.launches = 0
            _euler().launches = 0
            if not server.poll_once():
                raise AssertionError(f"job {name}: no job to run")
            torch.cuda.synchronize()
            counts[name] = (hist.histogram_2d.launches, hist.quantile_pass.launches)
            conv_launches = conv.conv3x3_nhwc.launches + conv.conv3x3_flat_chw.launches
            euler_launches = _euler_read(name, _euler_want(module, params, units[name]))
            peaks[name] = torch.cuda.max_memory_allocated() / 1e9
            with open(os.path.join(tmp, f"out_{name}", "status.json")) as f:
                status = json.load(f)
            if status["state"] != "complete":
                raise AssertionError(f"job {name}: {status.get('error')}")
            outputs[name] = status["outputs"]
            metrics = json.loads(status["outputs"]["metrics"])
            print(
                f"serve job {name} {module} {model} {json.dumps(params_summary(params))}: "
                f"frames_per_sec {metrics.get('frames_per_sec')} mvox_per_sec "
                f"{metrics.get('mvox_per_sec')} volumes_per_sec {metrics.get('volumes_per_sec')} "
                f"peak {peaks[name]:.3f} GB on {smi_line} (metrics {json.dumps(metrics)})"
            )
            # (h) normalizes with "none": its path runs no quantile pass
            want_passes = 0 if params.get("normalize") == "none" else units[name]
            print(
                f"serve job {name} histogram_2d launches {counts[name][0]} in {counts[name][1]} quantile "
                f"passes (each min/max + counts) for {units[name]} served frames or volumes (expected "
                f"{want_passes} passes); conv3x3 study kernels launched {conv_launches} times; the Euler "
                f"kernel {euler_launches} times"
            )
            if conv_launches:
                raise AssertionError(f"job {name}: served path launched a study kernel")
            if counts[name] != (want_passes, want_passes):
                raise AssertionError(
                    f"job {name}: {counts[name][0]} histogram launches in {counts[name][1]} passes, "
                    f"expected {want_passes} of each"
                )

        def read(name, key="labels"):
            return tiff.read_stack(outputs[name][key])

        # 2D: the port's f32 exact-normalize path on the card as reference;
        # two more paths split the served path's disagreement between its
        # bf16 compute and its 1024-bin kernel normalize
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

        labels_a, labels_c = read("a"), read("c")
        for name in ("a", "b", "c"):
            labels = read(name)
            if labels.shape != (4, 1024, 1024) or labels.dtype != np.uint16:
                raise AssertionError(f"job {name}: labels {labels.shape} {labels.dtype}")
        probs = read("b", "probs")
        if probs.shape != (12, 1024, 1024) or not np.isfinite(probs).all():
            raise AssertionError(f"job b: probs {probs.shape}")
        k, ref = labels_of("float32", "exact")
        miou = float(np.mean([fidelity.miou(a, b, k) for a, b in zip(labels_a, ref)]))
        print(f"serve job a miou_vs_ref {miou:.6f} (bar {MIOU_BAR}; ref: f32, exact normalize, on the card)")
        for dtype, normalize in (("bfloat16", "exact"), ("float32", "pallas")):
            _, other = labels_of(dtype, normalize)
            part = float(np.mean([fidelity.miou(a, b, k) for a, b in zip(other, ref)]))
            print(f"serve fidelity split: {dtype} + {normalize} normalize vs ref miou {part:.6f}")
        truth = float(np.mean([fidelity.miou(a, b, k) for a, b in zip(labels_a, truth_labels)]))
        truth_ref = float(np.mean([fidelity.miou(a, b, k) for a, b in zip(ref, truth_labels)]))
        print(f"serve job a miou_truth {truth:.6f}, ref miou_truth {truth_ref:.6f}")
        if miou < MIOU_BAR:
            raise AssertionError(f"miou_vs_ref {miou} < {MIOU_BAR}")
        agree = float(np.mean(labels_c == labels_a))
        miou_c = float(np.mean([fidelity.miou(a, b, k) for a, b in zip(labels_c, ref)]))
        print(
            f"serve job c (polyphase) labels equal to job a's on {agree:.6f} of pixels "
            f"(bar {POLY_AGREE_BAR}), miou_vs_ref {miou_c:.6f}"
        )
        if agree < POLY_AGREE_BAR:
            raise AssertionError(f"polyphase job agrees with job a on {agree} < {POLY_AGREE_BAR}")

        # 3D: each job against the port's f32 exact-normalize path with the
        # job's own tiling (whole volume, untransformed, for (e))
        def volume_labels(vol, patch, overlap):
            _, cfg, model, _ = fixtures.load("unet3d_cells", compute_dtype="float32", device="cuda")
            tc = infer.TileConfig(patch=patch, overlap=overlap, normalize="exact", emit_probs=False)
            fn = infer.make_frame_inferrer(cfg, tc, VOLUME, device="cuda")
            return fn(unet.fold_batchnorm(model), torch.from_numpy(vol).cuda())[1].cpu().numpy()

        labels_d, labels_e = read("d"), read("e")
        for name, labels in (("d", labels_d), ("e", labels_e)):
            if labels.shape != VOLUME or labels.dtype != np.uint16:
                raise AssertionError(f"job {name}: labels {labels.shape} {labels.dtype}")
        ref_tiled = volume_labels(vols[0], (16, 128, 128), (4, 32, 32))
        ref_whole = volume_labels(vols[0], VOLUME, (0, 0, 0))
        miou_d = fidelity.miou(labels_d, ref_tiled, 3)
        miou_e = fidelity.miou(labels_e, ref_whole, 3)
        agree_de = float(np.mean(labels_e == labels_d))
        print(
            f"serve job d (tiled 16x128x128/4x32x32, 75 tiles) miou_vs_ref {miou_d:.6f}; job e "
            f"(whole volume, polyphase) miou_vs_ref {miou_e:.6f} (bar {MIOU3D_BAR}; ref: f32, exact "
            f"normalize, the job's own tiling, on the card); e vs d labels equal on {agree_de:.6f} "
            f"(bar {POLY_AGREE_BAR}); the two f32 references equal on "
            f"{float(np.mean(ref_tiled == ref_whole)):.6f}"
        )
        for t in range(2):
            lt = tiff.read_stack(os.path.join(outputs["f"]["labels"], f"labels_t{t:04d}.tif"))
            if lt.shape != VOLUME:
                raise AssertionError(f"job f: timepoint {t} labels {lt.shape}")
            if t == 0:
                same = float(np.mean(lt == labels_d))
                print(f"serve job f timepoint 0 labels equal to job d's (same volume) on {same:.6f}")
                if same < 0.9999:
                    raise AssertionError(f"job f: timepoint 0 agrees with job d on {same}")
        if min(miou_d, miou_e) < MIOU3D_BAR:
            raise AssertionError(f"3D miou_vs_ref d {miou_d}, e {miou_e} < {MIOU3D_BAR}")
        if agree_de < POLY_AGREE_BAR:
            raise AssertionError(f"job e agrees with job d on {agree_de} < {POLY_AGREE_BAR}")

        # GAN (fidelity.py::gan_fidelity): served output against the port's
        # f32 enhancer with the exact normalize, and against the smoothed
        # exactly normalized scene the fixture was trained toward
        _, gcfg, gmodel, _ = fixtures.load("gan_denoise", compute_dtype="float32", device="cuda")
        gtc = infer.TileConfig(patch=(1024, 1024), overlap=(0, 0), normalize="exact")
        enhance = infer.make_gan_enhancer(gcfg, gtc, (1024, 1024), device="cuda")
        enhanced = read("g", "enhanced")
        psnr_ref, psnr_tgt = [], []
        for f, dev in zip(gan_frames, enhanced):
            ref = enhance(gmodel, torch.from_numpy(f).cuda()).cpu().numpy()[..., 0]
            psnr_ref.append(fidelity.psnr_db(dev, ref))
            psnr_tgt.append(fidelity.psnr_db(dev, fidelity.gan_target(f)))
        g_psnr = float(np.mean(psnr_ref))
        print(
            f"serve job g psnr_vs_ref_db {g_psnr:.4f} (bar {PSNR_BAR_DB}; ref: f32, exact normalize, on "
            f"the card), psnr_target_db {float(np.mean(psnr_tgt)):.4f}"
        )

        # N2V (fidelity.py::n2v_fidelity): (h) against the port's f32
        # denoiser with normalize "none"; the pair's clean frames are the
        # truth. (i) runs the kernel normalize on the same frames, which puts
        # them outside the fixture's trained scale: it is held against the
        # port's bf16 denoiser called directly (the served plumbing), and its
        # distance from the f32 path is printed, not barred
        def denoised(dtype, normalize):
            _, ncfg, nmodel, _ = fixtures.load("n2v_cells", compute_dtype=dtype, device="cuda")
            ntc = infer.TileConfig(patch=(1024, 1024), overlap=(0, 0), normalize=normalize)
            den = infer.make_denoiser(ncfg, ntc, (1024, 1024), device="cuda")
            return [den(nmodel, torch.from_numpy(f).cuda()).float().cpu().numpy()[..., 0] for f in noisy]

        out_h, out_i = read("h", "denoised"), read("i", "denoised")
        h_psnr = float(np.mean([fidelity.psnr_db(a, b) for a, b in zip(out_h, denoised("float32", "none"))]))
        truth_db = float(np.mean([fidelity.psnr_db(a, c) for a, c in zip(out_h, clean)]))
        noisy_db = float(np.mean([fidelity.psnr_db(n, c) for n, c in zip(noisy, clean)]))
        print(
            f"serve job h psnr_vs_ref_db {h_psnr:.4f} (bar {PSNR_BAR_DB}; ref: f32, normalize 'none'), "
            f"psnr_truth_db {truth_db:.4f}, psnr_noisy_db {noisy_db:.4f}"
        )
        direct = denoised("bfloat16", "auto")
        i_psnr = float(np.mean([fidelity.psnr_db(a, b) for a, b in zip(out_i, direct)]))
        i_err = float(max(np.abs(a - b).max() for a, b in zip(out_i, direct)))
        i_f32 = float(np.mean([fidelity.psnr_db(a, b) for a, b in zip(out_i, denoised("float32", "auto"))]))
        print(
            f"serve job i (kernel normalize) against the bf16 denoiser called directly: max |diff| "
            f"{i_err:.3g}, psnr {i_psnr:.4f} dB (bar {PSNR_DIRECT_BAR_DB}); against the f32 path "
            f"{i_f32:.4f} dB (outside the trained scale; no bar)"
        )
        for what, value, bar in (
            ("g", g_psnr, PSNR_BAR_DB), ("h", h_psnr, PSNR_BAR_DB), ("i", i_psnr, PSNR_DIRECT_BAR_DB),
        ):
            if not value >= bar:
                raise AssertionError(f"job {what}: psnr {value} dB < {bar}")

        # instances (fidelity.py's flows and stars meters): each job's labels
        # against the port's f32 exact-normalize path on the card
        refs = {
            name: [fidelity.instances_of(name, *ref(f)) for f in inst_frames]
            for name, ref in (
                ("flows_cells", fidelity.instance_pass("flows_cells", "float32", "exact", "cuda")),
                ("stars_cells", fidelity.instance_pass("stars_cells", "float32", "exact", "cuda")),
            )
        }
        for name, fixture in (("j", "flows_cells"), ("k", "flows_cells"), ("l", "stars_cells")):
            labels = read(name)
            if labels.shape != (4,) + INSTANCE_FRAME or labels.dtype != np.uint16:
                raise AssertionError(f"job {name}: labels {labels.shape} {labels.dtype}")
            ap_ref = float(np.mean([fidelity.ap50(r, g) for r, g in zip(refs[fixture], labels)]))
            ap_truth = float(np.mean([fidelity.ap50(t, g) for (_, t), g in zip(inst_scenes, labels)]))
            fps = json.loads(outputs[name]["metrics"])["frames_per_sec"]
            print(
                f"serve job {name} {specs[name][0]} {json.dumps(params_summary(specs[name][3]))}: ap50_vs_ref "
                f"{ap_ref:.6f} (bar {AP50_BAR}; ref: f32, exact normalize, on the card), ap50_truth "
                f"{ap_truth:.6f}, {fps} frames/s on {smi_line}"
            )
            if ap_ref < AP50_BAR:
                raise AssertionError(f"job {name}: ap50_vs_ref {ap_ref} < {AP50_BAR}")
        ap_kj = float(np.mean([fidelity.ap50(a, b) for a, b in zip(read("j"), read("k"))]))
        print(f"serve job k (doubling) against job j (Euler): ap50 {ap_kj:.6f}")

        # (m): the volumes' labels against the same bf16 pass called directly,
        # and the model at f32, card against CPU, on positions (a 16x128x128
        # crop: the CPU's Euler steps over 2 M voxels take minutes)
        _, _, model_m = load_model(models, "flows3d", device="cuda")
        direct = fidelity.instance_pass("flows3d", None, "auto", "cuda", spatial=INST_VOLUME, model=model_m)
        ref_m = fidelity.instance_pass(
            "flows3d", None, "exact", "cuda", spatial=INST_VOLUME,
            model=_with_dtype(unet, model_m, "float32"),
        )
        for t in range(2):
            lt = tiff.read_stack(os.path.join(os.path.dirname(outputs["m"]["labels"]), f"labels_t{t:04d}.tif"))
            if lt.shape != INST_VOLUME or lt.dtype != np.uint16:
                raise AssertionError(f"job m: timepoint {t} labels {lt.shape} {lt.dtype}")
            want = fidelity.instances_of("flows3d", *direct(inst_vols[t]))
            same = float(np.mean(lt == want))
            vs_f32 = fidelity.ap50(fidelity.instances_of("flows3d", *ref_m(inst_vols[t])), lt)
            print(
                f"serve job m timepoint {t}: {int(lt.max())} instances, labels equal to the bf16 pass "
                f"called directly on {same:.6f}; ap50 against the f32 path {vs_f32:.6f} (random weights: "
                f"no bar)"
            )
            if same < 0.9999:
                raise AssertionError(f"job m: timepoint {t} agrees with its pass called directly on {same}")
        crop = inst_vols[0][:16, :128, :128]
        finals = []
        for dev in ("cuda", "cpu"):
            m32 = _with_dtype(unet, model_m, "float32").to(dev)
            finals.append(fidelity.instance_pass("flows3d", None, "exact", dev, spatial=crop.shape, model=m32)(crop))
        (fa, pa), (fb, pb) = finals
        fg = pb > 0.5
        near = float(np.mean(np.abs(fa - fb).max(-1)[fg] <= INST_FINAL_PX))
        print(
            f"serve job m model at f32, 16x128x128 crop, card vs CPU: max |prob diff| "
            f"{float(np.abs(pa - pb).max()):.3g}, positions within {INST_FINAL_PX} px on {near:.6f} of "
            f"foreground voxels (bar {INST_FINAL_SHARE})"
        )
        if near < INST_FINAL_SHARE or not float(np.abs(pa - pb).max()) <= INST_PROB_BAR:
            raise AssertionError("job m's model: f32 card and CPU disagree")
        return counts


def _same_metrics(what, got, want, tol=EVAL_FLOAT_BAR):
    """``got`` (a job's metrics) against ``want`` (recomputed on the host):
    every key of ``want`` present, counts equal, floats within ``tol``,
    lists item by item with their ``None``s."""
    for k, v in want.items():
        g = got.get(k)
        if isinstance(v, list):
            ok = isinstance(g, list) and len(g) == len(v) and all(
                (a is None and b is None) or (a is not None and b is not None and abs(a - b) <= tol)
                for a, b in zip(g, v)
            )
        elif isinstance(v, float):
            ok = g is not None and abs(g - v) <= tol
        else:
            ok = g == v
        if not ok:
            raise AssertionError(f"{what}: metric {k} {g} against {v} recomputed on the host")


def _pooled_ap(np, flows, truths, preds, per_key, thresholds=(0.5, 0.75, 0.9)):
    """Pooled instance AP of ``preds`` against ``truths`` (truth ids
    renumbered densely), the evaluate jobs' metrics recomputed."""
    tp = {t: 0 for t in thresholds}
    n_gt = n_pred = 0
    good, per = [], []
    for truth, pred in zip(truths, preds):
        ids = np.unique(truth[truth > 0])
        dense = np.zeros(int(truth.max()) + 1, np.int64)
        dense[ids] = np.arange(1, ids.size + 1)
        ious, g, p = flows.match_instances(dense[truth], pred)
        n_gt, n_pred = n_gt + g, n_pred + p
        for t in thresholds:
            tp[t] += int((ious >= t).sum())
        good.extend(ious[ious >= 0.5].tolist())
        m = int((ious >= 0.5).sum())
        per.append(round(m / (g + p - m), 6) if g + p - m else None)
    out = {"n_gt": n_gt, "n_pred": n_pred, per_key: per,
           "mean_matched_iou": round(float(np.sum(good)) / len(good), 6) if good else 0.0}
    for t in thresholds:
        d = n_gt + n_pred - tp[t]
        out[f"ap{int(round(t * 100))}"] = round(tp[t] / d, 6) if d else 1.0
    return out


def evaluate_phase(torch, hist, conv, smi_line):
    """The evaluation and parity jobs through ImageServer on the card, one at
    a time, each with its launch counts reset just before it and read just
    after, beside its serving twin: each job's metrics recomputed on the
    host from its own saved outputs (or its twin's) and the truth, its
    saved labels against the twin's, its quantile passes against the count
    its code gives, and its frames/s (frames over the job's wall time)
    against the twin's. Returns {job: (histogram_2d launches, quantile
    passes)}."""
    import numpy as np
    from scipy import ndimage

    from sequitr_tpu_torch import __main__ as cli
    from sequitr_tpu_torch import fidelity
    from sequitr_tpu_torch.config import ServerConfiguration
    from sequitr_tpu_torch.data import synthetic, tiff
    from sequitr_tpu_torch.models import convert, fixtures, unet
    from sequitr_tpu_torch.ops import flows, losses
    from sequitr_tpu_torch.pipeline import infer
    from sequitr_tpu_torch.server import ImageServer, submit_job
    from sequitr_tpu_torch.server.server import save_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        jobs, models = os.path.join(tmp, "jobs"), os.path.join(tmp, "models")
        names = ("unet2d_cells", "unet3d_cells", "gan_denoise", "n2v_cells", "flows_cells", "stars_cells")
        for name in names:
            meta = fixtures.manifest()[name]
            arch = os.path.join(tmp, f"{name}.json")
            with open(arch, "w") as f:
                json.dump(dict(meta["config"], __kind__=meta["kind"]), f)
            npz = os.path.join(fixtures.fixture_dir(), f"{name}.npz")
            if cli.main(["import-model", "--models-dir", models, "--npz", npz, "--arch", arch, name]):
                raise AssertionError(f"import-model {name} failed")
        # a copy of unet2d_cells with one kernel scaled by 1e6: parity_check
        # must refuse it (its logits reach ~1e6, where f32 round-off alone
        # breaks the 1e-3 tolerance)
        with np.load(os.path.join(fixtures.fixture_dir(), "unet2d_cells.npz")) as npz:
            flat = {k: npz[k].astype(np.float32) for k in npz.files}
        flat["enc/0/conv1/w"] = flat["enc/0/conv1/w"] * 1e6
        bad = os.path.join(tmp, "corrupt.npz")
        np.savez(bad, **flat)
        if cli.main(["import-model", "--models-dir", models, "--npz", bad, "--arch",
                     os.path.join(tmp, "unet2d_cells.json"), "unet2d_corrupt"]):
            raise AssertionError("import-model unet2d_corrupt failed")
        # no trained 3D N2V or 3D flows fixture: unet.init models of
        # unet3d_cells' architecture with a 1-channel and a flows head
        cfg_n = unet.UNetConfig(dims=3, depth=3, base_features=32, features_cap=256, num_classes=1)
        save_model(models, "n2v3d", "n2v", cfg_n, unet.init(cfg_n, torch.Generator().manual_seed(18), device="cpu"))
        cfg_m = unet.UNetConfig(dims=3, depth=3, base_features=32, features_cap=256, num_classes=4)
        save_model(models, "flows3d", "flows", cfg_m, unet.init(cfg_m, torch.Generator().manual_seed(17), device="cpu"))

        def write(name, arr):
            path = os.path.join(tmp, name)
            tiff.write_stack(path, arr)
            return path

        scenes = [synthetic.cells_frame(424_000 + i, (1024, 1024)) for i in range(4)]
        frames = np.stack([img for img, _ in scenes]).clip(0, 65535).astype(np.uint16)
        truth = np.stack([lab for _, lab in scenes]).astype(np.uint16)
        sparse = truth.copy()
        sparse[:, ::2] = 255  # every other row unannotated
        sparse[2] = 255  # frame 2 wholly unannotated
        vol, vlab = synthetic.cells_volume(31_600, VOLUME)
        vol = vol.clip(0, 65535).astype(np.uint16)
        gan_frames = np.stack([synthetic.cells_frame(434_000 + i, (1024, 1024))[0] for i in range(4)])
        gan_frames = gan_frames.clip(0, 65535).astype(np.uint16)
        gan_targets = np.stack([fidelity.gan_target(f) for f in gan_frames]).astype(np.float32)
        pairs = [synthetic.denoise_pair(515_000 + i, (1024, 1024)) for i in range(4)]
        noisy = np.stack([n for _, n in pairs]).astype(np.float32)
        clean = np.stack([c for c, _ in pairs]).astype(np.float32)
        clean_v = np.stack([synthetic.cells_volume(515_800 + t, INST_VOLUME)[0] for t in range(2)]).astype(np.float32)
        noisy_v = clean_v + np.random.default_rng(9).normal(scale=20.0, size=clean_v.shape).astype(np.float32)
        inst = [synthetic.instances_frame(INSTANCE_SEED + i, INSTANCE_FRAME) for i in range(4)]
        inst_frames = np.stack([img for img, _ in inst]).clip(0, 65535).astype(np.uint16)
        inst_truth = np.stack([lab for _, lab in inst]).astype(np.uint16)
        ivols = [synthetic.cells_volume(31_700 + t, INST_VOLUME) for t in range(2)]
        inst_vols = np.stack([v for v, _ in ivols]).clip(0, 65535).astype(np.uint16)
        inst_vtruth = np.stack([ndimage.label(lab == 1)[0] for _, lab in ivols]).astype(np.uint16)
        paths = {
            "stack": write("stack.tif", frames), "truth": write("truth.tif", truth),
            "sparse": write("sparse.tif", sparse), "volume": write("volume.tif", vol),
            "vlabels": write("vlabels.tif", vlab.astype(np.uint16)),
            "gan": write("gan.tif", gan_frames), "gan_targets": write("gan_targets.tif", gan_targets),
            "noisy": write("noisy.tif", noisy), "clean": write("clean.tif", clean),
            "noisy_v": write("noisy_v.tif", noisy_v.reshape((-1,) + INST_VOLUME[1:])),
            "clean_v": write("clean_v.tif", clean_v.reshape((-1,) + INST_VOLUME[1:])),
            "inst": write("inst.tif", inst_frames), "inst_truth": write("inst_truth.tif", inst_truth),
            "inst_v": write("inst_v.tif", inst_vols.reshape((-1,) + INST_VOLUME[1:])),
            "inst_vtruth": write("inst_vtruth.tif", inst_vtruth.reshape((-1,) + INST_VOLUME[1:])),
        }
        server = ImageServer(ServerConfiguration(jobs_dir=jobs, models_dir=models, device="cuda"))
        counts, outputs, walls = {}, {}, {}

        def serve(name, module, model, inputs, params, want_passes, units, expect_fail=None):
            submit_job(jobs, {
                "module": module, "params": dict(model=model, **params),
                "input": [paths[k] for k in inputs], "output": os.path.join(tmp, f"out_{name}"),
            })
            torch.cuda.synchronize()
            hist.histogram_2d.launches = 0
            hist.quantile_pass.launches = 0
            conv.conv3x3_nhwc.launches = 0
            conv.conv3x3_flat_chw.launches = 0
            _euler().launches = 0
            t0 = time.perf_counter()
            if not server.poll_once():
                raise AssertionError(f"job {name}: no job to run")
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t0
            counts[name] = (hist.histogram_2d.launches, hist.quantile_pass.launches)
            if conv.conv3x3_nhwc.launches + conv.conv3x3_flat_chw.launches:
                raise AssertionError(f"job {name}: launched a conv study kernel")
            _euler_read(f"eval_{name}", _euler_want(module, params, units) if expect_fail is None else None)
            with open(os.path.join(tmp, f"out_{name}", "status.json")) as f:
                status = json.load(f)
            if expect_fail is not None:
                if status["state"] != "failed" or expect_fail not in status.get("error", ""):
                    raise AssertionError(f"job {name}: expected a JobError with {expect_fail!r}, got {status}")
                return status
            if status["state"] != "complete":
                raise AssertionError(f"job {name}: {status.get('error')}")
            outputs[name] = status["outputs"]
            print(
                f"evaluate job {name} {module} {model} {json.dumps(params)}: {walls[name]:.4f} s, "
                f"{units / walls[name]:.3f} items/s on {smi_line}; quantile passes {counts[name][1]} "
                f"(histogram_2d launches {counts[name][0]}; expected {want_passes}); metrics "
                f"{status['outputs']['metrics'][:400]}"
            )
            if counts[name] != (want_passes, want_passes):
                raise AssertionError(f"job {name}: {counts[name]} launches/passes, expected {want_passes}")
            return status

        def metrics(name):
            return json.loads(outputs[name]["metrics"])

        def twin(name, twin_name, units):
            print(
                f"evaluate job {name} {units / walls[name]:.3f} items/s beside its serving twin "
                f"{twin_name}'s {units / walls[twin_name]:.3f} items/s (same frames, same server, {smi_line})"
            )

        def labels_agree(name, twin_name, got, want):
            share = float(np.mean(got == want))
            print(f"evaluate job {name} saved labels equal to serving job {twin_name}'s on {share:.6f} of pixels")
            if share < EVAL_LABELS_BAR:
                raise AssertionError(f"job {name}: labels agree with {twin_name}'s on {share} < {EVAL_LABELS_BAR}")

        # (a) and (n), (n'): 2D segmentation, scored by one confusion matrix
        serve("a", "segmentation_unet2d", "unet2d_cells", ["stack"], {"localize": False}, 4, 4)
        serve("n", "evaluate_unet2d", "unet2d_cells", ["stack", "truth"],
              {"save_labels": True, "per_frame": True}, 4, 4)
        serve("n_ignore", "evaluate_unet2d", "unet2d_cells", ["stack", "sparse"],
              {"save_labels": True, "per_frame": True, "ignore_label": 255}, 4, 4)
        twin("n", "a", 4)
        labels_a = tiff.read_stack(outputs["a"]["labels"])
        for name, t_stack in (("n", truth), ("n_ignore", sparse)):
            saved = tiff.read_stack(outputs[name]["labels"])
            labels_agree(name, "a", saved, labels_a)
            cm, per = np.zeros((4, 3), np.int64), []
            for pred, t in zip(saved, t_stack):
                keep = t != 255
                fcm = losses.confusion_matrix_np(pred[keep], t[keep], 3)
                cm += fcm
                per.append(round(float(np.mean(losses.metrics_from_confusion(fcm)[0])), 6) if fcm.sum() else None)
            ious, dices, acc = losses.metrics_from_confusion(cm)
            want = {"miou": round(float(np.mean(ious)), 6), "pixel_accuracy": round(acc, 6),
                    "n_frames": 4, "per_frame_miou": per}
            want.update({f"iou_{i}": round(float(ious[i]), 6) for i in range(3)})
            want.update({f"dice_{i}": round(float(dices[i]), 6) for i in range(3)})
            _same_metrics(f"job {name}", metrics(name), want)
        if metrics("n_ignore")["per_frame_miou"][2] is not None:
            raise AssertionError("job n_ignore: a wholly ignored frame scored")

        # (d) and (o): the volume, default tiling
        serve("d", "segmentation_unet3d", "unet3d_cells", ["volume"], {"localize": False}, 1, 1)
        serve("o", "evaluate_unet3d", "unet3d_cells", ["volume", "vlabels"], {"save_labels": True}, 1, 1)
        twin("o", "d", 1)
        saved = tiff.read_stack(outputs["o"]["labels"])
        labels_agree("o", "d", saved, tiff.read_stack(outputs["d"]["labels"]))
        p_t, t_t = torch.from_numpy(saved.astype(np.int32)), torch.from_numpy(vlab.astype(np.int32))
        ious, dices = losses.iou(p_t, t_t, 3).numpy(), losses.dice(p_t, t_t, 3).numpy()
        want = {"miou": round(float(np.mean(ious)), 6),
                "voxel_accuracy": round(float((saved == vlab).mean()), 6)}
        want.update({f"iou_{i}": round(float(ious[i]), 6) for i in range(3)})
        want.update({f"dice_{i}": round(float(dices[i]), 6) for i in range(3)})
        _same_metrics("job o", metrics("o"), want)

        # (g) and (p): GAN against gan_fidelity's targets; (h), (i), (q), (q'):
        # N2V against the clean renders; every score recomputed from the
        # twin's saved output, the targets normalized the job's way
        def scores(out, t01, x01=None):
            l1s, ps, pins = [], [], []
            for k in range(len(out)):
                err = np.asarray(out[k], np.float32) - t01[k]
                l1s.append(float(np.mean(np.abs(err))))
                ps.append(round(10.0 * float(np.log10(1.0 / max(float(np.mean(err * err)), 1e-12))), 4))
                if x01 is not None:
                    e = x01[k] - t01[k]
                    pins.append(round(10.0 * float(np.log10(1.0 / max(float(np.mean(e * e)), 1e-12))), 4))
            want = {"l1": round(float(np.mean(l1s)), 6), "psnr": round(float(np.mean(ps)), 4)}
            if x01 is not None:
                want["psnr_noisy_input"] = round(float(np.mean(pins)), 4)
            return want, ps

        def normalized(arr, normalize, volume=False):
            tc = infer.TileConfig(patch=arr.shape[1:], overlap=(0,) * (arr.ndim - 1), normalize=normalize)
            t = torch.from_numpy(arr).cuda()[..., None]
            with torch.inference_mode():
                if volume:
                    return np.stack([infer._normalize(v[None], tc)[0].cpu().numpy() for v in t])
                return np.stack([infer._normalize(f[None], tc)[0].cpu().numpy() for f in t])

        serve("g", "enhancement_gan", "gan_denoise", ["gan"], {}, 4, 4)
        serve("p", "evaluate_gan", "gan_denoise", ["gan", "gan_targets"], {}, 8, 4)
        twin("p", "g", 4)
        want, per = scores(tiff.read_stack(outputs["g"]["enhanced"])[..., None], normalized(gan_targets, "auto"))
        _same_metrics("job p", metrics("p"), dict(want, per_frame_psnr=per, n_frames=4))
        for name, twin_name, norm, passes in (("q", "h", "none", 0), ("q_auto", "i", "auto", 8)):
            params = {"normalize": norm} if norm == "none" else {}
            serve(twin_name, "denoise", "n2v_cells", ["noisy"], params, passes // 2, 4)
            serve(name, "evaluate_denoise", "n2v_cells", ["noisy", "clean"], params, passes, 4)
            twin(name, twin_name, 4)
            want, per = scores(
                tiff.read_stack(outputs[twin_name]["denoised"])[..., None],
                normalized(clean, norm), normalized(noisy, norm),
            )
            _same_metrics(f"job {name}", metrics(name), dict(want, per_frame_psnr=per, n_frames=4))
        serve("h_3d", "denoise", "n2v3d", ["noisy_v"], {"z": INST_VOLUME[0]}, 2, 2)
        serve("q_3d", "evaluate_denoise", "n2v3d", ["noisy_v", "clean_v"], {"z": INST_VOLUME[0]}, 4, 2)
        twin("q_3d", "h_3d", 2)
        den_v = tiff.read_stack(outputs["h_3d"]["denoised"]).reshape(clean_v.shape)[..., None]
        want, per = scores(den_v, normalized(clean_v, "auto", True), normalized(noisy_v, "auto", True))
        _same_metrics("job q_3d", metrics("q_3d"), dict(want, per_volume_psnr=per, n_volumes=2))

        # (j) and (r), (m) and (r'), (l) and (s): pooled instance AP
        serve("j", "segment_flows", "flows_cells", ["inst"], {"localize": False}, 4, 4)
        serve("r", "evaluate_flows", "flows_cells", ["inst", "inst_truth"],
              {"save_labels": True, "per_frame": True}, 4, 4)
        serve("l", "segment_stars", "stars_cells", ["inst"], {"localize": False, "polyphase": True}, 4, 4)
        serve("s", "evaluate_stars", "stars_cells", ["inst", "inst_truth"],
              {"save_labels": True, "per_frame": True, "polyphase": True}, 4, 4)
        for name, twin_name in (("r", "j"), ("s", "l")):
            twin(name, twin_name, 4)
            saved = tiff.read_stack(outputs[name]["labels"])
            labels_agree(name, twin_name, saved, tiff.read_stack(outputs[twin_name]["labels"]))
            want = _pooled_ap(np, flows, inst_truth.astype(np.int64), saved, "per_frame_ap50")
            _same_metrics(f"job {name}", metrics(name), dict(want, n_frames=4))
            print(f"evaluate job {name}: ap50 {metrics(name)['ap50']} against the truth")
        serve("m", "segment_flows", "flows3d", ["inst_v"], {"localize": False, "z": INST_VOLUME[0]}, 2, 2)
        serve("r_3d", "evaluate_flows", "flows3d", ["inst_v", "inst_vtruth"],
              {"z": INST_VOLUME[0], "per_frame": True}, 2, 2)
        twin("r_3d", "m", 2)
        labs_m = [tiff.read_stack(os.path.join(os.path.dirname(outputs["m"]["labels"]), f"labels_t{t:04d}.tif"))
                  for t in range(2)]
        want = _pooled_ap(np, flows, inst_vtruth.astype(np.int64), labs_m, "per_volume_ap50")
        _same_metrics("job r_3d", metrics("r_3d"), dict(want, n_volumes=2))

        # (t): parity_check against the torch re-derivation on the CPU
        for name, fixture, params in (
            ("t_unet2d", "unet2d_cells", {}),
            ("t_unet3d", "unet3d_cells", {"spatial": [16, 64, 64], "n_probes": 2}),
            ("t_gan", "gan_denoise", {}),
            ("t_n2v", "n2v_cells", {}),
            ("t_flows", "flows_cells", {}),
        ):
            serve(name, "parity_check", fixture, ["stack"], params, 0, 1)
        serve("t_corrupt", "parity_check", "unet2d_corrupt", ["stack"], {}, 0, 1,
              expect_fail="parity FAILED: max |dlogits|")
        print("evaluate job t_corrupt: parity_check refused the copy with one kernel scaled by 1e6 (JobError)")
        submit_job(jobs, {"module": "parity_check", "params": {"model": "unet2d_cells", "reference": "keras",
                                                              "n_probes": 1},
                          "input": [paths["stack"]], "output": os.path.join(tmp, "out_t_keras")})
        server.poll_once()
        with open(os.path.join(tmp, "out_t_keras", "status.json")) as f:
            status = json.load(f)
        if status["state"] == "complete":
            print(f"evaluate job t_keras: the keras reference ran and passed: {status['outputs']['metrics']}")
        elif "reference 'keras' unavailable" in status.get("error", ""):
            print("evaluate job t_keras: the keras reference is unavailable on this machine "
                  f"(JobError: {status['error'].strip().splitlines()[-1][-160:]})")
        else:
            raise AssertionError(f"parity_check keras: {status}")
        return counts


def _with_dtype(unet, model, dtype):
    """A copy of the folded ``model`` computing in ``dtype``."""
    import dataclasses

    from sequitr_tpu_torch.models import convert

    cfg = dataclasses.replace(model.cfg, compute_dtype=dtype)
    device = next(model.parameters()).device
    return convert.load_flat(cfg, convert.to_flat(model), device=device)


def _unet2d_cells_arch(dtype):
    """``unet2d_cells``' architecture (depth 4, base 32, 3 classes, BN)."""
    from sequitr_tpu_torch.models import unet

    return unet.UNetConfig(
        in_channels=1, num_classes=3, depth=4, base_features=32, norm="batch", compute_dtype=dtype
    )


def _cells_batch(np, n, size, seed):
    """``n`` normalized ``size``x``size`` cells frames, their labels and U-Net
    weight maps (as build_records writes them)."""
    from sequitr_tpu_torch.data import synthetic
    from sequitr_tpu_torch.ops import weightmaps

    imgs, labs, ws = [], [], []
    for i in range(n):
        img, lab = synthetic.cells_frame(seed + i, (size, size))
        lo, hi = np.percentile(img, [5.0, 99.5])
        imgs.append(np.clip((img - lo) / max(hi - lo, 1e-8), 0, 1).astype(np.float32))
        labs.append(lab.astype(np.int32))
        ws.append(weightmaps.unet_weight_map(lab, num_classes=3))
    return np.stack(imgs)[..., None], np.stack(labs), np.stack(ws)


def _bn_nulled(key: str) -> bool:
    """A conv bias a batch norm follows: the norm subtracts it again, so its
    gradient is round-off, which Adam turns into a step of up to the
    learning rate either way."""
    return key.endswith(("conv1/b", "conv2/b"))


def _weights_vs(np, convert, a, b, start, lr=TRAIN_LR):
    """Two trained models against each other: the relative L2 difference of
    their updates from ``start`` (the flat weights they both began from)
    over the parameters a batch norm does not null, the share of those
    parameters whose updates differ by more than a tenth of an Adam step
    (lr / 10), the largest difference of a BN-nulled bias, and the
    largest difference of a running statistic relative to that tensor's
    largest value (a mean's beyond what its bias can move)."""
    fa, fb = convert.to_flat(a), convert.to_flat(b)
    num = den = 0.0
    over = total = 0
    nulled = stats = 0.0
    for k in fa:
        d = np.abs(fa[k].astype(np.float64) - fb[k])
        if k.startswith("state/"):
            # a running mean carries its conv's bias, which Adam moves on noise
            slack = TRAIN_STEPS_EXACT * lr if k.endswith("/mean") else 0.0
            stats = max(stats, float(np.maximum(d - slack, 0).max() / max(np.abs(fb[k]).max(), 1e-12)))
        elif _bn_nulled(k):
            nulled = max(nulled, float(d.max()))
        else:
            num += float((d**2).sum())
            den += float(((fb[k].astype(np.float64) - start[k]) ** 2).sum())
            over += int((d > lr / 10).sum())
            total += d.size
    return (num / den) ** 0.5, over / total, nulled, stats


def train_phase(torch, hist, conv, smi_line):
    """U-Net training on the card. PyTorch's own TF32
    defaults are restored first (earlier phases turn TF32 off globally), so
    every f32 check here rests on the port's own ``utils.ieee_f32``. Returns
    {job: (histogram_2d launches, quantile passes)} of the training jobs and
    the serve that follows them."""
    import numpy as np

    from sequitr_tpu_torch import __main__ as cli
    from sequitr_tpu_torch import fidelity
    from sequitr_tpu_torch.config import ServerConfiguration
    from sequitr_tpu_torch.data import synthetic, tiff
    from sequitr_tpu_torch.models import convert, fixtures, polyphase, unet
    from sequitr_tpu_torch.ops import augment as aug
    from sequitr_tpu_torch.ops import losses
    from sequitr_tpu_torch.pipeline import infer, train
    from sequitr_tpu_torch.server import ImageServer, submit_job
    from sequitr_tpu_torch.server.server import load_model

    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's defaults
    torch.backends.cudnn.allow_tf32 = True
    print(
        f"train: TF32 switches at PyTorch's defaults (matmul {torch.backends.cuda.matmul.allow_tf32}, "
        f"cuDNN {torch.backends.cudnn.allow_tf32}); torch {torch.__version__}"
    )

    with tempfile.TemporaryDirectory() as tmp:
        jobs, models = os.path.join(tmp, "jobs"), os.path.join(tmp, "models")

        def serve(server, module, params, inputs, name):
            submit_job(jobs if server is card_server else cpu_jobs, {
                "module": module, "params": params, "input": inputs,
                "output": os.path.join(tmp, f"out_{name}"),
            })
            torch.cuda.synchronize()
            hist.histogram_2d.launches = 0
            hist.quantile_pass.launches = 0
            conv.conv3x3_nhwc.launches = 0
            conv.conv3x3_flat_chw.launches = 0
            _euler().launches = 0
            t0 = time.perf_counter()
            if not server.poll_once():
                raise AssertionError(f"job {name}: no job to run")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = (hist.histogram_2d.launches, hist.quantile_pass.launches)
            if conv.conv3x3_nhwc.launches + conv.conv3x3_flat_chw.launches:
                raise AssertionError(f"job {name}: launched a conv study kernel")
            _euler_read(name, 0)
            with open(os.path.join(tmp, f"out_{name}", "status.json")) as f:
                status = json.load(f)
            if status["state"] != "complete":
                raise AssertionError(f"job {name}: {status.get('error')}")
            return status["outputs"], counts, wall

        # (1) an f32 model served with PyTorch's defaults: the card against
        # the CPU through ImageServer, probabilities within 1e-4
        meta = fixtures.manifest()["unet2d_cells"]
        arch = os.path.join(tmp, "unet2d_cells_f32.json")
        with open(arch, "w") as f:
            json.dump(dict(meta["config"], __kind__=meta["kind"], compute_dtype="float32"), f)
        npz = os.path.join(fixtures.fixture_dir(), "unet2d_cells.npz")
        cpu_models = os.path.join(tmp, "cpu_models")
        cpu_jobs = os.path.join(tmp, "cpu_jobs")
        for where in (models, cpu_models):
            if cli.main(["import-model", "--models-dir", where, "--npz", npz, "--arch", arch, "seg_f32"]):
                raise AssertionError("import-model seg_f32 failed")
        frame = synthetic.cells_frame(427_000, (1024, 1024))[0].clip(0, 65535).astype(np.uint16)
        one = os.path.join(tmp, "one.tif")
        tiff.write_stack(one, frame[None])
        card_server = ImageServer(ServerConfiguration(jobs_dir=jobs, models_dir=models, device="cuda"))
        cpu_server = ImageServer(ServerConfiguration(jobs_dir=cpu_jobs, models_dir=cpu_models, device="cpu"))
        f32_params = {"model": "seg_f32", "localize": False, "save_probs": True, "normalize": "exact"}
        card_out, _, _ = serve(card_server, "segmentation_unet2d", dict(f32_params), [one], "f32_card")
        cpu_out, _, _ = serve(cpu_server, "segmentation_unet2d", dict(f32_params), [one], "f32_cpu")
        p_card = tiff.read_stack(card_out["probs"])
        p_cpu = tiff.read_stack(cpu_out["probs"])
        f32_err = float(np.abs(p_card - p_cpu).max())
        same = float(np.mean(tiff.read_stack(card_out["labels"]) == tiff.read_stack(cpu_out["labels"])))
        # the same forward outside the port's f32 entry point, TF32 on: the
        # fault the entry point repairs
        _, _, f32_model, _ = fixtures.load("unet2d_cells", compute_dtype="float32", device="cuda")
        _, _, cpu_model, _ = fixtures.load("unet2d_cells", compute_dtype="float32", device="cpu")
        x = torch.rand((1, 256, 256, 1), generator=torch.Generator().manual_seed(7))
        with torch.inference_mode():
            want = cpu_model(x)
            ieee = float((f32_model(x.cuda()).cpu() - want).abs().max())
            tf32 = float((f32_model._forward(x.cuda(), None).cpu() - want).abs().max())
        print(
            f"train f32 serve with PyTorch's TF32 defaults: unet2d_cells f32 1024x1024 job, card vs CPU "
            f"max |prob diff| {f32_err:.3g} (bar 1e-4), labels equal on {same:.6f}; forward logits at "
            f"256x256 vs CPU: {ieee:.3g} through UNet.forward (IEEE f32), {tf32:.3g} with TF32 "
            f"(the same forward outside the entry point)"
        )
        if not f32_err <= 1e-4:
            raise AssertionError(f"f32 served probabilities differ from the CPU's by {f32_err}")

        # (2) three f32 train steps, augmentation off, at unet2d_cells' width:
        # the card against the CPU from the same weights and batches, for the
        # standard forward and the polyphase one
        cfg32 = _unet2d_cells_arch("float32")
        init = unet.init(cfg32, torch.Generator().manual_seed(0), device="cpu")
        flat = convert.to_flat(init)
        batches = [_cells_batch(np, 8, 256, 710_000 + 8 * s) for s in range(TRAIN_STEPS_EXACT)]
        for kind, tc in (("", train.TrainConfig(augment=False)), ("polyphase ", train.TrainConfig(augment=False, polyphase=True))):
            runs = {}
            for name, dev in (("cpu", "cpu"), ("card", "cuda"), ("card again", "cuda")):
                state = train.create_unet_state(cfg32, tc, model=convert.load_flat(cfg32, flat, device=dev))
                step = train.make_unet_train_step(cfg32, tc)
                got = []
                for img, lab, w in batches:
                    batch = {
                        "image": torch.from_numpy(img).to(dev), "labels": torch.from_numpy(lab).to(dev),
                        "weights": torch.from_numpy(w).to(dev),
                    }
                    state, m = step(state, batch)
                    got.append((float(m["loss"]), float(m["grad_norm"])))
                runs[name] = (got, state.model.to("cpu"))
            (cpu_m, cpu_model), (card_m, card_model), (again_m, again_model) = (
                runs["cpu"], runs["card"], runs["card again"]
            )
            for s, ((lc, gc), (lg, gg)) in enumerate(zip(cpu_m, card_m)):
                print(
                    f"train f32 {kind}step {s + 1} (8x256x256, unet2d_cells arch): loss card {lg:.7f} CPU "
                    f"{lc:.7f} (rel {abs(lg - lc) / lc:.3g}, bar {TRAIN_LOSS_RTOL}), grad_norm card {gg:.6f} "
                    f"CPU {gc:.6f} (rel {abs(gg - gc) / gc:.3g}, bar {TRAIN_GRAD_NORM_RTOL})"
                )
                if abs(lg - lc) > TRAIN_LOSS_RTOL * lc or abs(gg - gc) > TRAIN_GRAD_NORM_RTOL * gc:
                    raise AssertionError(f"train {kind}step {s + 1}: card and CPU disagree")
            rel, share, nulled, stats = _weights_vs(np, convert, card_model, cpu_model, flat)
            rel2, share2, nulled2, stats2 = _weights_vs(np, convert, card_model, again_model, flat)
            loss_runs = max(abs(a[0] - b[0]) / b[0] for a, b in zip(card_m, again_m))
            print(
                f"train f32 {kind}weights after {TRAIN_STEPS_EXACT} steps, card vs CPU: updates differ by "
                f"{rel:.3g} of their L2 norm (bar {TRAIN_UPDATE_BAR}), {share:.3g} of the weights by more than "
                f"a tenth of an Adam step (lr {TRAIN_LR}), BN-nulled biases by up to {nulled:.3g}, running "
                f"statistics by {stats:.3g} of their largest value (bar {TRAIN_STATS_BAR}); two card runs: "
                f"{rel2:.3g}, {share2:.3g}, {nulled2:.3g}, {stats2:.3g}, losses {loss_runs:.3g} apart (relative)"
            )
            if rel > TRAIN_UPDATE_BAR or stats > TRAIN_STATS_BAR:
                raise AssertionError(f"train {kind}weights: card and CPU disagree")

        # (3) the max-pool gradient with tied windows: the first maximal
        # element takes it, on the card as on the CPU (XLA's select-and-scatter)
        tied = torch.randint(0, 3, (8, 32, 256, 256), generator=torch.Generator().manual_seed(3)).float()
        cot = torch.rand((8, 32, 128, 128), generator=torch.Generator().manual_seed(4))
        grads = []
        for dev in ("cpu", "cuda"):
            t = unet.channels_last(tied.to(dev)).requires_grad_(True)
            (torch.nn.functional.max_pool2d(t, 2) * cot.to(dev)).sum().backward()
            grads.append(t.grad.cpu())
        first = tied.unfold(2, 2, 2).unfold(3, 2, 2).reshape(8, 32, 128, 128, 4).argmax(-1)
        want = torch.zeros(8, 32, 128, 128, 4)
        want.scatter_(-1, first[..., None], cot[..., None])
        want = want.reshape(8, 32, 128, 128, 2, 2).permute(0, 1, 2, 4, 3, 5).reshape(8, 32, 256, 256)
        print(
            f"train max-pool gradient, tied 2x2 windows (8x32x256x256, channels_last): card equal to CPU "
            f"{torch.equal(grads[0], grads[1])}, card equal to first-max routing {torch.equal(grads[1], want)}"
        )
        if not (torch.equal(grads[0], grads[1]) and torch.equal(grads[1], want)):
            raise AssertionError("max-pool gradient: ties not routed to the first maximum")
        # the polyphase forward's pool: the max over the four phase groups
        t = tied.cuda().requires_grad_(True)
        phases = unet._space_to_depth(t, 2).reshape(8, 4, 32, 128, 128).movedim(1, -1)
        (polyphase._first_max(phases, -1) * cot.cuda()).sum().backward()
        print(f"train polyphase pool gradient, same tied windows, card: equal to first-max routing {torch.equal(t.grad.cpu(), want)}")
        if not torch.equal(t.grad.cpu(), want):
            raise AssertionError("polyphase pool gradient: ties not routed to the first maximum")

        # (4) the augmentation's apply, card against CPU at the same draws
        img, lab, w = _cells_batch(np, 8, 256, 720_000)
        knobs = dict(p_elastic=1.0, gain_jitter=0.1, offset_jitter=0.05, noise_std=0.02)
        outs = []
        for dev in ("cpu", "cuda"):
            got = aug.augment_batch(
                torch.Generator().manual_seed(11), torch.from_numpy(img).to(dev),
                torch.from_numpy(lab).to(dev), torch.from_numpy(w).to(dev), **knobs,
            )
            outs.append([t.cpu() for t in got])
        (ci, cl, cw), (gi, gl, gw) = outs
        img_err = float((ci - gi).abs().max())
        w_err = float((cw - gw).abs().max())
        lab_eq = torch.equal(cl, gl)
        lat = torch.randn((8, 2, 4, 4), generator=torch.Generator().manual_seed(12)) * 20
        f_cpu, f_card = aug.elastic_fields(lat, (256, 256)), aug.elastic_fields(lat.cuda(), (256, 256))
        f_eq = all(torch.equal(a, b.cpu()) for a, b in zip(f_cpu, f_card))
        print(
            f"train augment apply 8x256x256 (flips, rot90, elastic p=1, photometric), card vs CPU at the same "
            f"draws: labels equal {lab_eq}, image max |diff| {img_err:.3g}, weights {w_err:.3g} (bar "
            f"{AUG_BAR}); elastic fields bit-equal {f_eq}"
        )
        if not (lab_eq and img_err <= AUG_BAR and w_err <= AUG_BAR and f_eq):
            raise AssertionError("augmentation: card and CPU disagree")

        # (5) a fold follows an in-place update on the card (stale-fold repair)
        small = unet.init(
            unet.UNetConfig(depth=2, base_features=8, num_classes=1, compute_dtype="float32"),
            torch.Generator().manual_seed(5), device="cuda",
        )
        dtc = infer.TileConfig(patch=(256, 256), overlap=(0, 0), normalize="exact")
        den = infer.make_denoiser(small.cfg, dtc, (256, 256), device="cuda")
        noisy = torch.rand((256, 256), device="cuda") * 1000
        before = den(small, noisy).clone()
        with torch.no_grad():
            for p in small.parameters():
                p.mul_(2.0)
        fresh = convert.load_flat(small.cfg, convert.to_flat(small), device="cuda")
        after, want_after = den(small, noisy), den(fresh, noisy)
        print(
            f"train fold after an in-place update (denoiser, card): output follows the update "
            f"{torch.equal(after, want_after)} (moved {float((after - before).abs().max()):.3g})"
        )
        if not torch.equal(after, want_after) or torch.equal(after, before):
            raise AssertionError("denoiser served stale folded weights after an in-place update")

        # (6) bf16 at full width: the step's time split, device ops, peak, kernels
        def timed_step(cfg, tc, b_img, b_lab, b_w, label, unit, units):
            state = train.create_unet_state(cfg, tc, torch.Generator().manual_seed(0), device="cuda")
            opt = tc.make_optimizer()
            batch = {
                "image": torch.from_numpy(b_img).cuda(), "labels": torch.from_numpy(b_lab).cuda(),
                "weights": torch.from_numpy(b_w).cuda(),
            }
            step = train.make_unet_train_step(cfg, tc)
            gen = torch.Generator().manual_seed(1)

            forward = train._train_forward(cfg, tc)

            def parts():
                t = [time.perf_counter()]
                images, labels, weights = train._prepare(batch, gen, tc, cfg.dims)
                torch.cuda.synchronize()
                t.append(time.perf_counter())
                logits, stats = forward(state.model, images)
                loss = losses.weighted_softmax_cross_entropy(logits, labels, weights)
                grads = torch.autograd.grad(loss, state.params)
                torch.cuda.synchronize()
                t.append(time.perf_counter())
                opt.update(state.params, grads, state.opt_state)
                state.model.set_bn_stats(stats)
                torch.cuda.synchronize()
                t.append(time.perf_counter())
                return [b - a for a, b in zip(t, t[1:])]

            for _ in range(3):
                parts()
            split = np.median(np.array([parts() for _ in range(10)]), axis=0) * 1e3

            def whole():
                step(state, batch, gen)

            whole()
            torch.cuda.synchronize()
            walls = []
            for _ in range(10):
                t0 = time.perf_counter()
                whole()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            step_ms = float(np.median(walls)) * 1e3
            _, peak = _peak_gb(torch, whole)
            ops = _device_events(torch, whole, 2)
            by_name = {}
            for e in ops:
                by_name.setdefault(e.name, []).append(e)
            top = sorted(by_name.items(), key=lambda kv: -_ms(kv[1], 2))[:8]
            print(
                f"train {label} bf16 step: {step_ms:.4f} ms ({units / step_ms * 1e3:.3f} {unit}/s) on "
                f"{smi_line}; split (synchronized, median of 10): augment {split[0]:.4f} ms, forward+"
                f"backward {split[1]:.4f} ms, optimizer+BN statistics {split[2]:.4f} ms; "
                f"{len(ops) / 2:.0f} device ops a step, {_ms(ops, 2):.4f} device ms, peak {peak:.3f} GB"
            )
            for name, es in top:
                print(f"train {label} kernel {_ms(es, 2):.4f} ms/step x{len(es) / 2:.0f} {name[:100]}")
            return step_ms

        img, lab, w = _cells_batch(np, 8, 256, 730_000)
        vol, vlab = synthetic.cells_volume(740_000, (16, 64, 64))
        v = np.clip(vol / max(float(np.percentile(vol, 99.5)), 1e-8), 0, 1).astype(np.float32)
        vols = np.stack([v, v[:, ::-1]])[..., None].copy()
        vlabs = np.stack([vlab, vlab[:, ::-1]]).astype(np.int32)
        step_ms = {}
        for kind, poly in (("", False), ("polyphase ", True)):
            tc_kind = train.TrainConfig(polyphase=poly)
            step_ms[kind, 2] = timed_step(
                _unet2d_cells_arch("bfloat16"), tc_kind, img, lab, w,
                f"2D {kind}8x256x256 (unet2d_cells arch, augment on)", "patches", 8,
            )
            step_ms[kind, 3] = timed_step(
                unet.UNetConfig(dims=3, depth=3, base_features=32, features_cap=256),
                tc_kind, vols, vlabs, np.ones(vlabs.shape, np.float32),
                f"3D {kind}2x16x64x64 (depth 3, cap 256, augment on)", "Mvox", 2 * 16 * 64 * 64 / 1e6,
            )
        print(
            f"train bf16 step, polyphase over standard (same process, same batches): 2D "
            f"{step_ms['polyphase ', 2] / step_ms['', 2]:.3f}x, 3D {step_ms['polyphase ', 3] / step_ms['', 3]:.3f}x "
            f"on {smi_line}"
        )

        # (7) train, then serve, in one server process: build_records on a
        # 4-frame 1024x1024 stack, train_unet2d (unet2d_cells' architecture),
        # segmentation_unet2d on the registered model
        scenes = [synthetic.cells_frame(750_000 + i, (1024, 1024)) for i in range(4)]
        frames = np.stack([s[0] for s in scenes]).clip(0, 65535).astype(np.uint16)
        stack, labels = os.path.join(tmp, "train_stack.tif"), os.path.join(tmp, "train_labels.tif")
        tiff.write_stack(stack, frames)
        tiff.write_stack(labels, np.stack([s[1] for s in scenes]).astype(np.uint16))
        counts = {}
        out, counts["build_records"], wall = serve(
            card_server, "build_records",
            {"patch": [256, 256], "patches_per_example": 4, "num_classes": 3, "seed": 1},
            [stack, labels], "records",
        )
        print(f"train job build_records: {out['n_examples']} examples in {out['n_shards']} shard(s), {wall:.3f} s")
        params = {
            "model": "seg_trained", "depth": 4, "base_features": 32, "num_classes": 3,
            "steps": 30, "batch_size": 8, "holdout_every": 4, "eval_every": 10,
            "checkpoint_every": 10, "log_every": 5, "ema_decay": 0.9, "learning_rate": 1e-3,
        }
        out, counts["train_unet2d"], wall = serve(
            card_server, "train_unet2d", params, [os.path.join(tmp, "out_records")], "train2d"
        )
        with open(out["metrics_file"]) as f:
            rows = [json.loads(line) for line in f]
        tr = [r for r in rows if r["kind"] == "train"]
        ev = [r for r in rows if r["kind"] == "eval"]
        print(
            f"train job train_unet2d: 30 steps of 8x256x256 in {wall:.3f} s; loss "
            f"{tr[0]['loss']:.4f} -> {tr[-1]['loss']:.4f}, {tr[-1]['steps_per_sec']:.3f} steps/s "
            f"({8 * tr[-1]['steps_per_sec']:.3f} patches/s over the job, first steps included); evals "
            + ", ".join(f"step {r['step']} miou {r['eval_miou']:.4f}" for r in ev)
        )
        if not all(np.isfinite(r["loss"]) for r in tr) or not ev:
            raise AssertionError("train_unet2d: non-finite loss or no eval")
        out, counts["serve_trained"], wall = serve(
            card_server, "segmentation_unet2d", {"model": "seg_trained", "localize": False}, [stack],
            "serve_trained",
        )
        served = tiff.read_stack(out["labels"])
        # the registered files, loaded anew (folded at load) and served directly
        _, cfg_t, model_t = load_model(models, "seg_trained", device="cuda")
        tc_serve = infer.TileConfig(patch=(1024, 1024), overlap=(0, 0), emit_probs=False)
        fn = infer.make_frame_inferrer(cfg_t, tc_serve, (1024, 1024), device="cuda")
        direct = np.stack([fn(model_t, torch.from_numpy(f).cuda())[1].cpu().numpy() for f in frames])
        equal = float(np.mean(direct == served))
        miou = float(np.mean([fidelity.miou(a, s[1], 3) for a, s in zip(served, scenes)]))
        print(
            f"train job segmentation_unet2d on the trained model, same server process: labels equal to the "
            f"registered weights served directly on {equal:.6f} of pixels; miou_truth {miou:.4f}"
        )
        if equal != 1.0:
            raise AssertionError("the trained model's served labels differ from its weights served directly")

        # the same training with polyphase: true, then its model served
        out, counts["train_unet2d_polyphase"], wall = serve(
            card_server, "train_unet2d", dict(params, model="seg_trained_poly", polyphase=True),
            [os.path.join(tmp, "out_records")], "train2d_poly",
        )
        with open(out["metrics_file"]) as f:
            rows = [json.loads(line) for line in f]
        trp = [r for r in rows if r["kind"] == "train"]
        evp = [r for r in rows if r["kind"] == "eval"]
        out, counts["serve_trained_polyphase"], _ = serve(
            card_server, "segmentation_unet2d", {"model": "seg_trained_poly", "localize": False}, [stack],
            "serve_trained_poly",
        )
        served_p = tiff.read_stack(out["labels"])
        miou_p = float(np.mean([fidelity.miou(a, s[1], 3) for a, s in zip(served_p, scenes)]))
        print(
            f"train job train_unet2d polyphase: 30 steps of 8x256x256 in {wall:.3f} s; loss "
            f"{trp[0]['loss']:.4f} -> {trp[-1]['loss']:.4f}, {trp[-1]['steps_per_sec']:.3f} steps/s; evals "
            + ", ".join(f"step {r['step']} miou {r['eval_miou']:.4f}" for r in evp)
            + f"; its model served: miou_truth {miou_p:.4f} (the standard run's {miou:.4f})"
        )
        if not all(np.isfinite(r["loss"]) for r in trp) or not evp:
            raise AssertionError("train_unet2d polyphase: non-finite loss or no eval")

        vol, vlab = synthetic.cells_volume(760_000, (16, 128, 128))
        vpath, lpath = os.path.join(tmp, "train_vol.tif"), os.path.join(tmp, "train_vlab.tif")
        tiff.write_stack(vpath, vol.clip(0, 65535).astype(np.uint16))
        tiff.write_stack(lpath, vlab.astype(np.uint16))
        out, counts["build_records_3d"], _ = serve(
            card_server, "build_records",
            {"dims": 3, "patch": [16, 64, 64], "patches_per_example": 4, "num_classes": 3},
            [vpath, lpath], "records3d",
        )
        params3 = {
            "model": "seg3d_trained", "depth": 3, "base_features": 32, "features_cap": 256,
            "num_classes": 3, "steps": 6, "batch_size": 2, "log_every": 3,
        }
        out, counts["train_unet3d"], wall = serve(
            card_server, "train_unet3d", params3, [os.path.join(tmp, "out_records3d")], "train3d"
        )
        with open(out["metrics_file"]) as f:
            tr3 = [r for r in map(json.loads, f) if r["kind"] == "train"]
        print(
            f"train job train_unet3d: 6 steps of 2x16x64x64 (depth 3, cap 256) in {wall:.3f} s; loss "
            f"{tr3[0]['loss']:.4f} -> {tr3[-1]['loss']:.4f}"
        )
        if not all(np.isfinite(r["loss"]) for r in tr3):
            raise AssertionError("train_unet3d: non-finite loss")
        want = {
            "build_records": 0, "train_unet2d": 0, "serve_trained": 4, "train_unet2d_polyphase": 0,
            "serve_trained_polyphase": 4, "build_records_3d": 0, "train_unet3d": 0,
        }
        print(
            "train jobs quantile passes (histogram_2d launches): "
            + ", ".join(f"{k} {counts[k][1]} ({counts[k][0]})" for k in want)
            + " (expected 0 for the record and train jobs, which normalize on the host; 1 a frame for the serve)"
        )
        for k, n in want.items():
            if counts[k] != (n, n):
                raise AssertionError(f"job {k}: {counts[k]} launches/passes, expected {n}")
        return counts


def _gan_pairs(np, n, size, seed):
    """``n`` normalized ``size``x``size`` cells frames and their smoothed
    targets (N, H, W, 1), as ``fidelity.train_fidelity`` makes GAN batches."""
    from scipy import ndimage

    from sequitr_tpu_torch.data import synthetic

    xs = []
    for i in range(n):
        img, _ = synthetic.cells_frame(seed + i, (size, size))
        lo, hi = np.percentile(img, [5.0, 99.5])
        xs.append(np.clip((img - lo) / max(hi - lo, 1e-8), 0, 1).astype(np.float32))
    ys = [ndimage.gaussian_filter(x, 1.5).astype(np.float32) for x in xs]
    return np.stack(xs)[..., None], np.stack(ys)[..., None]


def gan_train_phase(torch, hist, conv, smi_line):
    """GAN training on the card: 3 f32 steps card against CPU from the same
    weights; the bf16 step at ``bench_gan_train``'s shape (batch 8 of
    256x256, ``GANConfig()`` defaults), standard and polyphase, with its
    split, device ops and peak memory; then ``build_gan_pairs`` ->
    ``train_gan`` -> ``enhancement_gan`` -> ``evaluate_gan`` in one server
    process. Returns {job: (histogram_2d launches, quantile passes)}."""
    import numpy as np

    from sequitr_tpu_torch.config import ServerConfiguration
    from sequitr_tpu_torch.data import synthetic, tiff
    from sequitr_tpu_torch.models import convert
    from sequitr_tpu_torch.models import gan as gan_lib
    from sequitr_tpu_torch.ops import losses
    from sequitr_tpu_torch.pipeline import infer, train
    from sequitr_tpu_torch.server import ImageServer, submit_job
    from sequitr_tpu_torch.server.server import load_model

    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's defaults
    torch.backends.cudnn.allow_tf32 = True
    tc = train.TrainConfig(learning_rate=GAN_LR, beta1=0.5, augment=False)

    # (1) three f32 steps, the card against the CPU from the same weights
    cfg32 = gan_lib.GANConfig(compute_dtype="float32")
    flat = convert.to_flat(gan_lib.init(cfg32, torch.Generator().manual_seed(0), device="cpu"))
    batches = [_gan_pairs(np, 4, 128, 770_000 + 4 * s) for s in range(TRAIN_STEPS_EXACT)]
    runs = {}
    for name, dev in (("cpu", "cpu"), ("card", "cuda"), ("card again", "cuda")):
        state = train.create_gan_state(cfg32, tc, model=convert.load_flat(cfg32, flat, device=dev))
        step = train.make_gan_train_step(cfg32, tc)
        got = []
        for x, y in batches:
            state, m = step(state, {"input": torch.from_numpy(x).to(dev), "target": torch.from_numpy(y).to(dev)})
            got.append((float(m["d_loss"]), float(m["g_loss"])))
        runs[name] = (got, state.model.to("cpu"))
    (cpu_m, cpu_model), (card_m, card_model), (again_m, again_model) = (
        runs["cpu"], runs["card"], runs["card again"]
    )
    for s, ((dc, gc), (dg, gg)) in enumerate(zip(cpu_m, card_m)):
        print(
            f"gan_train f32 step {s + 1} (4x128x128, GANConfig() widths): d_loss card {dg:.7f} CPU {dc:.7f} "
            f"(rel {abs(dg - dc) / dc:.3g}), g_loss card {gg:.7f} CPU {gc:.7f} (rel {abs(gg - gc) / gc:.3g}; "
            f"bar {GAN_LOSS_RTOL} both)"
        )
        if abs(dg - dc) > GAN_LOSS_RTOL * dc or abs(gg - gc) > GAN_LOSS_RTOL * gc:
            raise AssertionError(f"gan_train step {s + 1}: card and CPU disagree")
    rel, share, nulled, stats = _weights_vs(np, convert, card_model, cpu_model, flat, GAN_LR)
    rel2, share2, nulled2, stats2 = _weights_vs(np, convert, card_model, again_model, flat, GAN_LR)
    print(
        f"gan_train f32 weights after {TRAIN_STEPS_EXACT} steps, card vs CPU: updates differ by {rel:.3g} of "
        f"their L2 norm (bar {TRAIN_UPDATE_BAR}), {share:.3g} of the weights by more than a tenth of an Adam "
        f"step (lr {GAN_LR}), BN-nulled biases by up to {nulled:.3g}, running statistics by {stats:.3g} of "
        f"their largest value (bar {TRAIN_STATS_BAR}); two card runs: {rel2:.3g}, {share2:.3g}, "
        f"{nulled2:.3g}, {stats2:.3g}"
    )
    if rel > TRAIN_UPDATE_BAR or stats > TRAIN_STATS_BAR:
        raise AssertionError("gan_train weights: card and CPU disagree")

    # (2) the bf16 step at bench_gan_train's shape, standard and polyphase
    x, y = _gan_pairs(np, 8, 256, 780_000)
    batch = {"input": torch.from_numpy(x).cuda(), "target": torch.from_numpy(y).cuda()}
    cfg = gan_lib.GANConfig()
    step_ms = {}
    for kind, poly in (("standard", False), ("polyphase", True)):
        ktc = train.TrainConfig(learning_rate=GAN_LR, beta1=0.5, augment=False, polyphase=poly)
        state = train.create_gan_state(cfg, ktc, torch.Generator().manual_seed(0), device="cuda")
        step = train.make_gan_train_step(cfg, ktc)
        opt = ktc.make_optimizer()
        forward = train._train_forward(cfg.generator_config, ktc)
        gen_p, disc_p = list(state.model.gen.parameters()), list(state.model.disc.parameters())

        def parts():
            t = [time.perf_counter()]
            logits, stats = forward(state.model.gen, batch["input"])
            fake = gan_lib.activate(cfg, logits)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            d_loss = losses.gan_discriminator_loss(
                gan_lib.discriminator_apply(state.model, batch["input"], batch["target"]),
                gan_lib.discriminator_apply(state.model, batch["input"], fake.detach()),
            )
            opt.update(disc_p, torch.autograd.grad(d_loss, disc_p), state.disc_opt_state)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            g_loss = losses.gan_generator_loss(
                gan_lib.discriminator_apply(state.model, batch["input"], fake), fake, batch["target"]
            )
            opt.update(gen_p, torch.autograd.grad(g_loss, gen_p), state.gen_opt_state)
            state.model.gen.set_bn_stats(stats)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            return [b - a for a, b in zip(t, t[1:])]

        for _ in range(3):
            parts()
        split = np.median(np.array([parts() for _ in range(10)]), axis=0) * 1e3

        def whole():
            step(state, batch)

        whole()
        torch.cuda.synchronize()
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            whole()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        step_ms[kind] = float(np.median(times)) * 1e3
        _, peak = _peak_gb(torch, whole)
        ops = _device_events(torch, whole, 2)
        by_name = {}
        for e in ops:
            by_name.setdefault(e.name, []).append(e)
        top = sorted(by_name.items(), key=lambda kv: -_ms(kv[1], 2))[:5]
        print(
            f"gan_train bf16 {kind} step 8x256x256 (GANConfig() defaults, bench_gan_train's shape): "
            f"{step_ms[kind]:.4f} ms ({8 / step_ms[kind] * 1e3:.3f} pairs/s) on {smi_line}; split "
            f"(synchronized, median of 10): generator forward {split[0]:.4f} ms, D step {split[1]:.4f} ms, "
            f"G step (loss through the new D, backward, optimizer) {split[2]:.4f} ms; {len(ops) / 2:.0f} "
            f"device ops a step, {_ms(ops, 2):.4f} device ms, peak {peak:.3f} GB; largest: "
            + "; ".join(f"{n[:60]} {_ms(es, 2):.4f}" for n, es in top)
        )
    print(f"gan_train bf16 step, polyphase over standard: {step_ms['polyphase'] / step_ms['standard']:.3f}x on {smi_line}")

    # (3) build_gan_pairs -> train_gan -> enhancement_gan -> evaluate_gan in
    # one server process on the card
    with tempfile.TemporaryDirectory() as tmp:
        jobs, models = os.path.join(tmp, "jobs"), os.path.join(tmp, "models")
        server = ImageServer(ServerConfiguration(jobs_dir=jobs, models_dir=models, device="cuda"))
        raw = np.stack([synthetic.cells_frame(790_000 + i, (256, 256))[0] for i in range(16)])
        raw = raw.clip(0, 65535).astype(np.uint16)
        from scipy import ndimage

        tgt = np.stack([ndimage.gaussian_filter(r.astype(np.float32), 1.5) for r in raw])
        raw_p, tgt_p = os.path.join(tmp, "raw.tif"), os.path.join(tmp, "target.tif")
        tiff.write_stack(raw_p, raw)
        tiff.write_stack(tgt_p, tgt)
        counts = {}

        def serve(module, params, inputs, name):
            submit_job(jobs, {"module": module, "params": params, "input": inputs,
                              "output": os.path.join(tmp, f"out_{name}")})
            torch.cuda.synchronize()
            hist.histogram_2d.launches = 0
            hist.quantile_pass.launches = 0
            conv.conv3x3_nhwc.launches = 0
            conv.conv3x3_flat_chw.launches = 0
            _euler().launches = 0
            t0 = time.perf_counter()
            if not server.poll_once():
                raise AssertionError(f"job {name}: no job to run")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts[name] = (hist.histogram_2d.launches, hist.quantile_pass.launches)
            if conv.conv3x3_nhwc.launches + conv.conv3x3_flat_chw.launches:
                raise AssertionError(f"job {name}: launched a conv study kernel")
            _euler_read(name, 0)
            with open(os.path.join(tmp, f"out_{name}", "status.json")) as f:
                status = json.load(f)
            if status["state"] != "complete":
                raise AssertionError(f"job {name}: {status.get('error')}")
            return status["outputs"], wall

        out, wall = serve("build_gan_pairs", {}, [raw_p, tgt_p], "build_gan_pairs")
        print(f"gan_train job build_gan_pairs: {out['n_examples']} pairs of 256x256 in {wall:.3f} s")
        params = {"model": "gan_trained", "steps": 30, "batch_size": 4, "holdout_every": 4, "eval_every": 10,
                  "checkpoint_every": 10, "log_every": 5, "ema_decay": 0.9}
        out, wall = serve("train_gan", params, [os.path.join(tmp, "out_build_gan_pairs")], "train_gan")
        with open(out["metrics_file"]) as f:
            rows = [json.loads(line) for line in f]
        tr = [r for r in rows if r["kind"] == "train"]
        ev = [r for r in rows if r["kind"] == "eval"]
        print(
            f"gan_train job train_gan: 30 steps of 4x256x256 (GANConfig() widths, bf16) in {wall:.3f} s; "
            f"g_loss {tr[0]['g_loss']:.4f} -> {tr[-1]['g_loss']:.4f}, d_loss {tr[0]['d_loss']:.4f} -> "
            f"{tr[-1]['d_loss']:.4f}, {tr[-1]['steps_per_sec']:.3f} steps/s; evals "
            + ", ".join(f"step {r['step']} psnr {r['eval_psnr']:.3f} dB" for r in ev)
        )
        if not all(np.isfinite(r["g_loss"]) and np.isfinite(r["d_loss"]) for r in tr) or not ev:
            raise AssertionError("train_gan: non-finite loss or no eval")
        out, wall = serve("enhancement_gan", {"model": "gan_trained"}, [raw_p], "enhance_trained")
        served = tiff.read_stack(out["enhanced"])
        # the registered files, loaded anew (folded at load) and served
        # directly in the job's batches of 8 (its auto frame batch at 256x256)
        _, cfg_t, model_t = load_model(models, "gan_trained", device="cuda")
        tc_job = infer.TileConfig(patch=(256, 256), overlap=(0, 0), labels_dtype="uint16")
        enhance = infer.make_gan_enhancer(cfg_t, tc_job, (256, 256), device="cuda")
        batched = infer.cached_gan_enhancer(model_t.cfg, tc_job, (256, 256), 8, "cuda")
        direct = np.concatenate([
            batched(model_t, torch.from_numpy(raw[i:i + 8]).cuda()).cpu().numpy()[..., 0] for i in (0, 8)
        ])
        one = np.stack([enhance(model_t, torch.from_numpy(f).cuda()).cpu().numpy()[..., 0] for f in raw[:2]])
        print(
            f"gan_train job enhancement_gan on the trained model (16 frames, 8 a batch): equal to the registered "
            f"weights served directly in the same batches {np.array_equal(direct, served)}; one frame a call "
            f"differs by {float(np.abs(one - served[:2]).max()):.3g} (bf16 convs at another batch size)"
        )
        if not np.array_equal(direct, served):
            raise AssertionError("the trained GAN's served output differs from its weights served directly")
        out, wall = serve("evaluate_gan", {"model": "gan_trained"}, [raw_p, tgt_p], "evaluate_trained")
        print(f"gan_train job evaluate_gan on the trained model: {out['metrics'][:300]} ({wall:.3f} s)")
        want = {"build_gan_pairs": 0, "train_gan": 0, "enhance_trained": 2, "evaluate_trained": 4}
        print(
            "gan_train jobs quantile passes (histogram_2d launches): "
            + ", ".join(f"{k} {counts[k][1]} ({counts[k][0]})" for k in want)
            + " (expected 0 for the pair and train jobs, which normalize on the host; one a batch of 8 "
            "frames a side for the serve and the evaluation)"
        )
        for k, n in want.items():
            if counts[k] != (n, n):
                raise AssertionError(f"job {k}: {counts[k]} launches/passes, expected {n}")
        return counts


FAMILY_LR = {"n2v": 4e-4, "flows": 3e-4, "stars": 3e-4}  # the train jobs' default learning rates
FAMILY_N2V_LATER_BAR = 1e-2  # N2V f32 steps 2-3, card vs CPU: loss and running statistics (family_train_phase)


def _family_cfg(family, dims, dtype):
    """The train job's default architecture: its preset (``n2v_denoise``,
    ``flows_cells`` with depth 3 for volumes, ``stars_cells``) at ``dtype``."""
    import dataclasses

    from sequitr_tpu_torch.models import zoo

    base = zoo.get({"n2v": "n2v_denoise", "flows": "flows_cells", "stars": "stars_cells"}[family])
    kw = dict(dims=dims, compute_dtype=dtype)
    if family == "flows":
        kw.update(num_classes=dims + 1, depth=base.depth if dims == 2 else 3)
    return dataclasses.replace(base, **kw)


def _family_batch(np, family, n, spatial, seed):
    """``n`` examples of ``family``'s records (host arrays), normalized as
    the train jobs write them: noisy ``denoise_pair`` frames or noisy
    ``cells_volume`` volumes (N2V); ``instances_frame`` images with their
    flow or ray targets (flows, stars)."""
    from sequitr_tpu_torch.data import synthetic
    from sequitr_tpu_torch.ops import flows as flows_ops
    from sequitr_tpu_torch.ops import stardist as sd

    def norm(img):
        lo, hi = np.percentile(img, [5.0, 99.5])
        return np.clip((img - lo) / max(hi - lo, 1e-8), 0, 1).astype(np.float32)

    rng = np.random.default_rng(seed)
    if family == "n2v":
        if len(spatial) == 2:
            imgs = [synthetic.denoise_pair(seed + i, spatial)[1] for i in range(n)]
        else:
            imgs = [synthetic.cells_volume(seed + i, spatial)[0] + rng.normal(0, 20.0, spatial) for i in range(n)]
        return {"image": np.stack([norm(x) for x in imgs])[..., None]}
    imgs, targets, probs = [], [], []
    for i in range(n):
        img, lab = synthetic.instances_frame(seed + i, spatial)
        t, p = (flows_ops.flow_targets(lab.astype(np.int64)) if family == "flows"
                else sd.star_targets(lab.astype(np.int64), n_rays=32, max_dist=40.0))
        imgs.append(norm(img))
        targets.append(t.astype(np.float32))
        probs.append(p.astype(np.float32))
    key = "flow" if family == "flows" else "dist"
    return {"image": np.stack(imgs)[..., None], key: np.stack(targets), "prob": np.stack(probs)}


def _family_step(train, family, cfg, tc):
    if family == "n2v":
        return train.make_n2v_train_step(cfg, tc, radius=5 if cfg.dims == 2 else (2, 5, 5))
    return (train.make_flows_train_step if family == "flows" else train.make_stars_train_step)(cfg, tc)


def _family_draws(np, train, family, gen, shape, tc):
    """One step's draws from ``gen`` (the step's own order)."""
    nd = len(shape) - 2
    if family != "n2v":
        return train.draw_flips(gen, shape, nd, tc)
    radii = (5, 5) if nd == 2 else (2, 5, 5)
    n_mask = max(1, int(0.005 * int(np.prod(shape[1:-1]))))
    return train.N2VDraws(train.n2v_draw_flip(gen, shape), train.n2v_draw_mask(gen, shape, n_mask, radii))


def family_train_phase(torch, hist, conv, smi_line):
    """N2V, flows and stars training on the card (PyTorch's TF32 defaults
    restored; the f32 steps enter ``utils.ieee_f32`` themselves): the N2V
    masking's apply on the card bit-equal to the CPU's on the same draws,
    with no host sync; 3 f32 steps of each family card against CPU from the
    same weights and draws; the bf16 step at each job's default shape and
    preset, standard and polyphase, with its split, device ops, busy share
    and peak memory; then each train job in one server process followed by
    the serve and evaluation of its model. Returns {job: (histogram_2d
    launches, quantile passes)}."""
    import numpy as np
    from scipy import ndimage

    from sequitr_tpu_torch.config import ServerConfiguration
    from sequitr_tpu_torch.data import synthetic, tiff
    from sequitr_tpu_torch.models import convert, unet
    from sequitr_tpu_torch.ops import stardist as sd
    from sequitr_tpu_torch.pipeline import infer, optim, train
    from sequitr_tpu_torch.server import ImageServer, submit_job
    from sequitr_tpu_torch.server.server import _tile_config, load_model

    torch.backends.cuda.matmul.allow_tf32 = False  # PyTorch's defaults
    torch.backends.cudnn.allow_tf32 = True

    # (1) the masking: the card's apply against the CPU's on the same
    # draws, bit for bit, and no host sync on the card
    cases = [
        ("2D uniform", (16, 64, 64, 1), (5, 5), "uniform", None, 20),
        ("2D median (120 taps)", (16, 64, 64, 1), (5, 5), "median", None, 20),
        ("2D struct y", (16, 64, 64, 1), (5, 5), "uniform", (0, 4), 20),
        ("2D median struct x", (16, 64, 64, 1), (5, 5), "median", (1, 4), 20),
        ("3D uniform", (16, 8, 64, 64, 1), (2, 5, 5), "uniform", None, 163),
        ("3D median (604 taps)", (16, 8, 64, 64, 1), (2, 5, 5), "median", None, 163),
        ("3D struct z", (16, 8, 64, 64, 1), (2, 5, 5), "uniform", (0, 2), 163),
        ("2D forced duplicates", (16, 64, 64, 1), (5, 5), "uniform", (1, 4), 20),
    ]
    for name, shape, radii, mode, struct, n_mask in cases:
        gen = torch.Generator().manual_seed(len(name))
        img = torch.rand(shape, generator=gen)
        draws = train.n2v_draw_mask(gen, shape, n_mask, radii, mode, struct)
        if "duplicates" in name:
            # every second centre repeats its neighbour, offsets differ
            draws.centers[:, :, 1::2] = draws.centers[:, :, 0::2]
        cpu, cpu_c = train.n2v_mask_apply(img, draws, radii, mode, struct)
        card_img = img.cuda()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            card, card_c = train.n2v_mask_apply(card_img, draws, radii, mode, struct)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        same = torch.equal(card.cpu(), cpu) and all(torch.equal(a.cpu(), b) for a, b in zip(card_c, cpu_c))
        changed = int((cpu != img).any(-1).sum())
        ms = _median_ms(lambda: train.n2v_mask_apply(card_img, draws, radii, mode, struct), 20)
        print(
            f"family_train mask {name} {tuple(shape)}: card bit-equal to the CPU {same}, no host sync, "
            f"{changed} pixels replaced, {ms:.4f} ms on the card"
        )
        if not same:
            raise AssertionError(f"N2V masking {name}: card and CPU differ")

    # (2) three f32 steps a family, the card against the CPU, from the same
    # weights and draws. The train phase's bars (TRAIN_*) hold for everything
    # read on the same weights (step 1's loss and grad_norm; the weights and
    # statistics after step 1) and for the updates after 3 steps. Adam's first update is the
    # sign of each gradient, so weights whose gradient cancels to round-off
    # part by 2 lr at once, and the later steps run on parted weights:
    # flows and stars still meet those loss and statistics bars at step 3,
    # N2V (its loss reads 20 masked pixels a sample, 163 a volume) reads
    # step-3 losses 3.0e-4 (2D) and 2.0e-3 (3D) apart and statistics up to
    # 3.7e-3 (NVIDIA H100 80GB HBM3, 700 W; two card runs agree to 7e-6 and
    # 2.2e-5), so its steps 2-3 are held at FAMILY_N2V_LATER_BAR
    failed = []
    exact = [("n2v", 2, (4, 64, 64)), ("n2v", 3, (2, 8, 64, 64)), ("flows", 2, (4, 64, 64)), ("stars", 2, (4, 64, 64))]
    for family, dims, shape in exact:
        lr = FAMILY_LR[family]
        cfg32 = _family_cfg(family, dims, "float32")
        tc = train.TrainConfig(learning_rate=lr)
        flat = convert.to_flat(unet.init(cfg32, torch.Generator().manual_seed(3), device="cpu"))
        batches = [_family_batch(np, family, shape[0], shape[1:], 880_000 + 10 * s) for s in range(TRAIN_STEPS_EXACT)]
        gen = torch.Generator().manual_seed(5)
        draws = [_family_draws(np, train, family, gen, b["image"].shape, tc) for b in batches]
        runs = {}
        for name, where in (("cpu", "cpu"), ("card", "cuda"), ("card again", "cuda")):
            state = train.create_unet_state(cfg32, tc, model=convert.load_flat(cfg32, flat, device=where))
            step = _family_step(train, family, cfg32, tc)
            got, first = [], None
            for b, d in zip(batches, draws):
                state, m = step(state, {k: torch.from_numpy(v).to(where) for k, v in b.items()}, draws=d)
                got.append((float(m["loss"]), float(m["grad_norm"])))
                if first is None:
                    first = convert.load_flat(cfg32, convert.to_flat(state.model), device="cpu")
            runs[name] = (got, first, state.model.to("cpu"))
        rel1, _, _, stats1 = _weights_vs(np, convert, runs["card"][1], runs["cpu"][1], flat, lr)
        rel, share, nulled, stats = _weights_vs(np, convert, runs["card"][2], runs["cpu"][2], flat, lr)
        rel2, share2, nulled2, stats2 = _weights_vs(np, convert, runs["card"][2], runs["card again"][2], flat, lr)
        loss_rel = [abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(runs["card"][0], runs["cpu"][0])]
        gn_rel = [abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(runs["card"][0], runs["cpu"][0])]
        again = [abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(runs["card"][0], runs["card again"][0])]
        later = FAMILY_N2V_LATER_BAR if family == "n2v" else None
        print(
            f"family_train f32 {family} {dims}D {TRAIN_STEPS_EXACT} steps of {shape} ({cfg32.depth} levels, base "
            f"{cfg32.base_features}, {cfg32.num_classes} out): losses card {[g[0] for g in runs['card'][0]]} CPU "
            f"{[g[0] for g in runs['cpu'][0]]} (rel {', '.join(f'{r:.3g}' for r in loss_rel)}), grad_norm rel "
            f"{', '.join(f'{r:.3g}' for r in gn_rel)}; after step 1 updates differ by {rel1:.3g} of their L2 norm "
            f"and statistics by {stats1:.3g}; after {TRAIN_STEPS_EXACT} steps updates by {rel:.3g} (bar "
            f"{TRAIN_UPDATE_BAR}), {share:.3g} of the weights by more than lr/10, BN-nulled biases by up to "
            f"{nulled:.3g}, statistics by {stats:.3g}; bars: step 1 loss {TRAIN_LOSS_RTOL}, grad_norm "
            f"{TRAIN_GRAD_NORM_RTOL}, statistics {TRAIN_STATS_BAR}; steps 2-3 loss and statistics "
            f"{later or f'{TRAIN_LOSS_RTOL} and {TRAIN_STATS_BAR}'}; two card runs: losses rel "
            f"{', '.join(f'{r:.3g}' for r in again)}, updates {rel2:.3g}, {share2:.3g}, {nulled2:.3g}, "
            f"statistics {stats2:.3g}"
        )
        ok = (
            loss_rel[0] <= TRAIN_LOSS_RTOL and gn_rel[0] <= TRAIN_GRAD_NORM_RTOL
            and rel1 <= TRAIN_UPDATE_BAR and stats1 <= TRAIN_STATS_BAR and rel <= TRAIN_UPDATE_BAR
            and max(loss_rel[1:]) <= (later or TRAIN_LOSS_RTOL) and stats <= (later or TRAIN_STATS_BAR)
        )
        if not ok:
            failed.append(f"{family} {dims}D")

    # (3) the bf16 step at each job's default shape and preset
    timed = [("n2v", 2, (16, 64, 64)), ("n2v", 3, (16, 8, 64, 64)), ("flows", 2, (16, 64, 64)), ("stars", 2, (16, 64, 64))]
    for family, dims, shape in timed:
        host = _family_batch(np, family, shape[0], shape[1:], 890_000)
        batch = {k: torch.from_numpy(v).cuda() for k, v in host.items()}
        cfg = _family_cfg(family, dims, "bfloat16")
        ms = {}
        for kind, poly in (("standard", False), ("polyphase", True)):
            tc = train.TrainConfig(learning_rate=FAMILY_LR[family], polyphase=poly)
            state = train.create_unet_state(cfg, tc, torch.Generator().manual_seed(0), device="cuda")
            step = _family_step(train, family, cfg, tc)
            opt = tc.make_optimizer()
            forward = train._train_forward(cfg, tc)
            gen = torch.Generator().manual_seed(1)

            perms = (torch.stack([torch.as_tensor(sd.ray_flip_perm(cfg.num_classes - 1, a)) for a in (0, 1)])
                     if family == "stars" else None)

            def prep(d):
                """(forward input, loss of the output) after the step's flips and mask."""
                if family == "n2v":
                    x = train.n2v_flip_batch(batch["image"], d.flip)
                    masked, coords = train.n2v_mask_apply(x, d.mask, (5, 5) if dims == 2 else (2, 5, 5))
                    return masked, lambda out: train.n2v_masked_mse(out, x, *coords)
                if family == "flows":
                    x, f, pr = train.flows_flip_batch(batch["image"], batch["flow"], batch["prob"], d.flips)
                    return x, lambda out: train.flows_loss(out, f, pr)[0]
                x, dist, pr = train.stars_flip_batch(batch["image"], batch["dist"], batch["prob"], d.flips, perms)
                return x, lambda out: train.stars_loss(out, dist, pr)[0]

            def parts():
                t = [time.perf_counter()]
                x, loss_of = prep(_family_draws(np, train, family, gen, tuple(batch["image"].shape), tc))
                torch.cuda.synchronize()
                t.append(time.perf_counter())
                out, stats = forward(state.model, x)
                params = state.params
                grads = torch.autograd.grad(loss_of(out), params)
                torch.cuda.synchronize()
                t.append(time.perf_counter())
                opt.update(params, grads, state.opt_state, grad_norm=optim.global_norm(grads))
                state.model.set_bn_stats(stats)
                torch.cuda.synchronize()
                t.append(time.perf_counter())
                return [b - a for a, b in zip(t, t[1:])]

            for _ in range(3):
                parts()
            split = np.median(np.array([parts() for _ in range(10)]), axis=0) * 1e3

            def whole():
                step(state, batch, gen)

            whole()
            torch.cuda.synchronize()
            times = []
            for _ in range(10):
                t0 = time.perf_counter()
                whole()
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            ms[kind] = float(np.median(times)) * 1e3
            _, peak = _peak_gb(torch, whole)
            ops = _device_events(torch, whole, 2)
            dev = _ms(ops, 2)
            by_name = {}
            for e in ops:
                by_name.setdefault(e.name, []).append(e)
            top = sorted(by_name.items(), key=lambda kv: -_ms(kv[1], 2))[:4]
            print(
                f"family_train bf16 {family} {dims}D {kind} step {shape} ({cfg.depth} levels, base "
                f"{cfg.base_features}, {cfg.num_classes} out): {ms[kind]:.4f} ms "
                f"({shape[0] / ms[kind] * 1e3:.3f} patches/s) on {smi_line}; split (synchronized, median of 10): "
                f"{'flip + mask' if family == 'n2v' else 'flip'} {split[0]:.4f} ms, forward + backward "
                f"{split[1]:.4f} ms, optimizer + BN statistics {split[2]:.4f} ms; {len(ops) / 2:.0f} device ops a "
                f"step, {dev:.4f} device ms, busy share {dev / ms[kind]:.3f}, peak {peak:.3f} GB; largest: "
                + "; ".join(f"{n[:50]} {_ms(es, 2):.4f}" for n, es in top)
            )
        print(f"family_train bf16 {family} {dims}D polyphase over standard: {ms['polyphase'] / ms['standard']:.3f}x")

    # (4) the jobs in one server process on the card
    with tempfile.TemporaryDirectory() as tmp:
        jobs, models = os.path.join(tmp, "jobs"), os.path.join(tmp, "models")
        server = ImageServer(ServerConfiguration(jobs_dir=jobs, models_dir=models, device="cuda"))
        counts, outputs = {}, {}

        def write(name, arr):
            path = os.path.join(tmp, name)
            tiff.write_stack(path, arr)
            return path

        def serve(name, module, params, inputs, passes):
            submit_job(jobs, {"module": module, "params": params, "input": inputs,
                              "output": os.path.join(tmp, f"out_{name}")})
            torch.cuda.synchronize()
            hist.histogram_2d.launches = 0
            hist.quantile_pass.launches = 0
            conv.conv3x3_nhwc.launches = 0
            conv.conv3x3_flat_chw.launches = 0
            _euler().launches = 0
            t0 = time.perf_counter()
            if not server.poll_once():
                raise AssertionError(f"job {name}: no job to run")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts[name] = (hist.histogram_2d.launches, hist.quantile_pass.launches)
            with open(os.path.join(tmp, f"out_{name}", "status.json")) as f:
                status = json.load(f)
            if status["state"] != "complete":
                raise AssertionError(f"job {name}: {status.get('error')}")
            if conv.conv3x3_nhwc.launches + conv.conv3x3_flat_chw.launches:
                raise AssertionError(f"job {name}: launched a conv study kernel")
            if counts[name] != (passes, passes):
                raise AssertionError(f"job {name}: {counts[name]} launches/passes, expected {passes}")
            _euler_read(name, _euler_want(module, params, passes))
            outputs[name] = status["outputs"]
            extra = ""
            if "metrics_file" in status["outputs"]:
                with open(status["outputs"]["metrics_file"]) as f:
                    rows = [json.loads(line) for line in f]
                tr = [r for r in rows if r["kind"] == "train"]
                if not tr or not all(np.isfinite(r["loss"]) for r in tr):
                    raise AssertionError(f"job {name}: no or non-finite training loss")
                extra = (f"; loss {tr[0]['loss']:.4f} -> {tr[-1]['loss']:.4f}, "
                         f"{tr[-1]['steps_per_sec']:.3f} steps/s")
            elif "metrics" in status["outputs"]:
                extra = f"; {str(status['outputs']['metrics'])[:240]}"
            print(f"family_train job {name} ({module}): {wall:.3f} s, quantile passes {counts[name][1]}{extra}")
            return status["outputs"]

        def direct(name, model_name, frames, make, out_of):
            """The registered weights served directly, as the job serves
            them (its tile config, one item a call), against the job's
            saved output."""
            _, cfg_t, model_t = load_model(models, model_name, device="cuda")
            spatial = frames.shape[1:]
            tc = _tile_config({}, len(spatial), spatial, cfg_t.min_input_multiple, exact_only=True,
                              allow_polyphase=True)
            fn = make(cfg_t, tc, tuple(spatial))
            with torch.inference_mode():
                want = np.stack([out_of(fn(model_t, torch.from_numpy(f).cuda())) for f in frames])
            return want

        def hold(name, served, want):
            same = np.array_equal(served, want)
            print(f"family_train job {name}: served output equal to the registered weights served directly {same}"
                  f" (max |diff| {float(np.abs(served - want).max()):.3g})")
            if not same:
                raise AssertionError(f"job {name}: served output differs from its weights served directly")

        # N2V 2D: 4 noisy 1024x1024 denoise_pair frames
        pairs = [synthetic.denoise_pair(895_000 + i, (1024, 1024)) for i in range(4)]
        noisy = np.stack([n for _, n in pairs]).astype(np.float32)
        p_noisy, p_clean = write("noisy.tif", noisy), write("clean.tif", np.stack([c for c, _ in pairs]).astype(np.float32))
        steps = {"steps": 30, "log_every": 10, "checkpoint_every": 30}
        serve("train_n2v", "train_n2v", dict(steps, model="n2v_t"), [p_noisy], 0)
        out = serve("denoise_n2v", "denoise", {"model": "n2v_t"}, [p_noisy], 4)
        hold("denoise_n2v", tiff.read_stack(out["denoised"]),
             direct("denoise_n2v", "n2v_t", noisy,
                    lambda c, t, s: infer.cached_denoiser(c, t, s, None, "cuda"),
                    lambda y: y.float().cpu().numpy()[..., 0]))
        serve("evaluate_denoise_n2v", "evaluate_denoise", {"model": "n2v_t"}, [p_noisy, p_clean], 8)

        # N2V 3D: 2 volumes of 32x256x256 in one file (z: 32)
        vols = np.stack([synthetic.cells_volume(896_000 + t, INST_VOLUME)[0] for t in range(2)]).astype(np.float32)
        vols = vols + np.random.default_rng(3).normal(0, 20.0, vols.shape).astype(np.float32)
        p_vols = write("noisy_v.tif", vols.reshape((-1,) + INST_VOLUME[1:]))
        serve("train_n2v_3d", "train_n2v", dict(steps, model="n2v3d_t", dims=3, z=INST_VOLUME[0]), [p_vols], 0)
        out = serve("denoise_n2v_3d", "denoise", {"model": "n2v3d_t", "z": INST_VOLUME[0]}, [p_vols], 2)
        hold("denoise_n2v_3d", tiff.read_stack(out["denoised"]).reshape(vols.shape),
             direct("denoise_n2v_3d", "n2v3d_t", vols,
                    lambda c, t, s: infer.cached_denoiser(c, t, s, None, "cuda"),
                    lambda y: y.float().cpu().numpy()[..., 0]))

        # flows 2D and stars: 4 instances_frames of 256x256 (the targets are
        # computed on the host: star_targets marches 32 rays a pixel)
        scenes = [synthetic.instances_frame(897_000 + i, (256, 256)) for i in range(4)]
        inst = np.stack([img for img, _ in scenes]).clip(0, 65535).astype(np.uint16)
        p_inst = write("inst.tif", inst)
        p_truth = write("inst_truth.tif", np.stack([lab for _, lab in scenes]).astype(np.uint16))
        seg_params = {"localize": False, "save_prob": True}
        serve("train_flows", "train_flows", dict(steps, model="flows_t"), [p_inst, p_truth], 0)
        out = serve("segment_flows_t", "segment_flows", dict(seg_params, model="flows_t"), [p_inst], 4)
        hold("segment_flows_t", tiff.read_stack(os.path.join(os.path.dirname(out["labels"]), "prob.tif")),
             direct("segment_flows_t", "flows_t", inst,
                    lambda c, t, s: infer.cached_flows_segmenter(c, t, s, device="cuda"),
                    lambda y: y[1].float().cpu().numpy()))
        serve("evaluate_flows_t", "evaluate_flows", {"model": "flows_t"}, [p_inst, p_truth], 4)
        serve("train_stars", "train_stars", dict(steps, model="stars_t", max_dist=40), [p_inst, p_truth], 0)
        out = serve("segment_stars_t", "segment_stars", dict(seg_params, model="stars_t"), [p_inst], 4)
        hold("segment_stars_t", tiff.read_stack(os.path.join(os.path.dirname(out["labels"]), "prob.tif")),
             direct("segment_stars_t", "stars_t", inst,
                    lambda c, t, s: infer.cached_stars_predictor(c, t, s, "cuda"),
                    lambda y: y[0].float().cpu().numpy()))
        serve("evaluate_stars_t", "evaluate_stars", {"model": "stars_t"}, [p_inst, p_truth], 4)

        # flows 3D: 2 volumes of 16x64x64, instances from cells_volume
        fv = [synthetic.cells_volume(898_000 + t, (16, 64, 64)) for t in range(2)]
        fvols = np.stack([v for v, _ in fv]).clip(0, 65535).astype(np.uint16)
        p_fv = write("inst_v.tif", fvols.reshape(-1, 64, 64))
        p_fl = write("inst_vl.tif", np.stack([ndimage.label(lab > 0)[0] for _, lab in fv]).astype(np.uint16).reshape(-1, 64, 64))
        serve("train_flows_3d", "train_flows", dict(steps, model="flows3d_t", dims=3, z=16), [p_fv, p_fl], 0)
        out = serve("segment_flows_3d_t", "segment_flows", dict(seg_params, model="flows3d_t", z=16), [p_fv], 2)
        served = np.stack([tiff.read_stack(os.path.join(os.path.dirname(out["labels"]), f"prob_t{t:04d}.tif"))
                           for t in range(2)])
        hold("segment_flows_3d_t", served,
             direct("segment_flows_3d_t", "flows3d_t", fvols,
                    lambda c, t, s: infer.cached_flows_segmenter(c, t, s, device="cuda"),
                    lambda y: y[1].float().cpu().numpy()))
        if failed:
            raise AssertionError(f"family_train f32 steps: card and CPU disagree for {failed}")
        print(
            "family_train jobs quantile passes: " + ", ".join(f"{k} {v[1]}" for k, v in counts.items())
            + " (0 for every train job, which normalizes on the host; one a normalized frame or volume for "
            "each serve, two a frame for evaluate_denoise, one a frame for evaluate_flows and evaluate_stars)"
        )
        return counts


GEOM_FRAME = (1024, 1024)  # (u), (x): the serving phases' frame
GEOM_FRAMES = 64
GEOM_SEED = 555_100
GEOM_VOLUME = VOLUME  # (v): the 3D serving phase's z-stack
GEOM_TILE = (1024, 1024)  # (w): 4x4 grid, 102 px (10%) overlap, +-2.5 px jitter
GEOM_OVERLAP = 102
GEOM_JITTER = 2.5
GEOM_CARD_CPU_PX = 1e-3  # shifts, positions and meter errors, card against the port on the CPU
GEOM_ILLUM_RTOL = 1e-5  # correct_illumination's output, card against CPU (relative)
GEOM_ILLUM_METER = 1e-4  # illum_fidelity's numbers, card against CPU
GEOM_TRUTH_PX = 0.1  # (u)/(v) trajectory RMSE against the known drift
MOSAIC_POSITION_BAR = 0.05  # tests/test_fidelity.py: position_rmse_px, seam_rms_residual_px
MOSAIC_PHOTOMETRIC_BAR = 0.08  # tests/test_fidelity.py: photometric_residual_frac


def _fourier_moved(torch, spec, shift):
    """The scene of spectrum ``spec`` (complex128 on the card) moved by
    ``shift``: an f64 Fourier shift, independent of the port's f32 code."""
    import math

    nd = len(shift)
    phase = 0
    for ax, (n, s) in enumerate(zip(spec.shape, shift)):
        f = torch.fft.fftfreq(n, dtype=torch.float64, device=spec.device)
        phase = phase + f.reshape([-1 if i == ax else 1 for i in range(nd)]) * float(s)
    ramp = torch.polar(torch.ones_like(phase), -2.0 * math.pi * phase)
    return torch.fft.ifftn(spec * ramp).real


def _shifts_csv(np, path):
    """shifts.csv -> (cumulative shifts, step shifts, responses) as arrays."""
    with open(path) as f:
        lines = f.read().strip().splitlines()[1:]
    # the reference row has no response
    rows = np.array([[float(v) if v else np.nan for v in line.split(",")] for line in lines])
    nd = (rows.shape[1] - 2) // 2
    return rows[:, 1 : 1 + nd], rows[:, 1 + nd : 1 + 2 * nd], rows[:, -1]


def _fft_split(by_name, n):
    """Device ms an item by kind: cuFFT, copies, and everything else
    (elementwise, reductions, sort, argmax)."""
    fft = sum(us for k, us in by_name.items() if "fft" in k.lower())
    copy = sum(us for k, us in by_name.items() if "memcpy" in k.lower() or "memset" in k.lower())
    other = sum(by_name.values()) - fft - copy
    return fft / 1e3 / n, copy / 1e3 / n, other / 1e3 / n


def geometry_phase(torch, hist, conv, smi_line):
    """register_stack (2D, first mode + frame_batch, integer mode, dims 3),
    stitch_mosaic (device and cpu backends, 4x4 and 3x3, timelapse) and
    correct_illumination (exp, ratio) through ImageServer on the card, held
    to the known truth, to the port on the CPU and to each other; the
    geometry meters on the card and the CPU. Returns {job: (histogram_2d
    launches, quantile passes)}: 0 for every job (no kernel of the four
    lies on these paths)."""
    import numpy as np

    from sequitr_tpu_torch import fidelity
    from sequitr_tpu_torch.config import ServerConfiguration
    from sequitr_tpu_torch.data import tiff
    from sequitr_tpu_torch.data.synthetic import bandlimited_scene
    from sequitr_tpu_torch.ops import registration as reg
    from sequitr_tpu_torch.server import ImageServer, submit_job

    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        servers = {
            dev: ImageServer(ServerConfiguration(
                jobs_dir=os.path.join(tmp, f"jobs_{dev}"), models_dir=os.path.join(tmp, "models"), device=dev,
            ))
            for dev in ("cuda", "cpu")
        }

        def write(name, arr):
            path = os.path.join(tmp, name)
            tiff.write_stack(path, arr)
            return path

        def serve(name, module, params, inputs, dev="cuda", count=True):
            """One job; returns (outputs, metrics, wall s). Card jobs run
            with every kernel's launch count reset just before and read
            just after."""
            out = os.path.join(tmp, f"out_{name}")
            submit_job(servers[dev].config.jobs_dir, {
                "module": module, "params": params, "input": inputs, "output": out,
            })
            torch.cuda.synchronize()
            hist.histogram_2d.launches = 0
            hist.quantile_pass.launches = 0
            conv.conv3x3_nhwc.launches = 0
            conv.conv3x3_flat_chw.launches = 0
            _euler().launches = 0
            t0 = time.perf_counter()
            if not servers[dev].poll_once():
                raise AssertionError(f"geometry job {name}: no job to run")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = (hist.histogram_2d.launches, hist.quantile_pass.launches,
                        conv.conv3x3_nhwc.launches + conv.conv3x3_flat_chw.launches)
            with open(os.path.join(out, "status.json")) as f:
                status = json.load(f)
            if status["state"] != "complete":
                raise AssertionError(f"geometry job {name}: {status.get('error')}")
            if dev == "cuda" and count:
                if any(launched):
                    raise AssertionError(f"geometry job {name} launched a kernel of the four: {launched}")
                _euler_read(f"geom_{name}", 0)
                counts[f"geom_{name}"] = launched[:2]
            metrics = json.loads(status["outputs"]["metrics"])
            shown = {k: v for k, v in metrics.items() if k != "chromatic_offsets_px"}
            print(f"geometry job {name} ({dev}) {module} {json.dumps(params)}: wall {wall:.4f} s, "
                  f"metrics {json.dumps(shown)} on {smi_line}")
            return status["outputs"], metrics, wall

        # (u) register_stack 2D: 64 uint16 frames of 1024x1024 along a
        # known sub-pixel trajectory (~1 px/frame)
        rng = np.random.default_rng(GEOM_SEED)
        base = bandlimited_scene(GEOM_FRAME, rng, amp=1500.0, offset=6000.0)
        truth = np.vstack([[0.0, 0.0], np.cumsum(rng.normal((0.8, -0.6), 0.3, (GEOM_FRAMES - 1, 2)), 0)])
        spec = torch.fft.fftn(torch.from_numpy(base).double().cuda())
        frames = np.stack([
            _fourier_moved(torch, spec, s).round().clamp(0, 65535).cpu().numpy() for s in truth
        ]).astype(np.uint16)
        stack = write("drift.tif", frames)
        # a warm-up job first: cuFFT's plans and the first use of each op
        # on the card would otherwise land in (u)'s frames/s
        serve("u_warmup", "register_stack", {"frame_range": [0, 8]}, [stack])
        out_u, m_u, wall_u = serve("u_previous", "register_stack", {}, [stack])
        cum_u, step_u, _ = _shifts_csv(np, out_u["shifts"])
        err_u = cum_u + truth  # the correction aligns back: -truth
        rmse_u = float(np.sqrt(np.mean(err_u**2)))
        print(f"geometry (u) previous: trajectory RMSE {rmse_u:.6f} px (max {np.abs(err_u).max():.6f}) over "
              f"{GEOM_FRAMES} frames of {GEOM_FRAME}, {m_u['frames_per_sec']} frames/s on {smi_line}")
        if rmse_u > GEOM_TRUTH_PX:
            raise AssertionError(f"(u) trajectory RMSE {rmse_u} px > {GEOM_TRUTH_PX}")
        out_c, _, _ = serve("u_previous_cpu", "register_stack", {"frame_range": [0, 8]}, [stack], dev="cpu")
        cum_c, step_c, _ = _shifts_csv(np, out_c["shifts"])
        gap = max(np.abs(cum_c - cum_u[:8]).max(), np.abs(step_c - step_u[:8]).max())
        print(f"geometry (u) card vs CPU port, first 8 frames: max shift gap {gap:.6f} px")
        if gap > GEOM_CARD_CPU_PX:
            raise AssertionError(f"(u) card and CPU shifts differ by {gap} px")
        out_s, _, _ = serve("u_first", "register_stack", {"mode": "first"}, [stack])
        out_b, m_b, _ = serve("u_first_batch8", "register_stack", {"mode": "first", "frame_batch": 8}, [stack])
        gap = np.abs(_shifts_csv(np, out_b["shifts"])[0] - _shifts_csv(np, out_s["shifts"])[0]).max()
        reg_s = tiff.read_stack(out_s["registered"])
        reg_b = tiff.read_stack(out_b["registered"])
        # test_registration.py's 1e-3 is on values ~120; these are ~6000
        pix = float(np.abs(reg_b - reg_s).max()) / float(np.abs(reg_s).mean()) * 120.0
        print(f"geometry (u) first mode, frame_batch 8 against streaming: shifts {gap:.6f} px, "
              f"registered {pix:.6f} at the JAX test's scale; {m_b['frames_per_sec']} frames/s")
        if gap > 1e-3 or pix > 1e-3:
            raise AssertionError(f"(u) frame_batch 8 differs from streaming: {gap} px, {pix}")
        del reg_s, reg_b
        out_i, m_i, _ = serve("u_integer", "register_stack", {"subpixel": False}, [stack])
        reg_i = tiff.read_stack(out_i["registered"])
        if reg_i.dtype != np.uint16:
            raise AssertionError(f"(u) integer mode wrote {reg_i.dtype}")
        cum_i = _shifts_csv(np, out_i["shifts"])[0]
        bad = [
            t for t in range(GEOM_FRAMES)
            if not np.array_equal(reg_i[t], np.roll(frames[t], tuple(np.round(cum_i[t]).astype(int)), axis=(0, 1)))
            and np.abs(np.abs(cum_i[t] % 1.0) - 0.5).min() > 1e-3  # a printed .5 may round either way
        ]
        if bad:
            raise AssertionError(f"(u) integer mode: frames {bad} are not host rolls by the reported shifts")
        print(f"geometry (u) integer mode: {GEOM_FRAMES} frames byte-equal to np.roll by the reported shifts, "
              f"{m_i['frames_per_sec']} frames/s")
        del reg_i

        # where a frame's time goes: the job's step, streamed with the
        # host fetch of each corrected frame as the job does
        dev_frames = [torch.from_numpy(f).cuda() for f in frames[:16]]

        def stream(subpixel=True, resample=True, fetch=True):
            anchor = torch.fft.fftn(dev_frames[0].float() * reg.hann_window(GEOM_FRAME, "cuda"))
            cum = torch.zeros(2, device="cuda")
            for f in dev_frames[1:]:
                anchor, cum, corr, _, _ = reg.register_step(
                    anchor, f, cum, subpixel=subpixel, resample=resample
                )
                if fetch:
                    corr.cpu()
                    cum.cpu()

        wall, busy, ops, by_name = _profile_stream(torch, "register_step 1024x1024", stream, 15, "frame")
        fft_ms, copy_ms, other_ms = _fft_split(by_name, 15)
        print(f"geometry (u) a frame: {wall / 15 * 1e3:.4f} ms wall, busy {busy / (wall * 1e6):.3f}, {ops:.1f} "
              f"device ops; device ms cuFFT {fft_ms:.4f}, copies {copy_ms:.4f}, elementwise and reductions "
              f"{other_ms:.4f}; host idle {(wall * 1e6 - busy) / 1e3 / 15:.4f} ms on {smi_line}")
        timings = {}
        for label, kw in (("sub-pixel, fetch each frame", dict()),
                          ("sub-pixel estimate only, queued", dict(resample=False, fetch=False)),
                          ("integer estimate only, queued", dict(subpixel=False, resample=False, fetch=False)),
                          ("integer roll (one sync)", dict(subpixel=False, fetch=False))):
            stream(**kw)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stream(**kw)
            torch.cuda.synchronize()
            timings[label] = (time.perf_counter() - t0) / 15 * 1e3
        print("geometry (u) ms a frame: " + ", ".join(f"{k} {v:.4f}" for k, v in timings.items())
              + f"; the integer roll and its sync cost "
              f"{timings['integer roll (one sync)'] - timings['integer estimate only, queued']:.4f}"
              f" ms a frame on {smi_line}")
        del dev_frames, spec

        # (v) register_stack dims 3: 4 timepoints of 32x512x512
        vbase = bandlimited_scene(GEOM_VOLUME, rng, sigma=0.12, amp=1500.0, offset=6000.0)
        vtruth = np.vstack([[0.0] * 3, np.cumsum(rng.normal((0.3, 0.9, -0.7), 0.2, (3, 3)), 0)])
        vspec = torch.fft.fftn(torch.from_numpy(vbase).double().cuda())
        vdir = os.path.join(tmp, "volumes")
        os.makedirs(vdir)
        for t, s in enumerate(vtruth):
            tiff.write_stack(os.path.join(vdir, f"vol_t{t:04d}.tif"),
                             _fourier_moved(torch, vspec, s).round().clamp(0, 65535).cpu().numpy().astype(np.uint16))
        del vspec
        out_v, m_v, _ = serve("v_dims3", "register_stack", {"dims": 3}, [vdir])
        err_v = _shifts_csv(np, out_v["shifts"])[0] + vtruth
        rmse_v = float(np.sqrt(np.mean(err_v**2)))
        print(f"geometry (v) dims 3: (dz, dy, dx) RMSE {rmse_v:.6f} px (max {np.abs(err_v).max():.6f}) over 4 "
              f"volumes of {GEOM_VOLUME}, {m_v['volumes_per_sec']} volumes/s on {smi_line}")
        if rmse_v > GEOM_TRUTH_PX:
            raise AssertionError(f"(v) RMSE {rmse_v} px > {GEOM_TRUTH_PX}")

        # (w) stitch_mosaic: 4x4 tiles of 1024x1024, 102 px overlap, +-2.5 px
        # jitter, a vignette and a fade across the scan
        r = c = 4
        h, w = GEOM_TILE
        step = h - GEOM_OVERLAP
        scene = bandlimited_scene(((r - 1) * step + h + 16,) * 2, rng, amp=1500.0, offset=6000.0)
        sspec = torch.fft.fftn(torch.from_numpy(scene).double().cuda())
        yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
        vig = 1.0 - 0.3 * (yy**2 + xx**2)
        fade = np.linspace(1.0, 0.7, r * c)
        tiles, pos = [], []
        for k in range(r * c):
            jy, jx = rng.uniform(-GEOM_JITTER, GEOM_JITTER, 2) if k else (0.0, 0.0)
            y0, x0 = (k // c) * step + 8 + jy, (k % c) * step + 8 + jx
            iy, ix = int(np.floor(y0)), int(np.floor(x0))
            cut = _fourier_moved(torch, sspec, (iy - y0, ix - x0))[iy : iy + h, ix : ix + w].cpu().numpy()
            tiles.append((cut * vig * fade[k]).astype(np.float32))
            pos.append((y0, x0))
        del sspec
        tiles = np.stack(tiles)
        pos = np.asarray(pos)
        grid4 = write("tiles4.tif", tiles)
        sub = [y * c + x for y in range(3) for x in range(3)]
        grid3 = write("tiles3.tif", tiles[sub])
        params = {"grid": [4, 4], "overlap": GEOM_OVERLAP, "flatfield": True, "match_gains": True}
        out_w, m_w, _ = serve("w_4x4", "stitch_mosaic", dict(params, backend="device"), [grid4])
        got = np.loadtxt(out_w["positions"], delimiter=",", skiprows=1, ndmin=2)[:, 3:5]
        err_w = got - (pos - pos.min(axis=0))
        rmse_w = float(np.sqrt(np.mean(err_w**2)))
        print(f"geometry (w) 4x4: position RMSE {rmse_w:.6f} px (max {np.abs(err_w).max():.6f}), rms_residual "
              f"{m_w['rms_residual_px']} px, gains {m_w['gain_min']}-{m_w['gain_max']}, flatfield "
              f"{m_w['flatfield_min']}-{m_w['flatfield_max']}")
        if rmse_w > MOSAIC_POSITION_BAR:
            raise AssertionError(f"(w) position RMSE {rmse_w} px > {MOSAIC_POSITION_BAR}")
        walls = {}
        for grid, path, g in (("4x4", grid4, [4, 4]), ("3x3", grid3, [3, 3])):
            for rep in (1, 2):
                for backend in ("device", "cpu"):
                    name = f"w_{grid}_{backend}_{rep}"
                    outs, m, wall = serve(name, "stitch_mosaic", dict(params, grid=g, backend=backend), [path])
                    walls[(grid, backend, rep)] = (wall, m["total_s"])
                    if rep == 2 and backend == "cpu":
                        card = os.path.join(tmp, f"out_w_{grid}_device_2")
                        pc = np.loadtxt(outs["positions"], delimiter=",", skiprows=1, ndmin=2)[:, 3:5]
                        pd = np.loadtxt(os.path.join(card, "positions.csv"), delimiter=",", skiprows=1, ndmin=2)[:, 3:5]
                        mc = tiff.read_stack(outs["mosaic"])
                        md = tiff.read_stack(os.path.join(card, "mosaic.tif"))
                        rel = float(np.abs(md - mc).max() / np.abs(mc).mean())
                        print(f"geometry (w) {grid} card vs cpu backend: positions {np.abs(pd - pc).max():.6f} px, "
                              f"mosaic {rel:.3e} of its mean")
                        if np.abs(pd - pc).max() > GEOM_CARD_CPU_PX or rel > GEOM_ILLUM_RTOL:
                            raise AssertionError(f"(w) {grid}: the card and cpu backends disagree")
        for grid in ("4x4", "3x3"):
            d, cp = walls[(grid, "device", 2)], walls[(grid, "cpu", 2)]
            print(f"geometry (w) {grid} backend device {d[0]:.4f} s (job total_s {d[1]}), cpu {cp[0]:.4f} s "
                  f"({cp[1]}); first runs device {walls[(grid, 'device', 1)][0]:.4f} s, cpu "
                  f"{walls[(grid, 'cpu', 1)][0]:.4f} s; cpu/device {cp[0] / d[0]:.3f} on {smi_line}")
        ldir = os.path.join(tmp, "lapse")
        os.makedirs(ldir)
        for k in range(r * c):
            tiff.write_stack(os.path.join(ldir, f"pos_{k:02d}.tif"), np.stack([tiles[k], tiles[k] * 0.9]))
        out_l, m_l, _ = serve("w_timelapse", "stitch_mosaic", dict(params, timelapse=True), [ldir])
        lapse = tiff.read_stack(out_l["mosaic"])
        if lapse.shape[0] != 2 or not np.isfinite(lapse).all():
            raise AssertionError(f"(w) timelapse mosaic {lapse.shape}")
        print(f"geometry (w) timelapse: 2 timepoints of {lapse.shape[1:]}, {m_l['timepoints_per_sec']} "
              f"timepoints/s")
        del tiles, lapse

        # (x) correct_illumination: 64 frames of 1024x1024, vignette, bleach 0.03
        big = bandlimited_scene((h + GEOM_FRAMES, w + GEOM_FRAMES), rng, amp=1500.0, offset=6000.0)
        ill = np.stack([
            big[k : k + h, k : k + w] * vig * np.exp(-0.03 * k) for k in range(GEOM_FRAMES)
        ]).round().astype(np.uint16)
        ill_path = write("illum.tif", ill)
        for mode in ("exp", "ratio"):
            out_x, m_x, _ = serve(f"x_{mode}", "correct_illumination", {"bleach": mode}, [ill_path])
            out_xc, _, _ = serve(f"x_{mode}_cpu", "correct_illumination", {"bleach": mode}, [ill_path], dev="cpu")
            a = tiff.read_stack(out_x["corrected"])
            b = tiff.read_stack(out_xc["corrected"])
            rel = float(np.abs(a - b).max() / np.abs(b).max())
            same_gains = open(out_x["gains"]).read() == open(out_xc["gains"]).read()
            stream_fps = GEOM_FRAMES / (m_x["total_s"] - m_x["estimate_s"])
            print(f"geometry (x) {mode}: card vs CPU port max rel {rel:.3e} (bit-equal {a.tobytes() == b.tobytes()}, "
                  f"gains.csv equal {same_gains}), {m_x['frames_per_sec']} frames/s ({stream_fps:.3f} frames/s "
                  f"after the host estimate's {m_x['estimate_s']} s), bleach_rate_c0 "
                  f"{m_x['bleach_rate_c0']} on {smi_line}")
            if rel > GEOM_ILLUM_RTOL or not same_gains:
                raise AssertionError(f"(x) {mode}: card and CPU disagree ({rel})")

        # the meters, card against the port on the CPU
        for name, px_keys, tol in (
            ("register_fidelity", ("trajectory_rmse_px", "max_err_px"), GEOM_CARD_CPU_PX),
            ("mosaic_fidelity", ("position_rmse_px", "max_err_px", "seam_rms_residual_px"), GEOM_CARD_CPU_PX),
            ("illum_fidelity", ("bleach_rate_err", "drift_ratio", "shading_rmse", "rel_err_p99"), GEOM_ILLUM_METER),
        ):
            card = getattr(fidelity, name)(device="cuda")
            cpu = getattr(fidelity, name)(device="cpu")
            print(f"geometry meter {name}: card {json.dumps(card)} cpu {json.dumps(cpu)} on {smi_line}")
            for k in px_keys:
                if abs(card[k] - cpu[k]) > tol:
                    raise AssertionError(f"{name}.{k}: card {card[k]} vs CPU {cpu[k]}")
            if name == "mosaic_fidelity" and not (
                card["position_rmse_px"] < MOSAIC_POSITION_BAR and card["seam_rms_residual_px"] < MOSAIC_POSITION_BAR
                and card["photometric_residual_frac"] < MOSAIC_PHOTOMETRIC_BAR
            ):
                raise AssertionError(f"mosaic_fidelity misses the JAX tests' bars: {card}")
    return counts


OPTICS_FRAME = (512, 512)  # bench.py::bench_emitters / bench_astig
OPTICS_FRAMES = 256  # (y)
OPTICS_EMITTERS = 120  # bench_emitters' and bench_emitters3d's 120 a frame / volume
OPTICS_VOLUME = (16, 512, 512)  # (z): bench_emitters3d
OPTICS_VOLUMES = 4
OPTICS_ASTIG_FRAMES = 64  # (aa): 80 emitters a frame, bench_astig's
OPTICS_DECON_FRAME = (1024, 1024)  # (bb): the serving phases' frame
OPTICS_DECON_FRAMES = 64
OPTICS_DECON_VOLUME = VOLUME  # (bb) dims 3: the 3D serving shape
OPTICS_SEED = 444_100
OPTICS_CARD_CPU_PX = 1e-4  # positions and widths, card against the port on the CPU (raw fits)
OPTICS_CSV_UNIT = 1e-4  # emitters.csv's %.4f: a raw gap of 1e-6 can move the last digit
OPTICS_Z_FRAC = 1e-3  # astigmatic z, card against CPU, as a share of the calibrated range
OPTICS_CALIB_RTOL = 1e-5  # calibration coefficients, card against CPU
OPTICS_RL_REL = 5e-6  # deconvolved frames and volumes, card against CPU, relative to the largest value (H100: 2.1e-6 frame, 2.7e-6 volume)
OPTICS_SEG3D = (65, 512, 512)  # seg_fidelity's reference side: 17,039,360 voxels > 2^24


def _emitters_csv(np, path):
    """emitters.csv -> (header, rows array)."""
    with open(path) as f:
        lines = f.read().strip().split("\n")
    ncol = lines[0].count(",") + 1
    return lines[0], np.asarray([[float(v) for v in r.split(",")] for r in lines[1:]]).reshape(-1, ncol)


def _same_rows(np, what, card, cpu, z_col=None, z_tol=None):
    """Card rows against CPU rows: the same count, frames and order; values
    within the raw bar plus one CSV unit (z, where given, at its own bar).
    Returns the largest gap of the position columns."""
    if card.shape != cpu.shape or not np.array_equal(card[:, 0], cpu[:, 0]):
        raise AssertionError(f"{what}: card rows {card.shape} and CPU rows {cpu.shape} differ in count or frames")
    gap = np.abs(card - cpu)
    cols = [c for c in range(1, card.shape[1]) if c != z_col]
    amp_tol = 1e-5 * np.abs(cpu) + OPTICS_CARD_CPU_PX + OPTICS_CSV_UNIT
    if (gap[:, cols] > amp_tol[:, cols]).any():
        raise AssertionError(f"{what}: card and CPU rows differ by up to {gap[:, cols].max()}")
    if z_col is not None and gap[:, z_col].max() > z_tol:
        raise AssertionError(f"{what}: z differs by {gap[:, z_col].max()} > {z_tol}")
    return float(gap[:, 1:].max())


def optics_phase(torch, hist, conv, smi_line):
    """localize_emitters (2D, dims 3, astigmatic after calibrate_astigmatism)
    and deconvolve (2D, dims 3, a volume timelapse) through ImageServer on
    the card, held to the port on the CPU and to the emitter meters' bars;
    the exact normalize's repair (a slice past 2^24 values, lo/hi card
    against CPU, seg_fidelity's reference side past 2^24 voxels); where a
    localized and a deconvolved frame's time goes. Returns {job:
    (histogram_2d launches, quantile passes)}: 0 for every job (no kernel
    of the four lies on these paths)."""
    import numpy as np

    from sequitr_tpu_torch import fidelity, psf
    from sequitr_tpu_torch.config import ServerConfiguration
    from sequitr_tpu_torch.data import synthetic, tiff
    from sequitr_tpu_torch.ops import normalize as norm_ops
    from sequitr_tpu_torch.pipeline import infer
    from sequitr_tpu_torch.server import ImageServer, submit_job

    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        servers = {
            dev: ImageServer(ServerConfiguration(
                jobs_dir=os.path.join(tmp, f"jobs_{dev}"), models_dir=os.path.join(tmp, "models"), device=dev,
            ))
            for dev in ("cuda", "cpu")
        }

        def write(name, arr):
            path = os.path.join(tmp, name)
            tiff.write_stack(path, arr)
            return path

        def serve(name, module, params, inputs, dev="cuda", depends_on=None):
            """One job (``depends_on``: the output directory of a job served
            before, which it names as its dependency); returns (outputs,
            metrics, wall s). Card jobs run with every kernel's launch
            count reset just before and read just after."""
            out = os.path.join(tmp, f"out_{dev}_{name}")
            spec = {"module": module, "params": params, "input": inputs, "output": out}
            if depends_on:
                spec["depends_on"] = [depends_on]
            submit_job(servers[dev].config.jobs_dir, spec)
            torch.cuda.synchronize()
            hist.histogram_2d.launches = 0
            hist.quantile_pass.launches = 0
            conv.conv3x3_nhwc.launches = 0
            conv.conv3x3_flat_chw.launches = 0
            _euler().launches = 0
            t0 = time.perf_counter()
            if not servers[dev].poll_once():
                raise AssertionError(f"optics job {name}: no job to run")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = (hist.histogram_2d.launches, hist.quantile_pass.launches,
                        conv.conv3x3_nhwc.launches + conv.conv3x3_flat_chw.launches)
            with open(os.path.join(out, "status.json")) as f:
                status = json.load(f)
            if status["state"] != "complete":
                raise AssertionError(f"optics job {name}: {status.get('error')}")
            if dev == "cuda":
                if any(launched):
                    raise AssertionError(f"optics job {name} launched a kernel of the four: {launched}")
                _euler_read(f"optics_{name}", 0)
                counts[f"optics_{name}"] = launched[:2]
            metrics = json.loads(status["outputs"].get("metrics", "{}"))
            shown = {k: v for k, v in status["outputs"].items() if k.startswith("n_")}
            print(f"optics job {name} ({dev}) {module} {json.dumps(params)[:160]}: wall {wall:.4f} s, "
                  f"{json.dumps(shown)} metrics {json.dumps(metrics)} on {smi_line}")
            return status["outputs"], metrics, wall

        def as_u16(a):
            return np.clip(np.round(a), 0, 65535).astype(np.uint16)

        # (y) localize_emitters 2D: 256 uint16 frames of 512x512, 120
        # emitters a frame, max_peaks 256, threshold_sigmas 5 (the default)
        frames = np.stack([
            as_u16(synthetic.emitter_frame(OPTICS_SEED + t, OPTICS_FRAME, n=OPTICS_EMITTERS)[0])
            for t in range(OPTICS_FRAMES)
        ])
        em_path = write("emitters.tif", frames)
        loc_params = {"max_peaks": 256}
        # warm-up: the first use of each op on the card would land in (y)'s frames/s
        serve("y_warmup", "localize_emitters", dict(loc_params, frame_range=[0, 8]), [em_path])
        out_y, _, wall_y = serve("y_2d", "localize_emitters", loc_params, [em_path])
        out_yc, _, _ = serve("y_2d_cpu", "localize_emitters", dict(loc_params, frame_range=[0, 8]), [em_path], "cpu")
        hdr, rows_y = _emitters_csv(np, out_y["emitters"])
        _, rows_yc = _emitters_csv(np, out_yc["emitters"])
        gap = _same_rows(np, "(y)", rows_y[rows_y[:, 0] < 8], rows_yc)
        thr0 = float(np.median(frames[0].astype(np.float32)))
        got = psf.localize_emitters(torch.from_numpy(frames[0]).cuda(), 120.0)
        want = psf.localize_emitters(frames[0], 120.0, device="cpu")
        raw = max(float(np.abs(got[k] - want[k]).max()) for k in ("y", "x"))
        if raw > OPTICS_CARD_CPU_PX or len(got["y"]) != len(want["y"]):
            raise AssertionError(f"(y) raw fits: card and CPU positions differ by {raw} px")
        fps_y = OPTICS_FRAMES / wall_y
        print(f"optics (y) {hdr}: {len(rows_y)} rows over {OPTICS_FRAMES} frames of {OPTICS_FRAME} "
              f"({len(rows_y) / OPTICS_FRAMES:.2f} a frame, frame 0 median {thr0}); card vs CPU port on the first "
              f"8 frames: rows equal in count and order, largest CSV gap {gap:.6f}, raw positions {raw:.3e} px; "
              f"{fps_y:.3f} frames/s (job wall) on {smi_line}")
        em = fidelity.emitter_fidelity(device="cuda")
        print(f"optics meter emitter_fidelity (card): {json.dumps(em)} on {smi_line}")
        if not (em["rmse_px"] < 0.05 and em["recall"] > 0.9 and em["precision"] > 0.9):
            raise AssertionError(f"emitter_fidelity misses the JAX tests' bars: {em}")

        # where a localized frame's time goes: detect + fit + the one fetch,
        # and the host threshold the job takes a frame
        dev_frames = [torch.from_numpy(f).cuda() for f in frames[:16]]

        def localize_stream():
            for f in dev_frames:
                _, valid, fits = psf._detect_and_fit(f, 40.0, max_peaks=256, min_distance=2, window=7, sigma=1.5)
                psf.fetch_valid(valid, fits)

        wall, busy, ops, by_name = _profile_stream(torch, "localize 512x512", localize_stream, 16, "frame")
        t0 = time.perf_counter()
        for f in frames[:16]:
            infer_thr = float(np.median(f.astype(np.float32)))
            np.median(np.abs(f.astype(np.float32) - infer_thr))
        host_thr_ms = (time.perf_counter() - t0) / 16 * 1e3
        torch.cuda.set_sync_debug_mode("error")
        try:  # no hidden sync before the one fetch
            _, valid, fits = psf._detect_and_fit(dev_frames[0], 40.0, max_peaks=256, min_distance=2, window=7, sigma=1.5)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        psf.fetch_valid(valid, fits)
        print(f"optics (y) a frame: {wall / 16 * 1e3:.4f} ms wall with its fetch, busy {busy / (wall * 1e6):.3f}, "
              f"{ops:.1f} device ops, device {sum(by_name.values()) / 1e3 / 16:.4f} ms; the host threshold (two "
              f"np.median) {host_thr_ms:.4f} ms a frame; no sync before the fetch on {smi_line}")
        del dev_frames, frames

        # (z) dims 3: 4 volumes of 16x512x512, 120 emitters each
        vdir = os.path.join(tmp, "em_volumes")
        os.makedirs(vdir)
        for t in range(OPTICS_VOLUMES):
            vol, _ = synthetic.emitter_volume(OPTICS_SEED + 100 + t, OPTICS_VOLUME, n=OPTICS_EMITTERS)
            tiff.write_stack(os.path.join(vdir, f"vol_t{t:04d}.tif"), as_u16(vol))
        p3 = {"dims": 3, "max_peaks": 256, "sigma": 1.4, "sigma_z": 1.6}
        serve("z_warmup", "localize_emitters", dict(p3, frame_range=[0, 1]), [vdir])
        out_z, _, wall_z = serve("z_dims3", "localize_emitters", p3, [vdir])
        out_zc, _, _ = serve("z_dims3_cpu", "localize_emitters", dict(p3, frame_range=[0, 1]), [vdir], "cpu")
        _, rows_z = _emitters_csv(np, out_z["emitters"])
        _, rows_zc = _emitters_csv(np, out_zc["emitters"])
        gap = _same_rows(np, "(z)", rows_z[rows_z[:, 0] < 1], rows_zc)
        print(f"optics (z) dims 3: {len(rows_z)} rows over {OPTICS_VOLUMES} volumes of {OPTICS_VOLUME}; card vs CPU "
              f"port on volume 0: rows equal, largest CSV gap {gap:.6f}; {OPTICS_VOLUMES / wall_z:.3f} volumes/s "
              f"(job wall) on {smi_line}")
        em3 = fidelity.emitter3d_fidelity(device="cuda")
        print(f"optics meter emitter3d_fidelity (card): {json.dumps(em3)} on {smi_line}")
        if not (em3["lateral_rmse_px"] < 0.05 and em3["axial_rmse_px"] < 0.15
                and em3["recall"] > 0.9 and em3["precision"] > 0.9):
            raise AssertionError(f"emitter3d_fidelity misses the JAX tests' bars: {em3}")

        # (aa) calibrate_astigmatism (17-plane bead scan) -> localize_emitters
        # with astigmatism (64 frames of 512x512, 80 emitters a frame)
        zs = np.linspace(*synthetic.ASTIG_Z_RANGE, 17)
        gy, gx = np.mgrid[:32, :32].astype(np.float64)
        rng = np.random.default_rng(OPTICS_SEED + 200)
        scan = []
        for z in zs:
            sy, sx = synthetic.astig_widths(z)
            scan.append(20.0 + 2000.0 / (2 * np.pi * sx * sy)
                        * np.exp(-((gy - 15.7) ** 2) / (2 * sy**2) - ((gx - 16.2) ** 2) / (2 * sx**2))
                        + rng.normal(0, 0.3, (32, 32)))
        beads = write("beads.tif", np.asarray(scan, np.float32))
        astig = np.stack([
            synthetic.astig_emitter_frame(OPTICS_SEED + 300 + t, OPTICS_FRAME, n=80)[0]
            for t in range(OPTICS_ASTIG_FRAMES)
        ]).astype(np.float32)
        astig_path = write("astig.tif", astig)
        cal_params = {"z_start": float(zs[0]), "z_step": float(zs[1] - zs[0])}
        calibs = {}
        for dev in ("cuda", "cpu"):
            sfx = "_cpu" if dev == "cpu" else ""
            out_cal, met, _ = serve(f"aa_calibrate{sfx}", "calibrate_astigmatism", cal_params, [beads], dev)
            lp = {"astigmatism": os.path.dirname(out_cal["calibration"]), "threshold": 25.0, "max_peaks": 256}
            if dev == "cpu":
                lp["frame_range"] = [0, 4]
            # chained as a workflow chains them: the calibration job's
            # output directory, named in depends_on and in astigmatism
            out_a, _, wall_a = serve(f"aa_localize{sfx}", "localize_emitters", lp, [astig_path], dev,
                                     depends_on=lp["astigmatism"])
            with open(out_cal["calibration"]) as f:
                calibs[dev] = (json.load(f), met, out_a, wall_a)
        (cal_d, met_d, out_a, wall_a), (cal_c, met_c, out_ac, _) = calibs["cuda"], calibs["cpu"]
        coef_gap = max(
            abs(a - b) / max(abs(b), 1e-30) for k in ("qx", "qy") for a, b in zip(cal_d[k], cal_c[k])
        )
        span = synthetic.ASTIG_Z_RANGE[1] - synthetic.ASTIG_Z_RANGE[0]
        _, rows_a = _emitters_csv(np, out_a["emitters"])
        _, rows_ac = _emitters_csv(np, out_ac["emitters"])
        gap = _same_rows(np, "(aa)", rows_a[rows_a[:, 0] < 4], rows_ac, z_col=1, z_tol=OPTICS_Z_FRAC * span)
        z_gap = float(np.abs(rows_a[rows_a[:, 0] < 4][:, 1] - rows_ac[:, 1]).max())
        print(f"optics (aa) calibration card {json.dumps(cal_d)} metrics {json.dumps(met_d)}; CPU metrics "
              f"{json.dumps(met_c)}; coefficients card vs CPU {coef_gap:.3e} relative; localize: {len(rows_a)} rows "
              f"over {OPTICS_ASTIG_FRAMES} frames, card vs CPU on 4 frames: z {z_gap:.6f} "
              f"({z_gap / span:.3e} of the range), other columns {gap:.6f}; "
              f"{OPTICS_ASTIG_FRAMES / wall_a:.3f} frames/s (job wall, after its calibration job) on {smi_line}")
        if coef_gap > OPTICS_CALIB_RTOL:
            raise AssertionError(f"(aa) calibration coefficients differ by {coef_gap} relative")
        ast = fidelity.astig_fidelity(device="cuda")
        print(f"optics meter astig_fidelity (card): {json.dumps(ast)} on {smi_line}")
        if not (ast["lateral_rmse_px"] < 0.05 and ast["axial_rmse_frac"] < 0.015
                and ast["recall"] > 0.9 and ast["precision"] > 0.9):
            raise AssertionError(f"astig_fidelity misses the JAX tests' bars: {ast}")
        del astig

        # (bb) deconvolve: 64 frames of 1024x1024 at 20 iterations; dims 3
        # on one 32x512x512 volume; a 2-timepoint volume timelapse (z: 32)
        h, w = OPTICS_DECON_FRAME
        big = synthetic.bandlimited_scene((h + OPTICS_DECON_FRAMES, w + OPTICS_DECON_FRAMES), rng,
                                          amp=1500.0, offset=6000.0)
        dframes = np.stack([as_u16(big[k:k + h, k:k + w]) for k in range(OPTICS_DECON_FRAMES)])
        dc_path = write("decon.tif", dframes)
        serve("bb_warmup", "deconvolve", {"frame_range": [0, 4]}, [dc_path])
        out_b, m_b, wall_b = serve("bb_2d", "deconvolve", {}, [dc_path])
        out_bc, _, _ = serve("bb_2d_cpu", "deconvolve", {"frame_range": [0, 1]}, [dc_path], "cpu")
        a = tiff.read_stack(out_b["deconvolved"]).reshape((-1,) + OPTICS_DECON_FRAME)[0]
        b = tiff.read_stack(out_bc["deconvolved"]).reshape((-1,) + OPTICS_DECON_FRAME)[0]  # one page: (H, W)
        rel_b = float(np.abs(a - b).max() / np.abs(b).max())
        print(f"optics (bb) deconvolve 2D: {OPTICS_DECON_FRAMES} frames of {OPTICS_DECON_FRAME}, 20 iterations: "
              f"{m_b['frames_per_sec']} frames/s (job), {OPTICS_DECON_FRAMES / wall_b:.3f} frames/s (wall); frame 0 "
              f"card vs CPU port {rel_b:.3e} of its largest value on {smi_line}")
        if rel_b > OPTICS_RL_REL:
            raise AssertionError(f"(bb) 2D: card and CPU differ by {rel_b} relative")
        vol = as_u16(synthetic.bandlimited_scene(OPTICS_DECON_VOLUME, rng, sigma=0.12, amp=1500.0, offset=6000.0))
        vol_path = write("decon_volume.tif", vol)
        out_v, m_v, wall_v = serve("bb_dims3", "deconvolve", {"dims": 3}, [vol_path])
        got_v = tiff.read_stack(out_v["deconvolved"])
        t0 = time.perf_counter()
        want_v = psf.richardson_lucy(
            torch.from_numpy(vol), psf.gaussian_psf_3d(9, 5, 1.5, 3.0, device="cpu"), 20
        ).numpy()
        cpu_s = time.perf_counter() - t0
        rel_v = float(np.abs(got_v - want_v).max() / np.abs(want_v).max())
        lapse_path = write("decon_lapse.tif", np.concatenate([vol, vol[::-1]]))
        out_l, m_l, _ = serve("bb_timelapse", "deconvolve", {"dims": 3, "z": OPTICS_DECON_VOLUME[0]}, [lapse_path])
        lapse0 = tiff.read_stack(os.path.join(out_l["deconvolved"], "deconvolved_t0000.tif"))
        same = bool(np.array_equal(lapse0, got_v))
        print(f"optics (bb) dims 3 on {OPTICS_DECON_VOLUME}: job wall {wall_v:.4f} s (metrics {json.dumps(m_v)}), "
              f"card vs CPU port {rel_v:.3e} of its largest value (the CPU's Richardson-Lucy {cpu_s:.2f} s); "
              f"timelapse (z: {OPTICS_DECON_VOLUME[0]}) {m_l['volumes_per_sec']} volumes/s, timepoint 0 equal to "
              f"the volume job {same} on {smi_line}")
        if rel_v > OPTICS_RL_REL or not same:
            raise AssertionError(f"(bb) dims 3: card vs CPU {rel_v}, timelapse equal {same}")
        del want_v, got_v, lapse0

        # where a Richardson-Lucy frame's time goes (20 iterations, fetched)
        kernel = psf.gaussian_psf_2d(9, 1.5, device="cuda")
        dev_frames = [torch.from_numpy(f).cuda() for f in dframes[:8]]

        def rl_stream():
            for f in dev_frames:
                infer._copy_to_host_async(psf.richardson_lucy_frame(f, kernel, 20))
            torch.cuda.synchronize()

        wall, busy, ops, by_name = _profile_stream(torch, "Richardson-Lucy 1024x1024 x20", rl_stream, 8, "frame")
        fft_ms, copy_ms, other_ms = _fft_split(by_name, 8)
        dev_ms = fft_ms + copy_ms + other_ms
        print(f"optics (bb) an RL frame: {wall / 8 * 1e3:.4f} ms wall, device {dev_ms:.4f} ms (cuFFT {fft_ms:.4f}, "
              f"{fft_ms / dev_ms:.3f} of it; copies {copy_ms:.4f}; elementwise {other_ms:.4f}), busy "
              f"{busy / (wall * 1e6):.3f}, {ops:.1f} device ops on {smi_line}")
        del dev_frames, dframes

        # the repair: the exact normalize past 2^24 values, and card = CPU
        n = 64 * 512 * 512 + 1
        gen = torch.Generator().manual_seed(OPTICS_SEED)
        x = (torch.empty(n, 2).exponential_(generator=gen).sum(-1) * 60.0).to(torch.float32)
        lohi_c = norm_ops.percentile_linear(x.reshape(-1, 1), (5.0, 99.5))
        xd = x.cuda()
        lohi_d = norm_ops.percentile_linear(xd.reshape(-1, 1), (5.0, 99.5))
        out_d = norm_ops.percentile_normalize(xd)
        ms = _median_ms(lambda: norm_ops.percentile_normalize(xd), 10)
        equal_big = torch.equal(lohi_d.cpu(), lohi_c)
        equal_out = torch.equal(out_d.cpu(), norm_ops.percentile_normalize(x))
        img, _ = synthetic.cells_frame(424_000, (1024, 1024))
        fr = torch.from_numpy(as_u16(img)).float().reshape(-1, 1)
        equal_frame = torch.equal(norm_ops.percentile_linear(fr.cuda(), (5.0, 99.5)).cpu(),
                                  norm_ops.percentile_linear(fr, (5.0, 99.5)))
        print(f"optics repair: exact normalize of {n} values (2^24 + ...) on the card: lo/hi {lohi_d.flatten().tolist()} "
              f"equal to the CPU's {equal_big}, normalized equal {equal_out}, {ms:.4f} ms; serve frame lo/hi card = "
              f"CPU {equal_frame} on {smi_line}")
        if not (equal_big and equal_out and equal_frame):
            raise AssertionError("the exact normalize differs between the card and the CPU")
        del x, xd, out_d
        tc3 = infer.TileConfig(patch=(32, 256, 256), overlap=(8, 32, 32))
        seg = fidelity.seg_fidelity("unet3d_cells", OPTICS_SEG3D, tc=tc3, n=1, device="cuda")
        print(f"optics repair: seg_fidelity unet3d_cells on {OPTICS_SEG3D} ({int(np.prod(OPTICS_SEG3D))} voxels, "
              f"the reference side's exact normalize past 2^24): {json.dumps(seg)} on {smi_line}")
        if not seg["miou_vs_ref"] >= 0.99:
            raise AssertionError(f"seg_fidelity past 2^24 voxels: {seg}")
    return counts


QUANT_FRAME = (1024, 1024)  # (cc): the served frame shape
QUANT_FRAMES = 64
QUANT_BLURRED = (5, 17, 33, 49)  # (cc)'s injected faults, by frame index
QUANT_DARK = (9, 26, 58)
QUANT_SATURATED = (12, 40)
QUANT_VOLUME = VOLUME  # (cc) dims 3 and (dd): the 3D serving shape
QUANT_VOLUMES = 8  # (dd); (cc) dims 3 takes the first 4
QUANT_BEST_Z = 12  # volume t is sharpest at plane 12 + t
QUANT_CHAIN_VOLUME = (16, 1024, 1024)  # (ee)
QUANT_CHAIN_VOLUMES = 4
QUANT_SEED = 464_100
QUANT_QC_RTOL = 2e-6  # focus_vol, tenengrad, mean, std (std against the frame's mean), card vs CPU port (H100: 2.6e-7)
QUANT_PROJ_RTOL = 1e-6  # project_stack's float methods card vs CPU port, of the volume's largest value
TRACK_SCENE = dict(n_objects=120, n_frames=60, field=(384, 384), n_divisions=12, seed=575_001)  # bench.py:674-700


def _focus_stacks(np, ndimage, base, n_planes, best_of, n_vols, shape, seed):
    """``n_vols`` uint16 z-stacks cropped from ``base`` at a 2 px drift a
    volume: plane z of volume t is the crop blurred by a Gaussian of sigma
    0.8 |z - best_of(t)|, plus camera noise (sigma 2)."""
    rng = np.random.default_rng(seed)
    h, w = shape
    blurred = {}
    vols = np.empty((n_vols, n_planes, h, w), np.uint16)
    for t in range(n_vols):
        for z in range(n_planes):
            d = abs(z - best_of(t))
            if d not in blurred:
                blurred[d] = ndimage.gaussian_filter(base, 0.8 * d) if d else base
            plane = blurred[d][2 * t:2 * t + h, 2 * t:2 * t + w] + rng.normal(0.0, 2.0, (h, w))
            vols[t, z] = np.clip(np.round(plane), 0, 65535)
    return vols


def quantify_phase(torch, hist, conv, smi_line):
    """qc_stack (2D, 2 channels, dims 3), project_stack (every method),
    the workflow chain project_stack -> segmentation_unet2d ->
    measure_objects -> export_ctc, and the host jobs (count_spots,
    measure_tracks) through ImageServer on the card, held to the injected
    truth and to the port on the CPU; the copied tracker's rate and the
    tracking meter on the host. Returns {job: (histogram_2d launches,
    quantile passes)}: 0 for every job but the chain's segmentation."""
    import numpy as np
    from scipy import ndimage

    from sequitr_tpu_torch import __main__ as cli
    from sequitr_tpu_torch import fidelity, localize, tracking
    from sequitr_tpu_torch.config import ServerConfiguration
    from sequitr_tpu_torch.data import synthetic, tiff
    from sequitr_tpu_torch.models import fixtures
    from sequitr_tpu_torch.ops import projection, qc
    from sequitr_tpu_torch.pipeline import infer
    from sequitr_tpu_torch.server import ImageServer, submit_job

    # uint16 on the card: the casts the paths take, and the reductions they avoid
    u16 = torch.tensor([[0, 65535], [7, 3]], dtype=torch.int32).to(torch.uint16).cuda()
    widened = u16.to(torch.int32).amax(0).to(torch.uint16).cpu().numpy().tolist()
    picked = torch.index_select(u16.view(torch.int16), 0, torch.tensor([1], device="cuda")).view(torch.uint16)
    if widened != [7, 65535] or picked.cpu().numpy().tolist() != [[7, 3]] \
            or u16.to(torch.float32).cpu().tolist() != [[0.0, 65535.0], [7.0, 3.0]]:
        raise AssertionError("uint16 casts, widened max or same-bits gather on the card")
    try:
        native = u16.amax(0).cpu().numpy().tolist() == [7, 65535]
    except RuntimeError as e:
        native = f"refused ({str(e).splitlines()[0][:80]})"
    print(f"quantify uint16 on the card: int32-widened max, int16-view gather, float cast right; "
          f"torch.amax on uint16 itself: {native}")

    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        models = os.path.join(tmp, "models")
        meta = fixtures.manifest()["unet2d_cells"]
        arch = os.path.join(tmp, "unet2d_cells.json")
        with open(arch, "w") as f:
            json.dump(dict(meta["config"], __kind__=meta["kind"]), f)
        npz = os.path.join(fixtures.fixture_dir(), "unet2d_cells.npz")
        if cli.main(["import-model", "--models-dir", models, "--npz", npz, "--arch", arch, "unet2d_cells"]):
            raise AssertionError("import-model unet2d_cells failed")
        servers = {
            dev: ImageServer(ServerConfiguration(
                jobs_dir=os.path.join(tmp, f"jobs_{dev}"), models_dir=models, device=dev,
            ))
            for dev in ("cuda", "cpu")
        }

        def write(name, arr):
            path = os.path.join(tmp, name)
            tiff.write_stack(path, arr)
            return path

        def serve(name, module, params, inputs, dev="cuda", depends_on=None):
            """One job, launch counts reset just before and read just after
            on the card; returns (outputs, metrics, wall s, output dir)."""
            out = os.path.join(tmp, f"out_{dev}_{name}")
            spec = {"module": module, "params": params, "input": inputs, "output": out}
            if depends_on:
                spec["depends_on"] = [depends_on]
            submit_job(servers[dev].config.jobs_dir, spec)
            torch.cuda.synchronize()
            hist.histogram_2d.launches = 0
            hist.quantile_pass.launches = 0
            conv.conv3x3_nhwc.launches = 0
            conv.conv3x3_flat_chw.launches = 0
            _euler().launches = 0
            t0 = time.perf_counter()
            if not servers[dev].poll_once():
                raise AssertionError(f"quantify job {name}: no job to run")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launched = (hist.histogram_2d.launches, hist.quantile_pass.launches,
                        conv.conv3x3_nhwc.launches + conv.conv3x3_flat_chw.launches)
            with open(os.path.join(out, "status.json")) as f:
                status = json.load(f)
            if status["state"] != "complete":
                raise AssertionError(f"quantify job {name}: {status.get('error')}")
            if dev == "cuda":
                counts[f"quant_{name}"] = launched[:2]
                if module != "segmentation_unet2d" and any(launched):
                    raise AssertionError(f"quantify job {name} launched a kernel of the four: {launched}")
                _euler_read(f"quant_{name}", 0)
            metrics = json.loads(status["outputs"].get("metrics", "{}"))
            print(f"quantify job {name} ({dev}) {module} {json.dumps(params)[:120]}: wall {wall:.4f} s, "
                  f"metrics {json.dumps(metrics)[:400]} on {smi_line}")
            return status["outputs"], metrics, wall, out

        def same_files(what, out_a, out_b, names):
            for n in names:
                with open(os.path.join(out_a, n), "rb") as fa, open(os.path.join(out_b, n), "rb") as fb:
                    if fa.read() != fb.read():
                        raise AssertionError(f"{what}: {n} differs between the card and the CPU port")

        def qc_gap(got, want):
            """Largest relative gap of the whole-frame sums (std against the
            frame's mean); p01/p99/sat_frac must be equal."""
            if not np.array_equal(got[..., 4:], want[..., 4:]):
                raise AssertionError("qc: p01/p99/sat_frac differ between the card and the CPU port")
            scale = np.abs(want[..., :4]).astype(np.float64)
            scale[..., 3] = np.maximum(scale[..., 3], np.abs(want[..., 2]))
            return float((np.abs(got[..., :4].astype(np.float64) - want[..., :4]) / np.maximum(scale, 1e-30)).max())

        def qc_flags(path):
            with open(path) as f:
                rows = [r.split(",") for r in f.read().strip().split("\n")[1:]]
            return [(int(r[0]), int(r[1]), r[-1]) for r in rows]

        # (cc) qc_stack: 64 uint16 frames of 1024x1024 (crops of one cells
        # scene drifting 1 px a frame) with faults injected by index
        big, _ = synthetic.cells_frame(QUANT_SEED, (QUANT_FRAME[0] + QUANT_FRAMES, QUANT_FRAME[1] + QUANT_FRAMES))
        h, w = QUANT_FRAME
        frames = np.stack([big[t:t + h, t:t + w] for t in range(QUANT_FRAMES)])
        for t in QUANT_BLURRED:
            frames[t] = ndimage.gaussian_filter(frames[t], 3.0)
        for t in QUANT_DARK:
            frames[t] *= 0.3
        frames = np.clip(np.round(frames), 0, 65535).astype(np.uint16)
        for t in QUANT_SATURATED:
            frames[t, :32] = 65535  # 3.1% of the pixels
        qc_path = write("qc.tif", frames)
        serve("cc_warmup", "qc_stack", {"frame_range": [0, 4]}, [qc_path])
        out_cc, m_cc, wall_cc, dir_cc = serve("cc_qc", "qc_stack", {}, [qc_path])
        flags = qc_flags(out_cc["qc"])
        flagged = {t for t, _, fl in flags if fl}
        injected = set(QUANT_BLURRED) | set(QUANT_DARK) | set(QUANT_SATURATED)
        by_t = {t: fl for t, _, fl in flags}
        if flagged != injected or not all("focus" in by_t[t] for t in QUANT_BLURRED) \
                or not all("dark" in by_t[t] for t in QUANT_DARK) \
                or not all("saturated" in by_t[t] for t in QUANT_SATURATED):
            raise AssertionError(f"(cc) flags {sorted((t, by_t[t]) for t in flagged)}, injected {sorted(injected)}")
        # the metrics: the card's frame_qc against the port's on the CPU, all 64 frames
        dev_rows = np.stack([qc.frame_qc(torch.from_numpy(f).cuda(), 65535.0).cpu().numpy() for f in frames])
        t0 = time.perf_counter()
        cpu_rows = np.stack([qc.frame_qc(torch.from_numpy(f), 65535.0).numpy() for f in frames])
        cpu_s = time.perf_counter() - t0
        gap_cc = qc_gap(dev_rows, cpu_rows)
        cpu_flags = qc.flag_frames(cpu_rows)
        if ["+".join(fl) for fl in cpu_flags] != [fl for _, _, fl in flags]:
            raise AssertionError("(cc) the CPU port's flags differ from the card's")
        out_c2, m_c2, _, _ = serve("cc_two_channels", "qc_stack", {}, [qc_path, write("qc_flipped.tif", frames[::-1])])
        flags2 = qc_flags(out_c2["qc"])
        with open(out_cc["qc"]) as f1, open(out_c2["qc"]) as f2:
            one = f1.read().strip().split("\n")[1:]
            two = f2.read().strip().split("\n")[1:]
        mirrored = {QUANT_FRAMES - 1 - t for t in injected}
        if one != two[0::2] or {t for t, ch, fl in flags2 if ch == 1 and fl} != mirrored:
            raise AssertionError("(cc) 2 channels: channel 0 differs from the 1-channel run or channel 1's flags")
        print(f"quantify (cc) qc_stack: {QUANT_FRAMES} frames of {QUANT_FRAME}: flagged {sorted(flagged)} = injected "
              f"(blurred {list(QUANT_BLURRED)}, dark {list(QUANT_DARK)}, saturated {list(QUANT_SATURATED)}); "
              f"{QUANT_FRAMES / wall_cc:.3f} frames/s (job wall); card vs CPU port: p01/p99/sat_frac equal, "
              f"whole-frame sums {gap_cc:.3e} relative (bar {QUANT_QC_RTOL}), flags equal (CPU {cpu_s:.2f} s); "
              f"2 channels: {m_c2['n_flagged_frames']} flagged frames, channel 0 rows equal to the 1-channel "
              f"run's on {smi_line}")
        if gap_cc > QUANT_QC_RTOL:
            raise AssertionError(f"(cc) qc metrics card vs CPU {gap_cc}")

        # where a QC frame's time goes: one batched pass + its one fetch
        dev_frames = [torch.from_numpy(f).cuda() for f in frames[:16]]

        def qc_stream():
            for f in dev_frames:
                infer._copy_to_host_async(qc.frame_qc(f, 65535.0))
            torch.cuda.synchronize()

        wall, busy, ops_qc, by_name = _profile_stream(torch, "qc 1024x1024 uint16", qc_stream, 16, "frame")
        print(f"quantify (cc) a QC frame: {wall / 16 * 1e3:.4f} ms wall, device {sum(by_name.values()) / 1e3 / 16:.4f} "
              f"ms, busy {busy / (wall * 1e6):.3f}, {ops_qc:.1f} device ops on {smi_line}")
        del dev_frames, frames, big

        # (cc) dims 3 and (dd): z-stacks of 32x512x512 sharpest at plane 12 + t
        z, vh, vw = QUANT_VOLUME
        base, _ = synthetic.cells_frame(QUANT_SEED + 100, (vh + 2 * QUANT_VOLUMES, vw + 2 * QUANT_VOLUMES))
        vols = _focus_stacks(np, ndimage, base, z, lambda t: QUANT_BEST_Z + t, QUANT_VOLUMES, (vh, vw),
                             QUANT_SEED + 101)
        vdir = os.path.join(tmp, "volumes")
        os.makedirs(vdir)
        for t in range(QUANT_VOLUMES):
            tiff.write_stack(os.path.join(vdir, f"vol_t{t:04d}.tif"), vols[t])
        p3 = {"dims": 3, "frame_range": [0, 4]}
        out_3, m_3, wall_3, _ = serve("cc_dims3", "qc_stack", p3, [vdir])
        out_3c, _, _, _ = serve("cc_dims3_cpu", "qc_stack", p3, [vdir], "cpu")
        with open(out_3["qc_volumes"]) as f:
            best = [int(r.split(",")[2]) for r in f.read().strip().split("\n")[1:]]
        with open(out_3c["qc_volumes"]) as f:
            best_c = [int(r.split(",")[2]) for r in f.read().strip().split("\n")[1:]]
        vol_rows = qc.frame_qc(torch.from_numpy(vols[0]).cuda(), 65535.0).cpu().numpy()
        gap_3 = qc_gap(vol_rows, qc.frame_qc(torch.from_numpy(vols[0]), 65535.0).numpy())
        print(f"quantify (cc) dims 3: 4 volumes of {QUANT_VOLUME}: best_z {best} (truth "
              f"{[QUANT_BEST_Z + t for t in range(4)]}), CPU port {best_c}, best_z_drift {m_3['best_z_drift']}; "
              f"volume 0's plane rows card vs CPU {gap_3:.3e}; {4 / wall_3:.3f} volumes/s (job wall) on {smi_line}")
        if best != [QUANT_BEST_Z + t for t in range(4)] or best_c != best or gap_3 > QUANT_QC_RTOL:
            raise AssertionError(f"(cc) dims 3: best_z {best}, CPU {best_c}, gap {gap_3}")

        # (dd) project_stack: 8 volumes, every method; the CPU port on the first 2
        methods = [("max", {}), ("min", {}), ("sum", {}), ("mean", {}), ("std", {}), ("median", {}),
                   ("best_focus", {}), ("edof", {}), ("edof", {"edof_mode": "select", "save_height": True})]
        serve("dd_warmup", "project_stack", {"method": "edof", "frame_range": [0, 1]}, [vdir])
        dev_vols = [torch.from_numpy(v).cuda() for v in vols[:4]]
        for method, extra in methods:
            tag = method if not extra else "edof_select"
            params = {"method": method, **extra}
            out_d, _, wall_d, dir_d = serve(f"dd_{tag}", "project_stack", params, [vdir])
            out_dc, _, _, dir_dc = serve(f"dd_{tag}_cpu", "project_stack", dict(params, frame_range=[0, 2]),
                                         [vdir], "cpu")
            got = tiff.read_stack(out_d["projected"])[:2]
            want = tiff.read_stack(out_dc["projected"])
            if got.dtype != want.dtype:
                raise AssertionError(f"(dd) {tag}: dtype {got.dtype} vs {want.dtype}")
            gap = float(np.abs(got.astype(np.float64) - want).max() / np.abs(want).max())
            bar = 0.0 if projection.METHODS[method] else QUANT_PROJ_RTOL
            notes = []
            if method == "best_focus":
                with open(out_d["projection"]) as f:
                    rows = f.read().strip().split("\n")
                with open(out_dc["projection"]) as f:
                    rows_c = f.read().strip().split("\n")
                truth = [QUANT_BEST_Z + t for t in range(QUANT_VOLUMES)]
                if rows[:3] != rows_c or [int(r.split(",")[2]) for r in rows[1:]] != truth:
                    raise AssertionError(f"(dd) projection.csv {rows} (CPU {rows_c}, truth {truth})")
                notes.append(f"projection.csv best_z = truth, equal to the CPU's")
            if "save_height" in extra:
                hgt, hgt_c = tiff.read_stack(out_d["height"])[:2], tiff.read_stack(out_dc["height"])
                if not np.array_equal(hgt, hgt_c):
                    raise AssertionError("(dd) height maps differ between the card and the CPU port")
                notes.append(f"height map equal (median plane {int(np.median(hgt[0]))})")
            project = projection.make_projector(method, mode=extra.get("edof_mode", "blend"))

            def proj_stream(project=project):
                for v in dev_vols * 4:
                    infer._copy_to_host_async(project(v)[0])
                torch.cuda.synchronize()

            # 16 volumes a profile (a profile of 20 short kernels has come
            # back empty), taken again if it caught no kernel
            for _ in range(2):
                pwall, busy, ops, by_name = _profile_stream(torch, f"project {tag} {QUANT_VOLUME}", proj_stream,
                                                            16, "volume", top=4)
                if ops:
                    break
            device = (f"device {sum(by_name.values()) / 1e3 / 16:.4f} ms, {ops:.1f} device ops, busy "
                      f"{busy / (pwall * 1e6):.3f}" if ops else "device time not measured (no kernel profiled)")
            print(f"quantify (dd) {tag}: {got.dtype}, card vs CPU port on 2 volumes {gap:.3e} of the largest value "
                  f"(bar {bar}){'; ' + '; '.join(notes) if notes else ''}; {QUANT_VOLUMES / wall_d:.3f} volumes/s "
                  f"(job wall), a volume {pwall / 16 * 1e3:.4f} ms wall, {device} on {smi_line}")
            if gap > bar:
                raise AssertionError(f"(dd) {tag}: card vs CPU {gap}")
        del dev_vols, vols

        # (ee) the workflow chain by depends_on: project_stack (max) of 4
        # volumes of 16x1024x1024 -> segmentation_unet2d -> measure_objects
        # (the projection as its intensity channel) -> export_ctc
        cz, ch_, cw = QUANT_CHAIN_VOLUME
        base, _ = synthetic.cells_frame(QUANT_SEED + 200, (ch_ + 2 * QUANT_CHAIN_VOLUMES, cw + 2 * QUANT_CHAIN_VOLUMES))
        chain = _focus_stacks(np, ndimage, base, cz, lambda t: cz // 2, QUANT_CHAIN_VOLUMES, (ch_, cw),
                              QUANT_SEED + 201)
        chain_path = write("chain.tif", chain.reshape((-1, ch_, cw)))
        del chain
        out_p, m_p, wall_p, dir_p = serve("ee_project", "project_stack", {"method": "max", "z": cz}, [chain_path])
        out_s, m_s, wall_s, dir_s = serve("ee_segment", "segmentation_unet2d",
                                          {"model": "unet2d_cells", "localize": False},
                                          [out_p["projected"]], depends_on=dir_p)
        seg = counts["quant_ee_segment"]
        if seg != (QUANT_CHAIN_VOLUMES, QUANT_CHAIN_VOLUMES):
            raise AssertionError(f"(ee) segmentation: {seg} histogram launches/passes, expected "
                                 f"{QUANT_CHAIN_VOLUMES} of each")
        labels = tiff.read_stack(out_s["labels"])
        out_m, m_m, _, dir_m = serve("ee_measure", "measure_objects", {}, [out_s["labels"], out_p["projected"]],
                                     depends_on=dir_s)
        _, _, _, dir_mc = serve("ee_measure_cpu", "measure_objects", {}, [out_s["labels"], out_p["projected"]], "cpu")
        same_files("(ee) measure_objects", dir_m, dir_mc, ["measurements.csv"])
        # tracks.csv and lbep.txt by the copied tracker on the served labels
        trk = os.path.join(tmp, "tracks")
        os.makedirs(trk)
        tables = [localize.localize_frame_table(labels[t], t=t) for t in range(len(labels))]
        ids, tracks = tracking.link_tables(tables, max_distance=20.0)
        tracking.write_tracks_csv(os.path.join(trk, "tracks.csv"), tables, ids)
        tracking.write_lbep(os.path.join(trk, "lbep.txt"), tracks)
        out_x, m_x, _, dir_x = serve("ee_export", "export_ctc", {}, [out_s["labels"], trk], depends_on=dir_m)
        _, _, _, dir_xc = serve("ee_export_cpu", "export_ctc", {}, [out_s["labels"], trk], "cpu")
        same_files("(ee) export_ctc", dir_x, dir_xc,
                   ["res_track.txt"] + [f"mask{t:03d}.tif" for t in range(QUANT_CHAIN_VOLUMES)])
        print(f"quantify (ee) chain: project_stack {QUANT_CHAIN_VOLUMES} x {QUANT_CHAIN_VOLUME} "
              f"{QUANT_CHAIN_VOLUMES / wall_p:.3f} volumes/s -> segmentation_unet2d {m_s.get('frames_per_sec')} "
              f"frames/s (histogram_2d launches {seg[0]} in {seg[1]} passes, as job a) -> measure_objects "
              f"{m_m['n_objects']} objects -> export_ctc {m_x['n_matched']} matched ({len(tracks)} tracks); "
              f"measurements.csv, res_track.txt and the masks byte-equal to the CPU port's on {smi_line}")

        # (ff) the host jobs on the card machine: count_spots on (ee)'s labels
        # and a localize_emitters emitters.csv; measure_tracks
        spots = np.stack([
            np.clip(np.round(synthetic.emitter_frame(QUANT_SEED + 300 + t, QUANT_FRAME, n=400)[0]), 0, 65535)
            for t in range(QUANT_CHAIN_VOLUMES)
        ]).astype(np.uint16)
        out_l, m_l, _, _ = serve("ff_localize", "localize_emitters", {"max_peaks": 512}, [write("spots.tif", spots)])
        cs_params = {"capture_radius": 2.0}
        out_c, m_cs, _, dir_c = serve("ff_count", "count_spots", cs_params, [out_s["labels"], out_l["emitters"]])
        _, _, _, dir_cc = serve("ff_count_cpu", "count_spots", cs_params, [out_s["labels"], out_l["emitters"]], "cpu")
        same_files("(ff) count_spots", dir_c, dir_cc, ["spots.csv", "spot_counts.csv"])
        out_t, m_t, _, dir_t = serve("ff_traces", "measure_tracks", {}, [dir_m, trk])
        _, _, _, dir_tc = serve("ff_traces_cpu", "measure_tracks", {}, [dir_m, trk], "cpu")
        same_files("(ff) measure_tracks", dir_t, dir_tc, ["traces.csv"])
        print(f"quantify (ff) count_spots: {m_cs['n_spots']} spots, {m_cs['n_assigned']} assigned to "
              f"{m_cs['n_objects']} objects; measure_tracks: {m_t['n_joined']} of {m_t['n_rows']} rows joined to "
              f"{m_t['n_tracks']} tracks; CSVs byte-equal to the CPU port's on {smi_line}")

        # the copied tracker at bench.py::bench_tracking's scene, on the host
        scene, _, _ = fidelity.tracking_scene(**TRACK_SCENE)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            _, trs = tracking.link_tables(scene, max_distance=12.0, max_gap=1, motion_model="kalman",
                                          divisions=True, mitotic_class=2)
            walls.append(time.perf_counter() - t0)
        fps = TRACK_SCENE["n_frames"] / float(np.median(walls))
        tf = fidelity.tracking_fidelity()
        print(f"quantify (ff) tracking: link_tables (kalman, divisions) on {TRACK_SCENE}: {len(trs)} tracks, "
              f"{fps:.3f} frames/s on the host (median of 3); tracking_fidelity {json.dumps(tf)}: link accuracy "
              f"{tf['link_accuracy']} (nearest {tf['link_accuracy_nearest']}) on {smi_line}")
        if not (tf["link_accuracy"] > 0.98 and tf["track_purity"] > 0.95 and tf["division_recall"] >= 0.75
                and tf["division_precision"] >= 0.9 and tf["link_accuracy"] > tf["link_accuracy_nearest"] + 0.02):
            raise AssertionError(f"tracking_fidelity misses the JAX tests' bars: {tf}")
    return counts


OPS_FRAMES = 4  # job (a)'s stack: 4 cells_frame frames of 1024x1024
OPS_SEED = 424_000  # job (a)'s frames
OPS_JOBS = 8  # (e): 4-frame segmentation jobs under --workers 1 and --workers 2
OPS_CANCEL_S = 5.0  # (d): a running job reaches "cancelled" within this after the cancel command
OPS_EXAMPLE_WORKERS = 4  # (f): examples run this many at a time

_STALE_TRACE_PROBE = """\
import json, os, sys, threading
import torch
from sequitr_tpu_torch import utils
out = sys.argv[1]
started, release = threading.Event(), threading.Event()
def abandoned():
    with utils.trace(os.path.join(out, "stale")):
        started.set()
        release.wait(60)
t = threading.Thread(target=abandoned)
t.start()
assert started.wait(30)
with utils.trace(os.path.join(out, "next")):
    x = torch.ones((256, 256), device="cuda")
    float((x @ x).sum())
release.set()
t.join(60)
assert os.path.getsize(os.path.join(out, "stale", "trace.json")) > 0
with open(os.path.join(out, "next", "trace.json")) as f:
    events = json.load(f)["traceEvents"]
print(json.dumps({"kernels": sum(e.get("cat") == "kernel" for e in events)}))
"""


def _log_time(line):
    """The wall-clock time of a ``logging`` line (``%(asctime)s`` first)."""
    import datetime

    return datetime.datetime.strptime(line[:23], "%Y-%m-%d %H:%M:%S,%f").timestamp()


def _trace_kernels(path):
    """{kernel name: launches} of a Chrome trace written by ``utils.trace``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    counts = {}
    for e in events:
        if e.get("cat") == "kernel":
            counts[e["name"]] = counts.get(e["name"], 0) + 1
    return counts


def ops_phase(torch, hist, conv, smi_line):
    """The operations surface on the card: doctor and info, the weight
    interchange round trip, a supervised two-worker serve (a profiled
    workflow, cancel, drain), jobs/s under one and two workers, and every
    example whose optional packages are present. Returns {job: (histogram_2d
    launches, quantile passes)}: the supervised job's from its own trace."""
    import importlib
    import importlib.util
    import re
    import signal
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from sequitr_tpu_torch import __main__ as cli
    from sequitr_tpu_torch import examples
    from sequitr_tpu_torch.config import ServerConfiguration
    from sequitr_tpu_torch.data import synthetic, tiff
    from sequitr_tpu_torch.models import fixtures
    from sequitr_tpu_torch.server import ImageServer, submit_job

    root = os.path.dirname(os.path.abspath(__file__))

    def run_cli(*args, timeout=180, env=None):
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "sequitr_tpu_torch", *args], cwd=root, capture_output=True,
            text=True, timeout=timeout, env=env,
        )
        return res, time.perf_counter() - t0

    def read_status(out):
        try:
            with open(os.path.join(out, "status.json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def wait_for(pred, timeout, what):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if pred():
                return
            time.sleep(0.05)
        if not pred():
            raise AssertionError(f"ops: timed out waiting for {what}")

    counts = {}
    with tempfile.TemporaryDirectory() as tmp:
        jobs, models, logs = (os.path.join(tmp, d) for d in ("jobs", "models", "logs"))
        for d in (jobs, logs):
            os.makedirs(d)

        # (a) doctor and info, beside the stale-trace probe, in subprocesses
        with ThreadPoolExecutor(3) as pool:
            doc = pool.submit(run_cli, "doctor", "--jobs-dir", jobs, "--models-dir", models,
                              "--timeout", "120")
            inf = pool.submit(run_cli, "info", "--models-dir", models)
            stale = pool.submit(
                subprocess.run, [sys.executable, "-c", _STALE_TRACE_PROBE, tmp], cwd=root,
                capture_output=True, text=True, timeout=180,
            )
            (doc, doc_s), (inf, inf_s), stale = doc.result(), inf.result(), stale.result()
        print(doc.stdout.rstrip())
        name = torch.cuda.get_device_name(0)
        if doc.returncode != 0 or f"cuda x{torch.cuda.device_count()} ({name})" not in doc.stdout:
            raise AssertionError(f"doctor: rc {doc.returncode}\n{doc.stdout}\n{doc.stderr[-2000:]}")
        probe = re.search(r"init_s ([0-9.]+), matmul_s ([0-9.]+)", doc.stdout)
        print(f"ops (a) doctor exit 0 in {doc_s:.2f} s: cuda init_s {probe.group(1)}, matmul_s "
              f"{probe.group(2)} (256x256 f32, first call) on {smi_line}")
        print(inf.stdout.rstrip())
        if inf.returncode != 0 or f"devices={torch.cuda.device_count()} ({name})" not in inf.stdout:
            raise AssertionError(f"info: rc {inf.returncode}\n{inf.stdout}\n{inf.stderr[-2000:]}")
        if stale.returncode != 0 or json.loads(stale.stdout.strip().splitlines()[-1])["kernels"] < 1:
            raise AssertionError(f"stale-trace probe: rc {stale.returncode}\n{stale.stdout}\n{stale.stderr[-2000:]}")
        print("ops (a) a profiled block after a trace left running on another thread: takes the profiler "
              "over (the stale trace lands in its own directory), completes with its own CUDA kernels in "
              "its trace, and the stale block's end does not crash the process")

        # (b) import-model -> export-model -> import-model of unet2d_cells, bit-equal at each step
        meta = fixtures.manifest()["unet2d_cells"]
        arch = os.path.join(tmp, "unet2d_cells.json")
        with open(arch, "w") as f:
            json.dump(dict(meta["config"], __kind__=meta["kind"]), f)
        npz = os.path.join(fixtures.fixture_dir(), "unet2d_cells.npz")
        exported = [os.path.join(tmp, "export1.npz"), os.path.join(tmp, "export2.npz")]
        steps = [
            ["import-model", "--models-dir", models, "--npz", npz, "--arch", arch, "unet2d_cells"],
            ["export-model", "--models-dir", models, "unet2d_cells", exported[0]],
            ["import-model", "--models-dir", models, "--npz", exported[0], "--arch", arch, "unet2d_cells_again"],
            ["export-model", "--models-dir", models, "unet2d_cells_again", exported[1]],
        ]
        for argv in steps:
            if cli.main(argv):
                raise AssertionError(f"{argv[0]} failed")

        def arrays(path):
            with np.load(path) as z:
                return {k: z[k] for k in z.files}

        src, first, second = arrays(npz), arrays(exported[0]), arrays(exported[1])
        if sorted(src) != sorted(first) or sorted(first) != sorted(second):
            raise AssertionError("export-model keys differ from the fixture's")
        for k in src:
            if not np.array_equal(src[k].astype(np.float32), first[k]) or first[k].tobytes() != second[k].tobytes():
                raise AssertionError(f"interchange round trip changed {k}")
        print(f"ops (b) unet2d_cells: import -> export -> import -> export, {len(first)} arrays "
              f"bit-equal at each step (the fixture's float16 read as float32)")

        frames = np.stack(
            [synthetic.cells_frame(OPS_SEED + i, (1024, 1024))[0] for i in range(OPS_FRAMES)]
        ).clip(0, 65535).astype(np.uint16)
        stack = os.path.join(tmp, "stack.tif")
        tiff.write_stack(stack, frames)
        seg_params = {"model": "unet2d_cells", "localize": False}

        def serve_cfg(name, **kw):
            path = os.path.join(tmp, f"{name}.json")
            ServerConfiguration(jobs_dir=jobs, models_dir=models, poll_interval=0.2, log_dir=logs,
                                device="cuda", **kw).to_json(path)
            return path

        def start_serve(workers, cfg_path, log_name, env=None):
            log_f = open(os.path.join(tmp, log_name), "w")
            t0 = time.time()
            proc = subprocess.Popen(
                [sys.executable, "-m", "sequitr_tpu_torch", "serve", "--workers", str(workers),
                 "--device", "cuda", "--config", cfg_path],
                cwd=root, stdout=log_f, stderr=subprocess.STDOUT, env=env,
            )
            proc.log_f, proc.log_path, proc.t0 = log_f, os.path.join(tmp, log_name), t0
            return proc

        def log_of(proc):
            with open(proc.log_path) as f:
                return f.read()

        def stop(proc):
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
                try:
                    proc.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
            proc.log_f.close()

        def boot_times(proc):
            """Seconds from the spawn of the workers (the supervisor's
            "supervising" line; a single worker's own start) to each
            worker's "server watching" line."""
            lines = log_of(proc).splitlines()
            spawned = [_log_time(ln) for ln in lines if "supervising" in ln] or [proc.t0]
            watching = [_log_time(ln) for ln in lines if "server watching" in ln]
            return [round(t - spawned[0], 3) for t in watching]

        # (c) serve --workers 2 on the one card; a profiled workflow by submit --follow
        slow_env = dict(os.environ, SEQUITR_TEST_SLOW="1")
        sup = start_serve(2, serve_cfg("ops_c"), "ops_c.log", env=slow_env)
        try:
            seg_out, meas_out = os.path.join(tmp, "ops_seg"), os.path.join(tmp, "ops_meas")
            wf = os.path.join(tmp, "workflow.json")
            with open(wf, "w") as f:
                json.dump([
                    {"module": "segmentation_unet2d", "params": dict(seg_params, profile=True),
                     "input": [stack], "output": seg_out},
                    {"module": "measure_objects", "params": {},
                     "input": [os.path.join(seg_out, "labels.tif"), stack], "output": meas_out},
                ], f)
            # the same job in this process on the card, while the workers boot
            ref_jobs = os.path.join(tmp, "ref_jobs")
            ref = ImageServer(ServerConfiguration(jobs_dir=ref_jobs, models_dir=models, device="cuda"))
            ref_out = os.path.join(tmp, "ref_seg")
            submit_job(ref_jobs, {"module": "segmentation_unet2d", "params": dict(seg_params, profile=True),
                                  "input": [stack], "output": ref_out})
            torch.cuda.synchronize()
            hist.histogram_2d.launches = 0
            hist.quantile_pass.launches = 0
            _euler().launches = 0
            if not ref.poll_once():
                raise AssertionError("ops: the in-process job did not run")
            torch.cuda.synchronize()
            counts["ops_inprocess"] = (hist.histogram_2d.launches, hist.quantile_pass.launches)
            _euler_read("ops_inprocess", 0)
            if counts["ops_inprocess"] != (OPS_FRAMES, OPS_FRAMES):
                raise AssertionError(f"ops: in-process job ran {counts['ops_inprocess']} (launches, passes)")
            res, follow_s = run_cli("submit", "--jobs-dir", jobs, "--follow", wf, timeout=300)
            if res.returncode != 0:
                raise AssertionError(f"submit --follow: rc {res.returncode}\n{res.stdout[-2000:]}\n"
                                     f"{res.stderr[-2000:]}\n{log_of(sup)[-3000:]}")
            seg_status = read_status(seg_out)
            metrics = json.loads(seg_status["outputs"]["metrics"])
            if seg_status["state"] != "complete" or metrics.get("device") != "cuda":
                raise AssertionError(f"ops: supervised job {seg_status}")
            with open(os.path.join(seg_out, "labels.tif"), "rb") as f:
                served = f.read()
            with open(os.path.join(ref_out, "labels.tif"), "rb") as f:
                if f.read() != served:
                    raise AssertionError("ops: the supervised job's labels.tif differs from the in-process job's")
            kernels = _trace_kernels(os.path.join(seg_out, "profile", "trace.json"))
            minmax = sum(n for k, n in kernels.items() if "minmax_kernel" in k)
            count = sum(n for k, n in kernels.items() if "count_kernel" in k)
            counts["ops_supervised"] = (count, minmax)
            print(f"ops (c) serve --workers 2 --device cuda: submit --follow of segmentation_unet2d "
                  f"(profile) -> measure_objects exit 0 in {follow_s:.2f} s; labels.tif byte-equal to "
                  f"the in-process job's; its trace holds minmax_kernel x{minmax}, count_kernel "
                  f"x{count} ({len(kernels)} kernel names, {sum(kernels.values())} launches); "
                  f"metrics {json.dumps(metrics)} on {smi_line}")
            if (count, minmax) != (OPS_FRAMES, OPS_FRAMES):
                raise AssertionError(f"ops: the supervised trace holds {minmax} minmax / {count} count launches")
            print(f"ops boot: worker spawn -> 'server watching' {boot_times(sup)} s")

            # (d) cancel a running job; then drain with one job running on each worker and one queued
            slow_out = os.path.join(tmp, "ops_slow")
            jid = submit_job(jobs, {"module": "__test_slow__", "params": {"sleep": 60},
                                    "input": [], "output": slow_out})
            wait_for(lambda: os.path.exists(os.path.join(slow_out, "worker_pid.txt")), 60, "the slow job")
            res, cancel_s = run_cli("cancel", "--jobs-dir", jobs, jid)
            t0 = time.perf_counter()
            if res.returncode != 0 or "cancel requested" not in res.stdout:
                raise AssertionError(f"cancel: rc {res.returncode} {res.stdout} {res.stderr[-1000:]}")
            wait_for(lambda: (read_status(slow_out) or {}).get("state") == "cancelled", OPS_CANCEL_S,
                     "the cancelled state")
            print(f"ops (d) cancel {jid}: the command took {cancel_s:.3f} s, the running job was "
                  f"cancelled {time.perf_counter() - t0:.3f} s after it ({res.stdout.strip()})")
            holds = [os.path.join(tmp, f"ops_hold{i}") for i in range(2)]
            for out in holds:
                submit_job(jobs, {"module": "__test_slow__", "params": {"sleep": 3}, "input": [], "output": out})
            wait_for(lambda: all((read_status(o) or {}).get("state") == "running" for o in holds), 60,
                     "both workers busy")
            queued_out = os.path.join(tmp, "ops_queued")
            queued = submit_job(jobs, {"module": "__test_slow__", "params": {"sleep": 0.1}, "input": [],
                                       "output": queued_out})
            res, drain_busy_s = run_cli("drain", "--jobs-dir", jobs, "--wait", "--timeout", "120")
            code = sup.wait(timeout=60)
            if res.returncode != 0 or code != 0:
                raise AssertionError(f"drain: rc {res.returncode}, supervisor {code}\n{res.stderr}\n"
                                     f"{log_of(sup)[-3000:]}")
            if any((read_status(o) or {}).get("state") != "complete" for o in holds) \
                    or read_status(queued_out) is not None \
                    or sorted(os.listdir(jobs)) != [f"job_{queued}.json"]:
                raise AssertionError(f"ops: drain left {sorted(os.listdir(jobs))}")
            print(f"ops (d) drain --wait with both workers busy: {drain_busy_s:.3f} s (running jobs "
                  f"complete, supervisor exit 0, .serve.pid gone, the queued job still queued)")
        finally:
            stop(sup)
        for argv in (["queue", "--jobs-dir", jobs], ["stats", logs]):
            res, _ = run_cli(*argv)
            if res.returncode != 0:
                raise AssertionError(f"{argv[0]}: rc {res.returncode} {res.stderr[-1000:]}")
            print(res.stdout.rstrip())
        os.remove(os.path.join(jobs, f"job_{queued}.json"))

        # profile overhead: the same 4-frame job in this process, warm, without and with profile
        walls = {}
        for name in ("plain", "profiled", "plain", "profiled"):
            out = os.path.join(tmp, f"overhead_{name}_{len(walls)}")
            params = dict(seg_params, profile=True) if name == "profiled" else seg_params
            submit_job(ref_jobs, {"module": "segmentation_unet2d", "params": params, "input": [stack],
                                  "output": out})
            t0 = time.perf_counter()
            ref.poll_once()
            torch.cuda.synchronize()
            walls.setdefault(name, []).append(time.perf_counter() - t0)
        plain_s, prof_s = min(walls["plain"]), min(walls["profiled"])
        print(f"ops profile overhead: the 4-frame job {plain_s * 1e3:.2f} ms plain, {prof_s * 1e3:.2f} ms "
              f"with profile (x{prof_s / plain_s:.3f}; best of 2, warm, in-process) on {smi_line}")

        # (e) eight 4-frame jobs under --workers 1 and --workers 2 on the one card: one
        # warm-up job a worker is queued before the serve starts (the serve start -> first
        # job complete time), the eight are submitted at once when every worker has
        # finished its warm-up
        for workers in (1, 2):
            ledger = os.path.join(logs, "jobs.jsonl")
            if os.path.exists(ledger):
                os.remove(ledger)

            def seg_jobs(tag, n):
                outs = [os.path.join(tmp, f"ops_e{workers}_{tag}{i}") for i in range(n)]
                ids = [submit_job(jobs, {"module": "segmentation_unet2d", "params": seg_params,
                                         "input": [stack], "output": out}) for out in outs]
                return outs, ids

            def ledger_rows():
                try:
                    with open(ledger) as f:
                        return {r["id"]: r for r in map(json.loads, f)}
                except (OSError, ValueError):
                    return {}

            warm_outs, warm_ids = seg_jobs("warm", workers)
            sup = start_serve(workers, serve_cfg(f"ops_e{workers}"), f"ops_e{workers}.log")
            try:
                # until every worker has served one (claims are first come, first served)
                for attempt in range(8):
                    # a job's status reads complete before the worker appends its ledger row
                    wait_for(lambda: all((read_status(o) or {}).get("state") == "complete" for o in warm_outs)
                             and set(warm_ids) <= set(ledger_rows()),
                             180, f"the warm-up jobs under {workers} worker(s)")
                    warmed = {str(ledger_rows()[i]["worker"]) for i in warm_ids}
                    if len(warmed) == workers:
                        break
                    more_outs, more_ids = seg_jobs(f"warm{attempt}_", 1)
                    warm_outs, warm_ids = warm_outs + more_outs, warm_ids + more_ids
                else:
                    raise AssertionError(f"ops: warm-up jobs reached only workers {sorted(warmed)}")
                t_submit = time.time()
                outs, ids = seg_jobs("job", OPS_JOBS)
                wait_for(lambda: all((read_status(o) or {}).get("state") == "complete" for o in outs), 180,
                         f"{OPS_JOBS} jobs under {workers} worker(s)")
                time.sleep(0.5)  # idle: every worker back in its poll loop
                res, drain_idle_s = run_cli("drain", "--jobs-dir", jobs, "--wait", "--timeout", "60")
                if res.returncode != 0 or sup.wait(timeout=30) != 0:
                    raise AssertionError(f"idle drain: rc {res.returncode}\n{log_of(sup)[-2000:]}")
            finally:
                stop(sup)
            rows = ledger_rows()
            first_done = min(rows[i]["finished"] for i in warm_ids)
            done = sorted(rows[i]["finished"] for i in ids if rows[i]["state"] == "complete")
            if len(done) != OPS_JOBS:
                raise AssertionError(f"ops: {len(done)} of {OPS_JOBS} jobs complete under {workers} workers")
            devices = {json.loads(read_status(o)["outputs"]["metrics"])["device"] for o in outs + warm_outs}
            if devices != {"cuda"}:
                raise AssertionError(f"ops: the jobs under {workers} worker(s) ran on {devices}")
            span = done[-1] - done[0]
            print(f"ops (e) --workers {workers}: {OPS_JOBS} jobs of {OPS_FRAMES} 1024x1024 frames submitted at "
                  f"once to warm workers: ledger finished span {span:.3f} s, {(OPS_JOBS - 1) / span:.3f} "
                  f"jobs/s ((n-1)/span); all done {done[-1] - t_submit:.3f} s after the submit "
                  f"({OPS_JOBS / (done[-1] - t_submit):.3f} jobs/s); by worker "
                  f"{sorted(str(rows[i]['worker']) for i in ids)}; serve start -> first (warm-up) job "
                  f"complete {first_done - sup.t0:.3f} s; spawn -> 'server watching' {boot_times(sup)} s; "
                  f"idle drain --wait {drain_idle_s:.3f} s; on {smi_line}")

        # (f) the examples on the card, those whose optional packages are present
        runnable, left_out = [], []
        for ex in examples.NAMES:
            mod = importlib.import_module(f"sequitr_tpu_torch.examples.{ex}")
            missing = [r for r in getattr(mod, "REQUIRES", ()) if importlib.util.find_spec(r) is None]
            (left_out if missing else runnable).append((ex, missing))
        print("ops (f) examples left out: " + (", ".join(
            f"{ex} (needs {', '.join(m)}, absent on this host)" for ex, m in left_out) or "none"))

        def run_example(ex):
            t0 = time.perf_counter()
            res = subprocess.run(
                [sys.executable, "-m", f"sequitr_tpu_torch.examples.{ex}", os.path.join(tmp, f"ex_{ex}")],
                cwd=root, capture_output=True, text=True, timeout=300,
                env=dict(os.environ, SEQUITR_EXAMPLE_STEPS="20"),
            )
            return ex, res, time.perf_counter() - t0

        t0 = time.perf_counter()
        with ThreadPoolExecutor(OPS_EXAMPLE_WORKERS) as pool:
            results = list(pool.map(run_example, [ex for ex, _ in runnable]))
        for ex, res, wall in results:
            if res.returncode != 0:
                raise AssertionError(f"example {ex}: rc {res.returncode}\n{res.stdout[-2000:]}\n{res.stderr[-3000:]}")
            print(f"ops (f) example {ex}: exit 0 in {wall:.2f} s ({OPS_EXAMPLE_WORKERS} at a time on the card)")
        print(f"ops (f) {len(results)} examples in {time.perf_counter() - t0:.2f} s on {smi_line}")
    return counts


PAR_WAYS = 4  # the emulated mesh: parallel.virtual_devices(4) over cuda:0
PAR_FRAME = (8192, 8192)  # (a): one slide-scanner-sized frame, 4 x 2048 rows
PAR_HYBRID = (2048, 2048)  # (b): 4 frames, 2 data x 2 space
PAR_VOLUME = (64, 512, 512)  # (c): 16 planes a shard
PAR_GAN = (2048, 2048)  # (d)
PAR_FT = (2048, 2048)  # (f): finetune_spatial frames
PAR_FT_STEPS = 3
PAR_SERVE_FRAME = (1024, 1024)  # (e): the serve phase's frame shape
PAR_OVERLAP = 102  # (e): stitch_mosaic's 3x3 grid of such tiles, 10% overlap
PAR_RECORD = (256, 256)  # (g): the train phase's patch shape, 8 records
PAR_SEED = 626_000
PAR_MIXED = (512, 512)  # (h): a frame, and 2 records of PAR_RECORD, on a mesh of cuda:0 and the CPU
PAR_MIXED_PROB_BAR = 2.5e-4  # (h): the model phase's card-vs-CPU logit bar (1e-3) times softmax's largest slope (1/4)
# (f) bf16, 4 ways against 1, between the bf16 noise floor (1 way bf16 against
# 1 way f32: update L2 0.242967, statistics 0.00346) and the planted fault
# (zeroed halos: 0.309188, 0.01793); 4 ways read 0.173802, 0.00178 (PERF.md)
PAR_FT_BF16_UPDATE_BAR = 0.275
PAR_FT_BF16_STATS_BAR = 0.007
PAR_ENHANCE_PSNR_DB = PSNR_BAR_DB  # (d): the enhance phase's bar
PAR_CSV_UNIT = OPTICS_CSV_UNIT  # (e): emitters.csv, DP against one device
PAR_GEOM_PX = GEOM_CARD_CPU_PX  # (e): register_stack / stitch_mosaic, DP against one device
PAR_PIXEL_REL = 1e-5  # (e): registered / mosaic pixels, DP against one device, of the frame's largest value


RESP_REL = 1e-4  # (e): a seam's or a frame's PSR response, DP against one device (tests/test_torch_geometry_jobs.py)
PAR_POLY_LOSS_RTOL = 1e-5  # (i): polyphase DP loss, 4 ways against 1 (P7's hold for (g))
PAR_POLY_STATS_BAR = 1e-4  # (i): running statistics, 4 ways against 1 (P7's hold)


def _csv_gap(np, path_a, path_b, abs_bar, rel_bar):
    """Two CSVs of one job: the same header, rows and text cells; numbers
    within ``abs_bar`` plus ``rel_bar`` of their size plus one unit of a
    printed last digit. Returns (rows, largest absolute gap)."""
    with open(path_a) as f, open(path_b) as g:
        a, b = f.read().strip().splitlines(), g.read().strip().splitlines()
    if a[0] != b[0] or len(a) != len(b):
        raise AssertionError(f"{path_b}: header or row count differs from {path_a}")
    gap = 0.0
    for ra, rb in zip(a[1:], b[1:]):
        for x, y in zip(ra.split(","), rb.split(",")):
            try:
                fx, fy = float(x), float(y)
            except ValueError:
                if x != y:
                    raise AssertionError(f"{path_b}: {y!r} against {x!r}")
                continue
            unit = 10.0 ** -len(x.split(".")[1]) if "." in x else 0.0
            d = abs(fx - fy)
            gap = max(gap, d)
            if not d <= abs_bar + rel_bar * abs(fx) + unit + 1e-12:
                raise AssertionError(f"{path_b}: {y} against {x}")
    return len(a) - 1, gap


def parallel_phase(torch, hist, conv, smi_line):
    """The ``parallel`` package on the card: every job that shards, served
    by ``ImageServer`` inside ``parallel.virtual_devices(4)`` (a 4-device
    pool over cuda:0: real shards and halo exchanges, the copies within one
    device), each beside an unsharded reference. Returns {job: (histogram_2d
    launches, quantile passes)}."""
    import contextlib
    import dataclasses

    import numpy as np

    from sequitr_tpu_torch import __main__ as cli
    from sequitr_tpu_torch import fidelity, parallel
    from sequitr_tpu_torch.config import ServerConfiguration
    from sequitr_tpu_torch.data import synthetic, tiff
    from sequitr_tpu_torch.data.synthetic import bandlimited_scene
    from sequitr_tpu_torch.models import convert, fixtures, gan
    from sequitr_tpu_torch.models import unet as unet_lib
    from sequitr_tpu_torch.parallel import spatial
    from sequitr_tpu_torch.pipeline import infer
    from sequitr_tpu_torch.server import ImageServer, submit_job
    from sequitr_tpu_torch.server.server import load_model, read_model

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    counts = {}
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with tempfile.TemporaryDirectory() as tmp:
        jobs, models = os.path.join(tmp, "jobs"), os.path.join(tmp, "models")
        for name in ("unet2d_cells", "unet3d_cells", "gan_denoise", "n2v_cells", "flows_cells"):
            meta = fixtures.manifest()[name]
            arch = os.path.join(tmp, f"{name}.json")
            with open(arch, "w") as f:
                json.dump(dict(meta["config"], __kind__=meta["kind"]), f)
            npz = os.path.join(fixtures.fixture_dir(), f"{name}.npz")
            if cli.main(["import-model", "--models-dir", models, "--npz", npz, "--arch", arch, name]):
                raise AssertionError(f"import-model {name} failed")
        server = ImageServer(ServerConfiguration(jobs_dir=jobs, models_dir=models, device="cuda"))

        def write(name, arr):
            path = os.path.join(tmp, name)
            tiff.write_stack(path, arr)
            return path

        def u16(a):
            return np.clip(np.round(a), 0, 65535).astype(np.uint16)

        halo = {"rows": 0, "bytes": 0}
        neighbor_rows = unet_lib._neighbor_rows
        halo_fn = {"rows": neighbor_rows}

        def counted(row, j):
            top, bot = halo_fn["rows"](row, j)
            n = int(j > 0) + int(j < len(row) - 1)
            halo["rows"] += n
            halo["bytes"] += n * top.numel() * top.element_size()
            return top, bot

        def serve(name, module, params, inputs, ways=PAR_WAYS, profile=False, rows=neighbor_rows):
            """One job, every kernel's count reset just before it and read just
            after; ``ways`` > 1 serves it on a virtual pool of that many
            devices, 1 on the card alone; ``rows`` is the halo exchange
            (``unet_lib._neighbor_rows``, or a planted fault). Returns
            (outputs, wall s, peak GB, device ms or None, halo rows)."""
            out = os.path.join(tmp, f"out_{name}")
            submit_job(jobs, {"module": module, "params": params, "input": inputs, "output": out})
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            hist.histogram_2d.launches = 0
            hist.quantile_pass.launches = 0
            conv.conv3x3_nhwc.launches = 0
            conv.conv3x3_flat_chw.launches = 0
            _euler().launches = 0
            halo.update(rows=0, bytes=0)
            pool = parallel.virtual_devices(ways) if ways > 1 else contextlib.nullcontext()
            prof = torch.profiler.profile(activities=acts) if profile else contextlib.nullcontext()
            unet_lib._neighbor_rows = counted
            halo_fn["rows"] = rows
            try:
                t0 = time.perf_counter()
                with pool, prof:
                    if not server.poll_once():
                        raise AssertionError(f"parallel job {name}: no job to run")
                    torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            finally:
                unet_lib._neighbor_rows = neighbor_rows
                halo_fn["rows"] = neighbor_rows
            peak = (torch.cuda.max_memory_allocated() - base) / 1e9
            if conv.conv3x3_nhwc.launches + conv.conv3x3_flat_chw.launches:
                raise AssertionError(f"parallel job {name} launched a conv study kernel")
            counts[f"par_{name}"] = (hist.histogram_2d.launches, hist.quantile_pass.launches)
            _euler_read(f"par_{name}")
            with open(os.path.join(out, "status.json")) as f:
                status = json.load(f)
            if status["state"] != "complete":
                raise AssertionError(f"parallel job {name}: {status.get('error')}")
            dev_ms = None
            if profile:
                ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
                dev_ms = _ms(ops, 1)
            metrics = json.loads(status["outputs"].get("metrics", "{}"))
            print(f"parallel job {name} {module} {json.dumps(params_summary(params))[:200]} on {ways} way(s): "
                  f"wall {wall:.4f} s, peak {peak:.3f} GB, device ms "
                  f"{'not measured' if dev_ms is None else f'{dev_ms:.4f}'}, halo rows copied {halo['rows']} "
                  f"({halo['bytes'] / 1e6:.3f} MB), histogram passes {counts[f'par_{name}'][1]}; metrics "
                  f"{json.dumps(metrics)} on {smi_line}")
            return status["outputs"], wall, peak, dev_ms, halo["rows"]

        def whole_labels(model, frames):
            """The untiled whole-frame (whole-volume) forward of the same
            normalized input on the card: labels, and its wall s."""
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            with torch.inference_mode():
                x = torch.as_tensor(frames, device="cuda")[..., None]
                tc = infer.TileConfig(patch=tuple(frames.shape[1:]), overlap=(0,) * (frames.ndim - 1))
                labels = torch.cat([
                    torch.argmax(torch.softmax(model(infer._normalize(x[i:i + 1], tc)), -1), -1)
                    for i in range(len(x))
                ]).to(torch.uint16).cpu().numpy()
            torch.cuda.synchronize()
            return labels, time.perf_counter() - t0

        def hold_labels(what, got, want):
            agree = float(np.mean(got == want))
            m = fidelity.miou(got.astype(np.int64), want.astype(np.int64), 3)
            print(f"parallel {what}: labels against the whole-frame forward: miou {m:.6f}, pixel agreement "
                  f"{agree:.6f} (bar miou >= {MIOU_BAR})")
            if not m >= MIOU_BAR:
                raise AssertionError(f"parallel {what}: miou {m} < {MIOU_BAR}")

        _, cfg2, seg2 = load_model(models, "unet2d_cells", device="cuda")
        n_convs = 2 * cfg2.depth + 2 * (cfg2.depth - 1)

        # (a) one 8192x8192 frame, spatial_parallel: true: 4 x 2048 rows
        big = u16(synthetic.cells_frame(PAR_SEED, PAR_FRAME)[0])
        big_path = write("big.tif", big)
        seg_params = {"model": "unet2d_cells", "localize": False, "spatial_parallel": True}
        serve("a_warmup", "segmentation_unet2d", seg_params, [write("warm.tif", big[:2048, :2048])])
        out_a, wall_a, peak_a, _, rows_a = serve("a_spatial", "segmentation_unet2d", seg_params, [big_path])
        if counts["par_a_spatial"] != (1, 1):
            raise AssertionError(f"(a): histogram {counts['par_a_spatial']}, expected one pass for the frame")
        want_rows = n_convs * 2 * (PAR_WAYS - 1)
        if rows_a != want_rows:
            raise AssertionError(f"(a): {rows_a} halo rows copied, expected {want_rows}")
        _, _, _, dev_a, _ = serve("a_spatial_profiled", "segmentation_unet2d", seg_params, [big_path], profile=True)
        whole_labels(seg2, big[None])  # warm: the first call at this shape allocates and picks algorithms
        want, wall_whole = whole_labels(seg2, big[None])
        hold_labels("(a) 8192x8192 on 4 ways", tiff.read_stack(out_a["labels"]), want[0])
        print(f"parallel (a): {rows_a} halo rows a frame ({n_convs} 3x3 convs x 2 x {PAR_WAYS - 1} boundaries); "
              f"job wall {wall_a:.4f} s (peak {peak_a:.3f} GB, device {dev_a:.4f} ms profiled) against the "
              f"warm whole-frame normalize + forward + argmax + fetch {wall_whole:.4f} s: x{wall_a / wall_whole:.3f} "
              f"(the job also reads the TIFF and writes labels.tif) on {smi_line}")
        # the sharded forward alone against the whole-frame forward, both warm,
        # on the same normalized frame: the halo exchange's and the lockstep's cost
        with torch.inference_mode():
            x = infer._normalize(torch.as_tensor(big, device="cuda")[None, ..., None],
                                 infer.TileConfig(patch=PAR_FRAME, overlap=(0, 0)))
            with parallel.virtual_devices(PAR_WAYS):
                sp_fn = spatial.spatial_unet2d_infer(cfg2, parallel.make_mesh(device="cuda"), PAR_FRAME)
            runs = {"sharded": lambda: sp_fn(seg2, x[0]), "whole": lambda: torch.softmax(seg2(x), -1)}
            cost = {}
            for kind, fn in runs.items():
                torch.cuda.empty_cache()
                fn()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                for _ in range(2):
                    fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / 2
                peak = (torch.cuda.max_memory_allocated() - base) / 1e9
                with torch.profiler.profile(activities=acts) as prof:
                    fn()
                    torch.cuda.synchronize()
                ops = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
                cost[kind] = (wall * 1e3, _ms(ops, 1), len(ops), peak)
        del x, runs, sp_fn
        (sw, sd, sn, sp), (ww, wd, wn, wp) = cost["sharded"], cost["whole"]
        print(f"parallel (a) forward 8192x8192 bf16, warm: 4-way sharded {sw:.3f} ms wall, {sd:.3f} device ms, "
              f"{sn} device ops, peak {sp:.3f} GB; whole frame {ww:.3f} ms, {wd:.3f} device ms, {wn} ops, peak "
              f"{wp:.3f} GB: the emulated mesh costs x{sw / ww:.3f} wall, x{sd / wd if wd else float('nan'):.3f} "
              f"device time on {smi_line}")
        del big, want

        # (b) spatial_parallel: 2 -> 2 data x 2 space, 4 frames of 2048x2048
        hyb = np.stack([u16(synthetic.cells_frame(PAR_SEED + 1 + i, PAR_HYBRID)[0]) for i in range(4)])
        out_b, *_ = serve("b_hybrid", "segmentation_unet2d", dict(seg_params, spatial_parallel=2),
                          [write("hybrid.tif", hyb)], profile=True)
        if counts["par_b_hybrid"] != (2, 2):
            raise AssertionError(f"(b): histogram {counts['par_b_hybrid']}, expected a pass a chunk of 2 frames")
        want, _ = whole_labels(seg2, hyb)
        got = tiff.read_stack(out_b["labels"])
        for i in range(4):
            hold_labels(f"(b) hybrid frame {i}", got[i], want[i])

        # (c) segmentation_unet3d, a 64x512x512 volume Z-sharded (16 planes a shard)
        vol = u16(synthetic.cells_volume(PAR_SEED + 10, PAR_VOLUME)[0])
        out_c, *_ = serve("c_volume", "segmentation_unet3d",
                          {"model": "unet3d_cells", "localize": False, "spatial_parallel": True},
                          [write("volume.tif", vol)], profile=True)
        if counts["par_c_volume"] != (1, 1):
            raise AssertionError(f"(c): histogram {counts['par_c_volume']}, expected one pass")
        _, _, seg3 = load_model(models, "unet3d_cells", device="cuda")
        want, _ = whole_labels(seg3, vol[None])
        hold_labels("(c) 64x512x512 on 4 ways", tiff.read_stack(out_c["labels"]), want[0])

        # (d) enhancement_gan, spatial_parallel: true at 2048x2048
        gframe = u16(synthetic.cells_frame(PAR_SEED + 20, PAR_GAN)[0])
        out_d, *_ = serve("d_enhance", "enhancement_gan", {"model": "gan_denoise", "spatial_parallel": True},
                          [write("gan.tif", gframe[None])], profile=True)
        _, _, gmodel = load_model(models, "gan_denoise", device="cuda")
        with torch.inference_mode():
            x = torch.as_tensor(gframe, device="cuda")[None, ..., None]
            tc = infer.TileConfig(patch=PAR_GAN, overlap=(0, 0))
            ref = gan.generator_apply(gmodel, infer._normalize(x, tc))[0, ..., 0].cpu().numpy()
        err = tiff.read_stack(out_d["enhanced"]).astype(np.float64) - ref
        psnr = float(10 * np.log10(1.0 / max(float(np.mean(err**2)), 1e-20)))
        print(f"parallel (d): enhanced against the whole-frame generator: PSNR {psnr:.2f} dB, max |diff| "
              f"{np.abs(err).max():.3g} (bar {PAR_ENHANCE_PSNR_DB} dB)")
        if not psnr >= PAR_ENHANCE_PSNR_DB:
            raise AssertionError(f"(d) PSNR {psnr} dB < {PAR_ENHANCE_PSNR_DB}")

        # (e) data_parallel through every job that takes it, 4 ways against 1
        frames = np.stack([u16(synthetic.cells_frame(424_000 + i, PAR_SERVE_FRAME)[0]) for i in range(4)])
        stack = write("stack.tif", frames)
        noisy = write("noisy.tif", np.stack([synthetic.denoise_pair(515_000 + i, PAR_SERVE_FRAME)[1]
                                             for i in range(4)]).astype(np.float32))
        inst = write("instances.tif", np.stack([u16(synthetic.instances_frame(INSTANCE_SEED + i, PAR_SERVE_FRAME)[0])
                                                for i in range(4)]))
        spots = write("spots.tif", np.stack([u16(synthetic.emitter_frame(OPTICS_SEED + t, OPTICS_FRAME,
                                                                         n=OPTICS_EMITTERS)[0]) for t in range(16)]))
        spot_vols = os.path.join(tmp, "spot_vols")
        os.makedirs(spot_vols)
        for t in range(4):
            tiff.write_stack(os.path.join(spot_vols, f"v_t{t:02d}.tif"),
                             u16(synthetic.emitter_volume(OPTICS_SEED + 100 + t, OPTICS_VOLUME, n=OPTICS_EMITTERS)[0]))
        astig = write("astig.tif", np.stack([u16(synthetic.astig_emitter_frame(OPTICS_SEED + 200 + t, OPTICS_FRAME,
                                                                              n=80)[0]) for t in range(16)]))
        calib = {"qx": list(synthetic.ASTIG_QX), "qy": list(synthetic.ASTIG_QY), "z_range": list(synthetic.ASTIG_Z_RANGE)}
        rng = np.random.default_rng(PAR_SEED + 30)
        base = bandlimited_scene(PAR_SERVE_FRAME, rng, amp=1500.0, offset=6000.0)
        spec = torch.fft.fftn(torch.from_numpy(base).double().cuda())
        drift = np.vstack([[0.0, 0.0], np.cumsum(rng.normal((0.8, -0.6), 0.3, (15, 2)), 0)])
        drift_path = write("drift.tif", np.stack([
            _fourier_moved(torch, spec, s).round().clamp(0, 65535).cpu().numpy() for s in drift]).astype(np.uint16))
        step, tile = PAR_SERVE_FRAME[0] - PAR_OVERLAP, PAR_SERVE_FRAME[0]
        scene = bandlimited_scene((2 * step + tile,) * 2, rng, amp=1500.0, offset=6000.0)
        tiles = write("tiles.tif", np.stack([scene[y * step:y * step + tile, x * step:x * step + tile]
                                             for y in range(3) for x in range(3)]).astype(np.float32))
        dp_jobs = {
            "e_seg2d": ("segmentation_unet2d", {"model": "unet2d_cells", "localize": False}, [stack], 4),
            "e_flows": ("segment_flows", {"model": "flows_cells", "localize": False}, [inst], 4),
            "e_enhance": ("enhancement_gan", {"model": "gan_denoise"}, [stack], 4),
            "e_denoise": ("denoise", {"model": "n2v_cells"}, [noisy], 4),
            "e_localize": ("localize_emitters", {"max_peaks": 256}, [spots], 0),
            "e_localize3d": ("localize_emitters", {"dims": 3, "max_peaks": 256}, [spot_vols], 0),
            "e_astig": ("localize_emitters", {"astigmatism": calib, "threshold": 25.0, "max_peaks": 256}, [astig], 0),
            "e_deconvolve": ("deconvolve", {"iterations": 20}, [stack], 0),
            "e_register": ("register_stack", {"mode": "first"}, [drift_path], 0),
            "e_stitch": ("stitch_mosaic", {"grid": [3, 3], "overlap": PAR_OVERLAP, "backend": "device"}, [tiles], 0),
        }
        for name, (module, params, inputs, passes) in dp_jobs.items():
            one, wall1, peak1, _, _ = serve(f"{name}_1way", module, params, inputs, ways=1)
            dp, wall4, peak4, dev4, _ = serve(f"{name}_4way", module, dict(params, data_parallel=True), inputs,
                                              profile=True)
            if counts[f"par_{name}_4way"] != (passes, passes):
                raise AssertionError(f"({name}): histogram {counts[f'par_{name}_4way']}, expected {passes} passes")
            euler_want = _euler_want(module, params, passes)
            for way in ("1way", "4way"):
                if EULER_LAUNCHES[f"par_{name}_{way}"] != euler_want:
                    raise AssertionError(f"({name}) {way}: the Euler kernel launched "
                                         f"{EULER_LAUNCHES[f'par_{name}_{way}']} times, expected {euler_want}")
            gaps = []
            for key, path in one.items():
                if not isinstance(path, str) or not os.path.isfile(path):
                    continue
                if path.endswith(".tif"):
                    a, b = tiff.read_stack(path), tiff.read_stack(dp[key])
                    if module in ("register_stack", "stitch_mosaic"):
                        gap = float(np.abs(a.astype(np.float64) - b).max() / max(np.abs(a).max(), 1e-12))
                        gaps.append(f"{key} {gap:.3g} of the largest value")
                        if gap > PAR_PIXEL_REL:
                            raise AssertionError(f"({name}) {key}: 4 ways and 1 differ by {gap} relative")
                    elif a.tobytes() != b.tobytes():
                        raise AssertionError(f"({name}) {key}: 4 ways and 1 are not byte-equal")
                    else:
                        gaps.append(f"{key} byte-equal")
                elif path.endswith(".csv"):
                    geom = module in ("register_stack", "stitch_mosaic")
                    n_rows, gap = _csv_gap(np, path, dp[key], PAR_GEOM_PX if geom else PAR_CSV_UNIT,
                                           RESP_REL if geom else 0.0)
                    gaps.append(f"{key} {n_rows} rows, largest gap {gap:.3g}")
            print(f"parallel {name} data_parallel on {PAR_WAYS} ways against 1: {'; '.join(gaps)}; wall "
                  f"{wall4:.4f} s against {wall1:.4f} s, peak {peak4:.3f} GB against {peak1:.3f} GB, device "
                  f"{dev4:.4f} ms (profiled run)")

        # (f) finetune_spatial: unet2d_cells' architecture from one seeded init,
        # 2048x2048 frames, batch 1, 3 steps, 4 ways against 1. At f32 compute
        # every hold of the train phase. At bf16 compute (the serving dtype)
        # loss, accuracy and grad_norm at the train phase's bars, the weights
        # at PAR_FT_BF16_*_BAR, set between two readings printed each run:
        # the noise floor (1 way at bf16 against 1 way at f32: what bf16
        # rounding alone does to 3 steps) and a planted sharding fault (4
        # ways at bf16 with every halo row zeroed), which must part beyond
        # the bar
        arch = {k: v for k, v in fixtures.manifest()["unet2d_cells"]["config"].items()
                if k in ("depth", "base_features", "num_classes", "norm", "compute_dtype", "in_channels")}
        scenes = [synthetic.cells_frame(PAR_SEED + 40 + i, PAR_FT) for i in range(2)]
        ft_in = [write("ft_img.tif", np.stack([u16(s[0]) for s in scenes])),
                 write("ft_lab.tif", np.stack([s[1] for s in scenes]).astype(np.uint16))]
        cfg_ft = fixtures.config_class("unet")(**dict(fixtures.manifest()["unet2d_cells"]["config"]))
        start = convert.to_flat(unet_lib.init(cfg_ft, torch.Generator().manual_seed(3), device="cpu"))

        def zero_rows(row, j):
            top, bot = neighbor_rows(row, j)
            return torch.zeros_like(top), torch.zeros_like(bot)

        runs = [("float32", 1, "f32_1"), ("float32", PAR_WAYS, "f32_4"), ("bfloat16", 1, "bf16_1"),
                ("bfloat16", PAR_WAYS, "bf16_4"), ("bfloat16", PAR_WAYS, "bf16_4_zero_halo")]
        ft, trained = {}, {}
        for dtype, ways, tag in runs:
            params = dict(arch, model=f"ft_{tag}", steps=PAR_FT_STEPS, log_every=1,
                          learning_rate=TRAIN_LR, checkpoint_every=100, seed=3, compute_dtype=dtype)
            outs, wall, peak, _, _ = serve(f"f_finetune_{tag}", "finetune_spatial", params, ft_in, ways=ways,
                                           rows=zero_rows if tag.endswith("zero_halo") else neighbor_rows)
            with open(outs["metrics_file"]) as f:
                ft[tag] = ([json.loads(line) for line in f if '"train"' in line], wall, peak)
            cfg_d = dataclasses.replace(cfg_ft, compute_dtype=dtype)
            trained[tag] = convert.load_flat(cfg_d, read_model(models, f"ft_{tag}")[2], device="cpu")

        def steps_part(a_tag, b_tag):
            parted = []
            for a, b in zip(ft[a_tag][0], ft[b_tag][0]):
                print(f"parallel (f) {a_tag} against {b_tag} step {a['step']}: loss {a['loss']:.6f} / "
                      f"{b['loss']:.6f}, accuracy {a['accuracy']:.6f} / {b['accuracy']:.6f}, grad_norm "
                      f"{a['grad_norm']:.6f} / {b['grad_norm']:.6f}")
                if abs(a["loss"] - b["loss"]) > TRAIN_LOSS_RTOL * abs(b["loss"]) \
                        or abs(a["grad_norm"] - b["grad_norm"]) > TRAIN_GRAD_NORM_RTOL * abs(b["grad_norm"]) \
                        or abs(a["accuracy"] - b["accuracy"]) > 1e-3:
                    parted.append(a["step"])
            return parted

        def weights(a_tag, b_tag, what):
            rel, over, nulled, stats = _weights_vs(np, convert, trained[a_tag], trained[b_tag], start)
            print(f"parallel (f) weights {a_tag} against {b_tag} ({what}) after {PAR_FT_STEPS} steps: update L2 "
                  f"{rel:.6g}, share beyond lr/10 {over:.4g}, BN-nulled biases {nulled:.3g}, statistics "
                  f"{stats:.6g}; job wall {ft[a_tag][1]:.3f} s against {ft[b_tag][1]:.3f} s, peak "
                  f"{ft[a_tag][2]:.3f} GB against {ft[b_tag][2]:.3f} GB on {smi_line}")
            return rel, stats

        for dtype in ("f32", "bf16"):
            if steps_part(f"{dtype}_4", f"{dtype}_1"):
                raise AssertionError(f"(f) {dtype}: 4 ways and 1 part beyond the train phase's bars")
        rel, stats = weights("f32_4", "f32_1", f"held at {TRAIN_UPDATE_BAR} and {TRAIN_STATS_BAR}")
        if rel > TRAIN_UPDATE_BAR or stats > TRAIN_STATS_BAR:
            raise AssertionError(f"(f) f32 weights: 4 ways and 1 part beyond the train phase's bars ({rel}, {stats})")
        floor = weights("bf16_1", "f32_1", "the bf16 noise floor")
        rel, stats = weights("bf16_4", "bf16_1", f"held at {PAR_FT_BF16_UPDATE_BAR} and {PAR_FT_BF16_STATS_BAR}")
        fault = weights("bf16_4_zero_halo", "bf16_1", "the planted fault")
        fault_steps = steps_part("bf16_4_zero_halo", "bf16_1")
        print(f"parallel (f) bf16 weights: 4 ways against 1 update L2 {rel:.6g}, statistics {stats:.6g}; noise "
              f"floor {floor[0]:.6g}, {floor[1]:.6g}; planted fault {fault[0]:.6g}, {fault[1]:.6g} (steps beyond "
              f"the train bars: {fault_steps}); bars {PAR_FT_BF16_UPDATE_BAR}, {PAR_FT_BF16_STATS_BAR}")
        if rel > PAR_FT_BF16_UPDATE_BAR or stats > PAR_FT_BF16_STATS_BAR:
            raise AssertionError(f"(f) bf16 weights: 4 ways and 1 part beyond the bf16 bars ({rel}, {stats})")
        if not (fault[0] > PAR_FT_BF16_UPDATE_BAR or fault[1] > PAR_FT_BF16_STATS_BAR):
            raise AssertionError(f"(f) the planted fault (zeroed halos) stays within the bf16 bars: {fault}")
        # the step itself, timed outside the job: 1 warm-up, then 3 steps a way
        from sequitr_tpu_torch.parallel import spatial_train
        from sequitr_tpu_torch.pipeline import train

        tc = train.TrainConfig(learning_rate=TRAIN_LR, augment=False)
        batch = {"image": torch.from_numpy(np.stack([scenes[0][0]]).astype(np.float32)[..., None] / 4000.0).cuda(),
                 "labels": torch.from_numpy(scenes[0][1][None].astype(np.int64)).cuda()}
        step_ms = {}
        for ways in (1, PAR_WAYS):
            with parallel.virtual_devices(ways):
                state = train.create_unet_state(cfg_ft, tc, torch.Generator().manual_seed(3), "cuda")
                step = spatial_train.make_spatial_train_step(cfg_ft, tc, parallel.make_mesh(device="cuda"), PAR_FT, 1)
                state, _ = step(state, batch)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                for _ in range(3):
                    state, m = step(state, batch)
                torch.cuda.synchronize()
                step_ms[ways] = ((time.perf_counter() - t0) / 3 * 1e3, torch.cuda.max_memory_allocated() / 1e9)
            del state, step
        print(f"parallel (f) spatial train step 1x{PAR_FT[0]}x{PAR_FT[1]} (unet2d_cells' widths, bf16 compute): "
              f"1 way {step_ms[1][0]:.3f} ms (peak {step_ms[1][1]:.3f} GB), {PAR_WAYS} ways {step_ms[PAR_WAYS][0]:.3f} "
              f"ms (peak {step_ms[PAR_WAYS][1]:.3f} GB): ratio x{step_ms[PAR_WAYS][0] / step_ms[1][0]:.3f} on {smi_line}")

        # (g) train_unet2d, data_parallel: batch 8 on 4 ways against 1 (global
        # batch-norm statistics), 3 steps
        cells = [synthetic.cells_frame(PAR_SEED + 50 + i, PAR_RECORD) for i in range(8)]
        rec_in = [write("rec_img.tif", np.stack([u16(c[0]) for c in cells])),
                  write("rec_lab.tif", np.stack([c[1] for c in cells]).astype(np.uint16))]
        recs, *_ = serve("g_records", "build_records", {"weight_maps": False}, rec_in, ways=1)
        tr = {}
        for ways in (1, PAR_WAYS):
            # f32 compute: the train phase's bars are f32 bars, at which a
            # per-replica batch norm would stand out by orders of magnitude
            params = dict(arch, model=f"tr_{ways}", steps=3, batch_size=8, log_every=1, augment=False,
                          learning_rate=TRAIN_LR, seed=5, data_parallel=True, compute_dtype="float32")
            outs, wall, peak, _, _ = serve(f"g_train_{ways}way", "train_unet2d", params, [recs["shards"]], ways=ways)
            with open(outs["metrics_file"]) as f:
                tr[ways] = [json.loads(line) for line in f if '"train"' in line]
        for a, b in zip(tr[PAR_WAYS], tr[1]):
            print(f"parallel (g) step {a['step']}: loss {a['loss']:.6f} / {b['loss']:.6f}, grad_norm "
                  f"{a['grad_norm']:.6f} / {b['grad_norm']:.6f} (4 ways / 1)")
            if abs(a["loss"] - b["loss"]) > TRAIN_LOSS_RTOL * abs(b["loss"]) \
                    or abs(a["grad_norm"] - b["grad_norm"]) > TRAIN_GRAD_NORM_RTOL * abs(b["grad_norm"]):
                raise AssertionError(f"(g) step {a['step']}: 4 ways and 1 part beyond the train phase's bars")
        cfg_tr = dataclasses.replace(cfg_ft, compute_dtype="float32")  # (g) trains at f32
        start = convert.to_flat(unet_lib.init(cfg_tr, torch.Generator().manual_seed(5), device="cpu"))
        trained = {w: convert.load_flat(cfg_tr, read_model(models, f"tr_{w}")[2], device="cpu") for w in (1, PAR_WAYS)}
        rel, over, nulled, stats = _weights_vs(np, convert, trained[PAR_WAYS], trained[1], start)
        print(f"parallel (g) weights 4 ways against 1: update L2 {rel:.4g}, share beyond lr/10 {over:.4g}, "
              f"BN-nulled biases {nulled:.3g}, statistics (global batch) {stats:.3g}")
        if rel > TRAIN_UPDATE_BAR or stats > TRAIN_STATS_BAR:
            raise AssertionError(f"(g) weights: 4 ways and 1 part beyond the train phase's bars ({rel}, {stats})")

        # (i) the same job with polyphase: the phase-domain training forward
        # shard by shard, its batch norms over the global batch
        tp = {}
        for ways in (1, PAR_WAYS):
            params = dict(arch, model=f"trp_{ways}", steps=3, batch_size=8, log_every=1, augment=False,
                          learning_rate=TRAIN_LR, seed=5, data_parallel=True, polyphase=True,
                          compute_dtype="float32")
            outs, wall, peak, _, _ = serve(f"i_train_poly_{ways}way", "train_unet2d", params, [recs["shards"]],
                                           ways=ways)
            with open(outs["metrics_file"]) as f:
                tp[ways] = [json.loads(line) for line in f if '"train"' in line]
            print(f"parallel (i) train_unet2d polyphase data_parallel f32 {ways} way(s): {wall:.3f} s wall, "
                  f"peak {peak:.3f} GB")
        for a, b in zip(tp[PAR_WAYS], tp[1]):
            print(f"parallel (i) step {a['step']}: loss {a['loss']:.7f} / {b['loss']:.7f}, grad_norm "
                  f"{a['grad_norm']:.7f} / {b['grad_norm']:.7f} (4 ways / 1)")
            if abs(a["loss"] - b["loss"]) > PAR_POLY_LOSS_RTOL * abs(b["loss"]) \
                    or abs(a["grad_norm"] - b["grad_norm"]) > TRAIN_GRAD_NORM_RTOL * abs(b["grad_norm"]):
                raise AssertionError(f"(i) step {a['step']}: 4 ways and 1 part beyond the bars")
        if len(tp[PAR_WAYS]) != 3 or len(tp[1]) != 3:
            raise AssertionError(f"(i): {len(tp[PAR_WAYS])} and {len(tp[1])} train rows, not 3")
        trained = {w: convert.load_flat(cfg_tr, read_model(models, f"trp_{w}")[2], device="cpu") for w in (1, PAR_WAYS)}
        rel, over, nulled, stats = _weights_vs(np, convert, trained[PAR_WAYS], trained[1], start)
        print(f"parallel (i) polyphase weights 4 ways against 1: update L2 {rel:.4g}, share beyond lr/10 "
              f"{over:.4g}, BN-nulled biases {nulled:.3g}, statistics (global batch) {stats:.3g}")
        if rel > TRAIN_UPDATE_BAR or stats > PAR_POLY_STATS_BAR:
            raise AssertionError(f"(i) weights: 4 ways and 1 part beyond the bars ({rel}, {stats})")
        # (i) the polyphase step's wall ms at 1 way and 4 (batch 8, 2 a shard),
        # and at 1 way on batch 2: a shard's batch on the card alone, which
        # parts cuDNN's choice at N = 2 from the sharded path
        from functools import partial

        tc_poly = train.TrainConfig(learning_rate=TRAIN_LR, augment=False, polyphase=True)
        batch_p = {"image": torch.from_numpy(np.stack([c[0] for c in cells]).astype(np.float32)[..., None] / 4000.0).cuda(),
                   "labels": torch.from_numpy(np.stack([c[1] for c in cells]).astype(np.int64)).cuda()}
        step_ms = {}
        for ways, nb in ((1, len(cells)), (1, len(cells) // PAR_WAYS), (PAR_WAYS, len(cells))):
            with parallel.virtual_devices(ways):
                state = train.create_unet_state(cfg_tr, tc_poly, torch.Generator().manual_seed(5), "cuda")
                make = partial(train.make_unet_train_step, cfg_tr, tc_poly)
                step = parallel.make_dp_train_step(make, parallel.make_mesh(device="cuda")) if ways > 1 else make()
                b = {k: v[:nb] for k, v in batch_p.items()}
                state, _ = step(state, b)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(3):
                    state, _ = step(state, b)
                torch.cuda.synchronize()
                step_ms[ways, nb] = (time.perf_counter() - t0) / 3 * 1e3
            del state, step
        print("parallel (i) polyphase f32 step wall ms, " + ", ".join(
            f"{ways} way(s) batch {nb}: {ms:.3f}" for (ways, nb), ms in step_ms.items())
            + f"; {PAR_WAYS} ways / 1 at batch {len(cells)} x{step_ms[PAR_WAYS, len(cells)] / step_ms[1, len(cells)]:.3f}"
            + f" on {smi_line}")

        # (h) a mesh of two distinct devices, cuda:0 and the CPU: the weight
        # copies (mesh.replica, spatial_train._Placed), the cross-device halo
        # exchanges, gathers and gradient returns of a multi-card pool, which
        # the virtual pool above makes within one device. unet2d_cells at f32
        # compute; the normalize is the histogram's 1024 bins on both (the
        # kernel on the card, its plain version on the CPU). Each output held
        # against the card alone at the model phase's card-vs-CPU bar, each
        # step and the weights at the train phase's
        from functools import partial

        mixed = np.empty(2, dtype=object)
        mixed[:] = [torch.device("cuda", 0), torch.device("cpu")]
        mesh_x = parallel.Mesh(mixed, ("data",), torch.device("cuda", 0))
        _, cfg32, m32, _ = fixtures.load("unet2d_cells", compute_dtype="float32", device="cuda")
        tc_x = infer.TileConfig(patch=PAR_MIXED, overlap=(0, 0), normalize="pallas")
        copies = []
        real_copy = parallel.mesh._copy_to
        parallel.mesh._copy_to = lambda m, d: copies.append(str(d)) or real_copy(m, d)
        try:
            frames_x = np.stack([u16(synthetic.cells_frame(PAR_SEED + 60 + i, PAR_MIXED)[0]) for i in range(2)])
            with torch.inference_mode():
                xn = infer._normalize(torch.as_tensor(frames_x[:1], device="cuda")[..., None], tc_x)[0, ..., 0]
            got = spatial.spatial_unet2d_infer(cfg32, mesh_x, PAR_MIXED)(m32, xn)
            with parallel.virtual_devices(2):
                want = spatial.spatial_unet2d_infer(cfg32, parallel.make_mesh(device="cuda"), PAR_MIXED)(m32, xn)
            make = lambda d: infer.cached_batch_inferrer(cfg32, tc_x, PAR_MIXED, 1, d)
            got_dp = parallel.make_dp_frame_inferrer(make, mesh_x)(m32, frames_x)
            one = make("cuda")
            want_dp = [torch.cat(t) for t in zip(*[one(m32, frames_x[i:i + 1]) for i in range(2)])]
            for what, (gp, gl), (wp, wl) in (("spatial 2-way", got, want), ("data-parallel", got_dp, want_dp)):
                if gp.device != torch.device("cuda", 0):
                    raise AssertionError(f"(h) {what}: gathered on {gp.device}, not the job's device")
                err = float((gp - wp).abs().max())
                gl, wl = gl.cpu().numpy(), wl.cpu().numpy()
                m = fidelity.miou(gl.astype(np.int64), wl.astype(np.int64), 3)
                print(f"parallel (h) {what} {PAR_MIXED[0]}x{PAR_MIXED[1]} f32 on cuda:0 + cpu against the card alone: "
                      f"max |prob diff| {err:.3g} (bar {PAR_MIXED_PROB_BAR}), miou {m:.6f}, pixel agreement "
                      f"{float(np.mean(gl == wl)):.6f}")
                if not (err <= PAR_MIXED_PROB_BAR and m >= MIOU_BAR):
                    raise AssertionError(f"(h) {what}: the mixed mesh parts from the card ({err}, {m})")
            if sorted(set(copies)) != ["cpu"]:
                raise AssertionError(f"(h) serving copied the weights to {copies}, not once to the CPU")

            from sequitr_tpu_torch.parallel import spatial_train
            from sequitr_tpu_torch.pipeline import train

            tc_t = train.TrainConfig(learning_rate=TRAIN_LR, augment=False)
            cells_x = [synthetic.cells_frame(PAR_SEED + 70 + i, PAR_RECORD) for i in range(2)]
            batch_x = {
                "image": torch.from_numpy(np.stack([c[0] for c in cells_x]).astype(np.float32)[..., None] / 4000.0).cuda(),
                "labels": torch.from_numpy(np.stack([c[1] for c in cells_x]).astype(np.int64)).cuda(),
            }
            steps_x = {
                "data-parallel": parallel.make_dp_train_step(partial(train.make_unet_train_step, cfg32, tc_t), mesh_x),
                "spatial 2-way": spatial_train.make_spatial_train_step(cfg32, tc_t, mesh_x, PAR_RECORD, 2),
            }
            ref_step = train.make_unet_train_step(cfg32, tc_t)
            for what, step_x in steps_x.items():
                sx, sr = (train.create_unet_state(cfg32, tc_t, torch.Generator().manual_seed(9), "cuda") for _ in "xr")
                start_x = convert.to_flat(sr.model)
                for i in range(3):
                    sx, a = step_x(sx, batch_x)
                    sr, b = ref_step(sr, batch_x)
                    a, b = ({k: float(v) for k, v in m.items()} for m in (a, b))
                    print(f"parallel (h) {what} train step {i + 1} on cuda:0 + cpu against the card alone: loss "
                          f"{a['loss']:.6f} / {b['loss']:.6f}, accuracy {a['accuracy']:.6f} / {b['accuracy']:.6f}, "
                          f"grad_norm {a['grad_norm']:.6f} / {b['grad_norm']:.6f}")
                    if abs(a["loss"] - b["loss"]) > TRAIN_LOSS_RTOL * abs(b["loss"]) \
                            or abs(a["grad_norm"] - b["grad_norm"]) > TRAIN_GRAD_NORM_RTOL * abs(b["grad_norm"]) \
                            or abs(a["accuracy"] - b["accuracy"]) > 1e-3:
                        raise AssertionError(f"(h) {what} step {i + 1}: the mixed mesh parts from the card")
                rel, over, nulled, stats = _weights_vs(np, convert, sx.model, sr.model, start_x)
                print(f"parallel (h) {what} weights on cuda:0 + cpu against the card alone after 3 steps: update L2 "
                      f"{rel:.4g}, share beyond lr/10 {over:.4g}, BN-nulled biases {nulled:.3g}, statistics "
                      f"{stats:.3g} (bars {TRAIN_UPDATE_BAR}, {TRAIN_STATS_BAR})")
                if rel > TRAIN_UPDATE_BAR or stats > TRAIN_STATS_BAR:
                    raise AssertionError(f"(h) {what} weights: the mixed mesh parts from the card ({rel}, {stats})")
        finally:
            parallel.mesh._copy_to = real_copy
    return counts


QUANT_PTQ_FRAME = (1024, 1024)  # the PTQ forward's frame: the served shape
QUANT_CALIB_FRAMES = 4  # normalized cells_frames, one a calibration batch
QUANT_PTQ_SEED = 535_000
QUANT_AGREE_BAR = 0.98  # int8 labels against the f32 folded forward's (tests/test_studies.py)
QUANT_ITERS = 16  # calls in a timed CUDA graph (int8_conv, roofline)
# ragged and odd shapes for qconv against its plain version: (x shape, w shape, transposed)
QCONV_CASES = [
    ((2, 37, 53, 7), (3, 3, 7, 5), False),
    ((1, 33, 65, 33), (3, 3, 33, 17), False),
    ((1, 1024, 1024, 32), (1, 1, 32, 3), False),  # the head
    ((1, 128, 128, 256), (2, 2, 256, 128), True),  # dec2's up-conv
    ((1, 31, 29, 12), (2, 2, 12, 8), True),
    ((1, 9, 23, 31, 5), (3, 3, 3, 5, 6), False),
    ((2, 8, 16, 16, 16), (3, 3, 3, 16, 32), False),
    ((1, 5, 11, 13, 9), (1, 1, 1, 9, 4), False),
    ((1, 4, 8, 8, 32), (2, 2, 2, 32, 16), True),
]


def quant_phase(torch, qk, hist, smi_line):
    """The int8 kernel and the quantization studies (docstring item 21).
    Returns the ``qconv`` entry of the ``kernels`` line and the quantile
    passes of the PTQ path (normalize, calibrate, the int8 forward)."""
    import numpy as np

    from sequitr_tpu_torch.data import synthetic
    from sequitr_tpu_torch.models import fixtures
    from sequitr_tpu_torch.models import unet as unet_lib
    from sequitr_tpu_torch.pipeline import infer
    from sequitr_tpu_torch.studies import int8_conv, ptq_unet, roofline

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(QUANT_PTQ_SEED)

    def ints(shape):
        return torch.as_tensor(rng.integers(-127, 128, size=shape).astype(np.int8), device="cuda")

    errs = []  # |kernel - plain version| at every hold, each output as its own type

    def gap(got, want):
        return float((got.to(torch.float64) - want.to(torch.float64)).abs().max())

    def hold(what, x, w, transpose=False):
        """Every epilogue of ``qconv`` against the plain version on the card."""
        c_out = w.shape[-1]
        scale = torch.as_tensor(rng.uniform(1e-5, 1e-3, c_out).astype(np.float32), device="cuda")
        bias = torch.as_tensor(rng.normal(0, 0.5, c_out).astype(np.float32), device="cuda")
        got = qk.qconv(x, w, transpose)
        want = qk.qconv_reference(x, w, transpose)
        errs.append(gap(got, want))
        if not torch.equal(got, want):
            raise AssertionError(f"qconv {what}: int32 sums differ by {int((got - want).abs().max())}")
        for epi, relu, inv in (("dequant", False, None), ("dequant", True, None), ("requant", True, 25.0)):
            g = qk.qconv(x, w, transpose, epi, scale, bias, relu, inv)
            r = qk.qconv_reference(x, w, transpose, epi, scale, bias, relu, inv)
            errs.append(gap(g, r))
            same = torch.equal(g.view(torch.int32), r.view(torch.int32)) if epi == "dequant" else torch.equal(g, r)
            if not same:
                raise AssertionError(f"qconv {what}: the {epi} epilogue (relu={relu}) is not bit-equal")
        return int(want.abs().max())

    t0 = time.perf_counter()
    for label, spatial, cin, cout in int8_conv.SHAPES:
        big = hold(label, ints((1, *spatial, cin)), ints((3, 3, cin, cout)))
        print(f"quant qconv {label}: int32 equal to the plain version (largest |sum| {big}), epilogues bit-equal")
    for xs, ws, tr in QCONV_CASES:
        hold(f"x {xs} w {ws}{' transposed' if tr else ''}", ints(xs), ints(ws), tr)
    print(f"quant qconv: {len(QCONV_CASES)} ragged, 3D, transposed and head shapes equal to the plain version "
          f"(largest gap over {len(errs)} outputs {max(errs)}; {time.perf_counter() - t0:.1f} s for all checks)")

    # the study rows at the U-Net's conv shapes, CUDA-graph timed
    rows = int8_conv.run(iters=QUANT_ITERS, device="cuda")
    for r in rows:
        print(f"quant int8_conv {r['shape']}: bf16 {r['bf16_ms']:.5f} ms, int8 {r['int8_ms']:.5f} ms "
              f"(x{r['speedup_raw']:.3f}), ptq layer {r['ptq_layer_ms']:.5f} ms (x{r['speedup_ptq']:.3f}), "
              f"_int_mm {r['int_mm_ms'] if r['int_mm_ms'] is None else round(r['int_mm_ms'], 5)} ms, bound "
              f"{r['bound_ms']:.5f} / {r['bound_ptq_ms']:.5f} ms ({r['bound_by']}) on {smi_line}")
    troof, summary = roofline.run(size=QUANT_PTQ_FRAME[0], iters=QUANT_ITERS, device="cuda")
    for r in troof:
        print(f"quant roofline {r['stage']}: {r['ms']:.5f} ms, {r['gflop']} GFLOP, {r['tflops']:.3f} TFLOP/s, "
              f"ceiling {r['ceiling_ms']:.5f} ms ({r['pct_of_ceiling']:.1f}%)")
    print(f"quant roofline total: sliced {summary['ms']:.5f} ms, whole inferrer {summary['fused_ms']:.5f} ms "
          f"(coverage {summary['coverage_pct']:.1f}%), {summary['gflop']} GFLOP, sliced chain's labels "
          f"{summary['chain_argmax_agreement']:.6f} of the forward's, on {smi_line}")
    if summary["chain_argmax_agreement"] != 1.0:
        raise AssertionError("roofline: the sliced chain parts from the forward")

    # PTQ of the folded unet2d_cells on normalized cells_frames: the main
    # path, every count set to 0 just before it and read just after
    tc = infer.TileConfig(patch=QUANT_PTQ_FRAME, overlap=(0, 0))
    frames = [synthetic.cells_frame(QUANT_PTQ_SEED + i, QUANT_PTQ_FRAME)[0] for i in range(QUANT_CALIB_FRAMES + 1)]
    _, _, model32, _ = fixtures.load("unet2d_cells", compute_dtype="float32", device="cuda")
    torch.cuda.synchronize()
    hist.histogram_2d.launches = 0
    hist.quantile_pass.launches = 0
    qk.qconv.launches = 0
    with torch.inference_mode():
        normed = [infer._normalize(torch.as_tensor(f[None, ..., None].astype(np.float32), device="cuda"), tc)
                  for f in frames]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qcfg, qparams = ptq_unet.quantize(model32, normed[:QUANT_CALIB_FRAMES])
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    x = normed[-1]
    with torch.inference_mode():
        logits_q = ptq_unet.apply(qcfg, qparams, x)
        torch.cuda.synchronize()
    launches = qk.qconv.launches
    passes = (hist.histogram_2d.launches, hist.quantile_pass.launches)
    want_launches = 2 * qcfg.depth + 3 * (qcfg.depth - 1) + 1
    if launches != want_launches:
        raise AssertionError(f"the int8 forward launched qconv {launches} times, not {want_launches}")
    if passes != (len(frames), len(frames)):
        raise AssertionError(f"the PTQ path ran {passes} quantile passes, not one a frame ({len(frames)})")
    t0 = time.perf_counter()
    logits_cpu = ptq_unet.apply(qcfg, ptq_unet._map_tree(lambda t: t.cpu(), qparams), x.cpu())
    cpu_s = time.perf_counter() - t0
    if not torch.equal(logits_q.cpu().view(torch.int32), logits_cpu.view(torch.int32)):
        raise AssertionError(f"the card's int8 logits part from the CPU port's by "
                             f"{float((logits_q.cpu() - logits_cpu).abs().max())}")
    folded32 = unet_lib.fold_batchnorm(model32)
    with torch.inference_mode():
        logits_f = folded32(x)
        agree = float((torch.argmax(logits_q, -1) == torch.argmax(logits_f, -1)).float().mean())
        diff = (logits_q - logits_f).abs()
        err = float(diff.max())
        err_q = float(torch.quantile(diff.reshape(-1)[:: max(1, diff.numel() // 2**24)], 0.9999))
        ref = float(logits_f.abs().max())
        _, _, bf16_model, _ = fixtures.load("unet2d_cells", device="cuda")
        bf16_model = unet_lib.fold_batchnorm(bf16_model)
        int8_ms = _median_ms(lambda: ptq_unet.apply(qcfg, qparams, x), n=20)
        bf16_ms = _median_ms(lambda: bf16_model(x), n=20)
        f32_ms = _median_ms(lambda: folded32(x), n=20)
    size = f"{QUANT_PTQ_FRAME[0]}x{QUANT_PTQ_FRAME[1]}"
    print(f"quant ptq unet2d_cells: quantize (fold + calibrate on {QUANT_CALIB_FRAMES} normalized {size} "
          f"cells_frames) {quant_s:.2f} s; the int8 forward {size}: "
          f"{launches} qconv launches, {passes[1]} quantile passes (one a normalized frame), logits bit-equal to "
          f"the CPU port's ({cpu_s:.1f} s there), labels "
          f"{agree:.6f} of the f32 folded forward's (bar {QUANT_AGREE_BAR}), |logit diff| max {err:.4g}, 99.99th "
          f"percentile {err_q:.4g} (largest |logit| {ref:.4g})")
    print(f"quant ptq forward {size}: int8 {int8_ms:.4f} ms, bf16 {bf16_ms:.4f} ms (x{bf16_ms / int8_ms:.3f}), "
          f"f32 {f32_ms:.4f} ms, on {smi_line}")
    if agree < QUANT_AGREE_BAR:
        raise AssertionError(f"the int8 forward's labels part from the f32 forward's ({agree})")

    # the kernel's entry, at enc0b (1024x1024, 32 -> 32, int32 out)
    label, spatial, cin, cout = int8_conv.SHAPES[1]
    xb, wb = ints((1, *spatial, cin)), ints((3, 3, cin, cout))
    ms = _median_ms(lambda: qk.qconv(xb, wb), n=50)
    plain_ms = _median_ms(lambda: qk.qconv_reference(xb, wb), n=10)
    bound, bound_by = int8_conv.bound_ms(spatial, cin, cout, 4)
    enc0b = rows[1]
    entry = {
        "name": "qconv",
        "route": "cuda",
        "source": "sequitr_tpu_torch/csrc/qconv.cu",
        "replaces": "none: XLA's int8 conv (sequitr_tpu/studies/ptq_unet.py:75, sequitr_tpu/studies/int8_conv.py:63)",
        "launches": launches,
        "max_abs_err": max(errs),
        "ms": ms,
        "kernel_ms": enc0b["int8_ms"],
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": bound_by,
        "library_ms": enc0b["int_mm_ms"],
        "shape": label,
        "ptq_forward_ms": int8_ms,
        "bf16_forward_ms": bf16_ms,
        "label_agreement": agree,
    }
    print(f"quant qconv {label} int32 out: {ms:.5f} ms as called, {enc0b['int8_ms']:.5f} ms in a CUDA graph, "
          f"plain {plain_ms:.5f} ms, im2col + _int_mm {enc0b['int_mm_ms']} ms, bound {bound:.5f} ms ({bound_by}) "
          f"on {smi_line}")
    return entry, passes


FIXTURES_BUDGET_S = 45.0  # the fixtures phase, factory and serve together
FIXTURES_FRAME = (1024, 1024)  # the served frame: the serve phase's shape
FIXTURES_SEED = 454_000
FIXTURES_COMMITTED_DB = 1.0  # a committed fixture's PSNR by the factory's scorer against its manifest (the margin)


def fixtures_phase(torch, hist, conv, smi_line):
    """The fixture factory at ``--quick`` on the card (docstring item 22).
    Returns {"fixtures_serve": (histogram_2d launches, quantile passes)} of
    the quick teacher's served frame."""
    import numpy as np

    from sequitr_tpu_torch.config import ServerConfiguration
    from sequitr_tpu_torch.data import synthetic, tiff
    from sequitr_tpu_torch.models import fixtures, gan
    from sequitr_tpu_torch.server import ImageServer, submit_job
    from sequitr_tpu_torch.server.server import save_model
    from sequitr_tpu_torch.tools import make_fixtures

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "fixtures")
        rows = make_fixtures.main(["--out", out, "--quick", "--device", "cuda"])
        factory_s = time.perf_counter() - t0
        want = ["unet2d_cells", "unet2d_cells_fast", "unet2d_cells_fast4", "unet3d_cells", "gan_denoise",
                "n2v_cells", "flows_cells", "stars_cells"]
        if [r["fixture"] for r in rows] != want or fixtures.names(out) != sorted(want):
            raise AssertionError(f"the factory wrote {fixtures.names(out)}")
        for r in rows:
            print(f"fixtures {r['fixture']} (--quick, bf16): {r['steps']} steps in {r['wall_s']:.2f} s, median "
                  f"step {r['step_ms']:.2f} ms, holdout {json.dumps(r['metrics'])} (committed full run "
                  f"{json.dumps(r['committed'])}) on {smi_line}")
            if not all(np.isfinite(v) for v in r["metrics"].values()):
                raise AssertionError(f"fixture {r['fixture']}: a holdout metric is not finite")
        steps = {r["fixture"]: r["steps"] for r in rows}
        for name in want:
            kind, cfg, model, meta = fixtures.load(name, device="cuda", directory=out)
            if cfg.compute_dtype != "bfloat16" or meta["recipe"]["steps"] != steps[name]:
                raise AssertionError(f"fixture {name}: stored {cfg.compute_dtype}, {meta['recipe']}")
            spatial = (16, 64, 64) if getattr(cfg, "dims", 2) == 3 else (256, 256)
            x = torch.rand((1, *spatial, 1), device="cuda")
            with torch.inference_mode():
                y = gan.generator_apply(model, x) if kind == "gan" else model(x)
            if not torch.isfinite(y).all():
                raise AssertionError(f"fixture {name}: the loaded model's output is not finite")

        # the factory's scorers on the committed GAN and N2V weights at bf16 on
        # the card, against what the manifest recorded for them
        for name, score in (("gan_denoise", make_fixtures._eval_gan), ("n2v_cells", make_fixtures._eval_n2v)):
            _, _, model, meta = fixtures.load(name, device="cuda")
            got = score(model, torch.device("cuda"))
            got = got if isinstance(got, float) else got[0]
            print(f"fixtures committed {name} scored by the factory at bf16: holdout_psnr {got:.4f} dB "
                  f"(manifest {meta['holdout_psnr']}) on {smi_line}")
            if abs(got - meta["holdout_psnr"]) > FIXTURES_COMMITTED_DB:
                raise AssertionError(f"the committed {name} scores {got} dB, not its manifest's "
                                     f"{meta['holdout_psnr']}")

        # the quick teacher served as job (a) serves the committed one
        jobs, models = os.path.join(tmp, "jobs"), os.path.join(tmp, "models")
        kind, cfg, model, _ = fixtures.load("unet2d_cells", device="cpu", directory=out)
        save_model(models, "quick_teacher", kind, cfg, model)
        frame = synthetic.cells_frame(FIXTURES_SEED, FIXTURES_FRAME)[0].clip(0, 65535).astype(np.uint16)
        path = os.path.join(tmp, "frame.tif")
        tiff.write_stack(path, frame[None])
        server = ImageServer(ServerConfiguration(jobs_dir=jobs, models_dir=models, device="cuda"))
        submit_job(jobs, {
            "module": "segmentation_unet2d", "params": {"model": "quick_teacher", "localize": False},
            "input": [path], "output": os.path.join(tmp, "out"),
        })
        torch.cuda.synchronize()
        hist.histogram_2d.launches = 0
        hist.quantile_pass.launches = 0
        conv.conv3x3_nhwc.launches = 0
        conv.conv3x3_flat_chw.launches = 0
        _euler().launches = 0
        if not server.poll_once():
            raise AssertionError("fixtures: no job to run")
        torch.cuda.synchronize()
        counts = (hist.histogram_2d.launches, hist.quantile_pass.launches)
        conv_launches = conv.conv3x3_nhwc.launches + conv.conv3x3_flat_chw.launches
        _euler_read("fixtures_serve", 0)
        with open(os.path.join(tmp, "out", "status.json")) as f:
            status = json.load(f)
        if status["state"] != "complete":
            raise AssertionError(f"fixtures: the quick teacher's job failed: {status.get('error')}")
        labels = tiff.read_stack(status["outputs"]["labels"])
        if labels.shape[-2:] != FIXTURES_FRAME or labels.dtype != np.uint16 or int(labels.max()) > 2:
            raise AssertionError(f"fixtures: labels {labels.shape} {labels.dtype} max {labels.max()}")
        if counts != (1, 1) or conv_launches:
            raise AssertionError(f"fixtures: {counts} histogram launches / passes and {conv_launches} conv "
                                 "launches serving one frame, not (1, 1) and 0")
    elapsed = time.perf_counter() - t0
    print(f"fixtures: the factory (8 recipes, --quick) {factory_s:.2f} s, with the loads and the served frame "
          f"{elapsed:.2f} s (budget {FIXTURES_BUDGET_S} s); the quick teacher's job: histogram_2d launches "
          f"{counts[0]} in {counts[1]} quantile passes, labels {labels.shape} on {smi_line}")
    if elapsed > FIXTURES_BUDGET_S:
        raise AssertionError(f"the fixtures phase took {elapsed:.1f} s, over its {FIXTURES_BUDGET_S} s budget")
    return {"fixtures_serve": counts}


def params_summary(params):
    return {k: v for k, v in params.items() if k != "localize"}


PHASES = (
    "histogram", "conv", "studies", "model", "polyphase", "volume", "enhance", "profile", "instances",
    "serve", "evaluate", "train", "gan_train", "family_train", "geometry", "optics", "quantify", "ops",
    "parallel", "quant", "fixtures",
)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Smoke test of sequitr_tpu_torch on one CUDA card.")
    parser.add_argument(
        "--phases", default=None,
        help=f"comma-separated subset of {', '.join(PHASES)}: run only these, print no result",
    )
    args = parser.parse_args(argv)
    phases = args.phases.split(",") if args.phases else None
    if phases and set(phases) - set(PHASES):
        parser.error(f"unknown phase in {args.phases!r}")
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
        from sequitr_tpu_torch.ops.kernels import qconv as qk
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

    names = ("histogram", "conv3x3", "qconv", "flows")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        logs = list(pool.map(lambda name: build.build(name, force=True), names))
    print(f"build: {', '.join(names)} in {time.perf_counter() - t0:.2f} s")
    for name, log in zip(names, logs):
        for line in log.splitlines():
            if "ptxas info" in line or "spill" in line:
                print(f"build {name}: {line.strip()}")

    if phases is not None:
        run = {
            "histogram": lambda: kernel_phase(torch, hist),
            "conv": lambda: conv_kernel_phase(torch, conv),
            "studies": lambda: studies_phase(torch, fixtures, unet, conv),
            "model": lambda: model_phase(torch, fixtures, unet),
            "polyphase": lambda: polyphase_phase(torch, fixtures, unet),
            "volume": lambda: volume_phase(torch, fixtures, unet),
            "enhance": lambda: enhance_phase(torch, fixtures, unet),
            "profile": lambda: profile_phase(torch, fixtures, unet),
            "instances": lambda: instances_phase(torch, smi_line),
            "serve": lambda: serve_phase(torch, hist, conv, smi_line),
            "evaluate": lambda: evaluate_phase(torch, hist, conv, smi_line),
            "train": lambda: train_phase(torch, hist, conv, smi_line),
            "gan_train": lambda: gan_train_phase(torch, hist, conv, smi_line),
            "family_train": lambda: family_train_phase(torch, hist, conv, smi_line),
            "geometry": lambda: geometry_phase(torch, hist, conv, smi_line),
            "optics": lambda: optics_phase(torch, hist, conv, smi_line),
            "quantify": lambda: quantify_phase(torch, hist, conv, smi_line),
            "ops": lambda: ops_phase(torch, hist, conv, smi_line),
            "parallel": lambda: parallel_phase(torch, hist, conv, smi_line),
            "quant": lambda: quant_phase(torch, qk, hist, smi_line),
            "fixtures": lambda: fixtures_phase(torch, hist, conv, smi_line),
        }
        for name in phases:
            run[name]()
        print(f"chip_smoke: ran only {', '.join(phases)}; no result line")
        return 0

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(torch, *args)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s")
        return out

    entry = timed("histogram", kernel_phase, hist)
    conv_entries = timed("conv", conv_kernel_phase, conv)
    studies_launches = timed("studies", studies_phase, fixtures, unet, conv)
    timed("model", model_phase, fixtures, unet)
    timed("polyphase", polyphase_phase, fixtures, unet)
    timed("volume", volume_phase, fixtures, unet)
    timed("enhance", enhance_phase, fixtures, unet)
    timed("profile", profile_phase, fixtures, unet)
    euler_entry = timed("instances", instances_phase, smi_line)
    counts = timed("serve", serve_phase, hist, conv, smi_line)
    evaluated = timed("evaluate", evaluate_phase, hist, conv, smi_line)
    counts.update({f"eval_{k}": v for k, v in evaluated.items()})
    counts.update(timed("train", train_phase, hist, conv, smi_line))
    counts.update(timed("gan_train", gan_train_phase, hist, conv, smi_line))
    counts.update(timed("family_train", family_train_phase, hist, conv, smi_line))
    counts.update(timed("geometry", geometry_phase, hist, conv, smi_line))
    counts.update(timed("optics", optics_phase, hist, conv, smi_line))
    counts.update(timed("quantify", quantify_phase, hist, conv, smi_line))
    counts.update(timed("ops", ops_phase, hist, conv, smi_line))
    counts.update(timed("parallel", parallel_phase, hist, conv, smi_line))
    qconv_entry, counts["ptq_path"] = timed("quant", quant_phase, qk, hist, smi_line)
    counts.update(timed("fixtures", fixtures_phase, hist, conv, smi_line))
    entry["launches"] = counts["a"][0]
    entry["launches_by_job"] = {job: c[0] for job, c in counts.items()}
    entry["passes_by_job"] = {job: c[1] for job, c in counts.items()}
    if entry["launches"] < 1:
        raise AssertionError("histogram_2d was not launched on the main path")
    for e in conv_entries:
        e["launches"] = studies_launches[e["name"]]
    euler_entry["launches"] = EULER_LAUNCHES["j"]
    euler_entry["launches_by_job"] = dict(EULER_LAUNCHES)
    print(
        "kernels: histogram_2d launches are those of served job a (launches_by_job: every "
        "served job's, each counted on its own; job h normalizes with 'none' and runs no "
        "pass; jobs j-m are segment_flows (Euler, doubling), segment_stars (polyphase) and the "
        "3D segment_flows; the training jobs build_records, train_unet2d (standard and polyphase) "
        "and train_unet3d normalize on the host and run none; serve_trained and "
        "serve_trained_polyphase are the trained models' 4-frame jobs; eval_* are the evaluate "
        "phase's jobs and their serving twins: evaluate_gan and evaluate_denoise with the kernel "
        "normalize run one pass a frame for each side, parity_check none; build_gan_pairs and "
        "train_gan run none, the trained GAN's serve and evaluation one a batch of 8 frames a side; "
        "train_n2v (2D, 3D), train_flows (2D, 3D) and train_stars run none, the trained models' "
        "serves one a frame or volume, evaluate_denoise two a frame, evaluate_flows and "
        "evaluate_stars one a frame); geom_* are the geometry phase's register_stack, "
        "stitch_mosaic and correct_illumination jobs on the card, which run cuFFT and torch ops and "
        "launch none of the four kernels; optics_* are the optics phase's localize_emitters (2D, dims 3, "
        "astigmatic), calibrate_astigmatism and deconvolve jobs, which run pools, sorts, gathers, cuFFT and "
        "torch ops and launch none of the four kernels; quant_* are the quantify phase's qc_stack, "
        "project_stack, measure_objects, export_ctc, localize_emitters, count_spots and measure_tracks "
        "jobs, which run sorts, reductions and elementwise torch ops on the card or host numpy and launch "
        "none of the four kernels, except quant_ee_segment, the chain's segmentation_unet2d on 4 projected "
        "frames, which normalizes each with one quantile pass as job a does; ops_supervised is the ops "
        "phase's segmentation_unet2d served by a supervised worker process (serve --workers 2), its "
        "launches counted in the job's own profile trace (count_kernel, minmax_kernel), ops_inprocess the "
        "same job in this process; par_* are the parallel phase's jobs on a virtual pool of 4 devices over "
        "the card (spatial: one pass a frame normalized whole before it is sharded, a pass a chunk of 2 "
        "frames for the hybrid; data_parallel: one a frame, as single-device) and their 1-way twins; the conv3x3 "
        "entries' launches are those of the studies path (enc0 chained through each entry "
        "point); the served and training jobs launch the conv3x3 kernels 0 times; qconv's launches are those of "
        "the quant phase's 1024x1024 int8 forward of the quantized unet2d_cells (one a conv; the weights packed "
        "once, in torch ops, at the first call), its ms and plain_ms at enc0b (1024x1024, 32 -> 32, int32 out) as "
        "called, kernel_ms the same from a CUDA graph, library_ms im2col + torch._int_mm there; no served or "
        "training job launches it; ptq_path is the histogram's passes on that PTQ path (one a normalized frame: 4 "
        "calibration frames and the forward's); fixtures_serve is the fixtures phase's segmentation_unet2d of the "
        "quick-trained unet2d_cells on one 1024x1024 frame (one pass, as job a's frames); follow_flows's "
        "launches are those of served job j (the Euler segment_flows, 4 frames), launches_by_job every served "
        "job's Euler kernel launches, counted on its own as the histogram's are: one a frame or volume for "
        "segment_flows and evaluate_flows on the Euler integrator (j, m, eval_j, eval_r, eval_m, eval_r_3d, "
        "segment_flows_t, evaluate_flows_t, segment_flows_3d_t, par_e_flows_1way and _4way), none for any other "
        "job; its ms and kernel_ms (as called, and the kernel's own device time) and plain_ms (the eager loop's "
        "device time) at 1024x1024, 200 steps, on the instances phase's field"
    )
    print(f"chip_smoke: {time.perf_counter() - T_START:.1f} s in all")
    print(json.dumps({"kernels": [entry] + conv_entries + [qconv_entry, euler_entry]}))
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
