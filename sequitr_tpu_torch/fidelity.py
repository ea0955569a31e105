"""Fidelity meters: the accuracy half of the port's numbers.

Port of ``sequitr_tpu.fidelity``'s model meters. Each runs the served
device path (bf16 compute on CUDA, ``normalize="auto"`` = the histogram
kernel's quantile pass) AND an f32 reference with the exact percentile
normalize, on identical committed fixture weights (``models.fixtures``)
over identical fixed-seed synthetic scenes (``data.synthetic``), with the
JAX package's fixtures, seeds, frame shapes and return keys:

* ``seg_fidelity``: mIoU of the device labels against the reference's,
  and both against the scene's truth;
* ``gan_fidelity`` / ``n2v_fidelity``: PSNR/L1 of the enhanced or
  denoised frames against the reference, and PSNR against the clean
  target;
* ``flows_fidelity`` / ``stars_fidelity``: Hungarian ap50 of the device
  instances against the reference's, and against the truth;
* ``train_fidelity``: relative loss deviation of the bf16 train step from
  the f32 step over a few steps from one init on the same batches;
* ``register_fidelity``, ``mosaic_fidelity``, ``illum_fidelity``: the
  geometry and illumination paths against the analytic truth of a
  band-limited synthetic scene (trajectory and position errors in px, the
  correction's residuals);
* ``emitter_fidelity``, ``emitter3d_fidelity``, ``astig_fidelity``: the
  localization paths (2D, volumetric, astigmatic) against the known
  emitter positions of synthetic frames and volumes (RMSE in px or as a
  share of the z range, recall, precision). The geometry and emitter
  meters carry no model and no reference path: the port's readings on
  the card are held to its readings on the CPU;
* ``tracking_scene`` / ``tracking_fidelity``: the built-in tracker
  (``tracking.link_tables``, host numpy) against the identities of a
  known constant-velocity scene with divisions (link accuracy, track
  purity, division recall and precision); no device.

The one deliberate difference from the JAX module: the reference runs on
the SAME device as the served path (IEEE f32, TF32 off: ``utils.ieee_f32``),
not on the CPU. A full-width 32x512x512 f32 reference on the card
machine's CPU would take tens of seconds a volume; the port's f32 path on
the card is held to the CPU's (and the CPU's to the JAX package's) by the
model and instances checks and the CPU tests. On a CPU device both sides
run f32 and the numbers read ~1.0, as the JAX module's do on a CPU host.

``miou``, ``ap50`` and ``psnr_db`` are the measures themselves, shared
with ``chip_smoke.py``. Meters run on ``device`` (default the CUDA card).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch

from sequitr_tpu_torch import localize as loc_lib
from sequitr_tpu_torch import tracking
from sequitr_tpu_torch.utils import resolve_device

__all__ = [
    "miou", "ap50", "psnr_db", "seg_fidelity", "gan_fidelity", "n2v_fidelity",
    "flows_fidelity", "stars_fidelity", "train_fidelity", "register_fidelity",
    "mosaic_fidelity", "illum_fidelity", "emitter_fidelity", "emitter3d_fidelity", "astig_fidelity",
    "tracking_scene", "tracking_fidelity",
]


def _device_dtype(device: torch.device) -> str:
    """The served compute dtype: bf16 on the card, f32 on the CPU (the JAX
    module's ``_device_dtype``: bf16 on its accelerator only)."""
    return "bfloat16" if device.type == "cuda" else "float32"


def _round(x: float, nd: int = 4) -> float:
    return round(float(x), nd)


def miou(a, b, k: int) -> float:
    """Mean over classes of the IoU of two label maps (``losses.iou``: a
    class absent from both scores 1.0)."""
    from sequitr_tpu_torch.ops import losses

    ious = losses.iou(torch.as_tensor(np.asarray(a)), torch.as_tensor(np.asarray(b)), k)
    return float(np.nanmean(ious.numpy()))


def ap50(want, got) -> float:
    """Hungarian-matched instance AP at IoU 0.5 of ``got`` against ``want``."""
    from sequitr_tpu_torch.ops import flows

    return flows.average_precision(np.asarray(want), np.asarray(got), thresholds=(0.5,))["ap50"]


def psnr_db(a, b) -> float:
    """PSNR in dB of ``a`` against ``b`` over [0, 1] data (peak 1)."""
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return 10.0 * float(np.log10(1.0 / max(mse, 1e-12)))


def _polyphase_covers(cfg, patch) -> bool:
    """Whether the polyphase forward covers the (folded) model at ``patch``."""
    from sequitr_tpu_torch.models import polyphase

    run = dataclasses.replace(cfg, norm="none") if cfg.norm == "batch" else cfg
    return polyphase.eligible3d(run, patch) if run.dims == 3 else polyphase.eligible(run, patch)


def _maybe_polyphase(tc, cfg, patch):
    """The device side serves polyphase where the model is covered, the
    standard graph otherwise: a meter measures any fixture it is pointed
    at."""
    return dataclasses.replace(tc, polyphase=True) if _polyphase_covers(cfg, patch) else tc


def _load(name: str, dtype: str, device):
    from sequitr_tpu_torch.models import fixtures

    _, cfg, model, _ = fixtures.load(name, compute_dtype=dtype, device=device)
    return cfg, model


def _host(t) -> np.ndarray:
    return t.float().cpu().numpy() if t.is_floating_point() else t.cpu().numpy()


# ---------------------------------------------------------------------------
# segmentation: mIoU parity
# ---------------------------------------------------------------------------


def seg_fidelity(
    fixture_name: str,
    frame_shape: Tuple[int, ...] = (1024, 1024),
    tc=None,
    n: int = 4,
    seed0: int = 424_000,
    device=None,
) -> Dict[str, Any]:
    """mIoU of the served device path against the f32 exact reference.

    ``frame_shape`` of length 3 evaluates the volumetric family on
    synthetic z-stacks. ``tc`` overrides the tiling; normalize stays
    ``"auto"`` on the device side and is ``"exact"`` on the reference side.
    """
    from sequitr_tpu_torch.data import synthetic
    from sequitr_tpu_torch.models import unet
    from sequitr_tpu_torch.pipeline import infer

    device = resolve_device(device)
    shape = tuple(frame_shape)
    cfg_dev, model_dev = _load(fixture_name, _device_dtype(device), device)
    cfg_ref, model_ref = _load(fixture_name, "float32", device)
    if tc is None:
        tc = infer.TileConfig(patch=shape, overlap=(0,) * len(shape))
    tc_ref = dataclasses.replace(tc, normalize="exact", polyphase=False)
    fn_dev = infer.make_frame_inferrer(cfg_dev, tc, shape, device=device)
    fn_ref = infer.make_frame_inferrer(cfg_ref, tc_ref, shape, device=device)
    model_dev = unet.fold_batchnorm(model_dev)  # as the server loads it
    k = cfg_dev.num_classes
    agree, truth_dev, truth_ref = [], [], []
    for i in range(n):
        make = synthetic.cells_volume if len(shape) == 3 else synthetic.cells_frame
        img, lab = make(seed0 + i, shape)
        dev = _host(fn_dev(model_dev, img)[1])
        ref = _host(fn_ref(model_ref, img)[1])
        agree.append(miou(dev, ref, k))
        truth_dev.append(miou(dev, lab, k))
        truth_ref.append(miou(ref, lab, k))
    return {
        "miou_vs_ref": _round(np.mean(agree)),
        "miou_truth": _round(np.mean(truth_dev)),
        "miou_truth_ref": _round(np.mean(truth_ref)),
        "n_frames": n,
        "fixture": fixture_name,
    }


# ---------------------------------------------------------------------------
# GAN enhancement and Noise2Void: PSNR parity
# ---------------------------------------------------------------------------


def gan_target(img: np.ndarray) -> np.ndarray:
    """The clean target ``gan_denoise`` was trained toward: the exactly
    normalized scene smoothed by a Gaussian of sigma 1.5."""
    from scipy import ndimage

    from sequitr_tpu_torch.ops import normalize as norm_ops

    x01 = norm_ops.percentile_normalize(torch.from_numpy(np.asarray(img, np.float32)), 5.0, 99.5)
    return ndimage.gaussian_filter(x01.numpy(), 1.5)


def gan_fidelity(
    fixture_name: str = "gan_denoise",
    frame_shape: Tuple[int, int] = (1024, 1024),
    n: int = 2,
    seed0: int = 434_000,
    device=None,
) -> Dict[str, Any]:
    """PSNR/L1 of the device enhancement path against the f32 reference,
    and PSNR against the clean target (``gan_target``). The device side
    serves polyphase where the generator is covered, as the JAX meter's."""
    from sequitr_tpu_torch.data import synthetic
    from sequitr_tpu_torch.pipeline import infer

    device = resolve_device(device)
    shape = tuple(frame_shape)
    tc = infer.TileConfig(patch=shape, overlap=(0, 0))
    tc_ref = dataclasses.replace(tc, normalize="exact")

    def enhancer(dtype, tcfg):
        cfg, model = _load(fixture_name, dtype, device)
        enhance = infer.make_gan_enhancer(cfg, tcfg, shape, device=device)
        return lambda frame: _host(enhance(model, frame))[..., 0]

    cfg_dev, _ = _load(fixture_name, _device_dtype(device), "cpu")
    dev_fn = enhancer(_device_dtype(device), _maybe_polyphase(tc, cfg_dev.generator_config, shape))
    ref_fn = enhancer("float32", tc_ref)
    psnr_ref, l1_ref, psnr_tgt = [], [], []
    for i in range(n):
        img, _ = synthetic.cells_frame(seed0 + i, shape)
        dev, ref = dev_fn(img), ref_fn(img)
        psnr_ref.append(psnr_db(dev, ref))
        l1_ref.append(float(np.mean(np.abs(dev - ref))))
        psnr_tgt.append(psnr_db(dev, gan_target(img)))
    return {
        "psnr_vs_ref_db": _round(np.mean(psnr_ref), 2),
        "l1_vs_ref": _round(np.mean(l1_ref), 6),
        "psnr_target_db": _round(np.mean(psnr_tgt), 2),
        "n_frames": n,
        "fixture": fixture_name,
    }


def n2v_fidelity(
    fixture_name: str = "n2v_cells",
    frame_shape: Tuple[int, int] = (1024, 1024),
    n: int = 2,
    seed0: int = 515_000,
    device=None,
) -> Dict[str, Any]:
    """PSNR of the device Noise2Void path against the f32 reference, and of
    both the output and the noisy input against the clean render.
    ``normalize="none"``: ``synthetic.denoise_pair`` scenes already lie in
    the fixture's trained intensity scale. The device side serves
    polyphase where the model is covered; the reference is the
    untransformed f32 graph."""
    from sequitr_tpu_torch.data import synthetic
    from sequitr_tpu_torch.pipeline import infer

    device = resolve_device(device)
    shape = tuple(frame_shape)
    tc = infer.TileConfig(patch=shape, overlap=(0, 0), normalize="none")

    def denoiser(dtype, tcfg):
        cfg, model = _load(fixture_name, dtype, device)
        den = infer.make_denoiser(cfg, tcfg, shape, device=device)
        return lambda frame: _host(den(model, frame))[..., 0]

    cfg_dev, _ = _load(fixture_name, _device_dtype(device), "cpu")
    dev_fn = denoiser(_device_dtype(device), _maybe_polyphase(tc, cfg_dev, shape))
    ref_fn = denoiser("float32", tc)
    psnr_ref, psnr_truth, psnr_noisy = [], [], []
    for i in range(n):
        clean, noisy = synthetic.denoise_pair(seed0 + i, shape)
        dev, ref = dev_fn(noisy), ref_fn(noisy)
        psnr_ref.append(psnr_db(dev, ref))
        psnr_truth.append(psnr_db(dev, clean))
        psnr_noisy.append(psnr_db(noisy, clean))
    return {
        "psnr_vs_ref_db": _round(np.mean(psnr_ref), 2),
        "psnr_truth_db": _round(np.mean(psnr_truth), 2),
        "psnr_noisy_db": _round(np.mean(psnr_noisy), 2),
        "n_frames": n,
        "fixture": fixture_name,
    }


# ---------------------------------------------------------------------------
# instance segmentation: Hungarian-AP parity
# ---------------------------------------------------------------------------


def instance_pass(name, dtype, normalize, device, polyphase=False, spatial=(1024, 1024), model=None):
    """``frame -> (a, b)`` on the host: the serving pass of a committed
    instance fixture (``stars_cells``: prob and ray distances; any other:
    the flows pass, final positions and prob) or of ``model`` (its own
    configuration), at ``dtype``, on ``device``."""
    from sequitr_tpu_torch.pipeline import infer

    if model is None:
        cfg, model = _load(name, dtype, device)
    else:
        cfg = model.cfg
    spatial = tuple(spatial)
    tc = infer.TileConfig(
        patch=spatial, overlap=(0,) * len(spatial), normalize=normalize, polyphase=polyphase
    )
    if name == "stars_cells":
        fn = infer.make_stars_predictor(cfg, tc, spatial, device=device)
    else:
        fn = infer.make_flows_segmenter(cfg, tc, spatial, device=device)
    return lambda frame: tuple(_host(t) for t in fn(model, frame))


def instances_of(name, a, b):
    """The host half: polygon NMS (``stars_cells``) or sink grouping."""
    from sequitr_tpu_torch.ops import flows, stardist

    if name == "stars_cells":
        return stardist.instances_from_rays(a, b)
    return flows.group_sinks(a, b > 0.5)


def _instance_fidelity(name, frame_shape, n, seed0, device, polyphase):
    from sequitr_tpu_torch.data import synthetic
    from sequitr_tpu_torch.ops import flows

    device = resolve_device(device)
    shape = tuple(frame_shape)
    dtype = _device_dtype(device)
    poly = polyphase and _polyphase_covers(_load(name, dtype, "cpu")[0], shape)
    dev_fn = instance_pass(name, dtype, "auto", device, polyphase=poly, spatial=shape)
    ref_fn = instance_pass(name, "float32", "exact", device, spatial=shape)
    ap_ref, ap_truth, iou_truth = [], [], []
    for i in range(n):
        img, lab = synthetic.instances_frame(seed0 + i, shape)
        dev = instances_of(name, *dev_fn(img))
        ref = instances_of(name, *ref_fn(img))
        ap_ref.append(ap50(ref, dev))
        t = flows.average_precision(lab, dev)
        ap_truth.append(t["ap50"])
        iou_truth.append(t["mean_matched_iou"])
    return {
        "ap50_vs_ref": _round(np.mean(ap_ref)),
        "ap50_truth": _round(np.mean(ap_truth)),
        "matched_iou_truth": _round(np.mean(iou_truth)),
        "n_frames": n,
        "fixture": name,
    }


def flows_fidelity(
    fixture_name: str = "flows_cells",
    frame_shape: Tuple[int, int] = (1024, 1024),
    n: int = 2,
    seed0: int = 717_000,
    device=None,
) -> Dict[str, Any]:
    """Instance AP of the device flows path (``segment_flows``' pass: the
    flow integration on the device, the sink grouping on the host) against
    the f32 reference's instances (``ap50_vs_ref``) and the scene's truth
    (``ap50_truth``, ``matched_iou_truth``)."""
    return _instance_fidelity(fixture_name, frame_shape, n, seed0, device, polyphase=False)


def stars_fidelity(
    fixture_name: str = "stars_cells",
    frame_shape: Tuple[int, int] = (1024, 1024),
    n: int = 2,
    seed0: int = 717_000,
    device=None,
) -> Dict[str, Any]:
    """Instance AP of the device stars path (``segment_stars``' pass, served
    polyphase where covered, then the host NMS) against the f32
    reference's instances and the scene's truth."""
    from sequitr_tpu_torch.models import fixtures

    if fixture_name not in fixtures.manifest():
        raise KeyError(f"stars_fidelity: fixture {fixture_name!r} is not committed")
    return _instance_fidelity(fixture_name, frame_shape, n, seed0, device, polyphase=True)


# ---------------------------------------------------------------------------
# training: loss-trajectory parity
# ---------------------------------------------------------------------------


def train_fidelity(
    kind: str = "unet2d", steps: int = 4, batch: int = 4, size: int = 128,
    seed: int = 7, polyphase: bool = False, device=None,
) -> Dict[str, Any]:
    """Relative loss deviation of the device train step (bf16 on the card)
    from the f32 step on the same device: one init, the same synthetic
    batches and the same augmentation draws a step, so the compute dtype
    (and with ``polyphase`` the phase-domain forward) is the only
    difference. ``kind``: ``unet2d``, ``unet3d`` or ``gan`` (whose metric
    is ``g_loss``). Reported as the largest per-step ``|dev - ref| /
    |ref|`` with both final losses."""
    from sequitr_tpu_torch.data import synthetic
    from sequitr_tpu_torch.models import gan as gan_lib
    from sequitr_tpu_torch.models import unet
    from sequitr_tpu_torch.pipeline import fit, train

    device = resolve_device(device)
    is_gan = kind == "gan"
    dims = 3 if kind == "unet3d" else 2
    dtype = _device_dtype(device)
    if is_gan:
        cfg_dev = gan_lib.GANConfig(compute_dtype=dtype)
        tc = train.TrainConfig(learning_rate=2e-4, beta1=0.5, augment=False)
    else:
        cfg_dev = unet.UNetConfig(
            in_channels=1, num_classes=3, dims=dims,
            depth=3 if dims == 3 else 4,
            base_features=32, features_cap=256 if dims == 3 else 512,
            compute_dtype=dtype,
        )
        tc = train.TrainConfig(augment=True)
    cfg_ref = dataclasses.replace(cfg_dev, compute_dtype="float32")

    def normalized(img):
        lo, hi = np.percentile(img, [5.0, 99.5])
        return np.clip((img - lo) / max(hi - lo, 1e-8), 0, 1).astype(np.float32)

    batches = []
    for s in range(steps):
        seeds = [seed * 1000 + s * batch + b for b in range(batch)]
        if is_gan:
            from scipy import ndimage

            xs = [normalized(synthetic.cells_frame(sd, (size, size))[0]) for sd in seeds]
            ys = [ndimage.gaussian_filter(x, 1.5).astype(np.float32) for x in xs]
            batches.append({"input": np.stack(xs)[..., None], "target": np.stack(ys)[..., None]})
            continue
        scenes = [
            synthetic.cells_volume(sd, (8, size, size)) if dims == 3
            else synthetic.cells_frame(sd, (size, size))
            for sd in seeds
        ]
        labs = np.stack([lab for _, lab in scenes])
        batches.append({
            "image": np.stack([normalized(img) for img, _ in scenes])[..., None],
            "labels": labs.astype(np.int32),
            "weights": np.ones(labs.shape, np.float32),
        })

    def run(cfg, run_tc):
        init = torch.Generator().manual_seed(0)
        if is_gan:
            state = train.create_gan_state(cfg, run_tc, init, device)
            step, metric = train.make_gan_train_step(cfg, run_tc), "g_loss"
        else:
            state = train.create_unet_state(cfg, run_tc, init, device)
            step, metric = train.make_unet_train_step(cfg, run_tc), "loss"
        out = []
        for s, b in enumerate(batches):
            b = {k: torch.as_tensor(v, device=device) for k, v in b.items()}
            state, metrics = step(state, b, fit.step_generator(1, s))
            out.append(float(metrics[metric]))
        return out

    # polyphase grades the phase-domain step against the STANDARD f32 step:
    # one bound covering the reformulation and the dtype together
    dev = run(cfg_dev, dataclasses.replace(tc, polyphase=True) if polyphase else tc)
    ref = run(cfg_ref, tc)
    devs = [abs(d - r) / max(abs(r), 1e-8) for d, r in zip(dev, ref)]
    return {
        "loss_rel_dev_max": _round(max(devs), 4),
        "loss_final_dev": _round(dev[-1], 4),
        "loss_final_ref": _round(ref[-1], 4),
        "steps": steps,
    }


# ---------------------------------------------------------------------------
# geometry and illumination: errors against the synthetic truth
# ---------------------------------------------------------------------------


def register_fidelity(
    n: int = 8, shape: Tuple[int, int] = (256, 256), seed: int = 555_000, device=None,
) -> Dict[str, float]:
    """Trajectory accuracy of the drift-registration path.

    A band-limited synthetic scene drifts along a known sub-pixel
    trajectory (~1.1 px/frame, Fourier-exact ground truth); the
    ``register_step`` chain (previous mode, default refine) on ``device``
    estimates it back. Reports the per-frame trajectory RMSE and worst
    error in pixels.
    """
    from sequitr_tpu_torch.data.synthetic import bandlimited_scene
    from sequitr_tpu_torch.ops import registration as reg

    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    base = torch.from_numpy(bandlimited_scene(shape, rng)).to(device)
    steps = rng.normal(0, 0.8, (n - 1, 2))
    truth = np.vstack([[0.0, 0.0], np.cumsum(steps, 0)])
    anchor = torch.fft.fftn(base * reg.hann_window(shape, device))
    cum = torch.zeros(2, dtype=torch.float32, device=device)
    errs = []
    for t in range(1, n):
        moved = reg.apply_shift(base, torch.tensor(truth[t], dtype=torch.float32))
        anchor, cum, _, _, _ = reg.register_step(anchor, moved, cum, resample=False)
        errs.append(cum.cpu().numpy() + truth[t])  # the estimate aligns back: -truth
    errs = np.stack(errs)
    return {
        "trajectory_rmse_px": _round(float(np.sqrt(np.mean(errs**2)))),
        "max_err_px": _round(float(np.abs(errs).max())),
        "n_frames": n,
    }


def mosaic_fidelity(
    grid: Tuple[int, int] = (3, 3),
    tile: Tuple[int, int] = (256, 256),
    overlap: int = 48,
    jitter: float = 2.5,
    seed: int = 565_000,
    device=None,
) -> Dict[str, float]:
    """Position accuracy of the mosaic-stitching path.

    Tiles are cut from one band-limited synthetic scene at grid spacing
    plus known sub-pixel jitter (Fourier-exact cuts), stitched with the
    default settings on ``device``, and the recovered tile origins are
    compared to truth; also the post-solve seam consistency
    (``rms_residual``) and the photometric residual of flat-field + gain
    matching on the same tiles under a known vignette and fade.
    """
    from sequitr_tpu_torch import mosaic as mosaic_lib
    from sequitr_tpu_torch.data.synthetic import bandlimited_scene
    from sequitr_tpu_torch.ops import registration as reg

    device = resolve_device(device)
    r, c = grid
    h, w = tile
    step_y, step_x = h - overlap, w - overlap
    scene_shape = ((r - 1) * step_y + h + 16, (c - 1) * step_x + w + 16)
    rng = np.random.default_rng(seed)
    scene = torch.from_numpy(bandlimited_scene(scene_shape, rng)).to(device)
    tiles, pos = [], []
    for ri in range(r):
        for ci in range(c):
            jy = jx = 0.0
            if (ri, ci) != (0, 0):
                jy, jx = rng.uniform(-jitter, jitter, 2)
            y0, x0 = ri * step_y + 8 + jy, ci * step_x + 8 + jx
            iy, ix = int(np.floor(y0)), int(np.floor(x0))
            shifted = reg.apply_shift(
                scene, torch.tensor([iy - y0, ix - x0], dtype=torch.float32)
            ).cpu().numpy()
            tiles.append(shifted[iy : iy + h, ix : ix + w])
            pos.append((y0, x0))
    pos = np.asarray(pos)
    tiles = np.stack(tiles)
    res = mosaic_lib.stitch_grid(tiles, grid, overlap=overlap, blend=False, device=device)
    rel = pos - pos.min(axis=0, keepdims=True)
    err = res.positions - rel

    yy = np.linspace(-1, 1, h)[:, None]
    xx = np.linspace(-1, 1, w)[None, :]
    vig = (1.0 - 0.35 * (yy**2 + xx**2)).astype(np.float32)
    fade = np.linspace(1.0, 0.65, r * c).astype(np.float32)
    damaged = tiles * vig[None] * fade[:, None, None]
    prof = mosaic_lib.estimate_flatfield(damaged)
    fixed = damaged / prof
    gains = mosaic_lib.solve_tile_gains(fixed, grid, (overlap, overlap))
    fixed = fixed * gains[:, None, None]
    clean_m = mosaic_lib.blend_mosaic(tiles, res.positions, (overlap, overlap), device=device)
    fixed_m = mosaic_lib.blend_mosaic(fixed, res.positions, (overlap, overlap), device=device)
    g = fixed_m.mean() / max(clean_m.mean(), 1e-9)  # global scale free
    resid = float(np.abs(fixed_m - g * clean_m).mean() / max(clean_m.std(), 1e-9))
    return {
        "position_rmse_px": _round(float(np.sqrt(np.mean(err**2)))),
        "max_err_px": _round(float(np.abs(err).max())),
        "seam_rms_residual_px": _round(res.rms_residual),
        "photometric_residual_frac": _round(resid),
        "n_tiles": r * c,
    }


def illum_fidelity(
    t: int = 24, shape: Tuple[int, int] = (256, 256), rate: float = 0.03, seed: int = 777_000, device=None,
) -> Dict[str, float]:
    """Correction accuracy of the illumination path.

    A moving band-limited scene is corrupted by a known radial vignette
    and a known exponential photobleach; the estimate -> correct chain
    (sampled ``fit_shading`` + ``estimate_bleach_exp`` on the host, the
    corrector on ``device``: what ``correct_illumination`` runs) takes it
    back. Reports the bleach-rate error, the temporal drift of the
    corrected stack (max/min frame median), the shading-profile RMSE
    against the true mean-1 profile, and the 99th-percentile relative
    error against the clean scene after one global rescale.
    """
    from sequitr_tpu_torch.data.synthetic import bandlimited_scene
    from sequitr_tpu_torch.ops import illumination as illum

    device = resolve_device(device)
    h, w = shape
    rng = np.random.default_rng(seed)
    big = bandlimited_scene((h + t, w + t), rng, sigma=0.08, amp=50.0) + 100.0
    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    vig = (1.0 - 0.35 * (yy**2 + xx**2)).astype(np.float64)
    truth = np.stack([big[k : k + h, k : k + w] for k in range(t)])
    stack = (truth * vig[None] * np.exp(-rate * np.arange(t))[:, None, None]).astype(np.float32)

    idx = np.unique(np.linspace(0, t - 1, min(16, t)).round().astype(int))
    prof = illum.fit_shading(stack[idx])
    meds = np.median(stack[idx] / prof[None], axis=(1, 2))
    gains, got_rate = illum.estimate_bleach_exp(idx, meds, t)
    run = illum.make_corrector("exp")
    shading_dev = torch.from_numpy(prof[..., None]).to(device)
    gains_dev = torch.from_numpy(gains).to(device)
    ones = torch.ones(1, dtype=torch.float32, device=device)
    corrected = np.stack([
        run(torch.from_numpy(stack[k][..., None]).to(device), shading_dev, gains_dev[k : k + 1], ones)[0]
        .cpu().numpy()[..., 0]
        for k in range(t)
    ])
    cmeds = np.median(corrected, axis=(1, 2))
    scale = float(np.median(truth) / np.median(corrected))
    rel = np.abs(corrected * scale - truth) / truth
    want = vig / vig.mean()
    return {
        "bleach_rate_err": _round(abs(got_rate - rate), 6),
        "drift_ratio": _round(float(cmeds.max() / cmeds.min())),
        "shading_rmse": _round(float(np.sqrt(np.mean((prof - want) ** 2)))),
        "rel_err_p99": _round(float(np.percentile(rel, 99))),
        "n_frames": t,
    }


# ---------------------------------------------------------------------------
# emitter localization: centroid RMSE against the truth
# ---------------------------------------------------------------------------


def _greedy_match(found: np.ndarray, truth, dist2, radius: float):
    """Greedy nearest-first matching (the JAX meters'): each truth row in
    turn takes the nearest unused detection within ``radius``. Returns the
    (detection index, truth row) pairs."""
    pairs = []
    unused = list(range(len(found)))
    for t in truth:
        if not unused:
            break
        d2 = [dist2(found[j], t) for j in unused]
        jbest = int(np.argmin(d2))
        if d2[jbest] <= radius**2:
            pairs.append((unused.pop(jbest), t))
    return pairs


def emitter_fidelity(
    n: int = 6, shape: Tuple[int, int] = (256, 256), n_emitters: int = 40, seed0: int = 444_000, device=None,
) -> Dict[str, float]:
    """Sub-pixel accuracy of the 2D detect+fit path on ``device``.

    Synthetic frames carry known continuous (y, x) positions; detections
    within 1.5 px of a truth position (greedy nearest-first) count as
    hits. RMSE is over matched pairs.
    """
    from sequitr_tpu_torch import psf
    from sequitr_tpu_torch.data import synthetic

    device = resolve_device(device)
    sq_errs, hits, dets, total = [], 0, 0, 0
    for i in range(n):
        img, pos = synthetic.emitter_frame(seed0 + i, shape, n=n_emitters)
        got = psf.localize_emitters(img, threshold=120.0, sigma=1.5, device=device)
        found = np.stack([got["y"], got["x"]], -1) if len(got["y"]) else np.zeros((0, 2))
        dets += len(found)
        total += len(pos)
        for j, (ty, tx) in _greedy_match(found, pos, lambda f, t: (f[0] - t[0]) ** 2 + (f[1] - t[1]) ** 2, 1.5):
            sq_errs.append((found[j, 0] - ty) ** 2 + (found[j, 1] - tx) ** 2)
            hits += 1
    return {
        "rmse_px": _round(np.sqrt(np.mean(sq_errs)) if sq_errs else float("nan")),
        "recall": _round(hits / max(total, 1)),
        "precision": _round(hits / max(dets, 1)),
        "n_frames": n,
    }


def emitter3d_fidelity(
    n: int = 3, shape: Tuple[int, int, int] = (16, 256, 256), n_emitters: int = 30, seed0: int = 446_000,
    device=None,
) -> Dict[str, float]:
    """Sub-voxel accuracy of the volumetric detect+fit path on ``device``:
    detections within 1.5 voxels euclidean count as hits; lateral and
    axial RMSE reported apart."""
    from sequitr_tpu_torch import psf
    from sequitr_tpu_torch.data import synthetic

    device = resolve_device(device)
    lat_sq, ax_sq, hits, dets, total = [], [], 0, 0, 0
    for i in range(n):
        vol, pos = synthetic.emitter_volume(seed0 + i, shape, n=n_emitters)
        got = psf.localize_emitters_3d(vol, threshold=120.0, sigma=1.4, sigma_z=1.6, device=device)
        found = np.stack([got["z"], got["y"], got["x"]], -1) if len(got["z"]) else np.zeros((0, 3))
        dets += len(found)
        total += len(pos)
        for j, (tz, ty, tx) in _greedy_match(found, pos, lambda f, t: float(np.sum((f - np.asarray(t)) ** 2)), 1.5):
            ax_sq.append((found[j, 0] - tz) ** 2)
            lat_sq.append((found[j, 1] - ty) ** 2 + (found[j, 2] - tx) ** 2)
            hits += 1
    return {
        "lateral_rmse_px": _round(np.sqrt(np.mean(lat_sq)) if lat_sq else float("nan")),
        "axial_rmse_px": _round(np.sqrt(np.mean(ax_sq)) if ax_sq else float("nan")),
        "recall": _round(hits / max(total, 1)),
        "precision": _round(hits / max(dets, 1)),
        "n_volumes": n,
    }


def astig_fidelity(
    n: int = 4, shape: Tuple[int, int] = (256, 256), n_emitters: int = 25, seed0: int = 447_000, device=None,
) -> Dict[str, float]:
    """z-recovery accuracy of the astigmatic path on ``device``, with the
    exactly matching calibration (``synthetic.ASTIG_*``): lateral RMSE in
    px, axial RMSE as a share of the calibrated z range; matched laterally
    within 2 px."""
    from sequitr_tpu_torch import psf
    from sequitr_tpu_torch.data import synthetic

    device = resolve_device(device)
    calib = psf.AstigCalibration(qx=synthetic.ASTIG_QX, qy=synthetic.ASTIG_QY, z_range=synthetic.ASTIG_Z_RANGE)
    span = synthetic.ASTIG_Z_RANGE[1] - synthetic.ASTIG_Z_RANGE[0]
    lat_sq, ax_sq, hits, dets, total = [], [], 0, 0, 0
    for i in range(n):
        img, pos = synthetic.astig_emitter_frame(seed0 + i, shape, n=n_emitters)
        got = psf.localize_emitters_astig(img, 25.0, calib, device=device)
        found = np.stack([got["z"], got["y"], got["x"]], -1) if len(got["z"]) else np.zeros((0, 3))
        dets += len(found)
        total += len(pos)
        lateral = lambda f, t: (f[1] - t[1]) ** 2 + (f[2] - t[2]) ** 2  # noqa: E731
        for j, t in _greedy_match(found, pos, lateral, 2.0):
            lat_sq.append(lateral(found[j], t))
            ax_sq.append((found[j, 0] - t[0]) ** 2)
            hits += 1
    return {
        "lateral_rmse_px": _round(np.sqrt(np.mean(lat_sq)) if lat_sq else float("nan")),
        "axial_rmse_frac": _round((np.sqrt(np.mean(ax_sq)) / span) if ax_sq else float("nan")),
        "recall": _round(hits / max(total, 1)),
        "precision": _round(hits / max(dets, 1)),
        "n_frames": n,
    }


def tracking_scene(
    n_objects: int = 40,
    n_frames: int = 40,
    field: Tuple[int, int] = (512, 512),
    n_divisions: int = 8,
    drop_rate: float = 0.02,
    speed: float = 3.0,
    noise: float = 0.3,
    seed: int = 575_000,
):
    """Ground-truth timelapse for the built-in tracker.

    Constant-velocity movers with border reflection, Gaussian detection
    jitter, random detection dropout, and ``n_divisions`` binary fissions
    (parent ends, two children separate at ~2 px/frame; the parent's last
    detection carries semantic class 2, the mitotic marker). Detection
    order is shuffled per frame so nothing rides on insertion order.

    Returns ``(tables, gt_ids, divisions)``: per-frame ``FrameTable``s,
    per-frame int arrays of ground-truth entity ids aligned with each
    table's rows, and a list of ``(parent_gid, (child_gid, child_gid),
    t_div)`` division records.
    """
    rng = np.random.default_rng(seed)
    h, w = field
    margin = 16.0
    # entity state: pos (2,), vel (2,), t_birth, t_end (exclusive), parent
    pos = rng.uniform(margin, [h - margin, w - margin], (n_objects, 2))
    vel = rng.uniform(-speed, speed, (n_objects, 2))
    ents = [
        {"pos": pos[i].copy(), "vel": vel[i].copy(), "t0": 0,
         "t1": n_frames, "parent": -1}
        for i in range(n_objects)
    ]
    divisions = []
    div_parents = rng.choice(n_objects, size=n_divisions, replace=False)
    div_times = rng.integers(8, max(9, n_frames - 10), n_divisions)
    for gid, t_div in zip(div_parents, div_times):
        ents[gid]["t1"] = int(t_div)

    def _step(e):
        e["pos"] += e["vel"]
        for a, lim in enumerate((h, w)):
            if not margin <= e["pos"][a] <= lim - margin:
                e["vel"][a] = -e["vel"][a]
                e["pos"][a] = np.clip(e["pos"][a], margin, lim - margin)

    tables, gt_ids = [], []
    pending: Dict[int, list] = {}
    for g, t in zip(div_parents, div_times):
        pending.setdefault(int(t), []).append(int(g))
    for t in range(n_frames):
        # fission: two children from each dividing parent's state
        for gid in pending.get(t, ()):
            par = ents[gid]
            perp = np.array([-par["vel"][1], par["vel"][0]])
            nrm = np.linalg.norm(perp)
            perp = perp / nrm if nrm > 1e-6 else np.array([0.0, 1.0])
            for sgn in (-1.0, 1.0):
                ents.append({
                    "pos": par["pos"] + sgn * 3.0 * perp,
                    "vel": par["vel"] + sgn * 1.0 * perp,
                    "t0": t, "t1": n_frames, "parent": gid,
                })
            divisions.append((gid, (len(ents) - 2, len(ents) - 1), t))
        rows, gids = [], []
        for gid, e in enumerate(ents):
            if not e["t0"] <= t < e["t1"]:
                continue
            if t > e["t0"]:
                _step(e)
            born = t == e["t0"]
            last = t == e["t1"] - 1
            # births and final (pre-division) detections always present:
            # the ground truth for a division must be observable
            if not (born or last) and rng.random() < drop_rate:
                continue
            det = e["pos"] + rng.normal(0, noise, 2)
            cls = 2 if (last and e["t1"] < n_frames) else 1
            rows.append((det[1], det[0], cls))  # x, y order of coords
            gids.append(gid)
        order = rng.permutation(len(rows))
        coords = np.zeros((len(rows), 5), np.float32)
        for k, j in enumerate(order):
            x, y, cls = rows[j]
            coords[k] = (t, x, y, 0.0, cls)
        tables.append(loc_lib.FrameTable(
            coords=coords,
            area=np.full(len(rows), 10, np.int32),
            intensity_mean=np.ones(len(rows), np.float32),
        ))
        gt_ids.append(np.asarray([gids[j] for j in order], np.int64))
    return tables, gt_ids, divisions


def tracking_fidelity(
    n_objects: int = 80,
    n_frames: int = 40,
    field: Tuple[int, int] = (200, 200),
    speed: float = 4.0,
    n_divisions: int = 8,
    seed: int = 575_000,
) -> Dict[str, float]:
    """Linking/lineage accuracy of the built-in tracker on ground truth.

    Runs the production ``track_objects`` path (Kalman motion model +
    division resolution with the mitotic-class gate) on a known
    constant-velocity scene (``tracking_scene``) and scores it against
    the generator's identities: the fraction of ground-truth
    frame-to-frame links the tracker reproduces (its headline number),
    per-entity track purity (majority predicted id per true entity), and
    division recall/precision. The Euclidean ``nearest`` model's link
    accuracy on the same scene is reported for contrast (the measured
    value of the motion model).
    """
    # dense enough that paths cross (the regime that separates the
    # models: measured kalman 0.99 vs nearest 0.95 link accuracy here)
    tables, gt_ids, divisions = tracking_scene(
        n_objects=n_objects, n_frames=n_frames, field=field, speed=speed,
        n_divisions=n_divisions, seed=seed,
    )

    def _link(motion_model):
        return tracking.link_tables(
            tables, max_distance=12.0, max_gap=1,
            motion_model=motion_model, divisions=True,
            division_distance=12.0, mitotic_class=2,
        )

    def _link_accuracy(pred_ids):
        # gid -> predicted id per frame (only where detected)
        ok = total = 0
        prev = {}
        for t in range(len(tables)):
            cur = {
                int(g): int(p) for g, p in zip(gt_ids[t], pred_ids[t])
            }
            for g, p in cur.items():
                if g in prev:
                    total += 1
                    ok += p == prev[g]
            prev = cur
        return ok / max(total, 1)

    def _purity(pred_ids):
        per_ent: Dict[int, list] = {}
        for t in range(len(tables)):
            for g, p in zip(gt_ids[t], pred_ids[t]):
                per_ent.setdefault(int(g), []).append(int(p))
        fracs = [
            max(np.bincount(v).max() / len(v), 0.0)
            for v in (np.asarray(v) for v in per_ent.values())
        ]
        return float(np.mean(fracs))

    ids_k, tracks_k = _link("kalman")
    ids_n, _ = _link("nearest")

    # division scoring: the predicted parent of both child detections at
    # their birth frame must be the predicted id of the parent's last
    # detection
    by_id = {tr.track_id: tr for tr in tracks_k}
    gid_to_pred: Dict[Tuple[int, int], int] = {}
    for t in range(len(tables)):
        for g, p in zip(gt_ids[t], ids_k[t]):
            gid_to_pred[(int(g), t)] = int(p)
    recalled = 0
    for parent_gid, (c1, c2), t_div in divisions:
        want_parent = gid_to_pred.get((parent_gid, t_div - 1))
        p1 = gid_to_pred.get((c1, t_div))
        p2 = gid_to_pred.get((c2, t_div))
        if want_parent is None or p1 is None or p2 is None:
            continue
        if (
            by_id[p1].parent_id == want_parent
            and by_id[p2].parent_id == want_parent
        ):
            recalled += 1
    n_pred_div = len({tr.parent_id for tr in tracks_k if tr.parent_id >= 0})
    return {
        "link_accuracy": _round(_link_accuracy(ids_k)),
        "link_accuracy_nearest": _round(_link_accuracy(ids_n)),
        "track_purity": _round(_purity(ids_k)),
        "division_recall": _round(recalled / max(len(divisions), 1)),
        "division_precision": _round(
            min(recalled, n_pred_div) / max(n_pred_div, 1)
        ),
        "n_entities": n_objects + 2 * len(divisions),
        "n_divisions_true": len(divisions),
    }
