"""Train the fixture checkpoints on the port: the eight recipes of the JAX
package's ``tools/make_fixtures.py``, recipe for recipe.

Each fixture is trained on the deterministic synthetic scenes
(``data/synthetic.py``) through the same fit machinery the server's train
jobs use (``pipeline.fit``), scored on fresh holdout seeds it never trained
on, and written with ``models.fixtures.save`` in the interchange layout
(float16 flat npz and a ``manifest.json`` entry) into ``--out``::

    python -m sequitr_tpu_torch.tools.make_fixtures --out DIR             # all eight
    python -m sequitr_tpu_torch.tools.make_fixtures --out DIR --only fast,fast4
    python -m sequitr_tpu_torch.tools.make_fixtures --out DIR --quick     # tiny step counts
    python -m sequitr_tpu_torch.tools.make_fixtures --out DIR --device cpu

The training data, step counts, batch sizes, learning rates and schedules,
fit cadences and scorers are the JAX tool's; the compute dtype is bfloat16
on the card and float32 on the CPU, and the port's generators (initial
weights, shuffle, augmentation draws) take seed 0 (``--seed`` gives
another, which the recipe then records). It runs on the CUDA card unless
``--device cpu`` is given. ``--out`` may not be the committed fixtures'
directory (``sequitr_tpu/fixtures/``): those are the reference's weights,
and ``fixtures.save`` refuses to write there. The distilled students
(``fast``, ``fast4``) take the teacher trained in the same run; without
``unet2d_cells`` among the targets they take the one in ``--out`` if it is
there, else the committed one (read only). Each fixture's holdout metric is
printed beside the committed manifest's, with its wall seconds and median
step time, as one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from sequitr_tpu_torch.data import records, synthetic
from sequitr_tpu_torch.models import fixtures, gan as gan_lib, zoo
from sequitr_tpu_torch.ops import weightmaps
from sequitr_tpu_torch.pipeline import fit as fit_lib
from sequitr_tpu_torch.pipeline import train as train_lib
from sequitr_tpu_torch.utils import resolve_device

__all__ = [
    "TARGETS", "Run", "StepClock", "make_teacher", "make_student", "make_unet3d", "make_gan",
    "make_n2v", "make_flows", "make_stars", "load_teacher", "main",
]

P_LO, P_HI = 5.0, 99.5

# --only names, in the order main runs them
TARGETS = (
    "unet2d_cells", "fast", "fast4", "unet3d_cells", "gan_denoise", "n2v_cells", "flows_cells",
    "stars_cells",
)
HOLDOUT = 8  # fresh frames each scorer averages over


def _normalize(img: np.ndarray) -> np.ndarray:
    """The record-build normalize (the server's ``build_records``): records
    store normalized intensities so training sees the distribution tiled
    inference feeds the net."""
    lo, hi = np.percentile(img, [P_LO, P_HI])
    return np.clip((img - lo) / max(hi - lo, 1e-8), 0.0, 1.0).astype(np.float32)


def _seg_shards(work: str, n: int, shape, volumetric: bool = False) -> List[str]:
    def gen():
        for i in range(n):
            if volumetric:
                img, lab = synthetic.cells_volume(1000 + i, shape)
            else:
                img, lab = synthetic.cells_frame(1000 + i, shape)
            w = weightmaps.unet_weight_map(lab, num_classes=3)
            yield records.SegExample(_normalize(img), lab, w)

    return records.write_segmentation_shards(
        os.path.join(work, "seg3d" if volumetric else "seg2d"), gen(), shard_size=64
    )


def _pair_shards(work: str, n: int, shape) -> List[str]:
    from scipy import ndimage

    shard_size = 64
    n_shards = max(1, -(-n // shard_size))
    paths = []
    i = 0
    for s in range(n_shards):
        path = os.path.join(work, f"pairs-{s:05d}-of-{n_shards:05d}.tfrecord")
        with records.RecordWriter(path) as w:
            for _ in range(min(shard_size, n - s * shard_size)):
                img, _ = synthetic.cells_frame(5000 + i, shape)
                x = _normalize(img)
                # denoise/smooth target: clean structure at the same scale
                y = ndimage.gaussian_filter(x, 1.5).astype(np.float32)
                w.write(fit_lib.encode_pair(x, y))
                i += 1
        paths.append(path)
    return paths


def _n2v_shards(work: str, n: int) -> List[str]:
    """Noisy frames alone: the self-supervised contract."""
    return records.write_shards(
        os.path.join(work, "n2v"),
        (
            fit_lib.encode_image_example(synthetic.denoise_pair(9000 + i, (128, 128))[1])
            for i in range(n)
        ),
        shard_size=64,
    )


def _instance_shards(work: str, n: int, family: str) -> List[str]:
    """Touching-cell instance scenes with flow (``flows``) or ray
    (``stars``) targets."""
    from sequitr_tpu_torch.ops import flows as flows_ops
    from sequitr_tpu_torch.ops import stardist as sd

    def gen():
        for i in range(n):
            img, lab = synthetic.instances_frame(7000 + i, (128, 128))
            if family == "flows":
                flow, prob = flows_ops.flow_targets(lab)
                yield fit_lib.encode_flow_example(_normalize(img), flow, prob)
            else:
                dist, prob = sd.star_targets(lab)
                yield fit_lib.encode_stars_example(_normalize(img), dist, prob)

    return records.write_shards(os.path.join(work, family), gen(), shard_size=64)


@dataclasses.dataclass(frozen=True)
class Run:
    """What every maker takes: the record shards' directory ``work``, the
    fixtures' directory ``out``, ``quick`` step counts, the ``device`` and
    the ``seed`` of the port's generators. The models compute in bfloat16
    on the card and float32 on the CPU."""

    work: str
    out: str
    device: torch.device
    quick: bool = False
    seed: int = 0

    @property
    def dtype(self) -> str:
        return "bfloat16" if self.device.type == "cuda" else "float32"

    def cfg(self, preset: str):
        return dataclasses.replace(zoo.get(preset), compute_dtype=self.dtype)

    def fit_config(self, steps: int, batch: int, eval_limit: int) -> fit_lib.FitConfig:
        return fit_lib.FitConfig(
            steps=steps, batch_size=batch, holdout_every=10, eval_every=max(10, steps // 4),
            eval_limit=eval_limit, checkpoint_every=10**9, log_every=max(10, steps // 10),
            seed=self.seed,
        )

    def recipe(self, **recipe) -> Dict:
        return dict(recipe, seed=self.seed) if self.seed else recipe


def _cosine(lr: float, steps: int) -> train_lib.TrainConfig:
    return train_lib.TrainConfig(
        learning_rate=lr, lr_schedule="cosine", lr_decay_steps=steps, augment=True
    )


class StepClock:
    """The trainer's ``progress`` callback: the time between consecutive
    steps. On the card it records a CUDA event at each step and reads them
    once, in ``median_ms``, so the loop is never synchronized and the host
    queues the next step while the card works: the gap is the step's
    period, whichever of the host (decode, batching) and the device is
    slower. On the CPU it reads the host clock."""

    def __init__(self, device: torch.device):
        self.device = device
        self.marks: List = []

    def __call__(self, step: int, total: int) -> None:
        if self.device.type == "cuda":
            mark = torch.cuda.Event(enable_timing=True)
            mark.record()
            self.marks.append(mark)
        else:
            self.marks.append(time.perf_counter())

    def median_ms(self) -> Optional[float]:
        if len(self.marks) < 2:
            return None
        if self.device.type == "cuda":
            self.marks[-1].synchronize()
            gaps = [a.elapsed_time(b) for a, b in zip(self.marks, self.marks[1:])]
        else:
            gaps = [(b - a) * 1e3 for a, b in zip(self.marks, self.marks[1:])]
        return float(np.median(gaps))


def _psnr(mse: float) -> float:
    return 10 * np.log10(1.0 / max(mse, 1e-12))


def _forward(model, x: np.ndarray, device: torch.device) -> np.ndarray:
    """The inference forward of one (H, W[, Z]) frame: f32 (..., C) on the host."""
    with torch.inference_mode():
        out = model(torch.as_tensor(x, device=device)[None, ..., None])
    return out[0].to(torch.float32).cpu().numpy()


def _eval_unet(cfg, model, device: torch.device) -> float:
    """Holdout mIoU of the final weights (fresh frames, seeds never
    trained): per frame the nan-mean of the per-class IoU of the argmax."""
    from sequitr_tpu_torch.ops import losses

    ious = []
    for i in range(HOLDOUT):
        if cfg.dims == 3:
            img, lab = synthetic.cells_volume(777_000 + i, (16, 64, 64))
        else:
            img, lab = synthetic.cells_frame(777_000 + i, (256, 256))
        pred = torch.as_tensor(np.argmax(_forward(model, _normalize(img), device), -1))
        per_class = losses.iou(pred, torch.as_tensor(lab), 3).numpy()
        ious.append(np.nanmean(per_class))
    return round(float(np.mean(ious)), 4)


def _eval_gan(model, device: torch.device) -> float:
    """Holdout PSNR of the generator against the smoothed target."""
    from scipy import ndimage

    psnrs = []
    for i in range(HOLDOUT):
        img, _ = synthetic.cells_frame(888_000 + i, (256, 256))
        x = _normalize(img)
        y = ndimage.gaussian_filter(x, 1.5)
        with torch.inference_mode():
            out = gan_lib.generator_apply(model, torch.as_tensor(x, device=device)[None, ..., None])
        mse = float(np.mean((out[0, ..., 0].cpu().numpy() - y) ** 2))
        psnrs.append(_psnr(mse))
    return round(float(np.mean(psnrs)), 2)


def _eval_n2v(model, device: torch.device):
    """Holdout PSNR of the denoised frames and of the noisy input against
    the clean renders the denoiser never saw: ``(denoised, noisy)``."""
    psnrs, psnrs_in = [], []
    for i in range(HOLDOUT):
        clean, noisy = synthetic.denoise_pair(999_000 + i, (128, 128))
        out = _forward(model, noisy, device)[..., 0]
        psnrs.append(_psnr(float(np.mean((out - clean) ** 2))))
        psnrs_in.append(_psnr(float(np.mean((noisy - clean) ** 2))))
    return round(float(np.mean(psnrs)), 2), round(float(np.mean(psnrs_in)), 2)


def _eval_instances(model, family: str, device: torch.device):
    """Holdout instance AP at IoU 0.5 and the mean matched IoU (Hungarian
    matching) on fresh instance scenes: ``(ap50, matched_iou)``."""
    from sequitr_tpu_torch.ops import flows as flows_ops
    from sequitr_tpu_torch.ops import stardist as sd

    aps, mious = [], []
    for i in range(HOLDOUT):
        img, lab = synthetic.instances_frame(997_000 + i, (128, 128))
        out = _forward(model, _normalize(img), device)
        if family == "flows":
            flow = out[..., :2] / flows_ops.FLOW_SCALE
            prob = 1.0 / (1.0 + np.exp(-out[..., 2]))
            pred = flows_ops.masks_from_flows(flow, prob, n_iter=150, device=device)
        else:
            prob = 1.0 / (1.0 + np.exp(-out[..., 0]))
            pred = sd.instances_from_rays(prob, np.maximum(out[..., 1:], 0.0))
        ap = flows_ops.average_precision(lab, pred)
        aps.append(ap["ap50"])
        mious.append(ap["mean_matched_iou"])
    return round(float(np.mean(aps)), 4), round(float(np.mean(mious)), 4)


def make_teacher(run: Run, clock=None):
    """``unet2d_cells``: the 3-class U-Net. Returns ``(cfg, model)``."""
    cfg = run.cfg("unet2d_3class")
    n = 48 if run.quick else 360
    shards = _seg_shards(run.work, n, (256, 256))
    steps = 30 if run.quick else 1500
    state = fit_lib.fit_unet(
        cfg, _cosine(1e-3, steps), run.fit_config(steps, 8, 16), shards, progress=clock, device=run.device
    )
    fixtures.save(
        "unet2d_cells", "unet", cfg, state.model,
        {"task": "synthetic 3-class cells (data/synthetic.py)",
         "recipe": run.recipe(steps=steps, batch=8, lr="1e-3 cosine", examples=n, patch=256),
         "holdout_miou": _eval_unet(cfg, state.model, run.device)},
        run.out,
    )
    return cfg, state.model


def make_student(run: Run, s2d: int, teacher, clock=None):
    """``unet2d_cells_fast`` (``s2d`` 2) or ``unet2d_cells_fast4`` (4):
    the space-to-depth preset distilled from ``teacher``, a ``(cfg,
    model)`` pair whose forward runs at its own compute dtype."""
    name = f"unet2d_cells_fast{'' if s2d == 2 else s2d}"
    cfg = run.cfg("unet2d_3class_fast" if s2d == 2 else "unet2d_3class_fast4")
    shards = sorted(
        os.path.join(run.work, f) for f in os.listdir(run.work) if f.startswith("seg2d")
    ) or _seg_shards(run.work, 48 if run.quick else 360, (256, 256))
    steps = 30 if run.quick else 1000
    distill = fit_lib.Distill(teacher=teacher[1], alpha=0.5, temperature=2.0)
    state = fit_lib.fit_unet(
        cfg, _cosine(1e-3, steps), run.fit_config(steps, 8, 16), shards, distill=distill,
        progress=clock, device=run.device,
    )
    fixtures.save(
        name, "unet", cfg, state.model,
        {"task": "distilled from unet2d_cells (fit.Distill)",
         "recipe": run.recipe(steps=steps, batch=8, lr="1e-3 cosine", alpha=0.5, temperature=2.0, s2d=s2d),
         "holdout_miou": _eval_unet(cfg, state.model, run.device)},
        run.out,
    )


def make_unet3d(run: Run, clock=None):
    cfg = run.cfg("unet3d_3class")
    shards = _seg_shards(run.work, 24 if run.quick else 240, (16, 64, 64), volumetric=True)
    steps = 20 if run.quick else 800
    state = fit_lib.fit_unet(
        cfg, _cosine(1e-3, steps), run.fit_config(steps, 2, 4), shards, progress=clock, device=run.device
    )
    fixtures.save(
        "unet3d_cells", "unet", cfg, state.model,
        {"task": "synthetic 3-class cell volumes (data/synthetic.py)",
         "recipe": run.recipe(steps=steps, batch=2, lr="1e-3 cosine", volume=[16, 64, 64]),
         "holdout_miou": _eval_unet(cfg, state.model, run.device)},
        run.out,
    )


def make_gan(run: Run, clock=None):
    cfg = run.cfg("gan_enhance")
    shards = _pair_shards(run.work, 48 if run.quick else 320, (256, 256))
    steps = 20 if run.quick else 800
    tc = train_lib.TrainConfig(learning_rate=2e-4, beta1=0.5, augment=False)
    state = fit_lib.fit_gan(cfg, tc, run.fit_config(steps, 8, 8), shards, progress=clock, device=run.device)
    fixtures.save(
        "gan_denoise", "gan", cfg, state.model,
        {"task": "smooth/denoise synthetic cells (gaussian sigma=1.5 target)",
         "recipe": run.recipe(steps=steps, batch=8, lr="2e-4 b1=0.5", l1_weight=100.0),
         "holdout_psnr": _eval_gan(state.model, run.device)},
        run.out,
    )


def make_n2v(run: Run, clock=None):
    """Noise2Void denoiser: trained on NOISY frames alone, scored against
    the clean renders it never saw (``synthetic.denoise_pair``)."""
    cfg = run.cfg("n2v_denoise")
    n = 64 if run.quick else 320
    shards = _n2v_shards(run.work, n)
    steps = 30 if run.quick else 1200
    state = fit_lib.fit_n2v(
        cfg, _cosine(4e-4, steps), run.fit_config(steps, 8, 8), shards, mask_frac=0.01, radius=5,
        progress=clock, device=run.device,
    )
    psnr, psnr_in = _eval_n2v(state.model, run.device)
    fixtures.save(
        "n2v_cells", "n2v", cfg, state.model,
        {"task": "self-supervised denoise of synthetic cells "
                 "(data/synthetic.py denoise_pair, sigma=0.1)",
         "recipe": run.recipe(steps=steps, batch=8, lr="4e-4 cosine", mask_frac=0.01, radius=5,
                              examples=n, patch=128),
         "holdout_psnr": psnr, "noisy_input_psnr": psnr_in},
        run.out,
    )


def make_flows(run: Run, clock=None):
    """Flow-field instance segmenter: trained on the touching-cell
    instance scenes (``synthetic.instances_frame``), scored by Hungarian
    instance AP on fresh seeds."""
    cfg = run.cfg("flows_cells")
    n = 16 if run.quick else 160
    shards = _instance_shards(run.work, n, "flows")
    steps = 30 if run.quick else 1500
    state = fit_lib.fit_flows(
        cfg, _cosine(3e-4, steps), run.fit_config(steps, 8, 8), shards, progress=clock, device=run.device
    )
    ap50, miou = _eval_instances(state.model, "flows", run.device)
    fixtures.save(
        "flows_cells", "flows", cfg, state.model,
        {"task": "flow-field instance segmentation of touching synthetic "
                 "cells (data/synthetic.py instances_frame)",
         "recipe": run.recipe(steps=steps, batch=8, lr="3e-4 cosine", examples=n, patch=128),
         "holdout_ap50": ap50, "holdout_matched_iou": miou},
        run.out,
    )


def make_stars(run: Run, clock=None):
    """Star-convex instance segmenter: the flows fixture's scenes and
    scoring, so the two learned separators stay directly comparable."""
    cfg = run.cfg("stars_cells")
    n = 16 if run.quick else 160
    shards = _instance_shards(run.work, n, "stars")
    steps = 30 if run.quick else 1500
    state = fit_lib.fit_stars(
        cfg, _cosine(3e-4, steps), run.fit_config(steps, 8, 8), shards, progress=clock, device=run.device
    )
    ap50, miou = _eval_instances(state.model, "stars", run.device)
    fixtures.save(
        "stars_cells", "stars", cfg, state.model,
        {"task": "star-convex instance segmentation of touching synthetic "
                 "cells (data/synthetic.py instances_frame)",
         "recipe": run.recipe(steps=steps, batch=8, lr="3e-4 cosine", examples=n, patch=128, n_rays=32),
         "holdout_ap50": ap50, "holdout_matched_iou": miou},
        run.out,
    )


def load_teacher(device: torch.device, directory: Optional[str] = None):
    """A saved teacher, ``(cfg, model)`` at its stored compute dtype: from
    ``directory``, or the committed fixture (read only) without one."""
    _, cfg, model, _ = fixtures.load("unet2d_cells", device=device, directory=directory)
    return cfg, model


_METRICS = ("holdout_miou", "holdout_psnr", "noisy_input_psnr", "holdout_ap50", "holdout_matched_iou")
_FIXTURE = {"fast": "unet2d_cells_fast", "fast4": "unet2d_cells_fast4"}


def _report(target: str, out: str, clock: StepClock, t0: float) -> Dict:
    """One fixture's line: its holdout metrics beside the committed ones."""
    name = _FIXTURE.get(target, target)
    meta = fixtures.manifest(out)[name]
    committed = fixtures.manifest().get(name, {})
    row = {
        "fixture": name,
        "steps": meta["recipe"]["steps"],
        "wall_s": round(time.perf_counter() - t0, 3),
        "step_ms": clock.median_ms(),
        "metrics": {k: meta[k] for k in _METRICS if k in meta},
        "committed": {k: committed[k] for k in _METRICS if k in committed},
    }
    print(json.dumps(row), flush=True)
    return row


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True, help="directory the fixtures are written to")
    ap.add_argument("--quick", action="store_true", help="tiny step counts and example sets")
    ap.add_argument("--only", default=None, help=f"comma list of: {' | '.join(TARGETS)}")
    ap.add_argument("--keep-work", action="store_true", help="keep the record shards")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the port's generators: initial weights, shuffle, augmentation draws")
    args = ap.parse_args(argv)
    only = set(args.only.split(",")) if args.only else None
    if only and only - set(TARGETS):
        ap.error(f"unknown --only targets {sorted(only - set(TARGETS))}; choose from {TARGETS}")
    device = resolve_device(args.device)
    out = os.path.abspath(args.out)
    if os.path.realpath(out) == os.path.realpath(fixtures.fixture_dir()):
        ap.error("--out names the committed fixtures' directory; give another one")
    want = lambda n: only is None or n in only  # noqa: E731
    work = tempfile.mkdtemp(prefix="fixtures-work-")
    run = Run(work, out, device, args.quick, args.seed)
    rows: List[Dict] = []
    try:
        teacher = None
        for target in TARGETS:
            if not want(target):
                continue
            clock, t0 = StepClock(device), time.perf_counter()
            if target == "unet2d_cells":
                teacher = make_teacher(run, clock)
            elif target in ("fast", "fast4"):
                if teacher is None:
                    saved = "unet2d_cells" in fixtures.manifest(out)
                    teacher = load_teacher(device, out if saved else None)
                    print(f"teacher loaded from {'--out' if saved else 'the committed fixture'}", flush=True)
                    t0 = time.perf_counter()
                make_student(run, 2 if target == "fast" else 4, teacher, clock)
            else:
                maker = {
                    "unet3d_cells": make_unet3d, "gan_denoise": make_gan, "n2v_cells": make_n2v,
                    "flows_cells": make_flows, "stars_cells": make_stars,
                }[target]
                maker(run, clock)
            rows.append(_report(target, out, clock, t0))
    finally:
        if args.keep_work:
            print(f"record shards kept in {work}", flush=True)
        else:
            shutil.rmtree(work, ignore_errors=True)
    return rows


if __name__ == "__main__":
    # the fit loops' progress and holdout evaluations, on stderr
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    main(sys.argv[1:])
