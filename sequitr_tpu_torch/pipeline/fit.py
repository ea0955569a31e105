"""The training loops: record shards in, trained checkpoint out (port of
``sequitr_tpu.pipeline.fit`` but its spatial trainer).

An epoch loop over shuffled record shards, host-to-device prefetch, the
train step, periodic checkpoints (``step_*``, pruned to the newest
``keep_checkpoints``), ``final``, ``best`` (keep_best on a holdout metric,
with early stopping), ``ema_*`` twins of every checkpoint when the weights'
moving average is on, resume from the newest checkpoint at its global step,
a JSONL metric stream, and cancellation that checkpoints before it raises.

Each step's augmentation draws from a generator seeded with (seed, global
step), and a resumed run skips the batches the interrupted run consumed,
so an interrupted run resumed from its checkpoint takes the same steps as
one that ran through. (The JAX package restarts the record stream on
resume.) ``fit_gan`` trains the enhancement GAN from (input, target) pair
shards (``encode_pair``), its EMA over the generator alone. ``fit_n2v``,
``fit_flows`` and ``fit_stars`` train from image-only, flow and ray
shards (their codecs are the JAX package's, byte for byte), each with its
holdout evaluator; the N2V evaluator scores one mask drawn once from a
generator seeded 0. Every record trainer takes a ``mesh``
(``parallel.make_mesh``): the step then runs data-parallel over its
devices with the global batch's statistics
(``parallel.make_dp_train_step``). ``fit_unet_spatial`` trains on whole
giant frames, their rows halo-sharded over the mesh
(``parallel.spatial_train``).
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
import json
import logging
import os
import shutil
import time
from typing import Callable, Dict, Iterable, Optional, Sequence, Union

import numpy as np
import torch

from sequitr_tpu_torch.data import records as records_lib
from sequitr_tpu_torch.data.prefetch import ShardIterator, load_holdout, prefetch_to_device
from sequitr_tpu_torch.models import gan as gan_lib
from sequitr_tpu_torch.models import unet
from sequitr_tpu_torch.ops import losses
from sequitr_tpu_torch.pipeline import train as train_lib
from sequitr_tpu_torch.utils import resolve_device

log = logging.getLogger("sequitr_tpu_torch.fit")

__all__ = [
    "FitConfig", "MetricsLogger", "Distill", "TrainingCancelled", "fit_unet",
    "fit_gan", "fit_n2v", "fit_flows", "fit_stars", "fit_unet_spatial", "encode_pair",
    "encode_image_example", "encode_flow_example", "encode_stars_example",
    "latest_checkpoint", "step_generator",
]


@dataclasses.dataclass(frozen=True)
class FitConfig:
    """The JAX package's ``FitConfig``: the same fields and defaults."""

    steps: int = 1000
    batch_size: int = 8
    checkpoint_every: int = 500
    log_every: int = 50
    seed: int = 0
    shuffle_buffer: int = 512
    prefetch_depth: int = 2
    holdout_every: int = 0
    eval_every: int = 0
    eval_limit: int = 16
    metrics_path: Optional[str] = None
    dump_eval_images: bool = False
    keep_checkpoints: int = 3
    keep_best_metric: str = ""
    early_stop_patience: int = 0
    ema_decay: float = 0.0


class MetricsLogger:
    """Append-only JSONL metric stream: ``{"kind": ..., "step": N, "wall":
    t, ...metrics}`` a line, flushed."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a")
        self._t0 = time.time()

    def write(self, kind: str, step: int, metrics: Dict[str, float]) -> None:
        rec = {"kind": kind, "step": step, "wall": round(time.time() - self._t0, 3)}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def _decode_seg(payload: bytes) -> Dict[str, np.ndarray]:
    ex = records_lib._decode_seg(payload)
    img = ex.image
    if img.ndim == ex.labels.ndim:  # add the channel axis
        img = img[..., None]
    out = {"image": img.astype(np.float32), "labels": ex.labels.astype(np.int32)}
    if ex.weights is not None:
        out["weights"] = ex.weights.astype(np.float32)
    return out


def _step_dirs(ckpt_dir: str):
    return sorted(
        n for n in os.listdir(ckpt_dir)
        if n.startswith("step_") and os.path.isdir(os.path.join(ckpt_dir, n))
    )


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """``final`` if the run completed, else the highest ``step_*``."""
    final = os.path.join(ckpt_dir, "final")
    if os.path.isdir(final):
        return final
    try:
        steps = _step_dirs(ckpt_dir)
    except FileNotFoundError:
        return None
    return os.path.join(ckpt_dir, steps[-1]) if steps else None


def _prune_checkpoints(ckpt_dir: str, keep: int) -> None:
    """Delete the oldest ``step_*`` checkpoints (and their EMA twins)
    beyond ``keep``; ``final`` and ``best`` stay; ``keep`` < 1 keeps all."""
    if keep < 1:
        return
    for name in _step_dirs(ckpt_dir)[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
        shutil.rmtree(os.path.join(ckpt_dir, f"ema_{name}"), ignore_errors=True)


def _ema_twin(ckpt_path: str) -> str:
    return os.path.join(os.path.dirname(ckpt_path), f"ema_{os.path.basename(ckpt_path)}")


@torch.no_grad()
def _ema_update(ema, params, decay: float) -> None:
    """``ema <- ema * decay + (1 - decay) * params``, in place."""
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, torch._foreach_mul([p.detach() for p in params], 1.0 - decay))


def _higher_is_better(metric: str) -> bool:
    """Loss-like names minimize; everything else maximizes."""
    return not metric.endswith(("_loss", "_mse", "_l1", "_rmse", "_bce"))


class TrainingCancelled(RuntimeError):
    """``should_stop`` fired; raised after the checkpoint is saved."""


def step_generator(seed: int, step: int) -> torch.Generator:
    """The augmentation generator of global step ``step`` (from 0)."""
    return torch.Generator().manual_seed((int(seed) << 32) + int(step))


def _run_loop(
    state: train_lib.TrainState,
    step_fn: Callable,
    batches: Iterable,
    fc: FitConfig,
    ckpt_dir: Optional[str],
    metric_keys: Sequence[str],
    eval_fn: Optional[Callable] = None,
    should_stop: Optional[Callable[[], bool]] = None,
    progress: Optional[Callable[[int, int], None]] = None,
    ema_select: Optional[Callable] = None,
):
    """Drive ``step_fn`` up to ``fc.steps`` total steps (a resumed state runs
    the rest); checkpoints are named by global step. ``eval_fn(state, g)``
    runs every ``fc.eval_every`` steps (default: every checkpoint) and at
    the end. ``ema_select(state)``: the parameters the EMA averages
    (default all of ``state.params``)."""
    if fc.early_stop_patience and not fc.keep_best_metric:
        raise ValueError("early_stop_patience requires keep_best_metric (the monitored eval metric)")
    if not 0.0 <= fc.ema_decay < 1.0:
        raise ValueError(f"ema_decay={fc.ema_decay} must be in [0, 1)")
    logger = MetricsLogger(fc.metrics_path) if fc.metrics_path else None
    eval_every = fc.eval_every or fc.checkpoint_every
    start = int(state.step)
    todo = max(0, fc.steps - start)
    ema = None
    ema_params = ema_select or (lambda s: s.params)
    if fc.ema_decay:
        # a copy of the current weights; a resumed run restores the twin of
        # the checkpoint it resumed from
        ema = [p.detach().clone() for p in ema_params(state)]
        if start > 0 and ckpt_dir:
            resumed = latest_checkpoint(ckpt_dir)
            if resumed and os.path.isdir(_ema_twin(resumed)):
                train_lib.restore_checkpoint(_ema_twin(resumed), ema)

    def save_ckpt(path):
        train_lib.save_checkpoint(path, state)
        if ema is not None:
            train_lib.save_checkpoint(_ema_twin(path), ema)

    t0 = time.time()
    seen = 0
    best = {"value": None}
    stall = {"n": 0, "stop": False}
    hib = _higher_is_better(fc.keep_best_metric) if fc.keep_best_metric else True

    def _improves(v) -> bool:
        if best["value"] is None:
            return True
        return v > best["value"] if hib else v < best["value"]

    # a resumed run takes its best value and staleness from the stream
    if fc.keep_best_metric and fc.metrics_path and os.path.exists(fc.metrics_path):
        with open(fc.metrics_path) as mf:
            for line in mf:
                try:
                    row = json.loads(line)
                except ValueError:
                    continue
                if row.get("kind") == "best" and fc.keep_best_metric in row:
                    v = float(row[fc.keep_best_metric])
                    if _improves(v):
                        best["value"] = v
                    if row.get("step", 0) <= start:
                        stall["n"] = 0
                elif (
                    row.get("kind") == "eval"
                    and fc.keep_best_metric in row
                    and row.get("step", 0) <= start
                ):
                    stall["n"] += 1

    def run_eval(g, terminal=False):
        if eval_fn is None:
            return
        ev = {k: float(v) for k, v in eval_fn(state, g).items()}
        log.info("eval @ step %d: %s", g, " ".join(f"{k}={v:.4f}" for k, v in ev.items()))
        if logger:
            logger.write("eval", g, ev)
        m = fc.keep_best_metric
        if not m:
            return
        if m not in ev:
            raise ValueError(f"keep_best_metric={m!r} not among eval metrics {sorted(ev)}")
        if _improves(ev[m]):
            best["value"] = ev[m]
            stall["n"] = 0
            if ckpt_dir:
                save_ckpt(os.path.join(ckpt_dir, "best"))
            log.info("new best %s=%.4f @ step %d", m, ev[m], g)
            if logger:
                logger.write("best", g, {m: ev[m]})
        else:
            stall["n"] += 1
            if fc.early_stop_patience and not terminal and stall["n"] >= fc.early_stop_patience:
                stall["stop"] = True
                log.info(
                    "early stop @ step %d: no %s improvement in %d evals (best %.4f)",
                    g, m, stall["n"], best["value"],
                )
                if logger:
                    logger.write(
                        "early_stop", g,
                        {m: ev[m], "best": best["value"], "stale_evals": stall["n"]},
                    )

    try:
        for i, batch in enumerate(batches):
            if i >= todo:
                break
            if should_stop is not None and should_stop():
                g = start + i
                if ckpt_dir:
                    save_ckpt(os.path.join(ckpt_dir, f"step_{g:08d}"))
                raise TrainingCancelled(f"training cancelled at step {g}/{fc.steps}")
            g = start + i + 1  # global step after this update
            state, metrics = step_fn(state, batch, step_generator(fc.seed, g - 1))
            if ema is not None:
                _ema_update(ema, ema_params(state), fc.ema_decay)
            seen += 1
            if progress is not None:
                progress(g, fc.steps)
            if g % fc.log_every == 0 or i + 1 == todo:
                vals = {k: float(metrics[k]) for k in metric_keys if k in metrics}
                rate = seen / (time.time() - t0)
                log.info(
                    "step %d/%d %s (%.2f steps/s)", g, fc.steps,
                    " ".join(f"{k}={v:.4f}" for k, v in vals.items()), rate,
                )
                if logger:
                    logger.write("train", g, dict(vals, steps_per_sec=rate))
            if g % eval_every == 0 and g < fc.steps:
                run_eval(g)
                if stall["stop"]:
                    break
            if ckpt_dir and g % fc.checkpoint_every == 0:
                save_ckpt(os.path.join(ckpt_dir, f"step_{g:08d}"))
                _prune_checkpoints(ckpt_dir, fc.keep_checkpoints)
        if not stall["stop"]:
            run_eval(int(state.step), terminal=True)
        if ckpt_dir:
            save_ckpt(os.path.join(ckpt_dir, "final"))
    finally:
        if logger:
            logger.close()
    return state


@dataclasses.dataclass
class Distill:
    """Teacher for distillation training: an inference ``UNet`` (folded or
    not); ``alpha`` weights the hard-label CE, ``1 - alpha`` the soft KL at
    ``temperature``."""

    teacher: unet.UNet
    alpha: float = 0.5
    temperature: float = 2.0


def _dump_dir(fc: FitConfig) -> Optional[str]:
    """Where an evaluator dumps its images: beside the metric stream."""
    if fc.dump_eval_images and fc.metrics_path:
        return os.path.dirname(os.path.abspath(fc.metrics_path))
    return None


def _make_unet_evaluator(
    cfg: unet.UNetConfig, fc: FitConfig, shard_paths: Sequence[str], device: torch.device
) -> Optional[Callable]:
    """Holdout evaluator: weighted-CE loss, accuracy, per-class and mean IoU
    on the examples ``ShardIterator`` skips; optionally dumps the first
    holdout prediction as a TIFF an eval."""
    holdout = load_holdout(shard_paths, _decode_seg, fc.holdout_every, fc.eval_limit)
    if holdout is None:
        log.warning("holdout_every=%d produced no eval examples", fc.holdout_every)
        return None
    images = torch.as_tensor(holdout["image"], device=device)
    labels = torch.as_tensor(holdout["labels"], device=device)
    weights = torch.as_tensor(holdout["weights"], device=device) if "weights" in holdout else None
    dump = _dump_dir(fc)

    def eval_fn(state, g):
        with torch.inference_mode():
            logits = state.model(images)
            loss = losses.weighted_softmax_cross_entropy(logits, labels, weights)
            preds = torch.argmax(logits, dim=-1)
            acc = (preds == labels).to(torch.float32).mean()
            per_class = losses.iou(preds, labels, cfg.num_classes).cpu().numpy()
        out = {
            "eval_loss": float(loss),
            "eval_accuracy": float(acc),
            "eval_miou": float(np.mean(per_class)),
        }
        for k, v in enumerate(per_class):
            out[f"eval_iou_{k}"] = float(v)
        if dump:
            from sequitr_tpu_torch.data import tiff

            tiff.write_stack(
                os.path.join(dump, f"eval_pred_{g:08d}.tif"),
                preds[0].cpu().numpy().astype(np.uint16),
            )
        return out

    return eval_fn


def _step_on(mesh, make_step: Callable, *args, **kwargs) -> Callable:
    """``make_step(*args, **kwargs)``, data-parallel over ``mesh`` when one
    is given (``parallel.make_dp_train_step``)."""
    if mesh is None:
        return make_step(*args, **kwargs)
    from sequitr_tpu_torch import parallel

    return parallel.make_dp_train_step(functools.partial(make_step, *args, **kwargs), mesh)


def _check_keep_best(fc: FitConfig, known: set) -> None:
    """Reject a misspelt ``keep_best_metric`` before any training."""
    if fc.keep_best_metric and fc.keep_best_metric not in known:
        raise ValueError(
            f"keep_best_metric={fc.keep_best_metric!r} is not an eval metric "
            f"this trainer produces; choose from {sorted(known)}"
        )


def fit_unet(
    cfg: unet.UNetConfig,
    tc: train_lib.TrainConfig,
    fc: FitConfig,
    shard_paths: Sequence[str],
    ckpt_dir: Optional[str] = None,
    init_state: Optional[train_lib.TrainState] = None,
    distill: Optional[Distill] = None,
    should_stop: Optional[Callable[[], bool]] = None,
    progress: Optional[Callable[[int, int], None]] = None,
    device: Union[str, torch.device, None] = None,
    mesh=None,
) -> train_lib.TrainState:
    """Train a U-Net from segmentation record shards on ``device`` (default
    the card); returns the final state. ``init_state`` (fresh or restored)
    replaces ``unet.init`` from ``fc.seed``; a state at step ``s`` > 0 skips
    the first ``s`` batches of the record stream. ``mesh``: data-parallel
    over its devices."""
    device = resolve_device(device)
    _check_keep_best(
        fc,
        {"eval_loss", "eval_accuracy", "eval_miou"}
        | {f"eval_iou_{k}" for k in range(cfg.num_classes)},
    )
    state = init_state or train_lib.create_unet_state(
        cfg, tc, torch.Generator().manual_seed(fc.seed), device
    )
    if distill is not None:
        step = _step_on(
            mesh, train_lib.make_unet_distill_step,
            cfg, distill.teacher, tc, alpha=distill.alpha, temperature=distill.temperature,
        )
        metric_keys = ("loss", "ce", "kd", "accuracy", "grad_norm")
    else:
        step = _step_on(mesh, train_lib.make_unet_train_step, cfg, tc)
        metric_keys = ("loss", "accuracy", "grad_norm")
    it = ShardIterator(
        shard_paths, _decode_seg, fc.batch_size, seed=fc.seed,
        shuffle_buffer=fc.shuffle_buffer, holdout_every=fc.holdout_every,
    )
    eval_fn = _make_unet_evaluator(cfg, fc, shard_paths, device) if fc.holdout_every else None
    host = itertools.islice(iter(it), int(state.step), None)
    batches = prefetch_to_device(host, depth=fc.prefetch_depth, device=device)
    return _run_loop(
        state, step, batches, fc, ckpt_dir, metric_keys, eval_fn=eval_fn,
        should_stop=should_stop, progress=progress,
    )


def _decode_pair(payload: bytes) -> Dict[str, np.ndarray]:
    f = records_lib.decode_example(payload)
    shape = tuple(int(v) for v in f["image/shape"])
    x = np.frombuffer(f["input/encoded"][0], dtype="<f4").reshape(shape)
    y = np.frombuffer(f["target/encoded"][0], dtype="<f4").reshape(shape)
    return {"input": x[..., None], "target": y[..., None]}


def encode_pair(x: np.ndarray, y: np.ndarray) -> bytes:
    """Encode a GAN training pair (raw, clean) as a record payload."""
    x = np.asarray(x, np.float32)
    return records_lib.encode_example(
        {
            "input/encoded": x.astype("<f4").tobytes(),
            "target/encoded": np.asarray(y, np.float32).astype("<f4").tobytes(),
            "image/shape": list(x.shape),
        }
    )


def _make_gan_evaluator(
    cfg: gan_lib.GANConfig, fc: FitConfig, shard_paths: Sequence[str], device: torch.device
) -> Optional[Callable]:
    """Holdout evaluator for the GAN: the inference-mode generator's L1 and
    PSNR against the targets (``eval_l1``, ``eval_psnr``); optionally dumps
    the first holdout output as a TIFF an eval."""
    holdout = load_holdout(shard_paths, _decode_pair, fc.holdout_every, fc.eval_limit)
    if holdout is None:
        log.warning("holdout_every=%d produced no eval examples", fc.holdout_every)
        return None
    x = torch.as_tensor(holdout["input"], device=device)
    y = torch.as_tensor(holdout["target"], device=device)
    dump = _dump_dir(fc)

    def eval_fn(state, g):
        with torch.inference_mode():
            fake = gan_lib.generator_apply(state.model, x).to(torch.float32)
            l1 = torch.mean(torch.abs(fake - y))
            mse = torch.mean((fake - y) ** 2)
        # data is [0, 1]-normalized: PSNR's peak is 1
        psnr = -10.0 * np.log10(max(float(mse), 1e-12))
        if dump:
            from sequitr_tpu_torch.data import tiff

            tiff.write_stack(
                os.path.join(dump, f"eval_enhanced_{g:08d}.tif"),
                fake[0, ..., 0].cpu().numpy().astype(np.float32),
            )
        return {"eval_l1": float(l1), "eval_psnr": psnr}

    return eval_fn


def fit_gan(
    cfg: gan_lib.GANConfig,
    tc: train_lib.TrainConfig,
    fc: FitConfig,
    shard_paths: Sequence[str],
    ckpt_dir: Optional[str] = None,
    init_state: Optional[train_lib.GANTrainState] = None,
    l1_weight: float = 100.0,
    should_stop: Optional[Callable[[], bool]] = None,
    progress: Optional[Callable[[int, int], None]] = None,
    device: Union[str, torch.device, None] = None,
    mesh=None,
) -> train_lib.GANTrainState:
    """Train the enhancement GAN from (input, target) pair shards on
    ``device`` (default the card); returns the final state. ``init_state``
    (fresh or restored) replaces ``gan.init`` from ``fc.seed``; a state at
    step ``s`` > 0 skips the first ``s`` batches. The EMA (``ema_decay``)
    averages the generator only: serving runs the generator alone."""
    device = resolve_device(device)
    _check_keep_best(fc, {"eval_l1", "eval_psnr"})
    state = init_state or train_lib.create_gan_state(
        cfg, tc, torch.Generator().manual_seed(fc.seed), device
    )
    step = _step_on(mesh, train_lib.make_gan_train_step, cfg, tc, l1_weight=l1_weight)
    it = ShardIterator(
        shard_paths, _decode_pair, fc.batch_size, seed=fc.seed,
        shuffle_buffer=fc.shuffle_buffer, holdout_every=fc.holdout_every,
    )
    eval_fn = _make_gan_evaluator(cfg, fc, shard_paths, device) if fc.holdout_every else None
    host = itertools.islice(iter(it), int(state.step), None)
    batches = prefetch_to_device(host, depth=fc.prefetch_depth, device=device)
    return _run_loop(
        state, step, batches, fc, ckpt_dir, ("d_loss", "g_loss"),
        eval_fn=eval_fn, should_stop=should_stop, progress=progress,
        ema_select=lambda s: list(s.model.gen.parameters()),
    )


# ---------------------------------------------------------------------------
# Noise2Void, flows and stars: codecs, holdout evaluators, fit loops
# ---------------------------------------------------------------------------


def _decode_image(payload: bytes) -> Dict[str, np.ndarray]:
    """Decode an image-only example (Noise2Void shards: no labels)."""
    f = records_lib.decode_example(payload)
    shape = tuple(int(v) for v in f["image/shape"])
    x = np.frombuffer(f["image/encoded"][0], dtype="<f4").reshape(shape)
    if x.ndim == 2:
        x = x[..., None]
    return {"image": x.astype(np.float32)}


def encode_image_example(x: np.ndarray) -> bytes:
    """Encode an image-only record payload ((H, W), (H, W, C) or a volume
    with its channel axis, float32)."""
    x = np.asarray(x, np.float32)
    return records_lib.encode_example(
        {"image/encoded": x.astype("<f4").tobytes(), "image/shape": list(x.shape)}
    )


def _fit(init_state, cfg, tc, fc, device, make_step, shard_paths, decode, make_eval, metric_keys, ckpt_dir,
         should_stop, progress):
    """The shared body of the N2V, flows and stars fit loops."""
    state = init_state or train_lib.create_unet_state(
        cfg, tc, torch.Generator().manual_seed(fc.seed), device
    )
    it = ShardIterator(
        shard_paths, decode, fc.batch_size, seed=fc.seed,
        shuffle_buffer=fc.shuffle_buffer, holdout_every=fc.holdout_every,
    )
    eval_fn = make_eval() if fc.holdout_every else None
    host = itertools.islice(iter(it), int(state.step), None)
    batches = prefetch_to_device(host, depth=fc.prefetch_depth, device=device)
    return _run_loop(
        state, make_step, batches, fc, ckpt_dir, metric_keys, eval_fn=eval_fn,
        should_stop=should_stop, progress=progress,
    )


def _make_n2v_evaluator(
    cfg: unet.UNetConfig,
    fc: FitConfig,
    shard_paths: Sequence[str],
    device: torch.device,
    mask_frac: float,
    radius,
    mask_mode: str = "uniform",
    struct=None,
    draws: Optional[train_lib.N2VMaskDraws] = None,
) -> Optional[Callable]:
    """Holdout evaluator for Noise2Void: the masked MSE of the inference
    forward under one mask, drawn once from a generator seeded 0 (or
    ``draws``), so every eval scores the same pixels: ``eval_n2v_mse`` and
    ``eval_psnr_masked`` = -10 log10(mse). Optionally dumps the first
    holdout image denoised (unmasked) as a TIFF an eval."""
    holdout = load_holdout(shard_paths, _decode_image, fc.holdout_every, fc.eval_limit)
    if holdout is None:
        log.warning("holdout_every=%d produced no eval examples", fc.holdout_every)
        return None
    images = torch.as_tensor(holdout["image"], device=device)
    n_mask = max(1, int(mask_frac * int(np.prod(images.shape[1:-1]))))
    radii = train_lib._n2v_radii(radius, images.ndim - 2)
    if draws is None:
        draws = train_lib.n2v_draw_mask(
            torch.Generator().manual_seed(0), images.shape, n_mask, radii, mask_mode, struct
        )
    masked, coords = train_lib.n2v_mask_apply(images, draws, radii, mask_mode, struct)
    dump = _dump_dir(fc)

    def eval_fn(state, g):
        with torch.inference_mode():
            mse = max(float(train_lib.n2v_masked_mse(state.model(masked), images, *coords)), 1e-12)
            pred = state.model(images[:1]) if dump else None
        if dump:
            from sequitr_tpu_torch.data import tiff

            tiff.write_stack(
                os.path.join(dump, f"eval_denoised_{g:08d}.tif"),
                pred[0, ..., 0].to(torch.float32).cpu().numpy(),
            )
        return {"eval_n2v_mse": mse, "eval_psnr_masked": -10.0 * np.log10(mse)}

    return eval_fn


def fit_n2v(
    cfg: unet.UNetConfig,
    tc: train_lib.TrainConfig,
    fc: FitConfig,
    shard_paths: Sequence[str],
    ckpt_dir: Optional[str] = None,
    init_state: Optional[train_lib.TrainState] = None,
    mask_frac: float = 0.005,
    radius=5,
    mask_mode: str = "uniform",
    struct=None,
    should_stop: Optional[Callable[[], bool]] = None,
    progress: Optional[Callable[[int, int], None]] = None,
    device: Union[str, torch.device, None] = None,
    eval_draws: Optional[train_lib.N2VMaskDraws] = None,
    mesh=None,
) -> train_lib.TrainState:
    """Train a Noise2Void denoiser from image-only shards on ``device``
    (default the card): ``fit_unet``'s loop with ``make_n2v_train_step``;
    the holdout evaluator scores under the same masking (``eval_draws``
    replaces its seeded draw)."""
    device = resolve_device(device)
    _check_keep_best(fc, {"eval_n2v_mse", "eval_psnr_masked"})
    step = _step_on(
        mesh, train_lib.make_n2v_train_step,
        cfg, tc, mask_frac=mask_frac, radius=radius, mask_mode=mask_mode, struct=struct,
    )
    return _fit(
        init_state, cfg, tc, fc, device, step, shard_paths, _decode_image,
        lambda: _make_n2v_evaluator(
            cfg, fc, shard_paths, device, mask_frac, radius, mask_mode, struct, eval_draws
        ),
        ("loss", "grad_norm"), ckpt_dir, should_stop, progress,
    )


def _decode_flow(payload: bytes) -> Dict[str, np.ndarray]:
    """Decode a flows training example (image + flow field + cell prob)."""
    f = records_lib.decode_example(payload)
    ishape = tuple(int(v) for v in f["image/shape"])
    x = np.frombuffer(f["image/encoded"][0], dtype="<f4").reshape(ishape)
    if x.ndim == 2:
        x = x[..., None]
    nd = x.ndim - 1
    spatial = x.shape[:nd]
    flow = np.frombuffer(f["flow/encoded"][0], dtype="<f4").reshape(spatial + (nd,))
    prob = np.frombuffer(f["prob/encoded"][0], dtype="<f4").reshape(spatial)
    return {"image": x.astype(np.float32), "flow": flow, "prob": prob}


def encode_flow_example(image: np.ndarray, flow: np.ndarray, prob: np.ndarray) -> bytes:
    """Encode a flows example: image (*s, C) or (*s), flow (*s, D), prob
    (*s), all float32 (targets from ``ops.flows.flow_targets``)."""
    image = np.asarray(image, np.float32)
    if image.ndim == flow.ndim - 1:
        image = image[..., None]
    return records_lib.encode_example(
        {
            "image/encoded": image.astype("<f4").tobytes(),
            "flow/encoded": np.asarray(flow, np.float32).astype("<f4").tobytes(),
            "prob/encoded": np.asarray(prob, np.float32).astype("<f4").tobytes(),
            "image/shape": list(image.shape),
        }
    )


def _holdout_tensors(shard_paths, decode, fc, device):
    holdout = load_holdout(shard_paths, decode, fc.holdout_every, fc.eval_limit)
    if holdout is None:
        log.warning("holdout_every=%d produced no eval examples", fc.holdout_every)
        return None
    return {k: torch.as_tensor(v, device=device) for k, v in holdout.items()}


def _make_flows_evaluator(
    cfg: unet.UNetConfig, fc: FitConfig, shard_paths: Sequence[str], device: torch.device
) -> Optional[Callable]:
    """Holdout evaluator for flows: the inference forward's flow MSE and
    prob BCE (``eval_flow_mse``, ``eval_prob_bce``, their sum
    ``eval_loss``)."""
    held = _holdout_tensors(shard_paths, _decode_flow, fc, device)
    if held is None:
        return None

    def eval_fn(state, g):
        with torch.inference_mode():
            _, flow_mse, prob_bce = train_lib.flows_loss(state.model(held["image"]), held["flow"], held["prob"])
        flow_mse, prob_bce = float(flow_mse), float(prob_bce)
        return {"eval_loss": flow_mse + prob_bce, "eval_flow_mse": flow_mse, "eval_prob_bce": prob_bce}

    return eval_fn


def fit_flows(
    cfg: unet.UNetConfig,
    tc: train_lib.TrainConfig,
    fc: FitConfig,
    shard_paths: Sequence[str],
    ckpt_dir: Optional[str] = None,
    init_state: Optional[train_lib.TrainState] = None,
    should_stop: Optional[Callable[[], bool]] = None,
    progress: Optional[Callable[[int, int], None]] = None,
    device: Union[str, torch.device, None] = None,
    mesh=None,
) -> train_lib.TrainState:
    """Train a flow-field instance segmenter from flow shards on ``device``
    (default the card): ``fit_unet``'s loop with ``make_flows_train_step``."""
    device = resolve_device(device)
    _check_keep_best(fc, {"eval_loss", "eval_flow_mse", "eval_prob_bce"})
    return _fit(
        init_state, cfg, tc, fc, device, _step_on(mesh, train_lib.make_flows_train_step, cfg, tc), shard_paths,
        _decode_flow, lambda: _make_flows_evaluator(cfg, fc, shard_paths, device),
        ("loss", "flow_mse", "prob_bce", "grad_norm"), ckpt_dir, should_stop, progress,
    )


def _decode_stars(payload: bytes) -> Dict[str, np.ndarray]:
    """Decode a star-convex training example (image + ray dists + prob)."""
    f = records_lib.decode_example(payload)
    ishape = tuple(int(v) for v in f["image/shape"])
    n_rays = int(f["dist/n_rays"][0])
    x = np.frombuffer(f["image/encoded"][0], dtype="<f4").reshape(ishape)
    if x.ndim == 2:
        x = x[..., None]
    spatial = x.shape[:2]
    dist = np.frombuffer(f["dist/encoded"][0], dtype="<f4").reshape(spatial + (n_rays,))
    prob = np.frombuffer(f["prob/encoded"][0], dtype="<f4").reshape(spatial)
    return {"image": x.astype(np.float32), "dist": dist, "prob": prob}


def encode_stars_example(image: np.ndarray, dist: np.ndarray, prob: np.ndarray) -> bytes:
    """Encode a star-convex example: image (H, W[, C]), dist (H, W,
    n_rays), prob (H, W), all float32 (targets from
    ``ops.stardist.star_targets``)."""
    image = np.asarray(image, np.float32)
    if image.ndim == 2:
        image = image[..., None]
    return records_lib.encode_example(
        {
            "image/encoded": image.astype("<f4").tobytes(),
            "dist/encoded": np.asarray(dist, np.float32).astype("<f4").tobytes(),
            "prob/encoded": np.asarray(prob, np.float32).astype("<f4").tobytes(),
            "image/shape": list(image.shape),
            "dist/n_rays": [int(dist.shape[-1])],
        }
    )


def _make_stars_evaluator(
    cfg: unet.UNetConfig, fc: FitConfig, shard_paths: Sequence[str], device: torch.device
) -> Optional[Callable]:
    """Holdout evaluator for stars: the inference forward's prob BCE and
    distance MAE weighted by ``prob`` itself (the train step weights by
    ``prob > 0``; both as in the JAX package): ``eval_dist_mae``,
    ``eval_prob_bce`` and ``eval_loss`` = BCE + ``STARS_DIST_WEIGHT`` x
    MAE."""
    held = _holdout_tensors(shard_paths, _decode_stars, fc, device)
    if held is None:
        return None
    n_rays = cfg.num_classes - 1

    def eval_fn(state, g):
        with torch.inference_mode():
            out = state.model(held["image"]).to(torch.float32)
            prob_bce = float(losses.sigmoid_bce_with_logits(out[..., 0], held["prob"]))
            w = held["prob"][..., None]
            dist_mae = float(
                torch.sum(w * torch.abs(out[..., 1:] - held["dist"])) / (torch.sum(w) * n_rays + 1e-8)
            )
        return {
            "eval_loss": prob_bce + train_lib.STARS_DIST_WEIGHT * dist_mae,
            "eval_dist_mae": dist_mae,
            "eval_prob_bce": prob_bce,
        }

    return eval_fn


def fit_stars(
    cfg: unet.UNetConfig,
    tc: train_lib.TrainConfig,
    fc: FitConfig,
    shard_paths: Sequence[str],
    ckpt_dir: Optional[str] = None,
    init_state: Optional[train_lib.TrainState] = None,
    should_stop: Optional[Callable[[], bool]] = None,
    progress: Optional[Callable[[int, int], None]] = None,
    device: Union[str, torch.device, None] = None,
    mesh=None,
) -> train_lib.TrainState:
    """Train a star-convex instance segmenter from stars shards on
    ``device`` (default the card): ``fit_unet``'s loop with
    ``make_stars_train_step``."""
    device = resolve_device(device)
    _check_keep_best(fc, {"eval_loss", "eval_dist_mae", "eval_prob_bce"})
    return _fit(
        init_state, cfg, tc, fc, device, _step_on(mesh, train_lib.make_stars_train_step, cfg, tc), shard_paths,
        _decode_stars, lambda: _make_stars_evaluator(cfg, fc, shard_paths, device),
        ("loss", "dist_mae", "prob_bce", "grad_norm"), ckpt_dir, should_stop, progress,
    )


def fit_unet_spatial(
    cfg: unet.UNetConfig,
    tc: train_lib.TrainConfig,
    fc: FitConfig,
    batches: Iterable,
    mesh,
    frame_spatial,
    ckpt_dir: Optional[str] = None,
    init_state: Optional[train_lib.TrainState] = None,
    data_axis: Optional[str] = None,
    space_axis: str = "data",
    should_stop: Optional[Callable[[], bool]] = None,
    progress: Optional[Callable[[int, int], None]] = None,
    device: Union[str, torch.device, None] = None,
) -> train_lib.TrainState:
    """Finetune on WHOLE giant frames, rows halo-sharded over ``mesh``.

    The training counterpart of the ``spatial_parallel`` serve: each step
    takes one item of ``batches`` (dicts of (batch, *frame_spatial) frames,
    numpy or tensors) through ``parallel.spatial_train``'s step (halo
    convs, batch-norm statistics over the mesh, one Adam update on
    ``device``); augmentation must be off. Checkpoints, resume (a state at
    step ``s`` skips the first ``s`` batches, as the other loops here do),
    the metric stream, cancellation and progress ride ``_run_loop``.
    """
    device = resolve_device(device)
    _check_keep_best(fc, set())
    from sequitr_tpu_torch.parallel import spatial_train

    state = init_state or train_lib.create_unet_state(
        cfg, tc, torch.Generator().manual_seed(fc.seed), device
    )
    step = spatial_train.make_spatial_train_step(
        cfg, tc, mesh, tuple(frame_spatial), fc.batch_size,
        space_axis=space_axis, data_axis=data_axis,
    )
    host = itertools.islice(iter(batches), int(state.step), None)
    return _run_loop(
        state, step, prefetch_to_device(host, depth=fc.prefetch_depth, device=device), fc, ckpt_dir,
        ("loss", "accuracy", "grad_norm"), should_stop=should_stop, progress=progress,
    )
