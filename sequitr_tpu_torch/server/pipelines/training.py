"""Training pipelines: record building and the U-Net and GAN train jobs
(port of the U-Net and GAN parts of
``sequitr_tpu.server.pipelines.training``).

``build_records`` and ``build_gan_pairs`` are the JAX package's, copied
(host numpy: the same job JSON writes the same shards, byte for byte,
normalized by ``np.percentile`` on the host, no quantile pass on the
card). ``train_unet2d`` / ``train_unet3d`` (``pipeline.fit.fit_unet``) and
``train_gan`` (``pipeline.fit.fit_gan``) train on ``config.device`` (the
card unless the server runs on the CPU) and register the model in the
port's store (kind ``unet`` or ``gan``); ``polyphase: true`` trains
through ``models.polyphase.apply_train`` (``apply3d_train``).
``train_n2v`` (2D and volumes, ``pipeline.fit.fit_n2v``) builds its own
image-only shards on the host and registers kind ``n2v``; its helpers
(``_family_train_config``, ``_fit_config``, ``_fit_and_register``)
also serve ``train_flows`` and ``train_stars``. ``data_parallel: true``
splits every batch over the device pool (``parallel.device_pool``; the
global batch's statistics, ``server._train_mesh``) and trains
single-device on a pool of one. ``finetune_spatial``
(``pipeline.fit.fit_unet_spatial``) finetunes on whole giant frames, their
rows halo-sharded over the pool.
"""

from __future__ import annotations

import glob as glob_lib
import os
from typing import Dict

import numpy as np

from sequitr_tpu_torch.config import ServerConfiguration
from sequitr_tpu_torch.server import jobs as jobs_lib
from sequitr_tpu_torch.server.jobs import Job
from sequitr_tpu_torch.server.server import (
    _check_ignore_collision,
    _ema_or_raw_params,
    _n_devices,
    _parse_ema_decay,
    _parse_ignore_label,
    _parse_patience,
    _parse_z_pages,
    _require_param,
    _resolve_globs,
    _resolve_inputs,
    _train_mesh,
    load_model_cached,
    read_model,
    register,
    save_model,
    unet_config_from_params,
)
from sequitr_tpu_torch.utils import resolve_device


@register("build_records")
def build_records(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Build training record shards from image + label TIFF stacks.

    The reference computes U-Net weight maps at record-creation time
    (SURVEY.md §3.2); this pipeline mirrors that: input = [images.tif,
    labels.tif], params: weight_maps (bool, default True), w0, sigma,
    shard_size, num_classes, dims (2: each frame of a (T, H, W) stack is
    one example; 3: the whole (Z, H, W) stack is one volumetric example),
    patch + patches_per_example (random-crop sub-examples, e.g. 256x256
    patches from 1024x1024 frames or sub-volumes from a z-stack), seed.

    ``ignore_label`` (sparse/partial annotations — the realistic hand-
    labelling regime): pixels carrying this label value are UNANNOTATED.
    They get loss weight 0 (the weighted CE's sum(w)-normalization makes
    that a true ignore) and are remapped to class 0 in the stored labels
    so downstream one-hots stay in range; class-balance statistics count
    only annotated pixels. Works with or without ``weight_maps`` (without,
    the stored weights are the pure annotation mask) and must not collide
    with a real class id (use e.g. 255).

    Output: ``train-*.tfrecord`` shards.
    """
    from sequitr_tpu_torch.data import records, tiff
    from sequitr_tpu_torch.data.source import FrameSource
    from sequitr_tpu_torch.ops import weightmaps

    paths = _resolve_inputs(job)
    if len(paths) < 2:
        raise jobs_lib.JobError("build_records needs [*image stacks, labels]")
    *img_paths, lab_path = paths
    p = job.params
    dims = int(p.get("dims", 2))
    # parse ONCE, before the default-class scan touches it: a malformed
    # value must be a deterministic JobError, not a retried ValueError
    ignore_label = _parse_ignore_label(job)
    closers: list = []  # lazy readers to close once the shards are written

    if dims == 3:
        # the whole (Z, H, W) stack is ONE volume example — eager read
        chans = [
            np.asarray(tiff.read_stack(ip), dtype=np.float32)
            for ip in img_paths
        ]
        labels3 = np.asarray(tiff.read_stack(lab_path)).astype(np.int32)
        if labels3.ndim != 3:
            raise jobs_lib.JobError(
                f"dims=3 expects one (Z, H, W) stack, got {labels3.shape}"
            )
        for c in chans:
            if c.shape != labels3.shape:
                raise jobs_lib.JobError(
                    f"image/label shape mismatch: {c.shape} vs {labels3.shape}"
                )
        images3 = np.stack(chans, axis=-1) if len(chans) > 1 else chans[0]
        multi_channel = len(chans) > 1
        n_frames = 1

        def pair_iter():
            yield images3, labels3

        default_classes = 0
        if "num_classes" not in p:
            vals = labels3
            if ignore_label is not None:
                vals = vals[vals != ignore_label]
            default_classes = int(vals.max()) + 1 if vals.size else 1
    else:
        # dims=2: stream frame pairs lazily — a timelapse larger than host
        # RAM builds records with O(frame) memory (round-3 streaming)
        try:
            source = FrameSource(paths=img_paths)
        except ValueError as e:
            raise jobs_lib.JobError(f"job {job.id}: cannot read inputs: {e}")
        closers.append(source.close)
        try:
            l_reader = tiff.TiffReader(lab_path)
            closers.append(l_reader.close)
            l_shape = l_reader.shape
            read_lab = lambda i: np.asarray(
                l_reader.read_frame(i)
            ).astype(np.int32)
        except ValueError:
            arr = np.asarray(tiff.read_stack(lab_path)).astype(np.int32)
            if arr.ndim == 2:
                arr = arr[None]
            l_shape = arr.shape
            read_lab = lambda i: arr[i]
        if (len(source),) + source.spatial != tuple(l_shape):
            raise jobs_lib.JobError(
                f"image/label shape mismatch: "
                f"{(len(source),) + source.spatial} vs {tuple(l_shape)}"
            )
        multi_channel = source.n_channels > 1
        n_frames = len(source)

        def pair_iter():
            for t in range(n_frames):
                yield source.frame(t), read_lab(t)

        default_classes = 0
        if "num_classes" not in p:
            # one bounded pass over the (small) label stack for the
            # default; an ignore_label must not inflate the class count
            def _frame_max(t):
                lab_t = read_lab(t)
                if ignore_label is not None:
                    lab_t = lab_t[lab_t != ignore_label]
                return int(lab_t.max()) if lab_t.size else 0

            default_classes = 1 + max(
                _frame_max(t) for t in range(n_frames)
            )

    patch = tuple(int(v) for v in p["patch"]) if "patch" in p else None
    if patch is not None and len(patch) != dims:
        raise jobs_lib.JobError(f"patch {patch} must have {dims} axes")
    n_crops = int(p.get("patches_per_example", 4))
    rng = np.random.default_rng(int(p.get("seed", 0)))

    num_classes = int(p.get("num_classes", default_classes))
    _check_ignore_collision(ignore_label, num_classes)
    p_lo, p_hi = float(p.get("p_lo", 5.0)), float(p.get("p_hi", 99.5))
    counter = {"n": 0}

    def gen_examples():
        for img, lab in jobs_lib.track(
            job, pair_iter(), total=n_frames, phase="frames"
        ):
            # frames arrive in storage dtype; records store float32
            img = np.asarray(img, dtype=np.float32)
            if p.get("normalize", True):
                # records store normalized intensities so training sees the
                # same distribution tiled inference feeds the net (SURVEY.md
                # §3.2/3.3); multi-channel normalizes per channel
                img = _normalize_frame(img, lab.ndim, p_lo, p_hi)
            if patch is not None:
                if any(ps > s for s, ps in zip(lab.shape, patch)):
                    raise jobs_lib.JobError(
                        f"patch {patch} larger than example {lab.shape}"
                    )
                crops = []
                for _ in range(n_crops):
                    sl = _crop(rng, lab.shape, patch)
                    img_sl = sl + (slice(None),) if multi_channel else sl
                    crops.append((img[img_sl], lab[sl]))
            else:
                crops = [(img, lab)]
            for ci, cl in crops:
                valid = None
                if ignore_label is not None:
                    valid = cl != ignore_label
                    cl = np.where(valid, cl, 0).astype(cl.dtype)
                w = None
                if p.get("weight_maps", True):
                    w = weightmaps.unet_weight_map(
                        cl, num_classes=num_classes,
                        w0=float(p.get("w0", 10.0)),
                        sigma=float(p.get("sigma", 5.0)),
                        valid=valid,
                    )
                elif valid is not None:
                    # no Ronneberger map requested: the stored weights
                    # are the pure annotation mask (still a true ignore)
                    w = valid.astype(np.float32)
                counter["n"] += 1
                yield records.SegExample(ci, cl, w)

    try:
        shard_paths = records.write_segmentation_shards(
            os.path.join(job.output, "train"), gen_examples(),
            shard_size=int(p.get("shard_size", 128)),
            compression="gzip" if p.get("compress_records") else None,
        )
    finally:
        for close in closers:
            close()
    return {"shards": os.path.join(job.output, "train-*.tfrecord"),
            "n_examples": str(counter["n"]), "n_shards": str(len(shard_paths))}


def _polyphase_train_param(p, cfg) -> bool:
    """Read the ``polyphase`` training param with deterministic
    rejection of uncovered models (mirrors the serving gate)."""
    poly = bool(p.get("polyphase", False))
    if poly and (
        cfg.dims not in (2, 3) or cfg.space_to_depth != 1
        or cfg.upsample != "transpose" or cfg.depth < 2
    ):
        raise jobs_lib.JobError(
            "polyphase training requires a space_to_depth=1 "
            f"transpose-upsample model of depth >= 2; got dims={cfg.dims}, "
            f"s2d={cfg.space_to_depth}, upsample={cfg.upsample!r}, "
            f"depth={cfg.depth}"
        )
    return poly


@register("train_unet2d")
def train_unet2d(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Train a 2D U-Net from record shards and register it as a model.

    input: record shard paths (globs or a build_records output directory).
    params: model (output name), architecture (num_classes, depth,
    base_features, norm, ...), training (steps, batch_size, learning_rate,
    augmentation knobs, ``grad_accum``, ``remat``, the lr schedule),
    observability (holdout_every, eval_every, dump_eval_images), keep_best,
    early_stop_patience, ema_decay, resume, distill_from.
    """
    return _train_unet(job, config)


@register("train_unet3d")
def train_unet3d(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Train a volumetric 3D U-Net from record shards: ``train_unet2d``'s
    parameters with ``dims`` defaulting to 3 (records of (Z, H, W) volumes,
    e.g. ``build_records`` with ``dims: 3``)."""
    job.params.setdefault("dims", 3)
    return _train_unet(job, config)


def _train_unet(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    from sequitr_tpu_torch.pipeline import fit as fit_lib
    from sequitr_tpu_torch.pipeline import train as train_lib

    device = resolve_device(config.device)
    shard_paths: list = []
    for pattern in _resolve_globs(job):
        shard_paths.extend(sorted(glob_lib.glob(pattern)))
    if not shard_paths:
        raise jobs_lib.JobError(f"job {job.id}: no record shards found")
    p = job.params
    cfg = unet_config_from_params(p)
    steps = int(p.get("steps", 1000))
    tc = train_lib.TrainConfig(
        polyphase=_polyphase_train_param(p, cfg),
        learning_rate=float(p.get("learning_rate", 1e-4)),
        augment=bool(p.get("augment", True)),
        elastic_alpha=float(p.get("elastic_alpha", 20.0)),
        elastic_grid=int(p.get("elastic_grid", 4)),
        p_elastic=float(p.get("p_elastic", 0.5)),
        gain_jitter=float(p.get("gain_jitter", 0.0)),
        offset_jitter=float(p.get("offset_jitter", 0.0)),
        noise_std=float(p.get("noise_std", 0.0)),
        grad_accum=int(p.get("grad_accum", 1)),
        remat=bool(p.get("remat", False)),
        lr_schedule=str(p.get("lr_schedule", "constant")),
        lr_warmup_steps=int(p.get("lr_warmup_steps", 0)),
        # the decay runs over the steps after the warmup by default
        lr_decay_steps=int(
            p.get("lr_decay_steps", max(1, steps - int(p.get("lr_warmup_steps", 0))))
        ),
        lr_end_factor=float(p.get("lr_end_factor", 0.01)),
    )
    fc = _fit_config(job, "eval_miou", 8)
    ckpt_dir = os.path.join(job.output, "ckpts")
    init_state = _resume_state(job, cfg, tc, device)
    distill = None
    if p.get("distill_from"):
        t_kind, _, teacher = load_model_cached(config.models_dir, p["distill_from"], device=device)
        if t_kind != "unet":
            raise jobs_lib.JobError(f"distill_from={p['distill_from']!r} is not a unet model")
        distill = fit_lib.Distill(
            teacher,
            alpha=float(p.get("distill_alpha", 0.5)),
            temperature=float(p.get("distill_temperature", 2.0)),
        )
    # the fit loop owns the cancel poll (it checkpoints before raising)
    rep = jobs_lib.ProgressReporter(job, steps, phase="steps", raise_on_cancel=False)
    try:
        state = fit_lib.fit_unet(
            cfg, tc, fc, shard_paths, ckpt_dir=ckpt_dir, init_state=init_state,
            distill=distill, should_stop=lambda: jobs_lib.cancel_requested(job),
            progress=lambda s, _t: rep.step(s), device=device,
            mesh=_train_mesh(p, fc.batch_size, device),
        )
    except fit_lib.TrainingCancelled as e:
        raise jobs_lib.JobCancelled(str(e))
    rep.finish()
    best_path = os.path.join(ckpt_dir, "best")
    used_best = bool(fc.keep_best_metric) and os.path.isdir(best_path)
    if used_best:
        # register the checkpoint with the best holdout metric, not the last
        state = train_lib.restore_checkpoint(best_path, state)
    model = _ema_or_raw_params(ckpt_dir, fc, state, used_best)
    model_dir = save_model(config.models_dir, _require_param(job, "model"), "unet", cfg, model)
    return {"model": model_dir, "metrics_file": fc.metrics_path}


@register("finetune_spatial")
def finetune_spatial(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Finetune a U-Net on WHOLE giant frames, rows sharded over the devices.

    The training counterpart of the ``spatial_parallel`` serve: frames too
    large to train as one-device batches (16k x 16k slide-scanner mosaics)
    train with their rows halo-sharded over the device pool
    (``parallel.spatial_train``: the whole-frame step, batch-norm
    statistics over the mesh). No record shards: the job reads the stacks.

    input: [*image stacks (one per channel), labels stack]. params:
    ``model`` (output name, required), ``from_model`` (a registered unet
    model to start from, trained in f32 and registered again with its own
    compute dtype; omit it to train from scratch with the architecture
    params), ``weights_input`` (optional per-pixel loss-weight stack),
    ``steps``, ``batch_size`` (default 1), ``learning_rate``,
    ``grad_accum``, ``remat``, ``data_ways`` (hybrid: the batch split this
    many ways and the rows over the rest; default 1, rows only),
    ``normalize`` (default true: percentile [p_lo, p_hi] -> [0, 1] per
    frame on the host, as ``build_records``), ``checkpoint_every``,
    ``log_every``, ``keep_checkpoints``, ``seed`` (the frame order:
    ``np.random.default_rng(seed)``), ``resume`` (default true). Frame
    heights must divide the space ways times the model's pooling multiple.
    Cancellation checkpoints first; a re-submitted job resumes.
    Augmentation is off by design (warps cross shard boundaries).
    """
    import dataclasses

    from sequitr_tpu_torch import parallel
    from sequitr_tpu_torch.data import tiff
    from sequitr_tpu_torch.data.source import FrameSource
    from sequitr_tpu_torch.models import convert as convert_lib
    from sequitr_tpu_torch.parallel.spatial import _validate_spatial
    from sequitr_tpu_torch.pipeline import fit as fit_lib
    from sequitr_tpu_torch.pipeline import train as train_lib

    device = resolve_device(config.device)
    paths = _resolve_inputs(job)
    if len(paths) < 2:
        raise jobs_lib.JobError(
            "finetune_spatial needs [*image stacks, labels]"
        )
    *img_paths, lab_path = paths
    p = job.params
    try:
        source = FrameSource(paths=img_paths)
    except ValueError as e:
        raise jobs_lib.JobError(f"job {job.id}: cannot read inputs: {e}")

    def lazy_stack(path, dtype):
        """Per-frame lazy reader (giant stacks are not read whole), the
        bulk reader for other layouts; ``(shape, read_fn, close_fn)``."""
        try:
            r = tiff.TiffReader(path)
            return (
                tuple(r.shape),
                lambda i: np.asarray(r.read_frame(i)).astype(dtype),
                r.close,
            )
        except ValueError:
            arr = np.asarray(tiff.read_stack(path)).astype(dtype)
            if arr.ndim == 2:
                arr = arr[None]
            return tuple(arr.shape), (lambda i: arr[i]), (lambda: None)

    closers = [source.close]
    try:
        lab_shape, read_lab, close_lab = lazy_stack(lab_path, np.int32)
        closers.append(close_lab)
        if (len(source),) + source.spatial != lab_shape:
            raise jobs_lib.JobError(
                f"image/label shape mismatch: "
                f"{(len(source),) + source.spatial} vs {lab_shape}"
            )
        read_w = None
        if p.get("weights_input"):
            w_shape, read_w, close_w = lazy_stack(str(p["weights_input"]), np.float32)
            closers.append(close_w)
            if w_shape != lab_shape:
                raise jobs_lib.JobError(
                    f"weights/label shape mismatch: {w_shape} vs {lab_shape}"
                )

        steps = int(p.get("steps", 100))
        batch_size = int(p.get("batch_size", 1))
        tc = train_lib.TrainConfig(
            learning_rate=float(p.get("learning_rate", 1e-5)),
            augment=False,
            grad_accum=int(p.get("grad_accum", 1)),
            remat=bool(p.get("remat", False)),
        )
        init = None
        if p.get("from_model"):
            kind, cfg, flat = read_model(config.models_dir, str(p["from_model"]))
            if kind != "unet":
                raise jobs_lib.JobError(
                    f"from_model={p['from_model']!r} is not a unet model"
                )
            save_cfg = cfg  # registered again with the SOURCE compute dtype
            # halo-exchange training runs f32 (gradient fidelity on giant
            # frames); serving keeps the source model's dtype
            cfg = dataclasses.replace(cfg, compute_dtype="float32")
            init = train_lib.create_unet_state(
                cfg, tc, model=convert_lib.load_flat(cfg, flat, device=device)
            )
        else:
            cfg = unet_config_from_params(p)
            save_cfg = cfg

        d_ways = int(p.get("data_ways", 1))
        n_dev = _n_devices(device)
        if d_ways > 1:
            if n_dev % d_ways:
                raise jobs_lib.JobError(
                    f"data_ways={d_ways} does not divide {n_dev} devices"
                )
            mesh = parallel.make_mesh2d((d_ways, n_dev // d_ways), device=device)
            data_axis, space_axis = "data", "space"
        else:
            mesh = parallel.make_mesh(device=device)
            data_axis, space_axis = None, "data"
        if batch_size > len(source):
            raise jobs_lib.JobError(
                f"batch_size={batch_size} exceeds the {len(source)}-frame stack"
            )
        try:
            # a mesh/shape mismatch (H divisibility, pooling multiple, the
            # hybrid batch factor) is deterministic: refused before training
            _validate_spatial(cfg, mesh.shape[space_axis], source.spatial)
            if batch_size % (mesh.shape[data_axis] if data_axis else 1):
                raise ValueError(
                    f"batch_size={batch_size} not divisible by {d_ways} data shards"
                )
        except (ValueError, NotImplementedError) as e:
            raise jobs_lib.JobError(str(e))

        fc = fit_lib.FitConfig(
            steps=steps,
            batch_size=batch_size,
            checkpoint_every=int(p.get("checkpoint_every", 500)),
            log_every=int(p.get("log_every", 50)),
            metrics_path=os.path.join(job.output, "metrics.jsonl"),
            seed=int(p.get("seed", 0)),
            keep_checkpoints=int(p.get("keep_checkpoints", 3)),
        )
        ckpt_dir = os.path.join(job.output, "ckpts")
        ckpt = fit_lib.latest_checkpoint(ckpt_dir) if p.get("resume", True) else None
        if ckpt:
            init = train_lib.restore_checkpoint(ckpt, train_lib.create_unet_state(cfg, tc, device=device))

        normalize = bool(p.get("normalize", True))
        p_lo, p_hi = float(p.get("p_lo", 5.0)), float(p.get("p_hi", 99.5))
        n_frames = len(source)

        def frame_batches():
            """Whole frames in batches, cycled forever (the fit loop bounds
            the steps); each frame normalizes on every visit (giant stacks
            are not cached), as ``build_records`` maps it."""
            order_rng = np.random.default_rng(fc.seed)
            while True:
                order = order_rng.permutation(n_frames)
                for s in range(0, n_frames - batch_size + 1, batch_size):
                    idx = order[s : s + batch_size]
                    imgs = []
                    for t in idx:
                        img = np.asarray(source.frame(int(t)), dtype=np.float32)
                        if normalize:
                            axes = tuple(range(len(source.spatial)))
                            lo = np.percentile(img, p_lo, axis=axes, keepdims=True)
                            hi = np.percentile(img, p_hi, axis=axes, keepdims=True)
                            img = np.clip(
                                (img - lo) / np.maximum(hi - lo, 1e-8), 0.0, 1.0
                            ).astype(np.float32)
                        imgs.append(img)
                    batch = {
                        "image": np.stack(imgs),
                        "labels": np.stack([read_lab(int(t)) for t in idx]),
                    }
                    if read_w is not None:
                        batch["weights"] = np.stack([read_w(int(t)) for t in idx])
                    yield batch

        rep = jobs_lib.ProgressReporter(job, steps, phase="steps", raise_on_cancel=False)
        try:
            state = fit_lib.fit_unet_spatial(
                cfg, tc, fc, frame_batches(), mesh, source.spatial,
                ckpt_dir=ckpt_dir, init_state=init,
                data_axis=data_axis, space_axis=space_axis,
                should_stop=lambda: jobs_lib.cancel_requested(job),
                progress=lambda s, _t: rep.step(s), device=device,
            )
        except fit_lib.TrainingCancelled as e:
            raise jobs_lib.JobCancelled(str(e))
    finally:
        for close in closers:
            close()
    rep.finish()
    model_dir = save_model(
        config.models_dir, _require_param(job, "model"), "unet", save_cfg, state.model
    )
    return {"model": model_dir, "metrics_file": fc.metrics_path}


@register("build_gan_pairs")
def build_gan_pairs(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Build GAN training pair shards from (raw, target) TIFF stacks.

    input: [raw.tif, target.tif] (same shape). params: normalize (bool,
    default True: each frame of both stacks percentile-normalized on the
    host), p_lo/p_hi, shard_size, compress_records. Output:
    ``pairs-*.tfrecord`` shards.
    """
    from sequitr_tpu_torch.data import records, tiff
    from sequitr_tpu_torch.pipeline import fit as fit_lib

    raw_path, tgt_path = _resolve_inputs(job)[:2]
    raw = np.asarray(tiff.read_stack(raw_path), dtype=np.float32)
    tgt = np.asarray(tiff.read_stack(tgt_path), dtype=np.float32)
    if raw.ndim == 2:
        raw, tgt = raw[None], tgt[None]
    if raw.shape != tgt.shape:
        raise jobs_lib.JobError(f"shape mismatch: {raw.shape} vs {tgt.shape}")
    p = job.params
    p_lo, p_hi = float(p.get("p_lo", 5.0)), float(p.get("p_hi", 99.5))

    def norm(img):
        lo, hi = np.percentile(img, [p_lo, p_hi])
        return np.clip((img - lo) / max(hi - lo, 1e-8), 0.0, 1.0).astype(np.float32)

    os.makedirs(job.output, exist_ok=True)
    shard_size = int(p.get("shard_size", 128))
    payloads = []
    for x, y in zip(raw, tgt):
        if p.get("normalize", True):
            x, y = norm(x), norm(y)
        payloads.append(fit_lib.encode_pair(x, y))
    n_shards = max(1, -(-len(payloads) // shard_size))
    for s in range(n_shards):
        path = os.path.join(job.output, f"pairs-{s:05d}-of-{n_shards:05d}.tfrecord")
        with records.RecordWriter(
            path, compression="gzip" if p.get("compress_records") else None,
        ) as w:
            for payload in payloads[s * shard_size:(s + 1) * shard_size]:
                w.write(payload)
    return {"shards": os.path.join(job.output, "pairs-*.tfrecord"),
            "n_examples": str(len(payloads))}


@register("train_gan")
def train_gan(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Train the enhancement GAN from pair shards and register it (kind
    ``gan``: ``enhancement_gan``, ``evaluate_gan`` and ``parity_check``
    serve it).

    input: pair shard globs (or a build_gan_pairs output directory).
    params: model (output name), in_channels, out_channels, gen_depth,
    gen_base_features, disc_layers, disc_base_features, compute_dtype,
    steps, batch_size, learning_rate (Adam with beta1 0.5), l1_weight, the
    lr schedule, polyphase, observability (holdout_every, eval_every,
    dump_eval_images, log_every, checkpoint_every), keep_best (on
    ``eval_psnr`` by default), early_stop_patience, ema_decay (the
    generator's), resume, seed.
    """
    from sequitr_tpu_torch.models import gan as gan_lib
    from sequitr_tpu_torch.pipeline import fit as fit_lib
    from sequitr_tpu_torch.pipeline import train as train_lib

    device = resolve_device(config.device)
    shard_paths: list = []
    for pattern in _resolve_globs(job):
        shard_paths.extend(sorted(glob_lib.glob(pattern)))
    if not shard_paths:
        raise jobs_lib.JobError(f"job {job.id}: no pair shards found")
    p = job.params
    cfg = gan_lib.GANConfig(
        in_channels=int(p.get("in_channels", 1)),
        out_channels=int(p.get("out_channels", 1)),
        gen_depth=int(p.get("gen_depth", 4)),
        gen_base_features=int(p.get("gen_base_features", 32)),
        disc_layers=int(p.get("disc_layers", 3)),
        disc_base_features=int(p.get("disc_base_features", 64)),
        compute_dtype=str(p.get("compute_dtype", "bfloat16")),
    )
    steps = int(p.get("steps", 1000))
    tc = train_lib.TrainConfig(
        learning_rate=float(p.get("learning_rate", 2e-4)), beta1=0.5,
        polyphase=_polyphase_train_param(p, cfg.generator_config),
        lr_schedule=str(p.get("lr_schedule", "constant")),
        lr_warmup_steps=int(p.get("lr_warmup_steps", 0)),
        # the decay runs over the steps after the warmup by default
        lr_decay_steps=int(
            p.get("lr_decay_steps", max(1, steps - int(p.get("lr_warmup_steps", 0))))
        ),
        lr_end_factor=float(p.get("lr_end_factor", 0.01)),
    )
    fc = _fit_config(job, "eval_psnr", 4)
    ckpt_dir = os.path.join(job.output, "ckpts")
    init_state = None
    ckpt = fit_lib.latest_checkpoint(ckpt_dir) if p.get("resume", True) else None
    if ckpt:
        template = train_lib.create_gan_state(cfg, tc, device=device)
        init_state = train_lib.restore_checkpoint(ckpt, template)
    # the fit loop owns the cancel poll (it checkpoints before raising)
    rep = jobs_lib.ProgressReporter(job, fc.steps, phase="steps", raise_on_cancel=False)
    try:
        state = fit_lib.fit_gan(
            cfg, tc, fc, shard_paths, ckpt_dir=ckpt_dir, init_state=init_state,
            l1_weight=float(p.get("l1_weight", 100.0)),
            should_stop=lambda: jobs_lib.cancel_requested(job),
            progress=lambda s, _t: rep.step(s), device=device,
            mesh=_train_mesh(p, fc.batch_size, device),
        )
    except fit_lib.TrainingCancelled as e:
        raise jobs_lib.JobCancelled(str(e))
    rep.finish()
    best_path = os.path.join(ckpt_dir, "best")
    used_best = bool(fc.keep_best_metric) and os.path.isdir(best_path)
    if used_best:
        state = train_lib.restore_checkpoint(best_path, state)
    # the EMA twin covers the generator only (fit_gan's ema_select); the
    # discriminator keeps its raw weights
    model = _ema_or_raw_params(ckpt_dir, fc, state, used_best, subtree="gen")
    model_dir = save_model(config.models_dir, _require_param(job, "model"), "gan", cfg, model)
    return {"model": model_dir, "metrics_file": fc.metrics_path}


def _crop(rng, shape, patch):
    """A random ``patch`` window of ``shape`` (``rng.integers`` a start an
    axis, in order)."""
    sl = []
    for s, ps in zip(shape, patch):
        st = int(rng.integers(0, s - ps + 1))
        sl.append(slice(st, st + ps))
    return tuple(sl)


def _normalize_frame(img: np.ndarray, dims: int, p_lo: float, p_hi: float) -> np.ndarray:
    """Percentile-normalize over the spatial axes only (a 2D multi-channel
    frame per channel), on the host, to [0, 1]."""
    axes = tuple(range(dims))
    lo = np.percentile(img, p_lo, axis=axes, keepdims=True)
    hi = np.percentile(img, p_hi, axis=axes, keepdims=True)
    return np.clip((img - lo) / np.maximum(hi - lo, 1e-8), 0.0, 1.0).astype(np.float32)


def _record_normalize(p: dict) -> bool:
    """The family jobs' ``normalize`` record param: records and serving
    share one intensity space (false or "none" trains in the raw scale)."""
    norm = p.get("normalize", True)
    return bool(norm) and norm != "none"


def _family_train_config(p: dict, cfg, learning_rate: float, jitter: bool):
    """The ``TrainConfig`` of a train_n2v / train_flows / train_stars job
    (``jitter``: the photometric knobs are read)."""
    from sequitr_tpu_torch.pipeline import train as train_lib

    steps = int(p.get("steps", 1000))
    kw = dict(
        learning_rate=float(p.get("learning_rate", learning_rate)),
        augment=bool(p.get("augment", True)),
        grad_accum=int(p.get("grad_accum", 1)),
        remat=bool(p.get("remat", False)),
        lr_schedule=str(p.get("lr_schedule", "constant")),
        lr_warmup_steps=int(p.get("lr_warmup_steps", 0)),
        lr_decay_steps=int(
            p.get("lr_decay_steps", max(1, steps - int(p.get("lr_warmup_steps", 0))))
        ),
        lr_end_factor=float(p.get("lr_end_factor", 0.01)),
    )
    if jitter:
        kw.update(
            gain_jitter=float(p.get("gain_jitter", 0.0)),
            offset_jitter=float(p.get("offset_jitter", 0.0)),
            noise_std=float(p.get("noise_std", 0.0)),
        )
    return train_lib.TrainConfig(polyphase=_polyphase_train_param(p, cfg), **kw)


def _fit_config(job: Job, keep_best: str, batch_size: int, dump: bool = True):
    """The ``FitConfig`` of a train job's params (``keep_best``: the default
    keep_best metric; ``batch_size``: the default batch; ``dump``: the
    ``dump_eval_images`` param is read), with the keep_best check."""
    from sequitr_tpu_torch.pipeline import fit as fit_lib

    p = job.params
    fc = fit_lib.FitConfig(
        steps=int(p.get("steps", 1000)),
        batch_size=int(p.get("batch_size", batch_size)),
        checkpoint_every=int(p.get("checkpoint_every", 500)),
        log_every=int(p.get("log_every", 50)),
        holdout_every=int(p.get("holdout_every", 0)),
        eval_every=int(p.get("eval_every", 0)),
        metrics_path=os.path.join(job.output, "metrics.jsonl"),
        dump_eval_images=bool(p.get("dump_eval_images", False)) if dump else False,
        seed=int(p.get("seed", 0)),
        keep_checkpoints=int(p.get("keep_checkpoints", 3)),
        keep_best_metric=(
            str(p.get("keep_best_metric", keep_best))
            if p.get("keep_best") or _parse_patience(p)
            else ""
        ),
        early_stop_patience=_parse_patience(p),
        ema_decay=_parse_ema_decay(p),
    )
    if fc.keep_best_metric and not fc.holdout_every:
        raise jobs_lib.JobError(
            "keep_best/early_stop_patience requires holdout_every > 0 "
            "(no eval metric to track)"
        )
    return fc


def _resume_state(job: Job, cfg, tc, device):
    """The newest checkpoint of the job's ``ckpts`` (unless ``resume`` is
    false) restored into a fresh state, or None."""
    from sequitr_tpu_torch.pipeline import fit as fit_lib
    from sequitr_tpu_torch.pipeline import train as train_lib

    ckpt_dir = os.path.join(job.output, "ckpts")
    ckpt = fit_lib.latest_checkpoint(ckpt_dir) if job.params.get("resume", True) else None
    if not ckpt:
        return None
    return train_lib.restore_checkpoint(ckpt, train_lib.create_unet_state(cfg, tc, device=device))


def _fit_and_register(job: Job, config: ServerConfiguration, device, kind: str, cfg, tc, fc,
                      init_state, fit, shard_paths, rec_dir: str, **fit_kw) -> Dict[str, str]:
    """Run a family fit loop (cancel -> JobCancelled, a ValueError of the
    step or loop -> JobError), take the best checkpoint when keep_best
    kept one, and register the EMA or raw weights as ``kind``."""
    from sequitr_tpu_torch.pipeline import fit as fit_lib
    from sequitr_tpu_torch.pipeline import train as train_lib

    ckpt_dir = os.path.join(job.output, "ckpts")
    mesh = _train_mesh(job.params, fc.batch_size, device)
    rep = jobs_lib.ProgressReporter(job, fc.steps, phase="steps", raise_on_cancel=False)
    try:
        state = fit(
            cfg, tc, fc, shard_paths, ckpt_dir=ckpt_dir, init_state=init_state,
            should_stop=lambda: jobs_lib.cancel_requested(job),
            progress=lambda s, _t: rep.step(s), device=device, mesh=mesh, **fit_kw,
        )
    except fit_lib.TrainingCancelled as e:
        raise jobs_lib.JobCancelled(str(e))
    except ValueError as e:
        # bad mask/radius/struct/keep_best_metric values are deterministic
        raise jobs_lib.JobError(str(e))
    rep.finish()
    best_path = os.path.join(ckpt_dir, "best")
    used_best = bool(fc.keep_best_metric) and os.path.isdir(best_path)
    if used_best:
        state = train_lib.restore_checkpoint(best_path, state)
    model = _ema_or_raw_params(ckpt_dir, fc, state, used_best)
    model_dir = save_model(config.models_dir, _require_param(job, "model"), kind, cfg, model)
    return {"model": model_dir, "metrics_file": fc.metrics_path,
            "shards": os.path.join(rec_dir, "train-*.tfrecord")}


@register("train_n2v")
def train_n2v(job: Job, config: ServerConfiguration) -> Dict[str, str]:
    """Train a Noise2Void self-supervised denoiser from noisy stacks alone.

    input: noisy TIFF stacks, one per channel (2D), or ONE volume-sequence
    entry (``dims: 3``: a dir/glob of per-timepoint z-stacks or a file,
    ``z`` pages a volume; single-channel). The job writes image-only
    shards of random ``patch`` crops (default [64, 64], [8, 64, 64] for
    volumes; ``patches_per_frame`` 4) of each frame or volume,
    percentile-normalized on the host (``normalize``, ``p_lo``/``p_hi``),
    once under the job output, reused on resume; then trains
    (``fit_n2v``) on ``config.device``. params: ``model`` (required),
    ``mask_frac`` (0.005), ``radius`` (5) and ``radius_z`` (2, volumes),
    ``mask_mode`` ("uniform" or the N2V2 "median"), ``struct_axis`` ("x",
    "y", "z" for volumes) with ``struct_span`` (4) for structN2V,
    ``space_to_depth`` (2D; base 64 above 1), ``depth``,
    ``base_features``, ``norm``, ``compute_dtype`` over the
    ``n2v_denoise`` preset, ``polyphase``, the training and observability
    params of ``train_unet2d`` (keep_best on ``eval_psnr_masked``),
    ``ema_decay``, ``resume``, ``seed``. Registers kind ``n2v``, served by
    ``denoise``, ``evaluate_denoise`` and ``parity_check``.
    """
    import dataclasses

    from sequitr_tpu_torch.data import records as records_lib
    from sequitr_tpu_torch.data.source import FrameSource, VolumeSequence
    from sequitr_tpu_torch.models import zoo
    from sequitr_tpu_torch.pipeline import fit as fit_lib

    device = resolve_device(config.device)
    p = job.params
    dims = int(p.get("dims", 2))
    if dims not in (2, 3):
        raise jobs_lib.JobError(f"train_n2v needs dims 2 or 3, got {dims}")
    s2d = int(p.get("space_to_depth", 1))
    if dims == 3 and s2d != 1:
        raise jobs_lib.JobError(
            "space_to_depth is a 2D-only rearrangement (volumes train "
            "without it)"
        )

    # record shards: built once, reused on resume
    rec_dir = os.path.join(job.output, "records")
    shard_paths = sorted(glob_lib.glob(os.path.join(rec_dir, "*.tfrecord")))
    if not shard_paths:
        paths = _resolve_inputs(job)
        if dims == 3:
            if len(paths) != 1:
                raise jobs_lib.JobError(
                    "train_n2v dims=3 takes ONE volume-sequence entry "
                    f"(got {len(paths)}); denoise channels as separate jobs"
                )
            try:
                source = VolumeSequence(paths[0], z=_parse_z_pages(job))
            except ValueError as e:
                raise jobs_lib.JobError(f"job {job.id}: cannot read inputs: {e}")
        else:
            try:
                source = FrameSource(paths=paths)
            except ValueError as e:
                raise jobs_lib.JobError(f"job {job.id}: cannot read inputs: {e}")
        default_patch = (64, 64) if dims == 2 else (8, 64, 64)
        patch = tuple(int(v) for v in p.get("patch", default_patch))
        if len(patch) != dims or any(ps > s for s, ps in zip(source.spatial, patch)):
            source.close()
            raise jobs_lib.JobError(
                f"patch {patch} must be {dims} axes and fit the "
                f"{'volumes' if dims == 3 else 'frames'} {source.spatial}"
            )
        n_crops = int(p.get("patches_per_frame", 4))
        p_lo, p_hi = float(p.get("p_lo", 5.0)), float(p.get("p_hi", 99.5))
        norm_rec = _record_normalize(p)
        rng = np.random.default_rng(int(p.get("seed", 0)))
        n_frames = len(source)
        read = source.volume if dims == 3 else source.frame

        def gen_payloads():
            with source:
                for t in jobs_lib.track(job, range(n_frames), total=n_frames, phase="records"):
                    img = np.asarray(read(t), dtype=np.float32)
                    if norm_rec:
                        img = _normalize_frame(img, dims, p_lo, p_hi)
                    if dims == 3:
                        # the channel axis, so a volume does not decode as
                        # a 2D multi-channel frame
                        img = img[..., None]
                    for _ in range(n_crops):
                        yield fit_lib.encode_image_example(img[_crop(rng, img.shape[:dims], patch)])

        os.makedirs(rec_dir, exist_ok=True)
        shard_paths = records_lib.write_shards(
            os.path.join(rec_dir, "train"), gen_payloads(), shard_size=int(p.get("shard_size", 128)),
        )
        n_channels = 1 if dims == 3 else source.n_channels
    else:
        # resumed: the channel count from the shards
        first = next(records_lib.read_records(shard_paths[0]), None)
        if first is None:
            raise jobs_lib.JobError(f"job {job.id}: empty record shards in {rec_dir}")
        n_channels = fit_lib._decode_image(first)["image"].shape[-1]

    # the n2v preset resized to the data's channels
    base = zoo.get("n2v_denoise")
    cfg = dataclasses.replace(
        base,
        in_channels=n_channels,
        num_classes=n_channels,  # regression: every input channel
        dims=dims,
        depth=int(p.get("depth", base.depth)),
        # space_to_depth 2 doubles the base width (n2v_denoise_fast's shape)
        base_features=int(p.get("base_features", 64 if s2d > 1 else base.base_features)),
        space_to_depth=s2d,
        norm=p.get("norm", base.norm),
        compute_dtype=str(p.get("compute_dtype", "bfloat16")),
    )
    tc = _family_train_config(p, cfg, 4e-4, jitter=False)
    fc = _fit_config(job, "eval_psnr_masked", 16)
    init_state = _resume_state(job, cfg, tc, device)
    radius = int(p.get("radius", 5))
    if dims == 3:
        # z is sampled more coarsely than the plane: a small z radius
        radius = (int(p.get("radius_z", 2)), radius, radius)
    mask_mode = str(p.get("mask_mode", "uniform"))
    if mask_mode not in ("uniform", "median"):
        raise jobs_lib.JobError(
            f"mask_mode={mask_mode!r} must be 'uniform' (Noise2Void "
            "random-neighbor) or 'median' (the N2V2 manipulation)"
        )
    struct = None
    if p.get("struct_axis") is not None:
        axes = {"y": dims - 2, "x": dims - 1}
        if dims == 3:
            axes["z"] = 0
        sa = str(p.get("struct_axis"))
        if sa not in axes:
            raise jobs_lib.JobError(
                f"struct_axis={sa!r} must be one of {sorted(axes)} "
                f"for dims={dims}"
            )
        span = int(p.get("struct_span", 4))
        if span < 1:
            raise jobs_lib.JobError(
                f"struct_span={span} must be >= 1 (pixels each side of "
                "the masked center along the correlated axis)"
            )
        struct = (axes[sa], span)
    elif p.get("struct_span") is not None:
        raise jobs_lib.JobError(
            "struct_span without struct_axis: say WHICH axis the noise "
            "is correlated along ('x', 'y'" + (", 'z'" if dims == 3 else "")
            + ")"
        )
    return _fit_and_register(
        job, config, device, "n2v", cfg, tc, fc, init_state, fit_lib.fit_n2v, shard_paths, rec_dir,
        mask_frac=float(p.get("mask_frac", 0.005)), radius=radius, mask_mode=mask_mode, struct=struct,
    )
