"""The ``unet`` kind: ``sequitr_tpu_torch``'s U-Net (``__kind__: "unet"``),
serving class labels (``labels.tif``).

A kind module is what the harness knows of a configuration's model, found
by the configuration file's ``kind`` (``spec.kind_of``):

* ``SERVER_KIND``: the model kind the job server builds it as (the
  ``__kind__`` of its ``config.json`` in the models directory);
* ``make_flat(cfg, seed, device, root)``: the weight file, the flat npz
  layout that the job server and the plain reference both read;
* ``flops_per_voxel(cfg)``: the model's FLOPs a served voxel, counted once
  over the served volume (``Run.flops_per_voxel``, which ``mfu`` reads);
* ``judge(cfg, traffic, items, flat, device)``: an object with
  ``add(job_output_dir, item_indices)``, which reads what a job wrote, and
  ``readings()``, the numbers that the cell's limits file holds;
* ``control_readings(cfg, traffic, items, flat, device)``: the same
  numbers with the reference at low precision in the program's place
  (``tools/control.py``);
* for the benchmark's own tests, ``small_traffic(traffic)`` (the mix at a
  CPU test's size) and ``altered_answers()`` (a context manager in which
  the program alters its answers where it produces them).

Here: the weights of ``portbench/weights.py``, the count of
``counts.unet_flops_per_voxel``, and ``check.Judge`` over the reference's
stitched class probabilities (``portbench/reference/``): ``max_gap`` and
``mismatch_share``.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict, Sequence

import numpy as np

from portbench import check, counts, reference, weights

__all__ = [
    "SERVER_KIND", "make_flat", "flops_per_voxel", "judge", "control_readings", "small_traffic",
    "altered_answers", "class_judge",
]

SERVER_KIND = "unet"

make_flat = weights.make_flat


def flops_per_voxel(cfg: Dict) -> float:
    return counts.unet_flops_per_voxel(cfg["model"])


def class_judge(cfg: Dict, traffic: Dict, items: np.ndarray, flat: Dict[str, np.ndarray],
                device) -> check.Judge:
    """``check.Judge`` of the plain U-Net on ``flat``, tiled as a job of the
    mix serves its items."""
    patch, overlap = reference.tiling_of(traffic["params"], traffic["input"]["shape"])
    return check.Judge(reference.load_weights(flat, cfg["model"], device), items, patch,
                       overlap, device)


class _Labels:
    """``check.Judge`` over the ``labels.tif`` each judged job wrote."""

    def __init__(self, judge: check.Judge):
        self.judge = judge

    def add(self, output: str, item_indices: Sequence[int]) -> None:
        labels = check.read_labels(output)
        if len(labels) != len(item_indices):
            raise ValueError(f"{output}: {len(labels)} label items for {len(item_indices)}")
        for i, lab in zip(item_indices, labels):
            self.judge.add(i, lab)

    def readings(self) -> Dict[str, float]:
        return self.judge.readings()


def judge(cfg: Dict, traffic: Dict, items: np.ndarray, flat: Dict[str, np.ndarray],
          device) -> _Labels:
    return _Labels(class_judge(cfg, traffic, items, flat, device))


def control_readings(cfg: Dict, traffic: Dict, items: np.ndarray, flat: Dict[str, np.ndarray],
                     device) -> Dict[str, float]:
    """Each distinct item labelled by the reference with every conv's input
    and weights in float8 e4m3, judged as a run judges the program's."""
    j = class_judge(cfg, traffic, items, flat, device)
    for i, item in enumerate(items):
        low = reference.class_scores(j.wts, item, j.patch, j.overlap, device, fp8=True)
        j.add(i, low.argmax(0))
    return j.readings()


def small_traffic(traffic: Dict) -> Dict:
    """The mix at a CPU test's size. ``normalize: pallas`` runs the card's
    1024-bin percentile rule (its plain version on the CPU), where the
    job's ``auto`` would pick the 4096-bin host histogram."""
    t = copy.deepcopy(traffic)
    t["params"]["normalize"] = "pallas"
    inp = t["input"]
    inp.update(shape=[64, 64], distinct=4, items_per_job=min(inp["items_per_job"], 4),
               job_inputs=min(inp["job_inputs"], 4))
    return t


@contextlib.contextmanager
def altered_answers():
    """Labels altered where the program produces them: the inferrer's label
    map has a block of its pixels moved to the next class."""
    import torch

    from sequitr_tpu_torch.pipeline import infer

    real = infer._make_batch_infer

    def broken(cfg, *args, **kw):
        fn = real(cfg, *args, **kw)

        def infer_(model, frames):
            probs, labels = fn(model, frames)
            labels = labels.clone()
            block = (slice(None),) * (labels.ndim - 2) + (slice(0, 8), slice(0, 8))
            moved = (labels[block].to(torch.int32) + 1) % cfg.num_classes
            labels[block] = moved.to(labels.dtype)
            return probs, labels

        return infer_

    infer._make_batch_infer = broken
    infer.cached_frame_inferrer.cache_clear()
    infer.cached_batch_inferrer.cache_clear()
    try:
        yield
    finally:
        infer._make_batch_infer = real
        infer.cached_frame_inferrer.cache_clear()
        infer.cached_batch_inferrer.cache_clear()
