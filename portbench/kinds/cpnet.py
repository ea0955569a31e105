"""The ``cpnet`` kind: Cellpose's CPnet served by ``segment_flows``
(``__kind__: "cpnet"``), judged by its instance maps (``labels.tif``).

* weights: the trained file the configuration's ``weights`` block names,
  refused unless its sha256 is the recorded one (``make_flat``); the seed
  changes the inputs, never the weights;
* FLOPs: ``cpnet_flops_per_voxel``, the convs counted once over the served
  frame (the 224^2 tiles of a 1024^2 frame cover it 1.72 times; that is
  the program's extra work, as a U-Net's tile overlap is);
* the judge: the plain pipeline of ``reference/flows.py`` (float32 CPnet,
  Hann stitch, 200 Euler steps, sink grouping) on each judged item, against
  the job's ``labels.tif``: ``instance_miss_share`` (1 - F1 of instances
  matched one to one at IoU >= 0.5, pooled over the judged frames) and
  ``pixel_mismatch_share`` (pixels whose foreground differs, or whose
  served instance is not the one matched to the reference's instance
  there);
* the control: the same pipeline with every conv's input and weights in
  float8 e4m3, judged as the program's labels are;
* the integrator's bound (``euler_bound_ms_per_mvox``), which
  ``metrics/euler_roofline.py`` reads: the work over the foreground pixels
  alone, the only ones whose final positions are read (Cellpose's own
  integrator takes only the pixels above the probability threshold).
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import os
from typing import Dict, Sequence

import numpy as np

from portbench import check
from portbench.reference import cpnet as cpnet_ref
from portbench.reference import flows as flows_ref

__all__ = [
    "SERVER_KIND", "make_flat", "flops_per_voxel", "cpnet_flops_per_voxel", "judge",
    "control_readings", "small_traffic", "altered_answers", "EULER_FLOPS_PER_PIXEL_STEP",
    "EULER_BYTES_PER_PIXEL", "EULER_BYTES_PER_FOREGROUND_PIXEL", "PEAK_F32_FLOPS",
    "euler_bound_ms_per_mvox",
]

SERVER_KIND = "cpnet"

# a pixel-step of the reference's integrator (``reference/flows.py::euler``)
# at the least: floor and fraction of both coordinates (4), the four
# bilinear weights (2 complements, 4 products), the two flow components'
# weighted sums (2 x (4 products + 3 adds)), the step (2 products, 2 adds)
# and the clamp of the position to the frame (4)
EULER_FLOPS_PER_PIXEL_STEP = 32
# what any integrator moves once a frame: the probability mask in (1 byte)
# at every pixel, and at each foreground pixel its flow in and its final
# position out (2 x f32 each)
EULER_BYTES_PER_PIXEL = 1
EULER_BYTES_PER_FOREGROUND_PIXEL = 16
# NVIDIA H100 SXM data sheet: float32 on the CUDA cores, HBM3 bandwidth
PEAK_F32_FLOPS = 66.9e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def make_flat(cfg: Dict, seed: int, device, root: str) -> Dict[str, np.ndarray]:
    """The trained weights (flat layout, float16 parameters, float32
    running statistics), the same for every seed and device."""
    w = cfg["weights"]
    path = os.path.join(root, w["path"])
    with open(path, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    if digest != w["sha256"]:
        raise ValueError(f"{w['path']}: sha256 {digest} is not the configuration's {w['sha256']}")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def cpnet_flops_per_voxel(model: Dict) -> float:
    """FLOPs of one pixel through CPnet's convs (2 a multiply-add), once
    over the served frame: ``resdown(ci, co)`` and ``resup(ci, co)`` each
    run a 1x1 projection ``ci * co``, a 3x3 conv ``9 ci co`` and three 3x3
    convs ``9 co^2`` a pixel of their level, level l on 4^-l of the pixels;
    the 1x1 head ``nbase[1] * nout``. The per-tile style maps (12 linear
    maps of 256 inputs a tile) are left out."""
    nb, k2 = [int(c) for c in model["nbase"]], int(model["sz"]) ** 2
    up = nb[1:] + [nb[-1]]

    def res(ci: int, co: int) -> int:
        return ci * co + k2 * ci * co + 3 * k2 * co * co

    macs = sum(res(nb[n], nb[n + 1]) / 4 ** n for n in range(len(nb) - 1))
    macs += sum(res(up[n], up[n - 1]) / 4 ** (n - 1) for n in range(1, len(up)))
    macs += nb[1] * int(model["nout"])
    return 2.0 * macs


def flops_per_voxel(cfg: Dict) -> float:
    return cpnet_flops_per_voxel(cfg["model"])


def euler_bound_ms_per_mvox(steps: float, foreground: float) -> float:
    """The least device time, in ms, of ``steps`` Euler steps over a
    million pixels of which the share ``foreground`` lies above the
    probability threshold: the foreground's pixel-steps at the float32
    peak or the bytes at the HBM bandwidth, whichever is longer."""
    flops = EULER_FLOPS_PER_PIXEL_STEP * steps * foreground * 1e6 / PEAK_F32_FLOPS
    moved = (EULER_BYTES_PER_PIXEL + EULER_BYTES_PER_FOREGROUND_PIXEL * foreground) * 1e6
    return 1e3 * max(flops, moved / PEAK_HBM_BYTES_PER_S)


class Instances:
    """The reference's instance maps of the distinct items, made once each,
    on demand, and the pooled readings over the maps compared."""

    def __init__(self, net: cpnet_ref.CPnet, items: np.ndarray, params: Dict, device,
                 fp8: bool = False):
        self.net, self.items, self.params, self.device, self.fp8 = net, items, params, device, fp8
        self._maps: Dict[int, np.ndarray] = {}
        self.tp = self.n_ref = self.n_served = 0
        self.mismatched = self.compared = 0

    def reference(self, i: int) -> np.ndarray:
        if i not in self._maps:
            self._maps[i] = flows_ref.instances(self.net, self.items[i], self.params, self.device,
                                                fp8=self.fp8)
        return self._maps[i]

    def compare(self, i: int, served: np.ndarray) -> None:
        ref = self.reference(i)
        served = np.asarray(served, np.int64)
        if served.shape != ref.shape:
            raise ValueError(f"labels of shape {served.shape} for an item of {ref.shape}")
        tp, n_r, n_s, partner = flows_ref.match(ref, served)
        self.tp, self.n_ref, self.n_served = self.tp + tp, self.n_ref + n_r, self.n_served + n_s
        fg_r, fg_s = ref > 0, served > 0
        agree = (fg_r == fg_s) & (~fg_r | (partner[ref] == served))
        self.mismatched += int((~agree).sum())
        self.compared += ref.size

    def add(self, output: str, item_indices: Sequence[int]) -> None:
        labels = check.read_labels(output)
        if labels.ndim == 2:
            labels = labels[None]
        if len(labels) != len(item_indices):
            raise ValueError(f"{output}: {len(labels)} label items for {len(item_indices)}")
        for i, lab in zip(item_indices, labels):
            self.compare(i, lab)

    def readings(self) -> Dict[str, float]:
        n = self.n_ref + self.n_served
        return {
            "instance_miss_share": 1.0 - 2.0 * self.tp / n if n else 0.0,
            "pixel_mismatch_share": self.mismatched / max(self.compared, 1),
        }


def judge(cfg: Dict, traffic: Dict, items: np.ndarray, flat: Dict[str, np.ndarray],
          device, fp8: bool = False) -> Instances:
    return Instances(cpnet_ref.load(flat, cfg["model"], device), items, traffic["params"], device,
                     fp8=fp8)


def control_readings(cfg: Dict, traffic: Dict, items: np.ndarray, flat: Dict[str, np.ndarray],
                     device) -> Dict[str, float]:
    """Each distinct item segmented by the reference with every conv's
    input and weights in float8 e4m3, judged as a run judges the
    program's."""
    j = judge(cfg, traffic, items, flat, device)
    low = judge(cfg, traffic, items, flat, device, fp8=True)
    for i in range(len(items)):
        j.compare(i, low.reference(i))
    return j.readings()


def small_traffic(traffic: Dict) -> Dict:
    """The mix at a CPU test's size: 64x64 frames in 48x48 tiles (a 2x2
    grid), ``normalize: pallas`` (the card's 1024-bin percentile rule, its
    plain version on the CPU, where the job's ``auto`` would pick the
    4096-bin host histogram)."""
    t = copy.deepcopy(traffic)
    t["params"].update(normalize="pallas", patch=[48, 48], overlap=[16, 16])
    inp = t["input"]
    inp.update(shape=[64, 64], distinct=2, items_per_job=2, job_inputs=2, warmup_items=2)
    return t


@contextlib.contextmanager
def altered_answers():
    """Instance maps altered where the program produces them: the sink
    grouping's map moved 8 pixels along x (every cell's IoU with itself
    falls under 0.5)."""
    from sequitr_tpu_torch.ops import flows as flows_ops

    real = flows_ops.group_sinks

    def moved(*args, **kw):
        return np.roll(real(*args, **kw), 8, axis=-1)

    flows_ops.group_sinks = moved
    try:
        yield
    finally:
        flows_ops.group_sinks = real
