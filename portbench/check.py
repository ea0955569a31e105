"""What decides ``correct``: the served labels against the plain reference.

After the window, a sample of the window's completed jobs, drawn from the
seed with the last one always in it, is read back from the files the job
server wrote (``labels.tif``) with the benchmark's own reader. For each voxel the reference's
stitched class probabilities give the gap by which the served label's
probability lies below the best class's (0 where they agree). The numbers
compared:

* ``max_gap``: the widest gap over every compared voxel;
* ``mismatch_share``: the share of compared voxels whose label is not the
  reference's best;
* ``missing``: jobs due in the window that failed or never completed
  (limit 0).
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench import reference, tiffio
from portbench.inputs import seed_words

__all__ = ["sample_jobs", "read_labels", "Judge"]


def sample_jobs(n_done: int, k: int, seed: int) -> List[int]:
    """Indices of ``k`` of ``n_done`` completed jobs, the last among them."""
    if n_done <= k:
        return list(range(n_done))
    rng = np.random.default_rng(seed_words(seed, 3))
    pick = rng.choice(n_done - 1, size=k - 1, replace=False)
    return sorted(int(i) for i in pick) + [n_done - 1]


def read_labels(output: str) -> np.ndarray:
    """(items, *item shape) labels a job wrote."""
    return tiffio.read_stack(os.path.join(output, "labels.tif"))


class Judge:
    """Reference scores of the distinct items, made once each, on demand,
    and the running readings over the labels compared."""

    def __init__(self, wts, items: np.ndarray, patch: Sequence[int], overlap: Sequence[int],
                 device, fp8: bool = False):
        self.wts, self.items, self.device, self.fp8 = wts, items, device, fp8
        self.patch, self.overlap = tuple(patch), tuple(overlap)
        self._scores: Dict[int, torch.Tensor] = {}
        self.max_gap, self.mismatched, self.compared = 0.0, 0, 0

    def scores(self, i: int) -> torch.Tensor:
        if i not in self._scores:
            self._scores[i] = reference.class_scores(
                self.wts, self.items[i], self.patch, self.overlap, self.device, fp8=self.fp8,
            )
        return self._scores[i]

    def add(self, i: int, labels) -> None:
        """Judge one item's served labels (an array or tensor of its shape)."""
        p = self.scores(i)
        lab = torch.as_tensor(labels, device=p.device).to(torch.int64)
        if tuple(lab.shape) != tuple(p.shape[1:]):
            raise ValueError(f"labels of shape {tuple(lab.shape)} for an item of {tuple(p.shape[1:])}")
        if int(lab.max()) >= p.shape[0] or int(lab.min()) < 0:
            self.max_gap = max(self.max_gap, 1.0)
            self.mismatched += lab.numel()
            self.compared += lab.numel()
            return
        gap = p.max(dim=0).values - p.gather(0, lab[None])[0]
        self.max_gap = max(self.max_gap, float(gap.max()))
        self.mismatched += int((gap > 0).sum())
        self.compared += lab.numel()

    def readings(self) -> Dict[str, float]:
        return {
            "max_gap": self.max_gap,
            "mismatch_share": self.mismatched / max(self.compared, 1),
        }
