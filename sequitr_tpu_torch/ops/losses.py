"""Losses and segmentation metrics (port of ``sequitr_tpu.ops.losses``).

Per-pixel weighted softmax cross-entropy (the U-Net loss), the softmax
label map, sigmoid BCE and
L1 (the GAN and N2V losses of the training slices), and the label-map
metrics: per-class IoU and Dice on tensors, and the streaming confusion
matrix and its metrics on the host (copied: numpy). Losses compute in
float32 whatever the logits' dtype, as the JAX package does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "weighted_softmax_cross_entropy",
    "softmax_label_map",
    "sigmoid_bce_with_logits",
    "gan_discriminator_loss",
    "gan_generator_loss",
    "l1_loss",
    "iou",
    "dice",
    "confusion_matrix_np",
    "metrics_from_confusion",
]


def weighted_softmax_cross_entropy(
    logits: torch.Tensor,
    labels: torch.Tensor,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-pixel weighted softmax cross-entropy, mean-reduced.

    ``logits``: (..., K); ``labels``: integer (...,) or one-hot (..., K);
    ``weights``: optional per-pixel (...,) loss weights. Weighted mean:
    ``sum(w * ce) / max(sum(w), 1e-8)``; unweighted: the mean.
    """
    logits = logits.to(torch.float32)
    logp = F.log_softmax(logits, dim=-1)
    if labels.shape == logits.shape:
        ce = -(labels.to(torch.float32) * logp).sum(dim=-1)
    else:
        ce = -torch.gather(logp, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    if weights is None:
        return ce.mean()
    w = weights.to(torch.float32)
    return (w * ce).sum() / torch.clamp(w.sum(), min=1e-8)


def softmax_label_map(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax probabilities and their argmax label map (sequitr's output
    contract) over the last (class) axis: ``(probs, labels)``, f32
    per-pixel class probabilities and the int32 label map."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    return probs, torch.argmax(probs, dim=-1).to(torch.int32)


def sigmoid_bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise binary cross-entropy with logits, mean:
    ``optax.sigmoid_binary_cross_entropy``'s form, whose gradient is
    ``sigmoid(z) - t`` everywhere, at ``z == 0`` too (a ReLU-dead pixel
    before a zero head bias gives exactly 0; the max/abs form's subgradient
    there is off by up to 1)."""
    logits = logits.to(torch.float32)
    targets = targets.to(torch.float32)
    return torch.mean(-(targets * F.logsigmoid(logits) + (1.0 - targets) * F.logsigmoid(-logits)))


def gan_discriminator_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    """Vanilla (non-saturating) GAN discriminator loss on patch logits."""
    loss_real = sigmoid_bce_with_logits(real_logits, torch.ones_like(real_logits))
    loss_fake = sigmoid_bce_with_logits(fake_logits, torch.zeros_like(fake_logits))
    return 0.5 * (loss_real + loss_fake)


def gan_generator_loss(
    fake_logits: torch.Tensor,
    fake_images: torch.Tensor,
    target_images: torch.Tensor,
    l1_weight: float = 100.0,
) -> torch.Tensor:
    """pix2pix generator objective: adversarial + ``l1_weight`` * L1 (100,
    the pix2pix paper's weight, as the JAX package)."""
    adv = sigmoid_bce_with_logits(fake_logits, torch.ones_like(fake_logits))
    return adv + l1_weight * l1_loss(fake_images, target_images)


def l1_loss(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(a.to(torch.float32) - b.to(torch.float32)))


def iou(pred: torch.Tensor, target: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Per-class intersection-over-union of integer label maps, (K,) f32.

    Classes absent from both prediction and target score 1.0.
    """
    out = []
    for k in range(num_classes):
        p, t = pred == k, target == k
        inter = (p & t).sum()
        union = (p | t).sum()
        out.append(torch.where(union == 0, 1.0, inter / torch.clamp(union, min=1)))
    return torch.stack(out).to(torch.float32)


def dice(pred: torch.Tensor, target: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Per-class Dice coefficient of integer label maps, (K,) f32."""
    out = []
    for k in range(num_classes):
        p, t = pred == k, target == k
        inter = (p & t).sum()
        total = p.sum() + t.sum()
        out.append(torch.where(total == 0, 1.0, 2.0 * inter / torch.clamp(total, min=1)))
    return torch.stack(out).to(torch.float32)


def confusion_matrix_np(pred, target, num_classes: int) -> np.ndarray:
    """(K+1, K) int64 confusion counts: rows = target class (row K collects
    out-of-range target labels), cols = predicted class (in [0, K)).

    Summing matrices over frames then applying ``metrics_from_confusion``
    reproduces the whole-stack ``iou``/``dice``/accuracy exactly.
    """
    k = int(num_classes)
    pred = np.asarray(pred).ravel().astype(np.int64)
    target = np.asarray(target).ravel().astype(np.int64)
    t_row = np.where((target >= 0) & (target < k), target, k)
    return np.bincount(t_row * k + pred, minlength=(k + 1) * k).reshape(k + 1, k)


def metrics_from_confusion(cm):
    """Per-class IoU and Dice (float64) and pixel accuracy from a (K+1, K)
    confusion matrix; vacuous classes score 1.0."""
    cm = np.asarray(cm, dtype=np.int64)
    k = cm.shape[1]
    inter = np.diagonal(cm[:k])
    row = cm[:k].sum(axis=1)
    col = cm.sum(axis=0)
    union = row + col - inter
    total = row + col
    ious = np.where(union == 0, 1.0, inter / np.maximum(union, 1))
    dices = np.where(total == 0, 1.0, 2.0 * inter / np.maximum(total, 1))
    accuracy = float(inter.sum()) / max(int(cm.sum()), 1)
    return ious.astype(np.float64), dices.astype(np.float64), accuracy
