"""End-to-end example: train a parity U-Net, distill a fast preset from it.

    python -m sequitr_tpu_torch.examples.distill_fast_model /tmp/sequitr_distill [--device cpu]

The fast-model recipe (the production path for latency-critical serving):

1. synthesize a segmentation task and build record shards;
2. train the PARITY model (standard architecture) — the teacher;
3. distill the space-to-depth FAST architecture (s2d=2, doubled width)
   from the teacher on the same records;
4. report held-out mIoU for both: the student must match the teacher.

The same flow runs through the job API with ``train_unet2d`` params
``{"space_to_depth": 2, "base_features": 64, "distill_from": "<teacher>"}``.
"""

import os

import numpy as np


def make_shards(base, n=24, s=32, seed=0):
    from sequitr_tpu_torch.data import records

    rng = np.random.default_rng(seed)
    exs = []
    for _ in range(n):
        img = rng.normal(0.1, 0.05, (s, s)).astype(np.float32)
        lab = np.zeros((s, s), np.int32)
        for _ in range(2):
            cy, cx = rng.integers(5, s - 5, 2)
            img[cy - 4 : cy + 4, cx - 4 : cx + 4] += 1.0
            lab[cy - 4 : cy + 4, cx - 4 : cx + 4] = 1
        exs.append(records.SegExample(img, lab, np.ones((s, s), np.float32)))
    return records.write_segmentation_shards(f"{base}/train", exs, shard_size=8)


def miou(state, imgs, labs):
    import torch

    from sequitr_tpu_torch.ops import losses

    device = next(state.model.parameters()).device
    with torch.inference_mode():
        logits = state.model(torch.as_tensor(imgs, device=device)[..., None])
        preds = torch.argmax(logits, dim=-1)
        return float(losses.iou(preds, torch.as_tensor(labs, device=device), 2).mean())


def main(base, device: str = "cuda"):
    from sequitr_tpu_torch.examples import step_cap, steps
    from sequitr_tpu_torch.models import unet
    from sequitr_tpu_torch.pipeline import fit as fit_lib
    from sequitr_tpu_torch.pipeline import train as train_lib

    os.makedirs(base, exist_ok=True)
    paths = make_shards(base)

    # held-out probes (fresh seed)
    rng = np.random.default_rng(99)
    imgs, labs = [], []
    for _ in range(8):
        img = rng.normal(0.1, 0.05, (32, 32)).astype(np.float32)
        lab = np.zeros((32, 32), np.int32)
        cy, cx = rng.integers(5, 27, 2)
        img[cy - 4 : cy + 4, cx - 4 : cx + 4] += 1.0
        lab[cy - 4 : cy + 4, cx - 4 : cx + 4] = 1
        imgs.append(img)
        labs.append(lab)
    imgs, labs = np.stack(imgs), np.stack(labs)

    # 1) the parity model (teacher)
    teacher_cfg = unet.UNetConfig(
        in_channels=1, num_classes=2, depth=3, base_features=8,
        norm="none", compute_dtype="float32",
    )
    tc = train_lib.TrainConfig(learning_rate=3e-3, augment=False)
    fc = fit_lib.FitConfig(
        steps=steps(120), batch_size=8, log_every=40,
        metrics_path=f"{base}/teacher_metrics.jsonl",
    )
    t_state = fit_lib.fit_unet(teacher_cfg, tc, fc, paths, device=device)
    iou_t = miou(t_state, imgs, labs)
    print(f"teacher (parity model)   mIoU {iou_t:.3f}")

    # 2) distill the fast (space-to-depth) architecture from it
    student_cfg = unet.UNetConfig(
        in_channels=1, num_classes=2, depth=3, base_features=16,
        norm="none", compute_dtype="float32", space_to_depth=2,
    )
    distill = fit_lib.Distill(t_state.model, alpha=0.5, temperature=2.0)
    tc_s = train_lib.TrainConfig(learning_rate=5e-3, augment=False)
    fc_s = fit_lib.FitConfig(
        steps=steps(300), batch_size=8, log_every=100,
        metrics_path=f"{base}/student_metrics.jsonl",
    )
    s_state = fit_lib.fit_unet(student_cfg, tc_s, fc_s, paths, distill=distill, device=device)
    iou_s = miou(s_state, imgs, labs)
    print(f"student (fast, s2d=2)    mIoU {iou_s:.3f}")
    if not step_cap():  # a truncated smoke run has no converged teacher to match
        assert iou_s >= iou_t - 0.05, "distillation fell short of the teacher"
    print("fast model matches the parity model — serve it for ~2-3x frame rate")


if __name__ == "__main__":
    from sequitr_tpu_torch.examples import run

    run(main, "/tmp/sequitr_distill")
