"""End-to-end example: instance segmentation with flows (touching cells).

    python -m sequitr_tpu_torch.examples.segment_instances_flows /tmp/sequitr_flows_demo [--device cpu]

Trains a flows model (``train_flows``) on discs, some pairs touching, then
files ``segment_flows``, ``evaluate_flows`` and a per-instance
``measure_objects`` (``instances: true``) behind it by ``depends_on``; the
flows keep touching cells apart where plain foreground connected
components merge them.
"""

import json
import os

import numpy as np

REQUIRES = ("h5py",)  # segment_flows' objects.h5


def make_scene(rng, n=30, size=48, n_cells=3):
    """(images, instance labels): discs, some pairs touching."""
    imgs = np.zeros((n, size, size), np.float32)
    labs = np.zeros((n, size, size), np.uint16)
    yy, xx = np.mgrid[:size, :size]
    for t in range(n):
        placed = []
        lab = np.zeros((size, size), np.int32)
        for i in range(1, n_cells + 1):
            for _ in range(30):
                r = int(rng.integers(6, 11))
                cy = int(rng.integers(r + 1, size - r - 1))
                cx = int(rng.integers(r + 1, size - r - 1))
                if all(
                    (cy - py) ** 2 + (cx - px) ** 2 >= max(r, pr) ** 2
                    for py, px, pr in placed
                ):
                    break
            m = (yy - cy) ** 2 + (xx - cx) ** 2 < r**2
            lab[m & (lab == 0)] = i
            placed.append((cy, cx, r))
        img = 0.15 + 0.7 * (lab > 0) + rng.normal(0, 0.05, lab.shape)
        imgs[t] = np.clip(img, 0, 1)
        labs[t] = lab
    return imgs, labs


def main(base: str, device: str = "cuda"):
    from sequitr_tpu_torch import localize
    from sequitr_tpu_torch.config import ServerConfiguration
    from sequitr_tpu_torch.data import tiff
    from sequitr_tpu_torch.examples import steps
    from sequitr_tpu_torch.server import ImageServer, submit_job

    os.makedirs(base, exist_ok=True)
    cfg = ServerConfiguration(
        jobs_dir=os.path.join(base, "jobs"),
        models_dir=os.path.join(base, "models"),
        device=device,
    )
    cfg.ensure_dirs()
    server = ImageServer(cfg)

    rng = np.random.default_rng(11)
    imgs, labs = make_scene(rng)
    img_path = os.path.join(base, "cells.tif")
    lab_path = os.path.join(base, "instances.tif")
    tiff.write_stack(img_path, imgs)
    tiff.write_stack(lab_path, labs)

    train_out = os.path.join(base, "train")
    seg_out = os.path.join(base, "segmented")
    ev_out = os.path.join(base, "evaluation")
    submit_job(
        cfg.jobs_dir,
        {"module": "train_flows",
         "params": {"model": "flows_demo", "patch": [32, 32],
                    "patches_per_frame": 3, "steps": steps(400), "batch_size": 8,
                    "learning_rate": 2e-3, "lr_schedule": "cosine",
                    "depth": 2, "base_features": 8,
                    "compute_dtype": "float32",
                    "holdout_every": 10, "keep_best": True},
         "input": [img_path, lab_path], "output": train_out},
    )
    submit_job(
        cfg.jobs_dir,
        {"module": "segment_flows",
         "params": {"model": "flows_demo", "min_area": 20,
                    "save_objects_csv": True},
         "input": [img_path], "output": seg_out,
         "depends_on": [train_out]},
    )
    submit_job(
        cfg.jobs_dir,
        {"module": "evaluate_flows",
         "params": {"model": "flows_demo", "min_area": 20},
         "input": [img_path, lab_path], "output": ev_out,
         "depends_on": [train_out]},
    )
    # quantify per-INSTANCE intensities on the serve's own label stack:
    # instances: true trusts the ids (plain CCL would re-merge the
    # touching cells the flows serve just separated)
    meas_out = os.path.join(base, "measurements")
    submit_job(
        cfg.jobs_dir,
        {"module": "measure_objects",
         "params": {"instances": True},
         "input": [os.path.join(seg_out, "labels.tif"), img_path],
         "output": meas_out,
         "depends_on": [seg_out]},
    )
    for _ in range(4):
        assert server.poll_once(), "no job ready"

    with open(os.path.join(seg_out, "status.json")) as f:
        st = json.load(f)
    assert st["state"] == "complete", st.get("error")
    print("serve:", json.loads(st["outputs"]["metrics"]))

    with open(os.path.join(ev_out, "status.json")) as f:
        st = json.load(f)
    assert st["state"] == "complete", st.get("error")
    m = json.loads(st["outputs"]["metrics"])
    print(f"instance AP vs truth: ap50={m['ap50']} ap75={m['ap75']} "
          f"mean_matched_iou={m['mean_matched_iou']}")

    # what plain foreground-CCL would have produced on the SAME truth
    # masks: touching pairs merge, so it cannot reach the GT count
    n_ccl = sum(
        int(localize.label_components(labs[t] > 0).max())
        for t in range(len(labs))
    )
    print(f"instances: truth={m['n_gt']} flows={m['n_pred']} "
          f"plain-CCL-on-truth-fg={n_ccl} (merged touching pairs)")

    with open(os.path.join(meas_out, "status.json")) as f:
        st = json.load(f)
    assert st["state"] == "complete", st.get("error")
    with open(st["outputs"]["measurements"]) as f:
        rows = f.read().strip().split("\n")
    print(f"per-instance measurements: {len(rows) - 1} rows "
          f"({rows[0]}) — instances: true keeps touching cells apart")


if __name__ == "__main__":
    from sequitr_tpu_torch.examples import run

    run(main, "/tmp/sequitr_flows_demo")
