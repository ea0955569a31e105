"""End-to-end example: records -> train -> segment + localize -> track.

    python -m sequitr_tpu_torch.examples.segment_timelapse /tmp/sequitr_demo [--device cpu]

1. writes a small timelapse of bright blobs and its labels;
2. ``build_records`` (with weight maps) -> ``train_unet2d``;
3. ``segmentation_unet2d``: labels.tif and the btrack ``objects.h5``;
4. ``track_objects``: the built-in constant-velocity Kalman linker.
"""

import json
import os

import numpy as np

REQUIRES = ("h5py",)  # objects.h5


def make_stack(path: str, t: int = 4, size: int = 64, seed: int = 0):
    from sequitr_tpu_torch.data import tiff

    rng = np.random.default_rng(seed)
    stack = rng.normal(80.0, 10.0, (t, size, size)).astype(np.float32)
    labels = np.zeros((t, size, size), np.int32)
    for f in range(t):
        for _ in range(3):
            cy, cx = rng.integers(10, size - 10, 2)
            yy, xx = np.mgrid[:size, :size]
            blob = (yy - cy) ** 2 + (xx - cx) ** 2 < rng.integers(12, 30)
            stack[f][blob] += 400.0
            labels[f][blob] = 1
    tiff.write_stack(path, stack)
    return labels


def main(base: str, device: str = "cuda"):
    import h5py

    from sequitr_tpu_torch import client
    from sequitr_tpu_torch.config import ServerConfiguration
    from sequitr_tpu_torch.data import tiff
    from sequitr_tpu_torch.examples import steps
    from sequitr_tpu_torch.server import ImageServer

    os.makedirs(base, exist_ok=True)
    cfg = ServerConfiguration(
        jobs_dir=os.path.join(base, "jobs"), models_dir=os.path.join(base, "models"),
        device=device,
    )
    cfg.ensure_dirs()
    server = ImageServer(cfg)

    stack_path = os.path.join(base, "stack.tif")
    labels = make_stack(stack_path)
    tiff.write_stack(os.path.join(base, "labels.tif"), labels.astype(np.uint16))

    def run(spec):
        client.jobs_lib.submit_job(cfg.jobs_dir, spec)
        assert server.poll_once(), "no job claimed"
        return client.wait_for_job(spec["output"], timeout=60)

    # 1. build records with weight maps
    rec_out = os.path.join(base, "records")
    status = run(
        {
            "module": "build_records",
            "params": {"num_classes": 2},
            "input": [stack_path, os.path.join(base, "labels.tif")],
            "output": rec_out,
        }
    )
    print("records:", status["outputs"])

    # 2. train
    train_out = os.path.join(base, "train")
    status = run(
        {
            "module": "train_unet2d",
            "params": {
                "model": "demo_seg",
                "num_classes": 2,
                "depth": 2,
                "base_features": 8,
                "norm": "none",
                "compute_dtype": "float32",
                "steps": steps(60),
                "batch_size": 4,
                "learning_rate": 3e-3,
                "augment": False,
            },
            "input": [status["outputs"]["shards"]],
            "output": train_out,
        }
    )
    print("trained model:", status["outputs"]["model"])

    # 3. segment + localize
    seg_out = os.path.join(base, "segmentation")
    status = run(
        {
            "module": "segmentation_unet2d",
            "params": {"model": "demo_seg", "patch": [32, 32], "overlap": [8, 8]},
            "input": [stack_path],
            "output": seg_out,
        }
    )
    print("segmentation metrics:", json.loads(status["outputs"]["metrics"]))

    with h5py.File(status["outputs"]["objects"]) as f:
        n = f["objects/obj_type_1/coords"].shape[0]
    masks = tiff.read_stack(status["outputs"]["labels"])
    print(f"objects for btrack: {n}; mask foreground fraction: "
          f"{(masks > 0).mean():.3f} (true: {(labels > 0).mean():.3f})")

    # 4. built-in tracking over the objects (btrack stays the Bayesian
    # publication-grade path; this is the in-framework linker). The
    # constant-velocity Kalman model keeps identities through crossings
    # and closes gaps by prediction; "divisions": true would additionally
    # resolve binary fission into parent/child lineages.
    trk_out = os.path.join(base, "tracks")
    status = run(
        {
            "module": "track_objects",
            "params": {"max_distance": 15, "max_gap": 1,
                       "motion_model": "kalman"},
            "input": [status["outputs"]["objects"]],
            "output": trk_out,
        }
    )
    print("tracking metrics:", json.loads(status["outputs"]["metrics"]))
    with open(status["outputs"]["track_summaries"]) as f:
        print("track summaries:", f.read().splitlines()[0])


if __name__ == "__main__":
    from sequitr_tpu_torch.examples import run

    run(main, "/tmp/sequitr_demo")
