"""End-to-end example: volumetric records -> 3D U-Net -> 3D segmentation.

    python -m sequitr_tpu_torch.examples.segment_volume_3d /tmp/sequitr_demo_3d [--device cpu]

1. writes one z-stack of ellipsoidal blobs and its labels;
2. ``build_records`` with ``dims: 3`` (random sub-volume crops) ->
   ``train_unet3d``;
3. ``segmentation_unet3d``: labels and the 3D btrack ``objects.h5``.
"""

import json
import os

import numpy as np

REQUIRES = ("h5py",)  # objects.h5


def make_volume(path: str, z: int = 8, size: int = 48, seed: int = 0):
    from sequitr_tpu_torch.data import tiff

    rng = np.random.default_rng(seed)
    vol = rng.normal(80.0, 10.0, (z, size, size)).astype(np.float32)
    labels = np.zeros((z, size, size), np.int32)
    zz, yy, xx = np.mgrid[:z, :size, :size]
    for _ in range(4):
        cz = rng.integers(2, z - 2)
        cy, cx = rng.integers(10, size - 10, 2)
        blob = (
            ((zz - cz) / 2.0) ** 2 + ((yy - cy) / 4.0) ** 2 + ((xx - cx) / 4.0) ** 2
        ) < 1.0
        vol[blob] += 400.0
        labels[blob] = 1
    tiff.write_stack(path, vol)
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

    vol_path = os.path.join(base, "volume.tif")
    labels = make_volume(vol_path)
    tiff.write_stack(
        os.path.join(base, "labels.tif"), labels.astype(np.uint16)
    )

    def run(spec):
        client.jobs_lib.submit_job(cfg.jobs_dir, spec)
        assert server.poll_once(), "no job claimed"
        return client.wait_for_job(spec["output"], timeout=120)

    # 1. volumetric records: the whole stack is one example; random
    #    sub-volume crops make the training set
    rec_out = os.path.join(base, "records")
    status = run(
        {
            "module": "build_records",
            "params": {
                "dims": 3,
                "num_classes": 2,
                "patch": [4, 16, 16],
                "patches_per_example": 16,
            },
            "input": [vol_path, os.path.join(base, "labels.tif")],
            "output": rec_out,
        }
    )
    print("records:", status["outputs"])

    # 2. train a 3D U-Net (volumetric augmentation: 3-axis flips,
    #    z-consistent elastic field)
    train_out = os.path.join(base, "train")
    status = run(
        {
            "module": "train_unet3d",
            "params": {
                "model": "demo_seg3d",
                "num_classes": 2,
                "depth": 2,
                "base_features": 8,
                "norm": "none",
                "compute_dtype": "float32",
                "steps": steps(60),
                "batch_size": 4,
                "learning_rate": 3e-3,
            },
            "input": [status["outputs"]["shards"]],
            "output": train_out,
        }
    )
    print("trained model:", status["outputs"]["model"])

    # 3. volumetric segmentation + 3D localization
    seg_out = os.path.join(base, "segmentation")
    status = run(
        {
            "module": "segmentation_unet3d",
            "params": {
                "model": "demo_seg3d",
                "patch": [8, 48, 48],
                "overlap": [0, 0, 0],
            },
            "input": [vol_path],
            "output": seg_out,
        }
    )
    print("segmentation metrics:", json.loads(status["outputs"]["metrics"]))

    with h5py.File(status["outputs"]["objects"]) as f:
        coords = f["objects/obj_type_1/coords"][:]
    masks = tiff.read_stack(status["outputs"]["labels"])
    print(
        f"objects for btrack: {len(coords)} (z range "
        f"{coords[:, 3].min():.1f}-{coords[:, 3].max():.1f}); "
        f"mask foreground fraction: {(masks > 0).mean():.3f} "
        f"(true: {(labels > 0).mean():.3f})"
    )


if __name__ == "__main__":
    from sequitr_tpu_torch.examples import run

    run(main, "/tmp/sequitr_demo_3d")
