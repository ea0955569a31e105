"""End-to-end example: the review knobs of a segmentation serve.

    python -m sequitr_tpu_torch.examples.qc_review /tmp/sequitr_qc [--device cpu]

Touching cells in a deflate-compressed stack, served twice: plain, and
with test-time augmentation (``tta: 4``), per-pixel uncertainty
(``save_entropy``), watershed splitting of touching cells
(``split_touching``) and deflated outputs (``compress_output``); prints
each frame's mean uncertainty and the two label files' sizes.
"""

import json
import os

import numpy as np

REQUIRES = ("h5py",)  # the served jobs' objects.h5


def make_touching_cells(path: str, t: int = 3, size: int = 64, seed: int = 0):
    """Pairs of overlapping bright disks — the touching-cell scenario."""
    from sequitr_tpu_torch.data import tiff

    rng = np.random.default_rng(seed)
    stack = rng.normal(80.0, 10.0, (t, size, size)).astype(np.float32)
    labels = np.zeros((t, size, size), np.int32)
    yy, xx = np.mgrid[:size, :size]
    for f in range(t):
        for _ in range(2):
            cy, cx = rng.integers(16, size - 16, 2)
            # two disks whose centers are 1.4 radii apart: they overlap
            for dy, dx in ((0, -5), (0, 5)):
                blob = (yy - cy - dy) ** 2 + (xx - cx - dx) ** 2 < 49
                stack[f][blob] += 400.0
                labels[f][blob] = 1
    tiff.write_stack(path, stack, compression="deflate")  # compressed ingest
    return labels


def main(base: str, device: str = "cuda"):
    import torch

    from sequitr_tpu_torch import client
    from sequitr_tpu_torch.config import ServerConfiguration
    from sequitr_tpu_torch.data import tiff
    from sequitr_tpu_torch.models import unet
    from sequitr_tpu_torch.server import ImageServer, save_model

    os.makedirs(base, exist_ok=True)
    cfg = ServerConfiguration(
        jobs_dir=os.path.join(base, "jobs"),
        models_dir=os.path.join(base, "models"),
        device=device,
    )
    cfg.ensure_dirs()
    server = ImageServer(cfg)

    stack_path = os.path.join(base, "stack.tif")
    make_touching_cells(stack_path)
    print(f"input stack: {os.path.getsize(stack_path)} bytes (deflate)")

    # an untrained tiny model is enough to demonstrate the knobs
    net_cfg = unet.UNetConfig(
        in_channels=1, num_classes=2, depth=2, base_features=8,
        compute_dtype="float32",
    )
    model = unet.init(net_cfg, torch.Generator().manual_seed(0), device="cpu")
    save_model(cfg.models_dir, "qc_demo", "unet", net_cfg, model)

    def run(spec):
        client.jobs_lib.submit_job(cfg.jobs_dir, spec)
        assert server.poll_once(), "no job claimed"
        return client.wait_for_job(spec["output"], timeout=120)

    results = {}
    for name, extra in [
        ("plain", {}),
        ("qc", {"tta": 4, "save_entropy": True, "split_touching": True,
                "min_distance": 4, "compress_output": True}),
    ]:
        out_dir = os.path.join(base, f"out_{name}")
        status = run(
            {
                "module": "segmentation_unet2d",
                "params": dict(
                    {"model": "qc_demo", "patch": [32, 32],
                     "overlap": [8, 8], "save_probs": True},
                    **extra,
                ),
                "input": [stack_path],
                "output": out_dir,
            }
        )
        metrics = json.loads(status["outputs"]["metrics"])
        results[name] = status["outputs"]
        print(f"{name}: {metrics['n_objects']} objects, "
              f"{metrics['frames_per_sec']} fps")

    # uncertainty summary: mean entropy per frame flags the shakiest frames
    ent = tiff.read_stack(results["qc"]["entropy"])
    for f, e in enumerate(ent.reshape(ent.shape[0], -1).mean(axis=1)):
        print(f"frame {f}: mean uncertainty {e:.3f}")
    lbl_qc = os.path.getsize(results["qc"]["labels"])
    lbl_plain = os.path.getsize(results["plain"]["labels"])
    print(f"labels.tif: {lbl_qc} bytes deflated vs {lbl_plain} raw")


if __name__ == "__main__":
    from sequitr_tpu_torch.examples import run

    run(main, "/tmp/sequitr_qc")
