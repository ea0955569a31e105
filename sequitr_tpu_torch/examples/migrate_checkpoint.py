"""End-to-end example: migrate a foreign checkpoint into the server.

    python -m sequitr_tpu_torch.examples.migrate_checkpoint /tmp/sequitr_migrate [--device cpu]

1. a "foreign" trained checkpoint (random weights stand in), dumped flat
   with TF-layout transposed-conv kernels and batch-norm running stats;
2. registered through the CLI (``import-model --layout tf``);
3. validated through the job API (``parity_check`` against the torch
   re-derivation);
4. served (``segmentation_unet2d``).
"""

import json
import os

import numpy as np

REQUIRES = ("h5py",)  # the served job's objects.h5


def main(base: str, device: str = "cuda"):
    import torch

    from sequitr_tpu_torch import client
    from sequitr_tpu_torch.__main__ import main as cli
    from sequitr_tpu_torch.config import ServerConfiguration
    from sequitr_tpu_torch.data import tiff
    from sequitr_tpu_torch.models import convert as convert_lib
    from sequitr_tpu_torch.models import unet
    from sequitr_tpu_torch.server import ImageServer

    os.makedirs(base, exist_ok=True)
    models = os.path.join(base, "models")

    # 1. a "foreign" trained checkpoint (random weights stand in), dumped
    # flat with TF-layout transposed-conv kernels + BN running stats
    cfg = unet.UNetConfig(
        in_channels=1, num_classes=3, depth=3, base_features=8, norm="batch",
    )
    flat = convert_lib.to_flat(unet.init(cfg, torch.Generator().manual_seed(0), device="cpu"))
    rng = np.random.default_rng(1)
    flat = {
        k: (convert_lib.tf_transpose_kernel_to_jax(v)  # involution: to TF layout
            if "/up/" in f"/{k}/" and k.endswith("/w") and v.ndim >= 4
            else v + 0.1 * rng.random(v.shape).astype(np.float32) if k.startswith("state/")
            else v)
        for k, v in flat.items()
    }
    npz = os.path.join(base, "tf_checkpoint.npz")
    np.savez(npz, **flat)

    # 2. register through the CLI
    arch = os.path.join(base, "arch.json")
    with open(arch, "w") as f:
        json.dump({"in_channels": 1, "num_classes": 3, "depth": 3,
                   "base_features": 8, "norm": "batch"}, f)
    assert cli(["import-model", "--models-dir", models, "--npz", npz,
                "--arch", arch, "--layout", "tf", "migrated"]) == 0
    print("registered: migrated")

    # 3. validate through the job API
    srv_cfg = ServerConfiguration(
        jobs_dir=os.path.join(base, "jobs"), models_dir=models, device=device,
    )
    srv_cfg.ensure_dirs()
    server = ImageServer(srv_cfg)

    def run(spec):
        client.jobs_lib.submit_job(srv_cfg.jobs_dir, spec)
        assert server.poll_once()
        return client.wait_for_job(spec["output"], timeout=300)

    status = run({
        "module": "parity_check",
        "params": {"model": "migrated", "reference": "torch",
                   "spatial": [32, 32]},
        "input": [], "output": os.path.join(base, "parity"),
    })
    print("parity:", status["outputs"]["metrics"])

    # 4. serve with the migrated model
    rng = np.random.default_rng(2)
    stack_path = os.path.join(base, "stack.tif")
    tiff.write_stack(
        stack_path, (rng.random((2, 64, 64)) * 60000).astype(np.uint16)
    )
    status = run({
        "module": "segmentation_unet2d",
        "params": {"model": "migrated", "patch": [32, 32], "overlap": [8, 8]},
        "input": [stack_path], "output": os.path.join(base, "seg"),
    })
    print("serving metrics:", json.loads(status["outputs"]["metrics"]))
    print("migration complete: converted -> registered -> validated -> served")


if __name__ == "__main__":
    from sequitr_tpu_torch.examples import run

    run(main, "/tmp/sequitr_migrate")
