"""End-to-end example: drift correction, verified by a chained job.

    python -m sequitr_tpu_torch.examples.register_and_chain /tmp/sequitr_chain_demo [--device cpu]

1. synthesizes a band-limited scene drifting ~1 px/frame (a Fourier-exact
   shift, so the truth is known);
2. files BOTH jobs up front: ``register_stack`` (previous-frame mode,
   cropped) and an ``estimate_only`` ``register_stack`` over the
   registered output, chained by ``depends_on``;
3. the server works the chain in dependency order; the residual drift of
   the registered stack must be below 0.05 px/frame.
"""

import json
import os

import numpy as np


def make_drifting_stack(path: str, t: int = 8, size: int = 96, seed: int = 0):
    """Band-limited scene translated by ~1 px/frame (Fourier-exact)."""
    import torch

    from sequitr_tpu_torch.data import tiff
    from sequitr_tpu_torch.data.synthetic import bandlimited_scene
    from sequitr_tpu_torch.ops import registration as reg

    rng = np.random.default_rng(seed)
    base = bandlimited_scene((size, size), rng)
    frames = [
        reg.apply_shift(
            torch.as_tensor(base), torch.tensor([0.8 * k, -0.5 * k])
        ).numpy()
        for k in range(t)
    ]
    tiff.write_stack(path, np.stack(frames))


def main(base: str, device: str = "cuda"):
    from sequitr_tpu_torch import client
    from sequitr_tpu_torch.config import ServerConfiguration
    from sequitr_tpu_torch.server import ImageServer

    os.makedirs(base, exist_ok=True)
    cfg = ServerConfiguration(
        jobs_dir=os.path.join(base, "jobs"),
        models_dir=os.path.join(base, "models"),
        device=device,
    )
    cfg.ensure_dirs()
    server = ImageServer(cfg)

    stack_path = os.path.join(base, "drifting.tif")
    make_drifting_stack(stack_path)

    reg_out = os.path.join(base, "registered")
    resid_out = os.path.join(base, "residual")

    # file BOTH jobs up front — submission order doesn't matter; the
    # second stays queued until reg_out holds a complete status.json
    # (`python -m sequitr_tpu_torch submit --after <dir>` does the same)
    client.jobs_lib.submit_job(
        cfg.jobs_dir,
        {
            "module": "register_stack",
            "params": {"mode": "previous", "crop": True},
            "input": [stack_path],
            "output": reg_out,
        },
    )
    client.jobs_lib.submit_job(
        cfg.jobs_dir,
        {
            "module": "register_stack",
            "params": {"estimate_only": True},
            "input": [os.path.join(reg_out, "registered.tif")],
            "output": resid_out,
            "depends_on": reg_out,
        },
    )

    # the server works the chain in dependency order
    assert server.poll_once(), "registration job should claim first"
    assert server.poll_once(), "residual job should claim once unblocked"
    status = client.wait_for_job(resid_out, timeout=60)
    assert status["state"] == "complete", status.get("error")

    with open(os.path.join(reg_out, "status.json")) as f:
        reg_metrics = json.load(f)["outputs"]["metrics"]
    print("registration:", reg_metrics)

    resid = np.loadtxt(
        os.path.join(resid_out, "shifts.csv"),
        delimiter=",", skiprows=1, usecols=(1, 2),
    )
    worst = float(np.abs(resid).max())
    print(f"residual drift of the registered stack: {worst:.4f} px/frame")
    assert worst < 0.05, "registered stack should be stationary"
    print("chain complete: register -> verify, no client-side polling")


if __name__ == "__main__":
    from sequitr_tpu_torch.examples import run

    run(main, "/tmp/sequitr_chain_demo")
