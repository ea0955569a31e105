"""End-to-end example: retrospective illumination correction.

    python -m sequitr_tpu_torch.examples.correct_illumination /tmp/sequitr_illum_demo [--device cpu]

1. synthesizes a fluorescence-like timelapse corrupted by the two
   classic acquisition nuisances — a radial vignette (every frame sees
   the same optical path) and exponential photobleaching (each frame a
   little dimmer than the last);
2. files a calibrate -> apply chain UP FRONT: a `correct_illumination`
   job in `estimate_only` mode measures the shading profile, and a
   second job chained via `depends_on` applies that profile (plus a
   per-run photobleach ramp) to the stack — the calibrate-once /
   apply-many pattern a multi-round acquisition uses;
3. checks the corrected stack is stationary in time (bleach removed)
   and flat in space (vignette removed).
"""

import json
import os

import numpy as np


def make_corrupted_stack(path: str, t: int = 24, size: int = 96, seed: int = 0):
    """Moving band-limited scene x radial vignette x exp photobleach."""
    from sequitr_tpu_torch.data import tiff
    from sequitr_tpu_torch.data.synthetic import bandlimited_scene

    rng = np.random.default_rng(seed)
    big = bandlimited_scene((size + t, size + t), rng, sigma=0.08, amp=60.0)
    big = big + 120.0
    yy, xx = np.meshgrid(
        np.linspace(-1, 1, size), np.linspace(-1, 1, size), indexing="ij"
    )
    vignette = 1.0 - 0.35 * (yy**2 + xx**2)
    bleach_rate = 0.03
    frames = np.stack(
        [
            big[k : k + size, k : k + size]  # the sample drifts a little
            * vignette
            * np.exp(-bleach_rate * k)
            for k in range(t)
        ]
    ).astype(np.float32)
    tiff.write_stack(path, frames)
    return bleach_rate


def main(base: str, device: str = "cuda"):
    from sequitr_tpu_torch import client
    from sequitr_tpu_torch.config import ServerConfiguration
    from sequitr_tpu_torch.data import tiff
    from sequitr_tpu_torch.server import ImageServer

    os.makedirs(base, exist_ok=True)
    cfg = ServerConfiguration(
        jobs_dir=os.path.join(base, "jobs"),
        models_dir=os.path.join(base, "models"),
        device=device,
    )
    cfg.ensure_dirs()
    server = ImageServer(cfg)

    stack_path = os.path.join(base, "timelapse.tif")
    true_rate = make_corrupted_stack(stack_path)

    cal_out = os.path.join(base, "calibration")
    corr_out = os.path.join(base, "corrected")

    # calibrate once (a real rig would run this on a blank/reference
    # acquisition), then apply the measured profile to the experiment —
    # bleach stays per-run because each acquisition bleaches its own
    # sample
    client.jobs_lib.submit_job(
        cfg.jobs_dir,
        {
            "module": "correct_illumination",
            "params": {"estimate_only": True, "sample_frames": 16},
            "input": [stack_path],
            "output": cal_out,
        },
    )
    client.jobs_lib.submit_job(
        cfg.jobs_dir,
        {
            "module": "correct_illumination",
            "params": {"shading": cal_out, "bleach": "exp",
                       "sample_frames": 16},
            "input": [stack_path],
            "output": corr_out,
            "depends_on": cal_out,
        },
    )

    assert server.poll_once(), "calibration job should claim first"
    assert server.poll_once(), "apply job should claim once unblocked"
    status = client.wait_for_job(corr_out, timeout=120)
    assert status["state"] == "complete", status.get("error")

    metrics = json.loads(status["outputs"]["metrics"])
    print(
        f"measured bleach rate: {metrics['bleach_rate_c0']:.4f} "
        f"(true {true_rate}) — half-life "
        f"{np.log(2) / metrics['bleach_rate_c0']:.0f} frames"
    )
    print(
        "shading profile range:",
        f"[{metrics['shading_min']}, {metrics['shading_max']}]",
    )

    raw = tiff.read_stack(stack_path)
    corrected = tiff.read_stack(status["outputs"]["corrected"])
    raw_meds = np.median(raw, axis=(1, 2))
    cor_meds = np.median(corrected, axis=(1, 2))
    print(
        f"temporal drift (max/min frame median): raw "
        f"{raw_meds.max() / raw_meds.min():.3f}x -> corrected "
        f"{cor_meds.max() / cor_meds.min():.3f}x"
    )
    assert cor_meds.max() / cor_meds.min() < 1.02, "bleach should be gone"

    # spatial flatness: the corner-to-centre intensity ratio of the
    # AVERAGE frame (content averages out; shading does not)
    mean_frame = corrected.mean(axis=0)
    centre = mean_frame[32:64, 32:64].mean()
    corners = np.concatenate(
        [mean_frame[:16, :16].ravel(), mean_frame[-16:, -16:].ravel()]
    ).mean()
    print(f"corner/centre after correction: {corners / centre:.3f}")
    print("calibrate -> apply chain complete")


if __name__ == "__main__":
    from sequitr_tpu_torch.examples import run

    run(main, "/tmp/sequitr_illum_demo")
