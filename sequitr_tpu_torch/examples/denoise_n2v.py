"""Noise2Void example: train a denoiser from NOISY data alone, then serve.

The pix2pix enhancer (``enhance_denoise``) needs paired clean targets;
most microscopy has none. Noise2Void's blind-spot training (``train_n2v``)
learns the denoiser from the noisy acquisition itself — this demo trains
on a noisy synthetic timelapse and scores the output against the clean
render the training never saw.

    python -m sequitr_tpu_torch.examples.denoise_n2v /tmp/sequitr_n2v_demo [--device cpu]
"""

import os

import numpy as np


def main(base: str, device: str = "cuda"):
    from sequitr_tpu_torch import client
    from sequitr_tpu_torch.config import ServerConfiguration
    from sequitr_tpu_torch.data import synthetic, tiff
    from sequitr_tpu_torch.examples import steps
    from sequitr_tpu_torch.server import ImageServer

    os.makedirs(base, exist_ok=True)
    cfg = ServerConfiguration(
        jobs_dir=os.path.join(base, "jobs"), models_dir=os.path.join(base, "models"),
        device=device,
    )
    cfg.ensure_dirs()
    server = ImageServer(cfg)

    # a noisy timelapse with a known clean truth (only for scoring — the
    # training below sees the noisy stack ONLY)
    pairs = [synthetic.denoise_pair(100 + t, (64, 64)) for t in range(24)]
    clean = np.stack([c for c, _ in pairs])
    noisy = np.stack([x for _, x in pairs])
    noisy_p = os.path.join(base, "noisy.tif")
    tiff.write_stack(noisy_p, noisy)

    def run(spec):
        client.jobs_lib.submit_job(cfg.jobs_dir, spec)
        assert server.poll_once(), "no job claimed"
        return client.wait_for_job(spec["output"], timeout=300)

    status = run(
        {
            "module": "train_n2v",
            "params": {
                "model": "demo_n2v",
                "patch": [64, 64],
                "patches_per_frame": 1,
                "steps": steps(250),
                "batch_size": 8,
                "learning_rate": 3e-3,
                "mask_frac": 0.02,
                "radius": 4,
                "lr_schedule": "cosine",
                "depth": 2,
                "base_features": 12,
                "compute_dtype": "float32",
                # denoise_pair scenes are pre-scaled: train raw + serve
                # with normalize "none" so both sides share one space
                "normalize": False,
                "holdout_every": 8,
                "keep_best": True,
            },
            "input": [noisy_p],
            "output": os.path.join(base, "train"),
        }
    )
    print("trained:", status["outputs"]["model"])

    status = run(
        {
            "module": "denoise",
            # denoise_pair scenes already live in the trained scale; raw
            # microscopy stacks would keep the default percentile normalize
            "params": {"model": "demo_n2v", "normalize": "none"},
            "input": [noisy_p],
            "output": os.path.join(base, "serve"),
        }
    )
    out = np.asarray(tiff.read_stack(status["outputs"]["denoised"]))

    def psnr(a, b):
        return 10 * np.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-12))

    print(
        f"PSNR vs clean truth: noisy input {psnr(noisy, clean):.1f} dB "
        f"-> denoised {psnr(out, clean):.1f} dB"
    )


if __name__ == "__main__":
    from sequitr_tpu_torch.examples import run

    run(main, "/tmp/sequitr_n2v_demo")
