"""End-to-end example: train the pix2pix enhancer on paired data, serve it.

    python -m sequitr_tpu_torch.examples.enhance_denoise /tmp/sequitr_gan_demo [--device cpu]

1. writes a noisy / clean pair of stacks;
2. ``build_gan_pairs`` -> ``train_gan`` (a small generator, near-supervised
   L1 weight) -> ``enhancement_gan`` through the job API;
3. prints the correlation with the clean target before and after.
"""

import os

import numpy as np


def make_pairs(base: str, t: int = 6, size: int = 32, seed: int = 0):
    from sequitr_tpu_torch.data import tiff

    rng = np.random.default_rng(seed)
    clean = np.zeros((t, size, size), np.float32)
    for f in range(t):
        for _ in range(2):
            cy, cx = rng.integers(6, size - 6, 2)
            yy, xx = np.mgrid[:size, :size]
            clean[f] += 300.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0)
    noisy = clean + rng.normal(0, 60.0, clean.shape).astype(np.float32) + 100.0
    tiff.write_stack(os.path.join(base, "noisy.tif"), noisy.astype(np.float32))
    tiff.write_stack(os.path.join(base, "clean.tif"), clean.astype(np.float32))
    return noisy, clean


def main(base: str, device: str = "cuda"):
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
    noisy, clean = make_pairs(base)

    def run(spec):
        client.jobs_lib.submit_job(cfg.jobs_dir, spec)
        assert server.poll_once(), "no job claimed"
        return client.wait_for_job(spec["output"], timeout=120)

    pairs_out = os.path.join(base, "pairs")
    status = run(
        {
            "module": "build_gan_pairs",
            "params": {},
            "input": [os.path.join(base, "noisy.tif"), os.path.join(base, "clean.tif")],
            "output": pairs_out,
        }
    )
    print("pairs:", status["outputs"])

    train_out = os.path.join(base, "train")
    status = run(
        {
            "module": "train_gan",
            "params": {
                "model": "demo_enh",
                "gen_depth": 2,
                "gen_base_features": 8,
                "disc_layers": 2,
                "disc_base_features": 8,
                "compute_dtype": "float32",
                "steps": steps(200),
                "batch_size": 3,
                "learning_rate": 1e-3,
                "l1_weight": 500.0,  # near-supervised for the quick demo
            },
            "input": [status["outputs"]["shards"]],
            "output": train_out,
        }
    )
    print("trained:", status["outputs"]["model"])

    enh_out = os.path.join(base, "enhanced")
    status = run(
        {
            "module": "enhancement_gan",
            "params": {"model": "demo_enh", "patch": [32, 32], "overlap": [0, 0]},
            "input": [os.path.join(base, "noisy.tif")],
            "output": enh_out,
        }
    )
    enhanced = tiff.read_stack(status["outputs"]["enhanced"])

    # compare correlation with the clean target before/after
    def corr(a, b):
        a, b = a.reshape(-1), b.reshape(-1)
        return float(np.corrcoef(a, b)[0, 1])

    # normalize the raw stack the way the pipeline did for a fair comparison
    lo, hi = np.percentile(noisy[0], [5.0, 99.5])
    raw_n = np.clip((noisy[0] - lo) / (hi - lo), 0, 1)
    clean_n = (clean[0] - clean[0].min()) / max(float(np.ptp(clean[0])), 1e-8)
    print(
        f"corr(raw, clean) = {corr(raw_n, clean_n):.3f}; "
        f"corr(enhanced, clean) = {corr(enhanced if enhanced.ndim == 2 else enhanced[0], clean_n):.3f}"
    )


if __name__ == "__main__":
    from sequitr_tpu_torch.examples import run

    run(main, "/tmp/sequitr_gan_demo")
