"""End-to-end example: stitch a jittered tile grid with flat-field and gains.

    python -m sequitr_tpu_torch.examples.stitch_mosaic /tmp/sequitr_mosaic_demo [--device cpu]

1. cuts a 2x3 grid of overlapping tiles from one band-limited scene, each
   with sub-pixel stage jitter, a shared vignette and a photobleaching
   ramp across the scan;
2. ``stitch_mosaic`` (``refine: 3``, ``flatfield``, ``match_gains``);
3. checks the tile positions against the truth (< 0.05 px) and that the
   gains recovered the ramp.
"""

import json
import os

import numpy as np


def make_tile_grid(tile_dir: str, r=2, c=3, h=160, w=160, ov=32, seed=0):
    """Cut an (r, c) grid of jittered overlapping tiles from one scene.
    Returns the true row-major tile origins."""
    import torch

    from sequitr_tpu_torch.data import tiff
    from sequitr_tpu_torch.data.synthetic import bandlimited_scene
    from sequitr_tpu_torch.ops import registration as reg

    size = (
        (r - 1) * (h - ov) + h + 16,
        (c - 1) * (w - ov) + w + 16,
    )
    rng = np.random.default_rng(seed)
    scene = bandlimited_scene(size, rng)
    os.makedirs(tile_dir, exist_ok=True)
    # the optics: a shared vignette every tile sees identically
    yy = np.linspace(-1, 1, h)[:, None]
    xx = np.linspace(-1, 1, w)[None, :]
    vignette = (1.0 - 0.3 * (yy**2 + xx**2)).astype(np.float32)
    pos = []
    k = 0
    for ri in range(r):
        for ci in range(c):
            jy = jx = 0.0
            if (ri, ci) != (0, 0):
                jy, jx = rng.uniform(-2.0, 2.0, 2)  # stage jitter
            y0, x0 = ri * (h - ov) + 8 + jy, ci * (w - ov) + 8 + jx
            iy, ix = int(np.floor(y0)), int(np.floor(x0))
            shifted = reg.apply_shift(
                torch.as_tensor(scene),
                torch.tensor([iy - y0, ix - x0], dtype=torch.float32),
            ).numpy()
            fade = 1.0 - 0.05 * k  # photobleaching across the scan
            tiff.write_stack(
                os.path.join(tile_dir, f"tile_{ri}_{ci}.tif"),
                (fade * vignette)[None]
                * shifted[None, iy : iy + h, ix : ix + w],
            )
            pos.append((y0, x0))
            k += 1
    return np.asarray(pos)


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

    tile_dir = os.path.join(base, "tiles")
    truth = make_tile_grid(tile_dir)

    out = os.path.join(base, "mosaic")
    client.jobs_lib.submit_job(
        cfg.jobs_dir,
        {
            "module": "stitch_mosaic",
            "params": {"grid": [2, 3], "overlap": 32, "refine": 3,
                       "flatfield": True, "match_gains": True},
            "input": [tile_dir],
            "output": out,
        },
    )
    assert ImageServer(cfg).poll_once()
    status = client.wait_for_job(out, timeout=120)
    assert status["state"] == "complete", status.get("error")

    metrics = json.loads(status["outputs"]["metrics"])
    print("stitch metrics:", metrics)

    got = np.loadtxt(
        status["outputs"]["positions"], delimiter=",", skiprows=1
    )[:, 3:]
    rel = truth - truth.min(axis=0, keepdims=True)
    worst = float(np.abs(got - rel).max())
    print(f"worst tile-position error vs truth: {worst:.4f} px")
    print(f"seam consistency (rms_residual_px): {metrics['rms_residual_px']}")
    print(
        f"shading profile range: [{metrics['flatfield_min']}, "
        f"{metrics['flatfield_max']}]; per-tile gains: "
        f"[{metrics['gain_min']}, {metrics['gain_max']}]"
    )
    assert worst < 0.05, "stage jitter should be recovered sub-pixel"
    assert metrics["gain_max"] / metrics["gain_min"] > 1.2  # the ramp
    print(f"mosaic written: {status['outputs']['mosaic']}")


if __name__ == "__main__":
    from sequitr_tpu_torch.examples import run

    run(main, "/tmp/sequitr_mosaic_demo")
