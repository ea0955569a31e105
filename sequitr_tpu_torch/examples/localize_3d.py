"""End-to-end example: 3D single-molecule localization, two routes.

    python -m sequitr_tpu_torch.examples.localize_3d /tmp/sequitr_loc3d_demo [--device cpu]

1. astigmatic: a bead z-scan calibrates the cylindrical-lens defocus model
   (``calibrate_astigmatism``) and a chained ``localize_emitters`` job
   (``depends_on`` the calibration's output dir) reads z from each
   emitter's fitted widths, with a btrack export in xy-pixel units;
2. volumetric: one z-stack file per timepoint, localized in 3D
   (``dims: 3``).
"""

import json
import os

import numpy as np

REQUIRES = ("h5py",)  # the btrack export (objects.h5)


def widths(z):
    """The cylindrical-lens defocus model: foci split +/-300 units."""
    sx = 1.3 * np.sqrt(1.0 + ((z - 300.0) / 400.0) ** 2)
    sy = 1.3 * np.sqrt(1.0 + ((z + 300.0) / 400.0) ** 2)
    return sy, sx


def astig_frame(truth, shape=(96, 96), seed=0):
    """2D frame of emitters whose widths encode their (known) z."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    frame = np.full(shape, 20.0)
    for cz, cy, cx in truth:
        sy, sx = widths(cz)
        frame += 3000.0 / (2 * np.pi * sx * sy) * np.exp(
            -((yy - cy) ** 2) / (2 * sy**2) - ((xx - cx) ** 2) / (2 * sx**2)
        )
    return (frame + rng.normal(0, 0.2, shape)).astype(np.float32)


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

    # ---- route 1: astigmatic, calibrate -> localize chained up front
    zs = np.linspace(-600, 600, 17)
    scan = np.stack(
        [astig_frame([(z, 15.7, 16.2)], (32, 32), seed=9) for z in zs]
    )
    scan_path = os.path.join(base, "bead_scan.tif")
    tiff.write_stack(scan_path, scan)

    truth = [(250.0, 20.5, 40.2), (-380.0, 45.1, 18.7)]
    frames_path = os.path.join(base, "astig_frames.tif")
    tiff.write_stack(
        frames_path, np.stack([astig_frame(truth, seed=s) for s in range(3)])
    )

    cal_out = os.path.join(base, "calibration")
    loc_out = os.path.join(base, "localized_astig")
    client.jobs_lib.submit_job(
        cfg.jobs_dir,
        {
            "module": "calibrate_astigmatism",
            # uniform scan: stage positions z_start + i*z_step (your units
            # — typically nm; every z the calibration produces inherits them)
            "params": {"z_start": -600.0, "z_step": 75.0},
            "input": [scan_path],
            "output": cal_out,
        },
    )
    client.jobs_lib.submit_job(
        cfg.jobs_dir,
        {
            "module": "localize_emitters",
            # astigmatism points at the CALIBRATION JOB'S OUTPUT DIR;
            # z_scale maps calibration units -> xy-pixel units in the
            # btrack export (e.g. 1/pixel_size_nm) so tracking gates on
            # consistent units
            "params": {
                "astigmatism": cal_out,
                "threshold": 40,
                "btrack": True,
                "z_scale": 0.01,
            },
            "input": [frames_path],
            "output": loc_out,
            "depends_on": cal_out,
        },
    )
    assert server.poll_once(), "calibration should claim first"
    assert server.poll_once(), "localization should claim once unblocked"
    status = client.wait_for_job(loc_out, timeout=120)
    assert status["state"] == "complete", status.get("error")

    with open(os.path.join(cal_out, "status.json")) as f:
        cal_metrics = json.loads(json.load(f)["outputs"]["metrics"])
    print("calibration self-check:", cal_metrics)

    with open(os.path.join(loc_out, "emitters.csv")) as f:
        rows = f.read().strip()
    header, *data = rows.split("\n")
    print(f"astigmatic: {header}")
    for r in data[:4]:
        t, z, y, x, *_ = r.split(",")
        print(f"  t={t} z={float(z):+8.1f}  y={float(y):6.2f} x={float(x):6.2f}")
    print(f"  (truth z: {[t[0] for t in truth]})")

    # ---- route 2: volumetric (one z-stack file per timepoint)
    vols_dir = os.path.join(base, "volumes")
    os.makedirs(vols_dir, exist_ok=True)
    zz, yy, xx = np.mgrid[:13, :40, :40]
    for t, tr in enumerate([[(4.3, 12.6, 25.1)], [(5.1, 13.0, 25.5)]]):
        vol = np.full((13, 40, 40), 20.0)
        for cz, cy, cx in tr:
            vol += 300.0 * np.exp(
                -((zz - cz) ** 2) / (2 * 1.4**2)
                - ((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 1.4**2)
            )
        tiff.write_stack(
            os.path.join(vols_dir, f"vol_t{t}.tif"), vol.astype(np.float32)
        )

    vol_out = os.path.join(base, "localized_3d")
    client.jobs_lib.submit_job(
        cfg.jobs_dir,
        {
            "module": "localize_emitters",
            "params": {
                "dims": 3,
                "threshold": 100,
                "sigma": 1.4,
                "sigma_z": 1.4,
                "btrack": True,
            },
            "input": [vols_dir],
            "output": vol_out,
        },
    )
    assert server.poll_once()
    status = client.wait_for_job(vol_out, timeout=120)
    assert status["state"] == "complete", status.get("error")
    print("volumetric:")
    with open(os.path.join(vol_out, "emitters.csv")) as f:
        print("  " + f.read().strip().replace("\n", "\n  "))


if __name__ == "__main__":
    from sequitr_tpu_torch.examples import run

    run(main, "/tmp/sequitr_loc3d_demo")
