"""End-to-end example: segment -> measure -> track as one filed workflow.

    python -m sequitr_tpu_torch.examples.quantify_workflow /tmp/sequitr_quantify_demo [--device cpu]

1. a drifting bright cell on a nuclear channel, with a marker channel of
   known per-cell intensity (what we quantify);
2. trains a tiny demo segmenter (``build_records`` -> ``train_unet2d``);
3. files ``segmentation_unet2d`` -> ``measure_objects`` (the marker
   channel per object) -> ``track_objects`` up front, each step
   ``depends_on`` the previous one's output, and prints the per-object
   marker means and the linked detections.
"""

import json
import os

import numpy as np

REQUIRES = ("h5py",)  # objects.h5 between the segmentation and the tracker


def make_data(base: str, t: int = 6, size: int = 64, seed: int = 3):
    """A drifting bright cell on the nuclear channel; the marker channel
    carries a DIFFERENT, known per-cell intensity (what we quantify).
    Writes the ground-truth masks too (used only to train the tiny demo
    segmenter — real pipelines bring a trained model)."""
    from sequitr_tpu_torch.data import tiff

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    nuc = np.zeros((t, size, size), np.float32)
    marker = np.zeros((t, size, size), np.float32)
    truth = np.zeros((t, size, size), np.uint16)
    for f in range(t):
        cy, cx = 20 + 2.0 * f, 24 + 1.5 * f  # slow directed motion
        blob = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 18.0)
        nuc[f] = 900.0 * blob + 60.0
        truth[f] = blob > 0.35
        marker[f] = 140.0 * truth[f] + 10.0  # flat marker level in-cell
    nuc += rng.normal(0, 4.0, nuc.shape).astype(np.float32)
    marker += rng.normal(0, 1.0, marker.shape).astype(np.float32)
    tiff.write_stack(os.path.join(base, "nuclei.tif"), nuc)
    tiff.write_stack(os.path.join(base, "marker.tif"), marker)
    tiff.write_stack(os.path.join(base, "truth.tif"), truth)


def main(base: str, device: str = "cuda"):
    from sequitr_tpu_torch import client
    from sequitr_tpu_torch.config import ServerConfiguration
    from sequitr_tpu_torch.examples import steps
    from sequitr_tpu_torch.server import ImageServer
    from sequitr_tpu_torch.server import jobs as jobs_lib

    os.makedirs(base, exist_ok=True)
    cfg_srv = ServerConfiguration(
        jobs_dir=os.path.join(base, "jobs"), models_dir=os.path.join(base, "models"),
        device=device,
    )
    cfg_srv.ensure_dirs()
    make_data(base)
    server = ImageServer(cfg_srv)

    def run(spec):
        client.jobs_lib.submit_job(cfg_srv.jobs_dir, spec)
        assert server.poll_once(), "no job claimed"
        return client.wait_for_job(spec["output"], timeout=300)

    # train a tiny demo segmenter on the synthetic truth (real pipelines
    # bring a trained model — see segment_timelapse)
    status = run(
        {"module": "build_records", "params": {"num_classes": 2},
         "input": [os.path.join(base, "nuclei.tif"),
                   os.path.join(base, "truth.tif")],
         "output": os.path.join(base, "records")}
    )
    status = run(
        {"module": "train_unet2d",
         "params": {"model": "seg_demo", "num_classes": 2, "depth": 2,
                    "base_features": 8, "norm": "none",
                    "compute_dtype": "float32", "steps": steps(80),
                    "batch_size": 4, "learning_rate": 3e-3,
                    "augment": False},
         "input": [status["outputs"]["shards"]],
         "output": os.path.join(base, "train")}
    )

    seg_out = os.path.join(base, "seg")
    meas_out = os.path.join(base, "meas")
    trk_out = os.path.join(base, "trk")
    workflow = [
        {"module": "segmentation_unet2d",
         "params": {"model": "seg_demo"},
         "input": [os.path.join(base, "nuclei.tif")], "output": seg_out},
        # measure the MARKER channel per segmented object; with a SECOND
        # marker channel, "colocalize": true would add per-object Pearson
        # + Manders M1/M2 columns; "dims": 3 measures z-stack timelapses
        {"module": "measure_objects", "params": {},
         "input": [os.path.join(seg_out, "labels.tif"),
                   os.path.join(base, "marker.tif")],
         "output": meas_out},
        {"module": "track_objects", "params": {"max_distance": 10},
         "input": [os.path.join(seg_out, "objects.h5")], "output": trk_out},
    ]
    wf_path = os.path.join(base, "workflow.json")
    with open(wf_path, "w") as f:
        json.dump(workflow, f, indent=2)

    # file the whole chain up front (the CLI form is
    # `python -m sequitr_tpu_torch submit --jobs-dir ... workflow.json`)
    prev = None
    for step in workflow:
        spec = dict(step)
        if prev is not None:
            spec["depends_on"] = [prev]
        jobs_lib.submit_job(cfg_srv.jobs_dir, spec)
        prev = spec["output"]

    for _ in range(3):
        assert server.poll_once(), "no job ready"
    status = client.wait_for_job(trk_out, timeout=300)
    assert status["state"] == "complete", status.get("error")

    with open(os.path.join(meas_out, "measurements.csv")) as f:
        rows = f.read().strip().split("\n")
    print(rows[0])
    for r in rows[1:4]:
        print(r)
    marker_means = [float(r.split(",")[6]) for r in rows[1:]]
    print(
        f"{len(rows) - 1} objects; marker mean across track: "
        f"{np.mean(marker_means):.1f} (in-cell level was ~150)"
    )
    with open(os.path.join(trk_out, "tracks.csv")) as f:
        tracks = f.read().strip().split("\n")
    print(f"{len(tracks) - 1} linked detections ->", status["outputs"].get("metrics"))


if __name__ == "__main__":
    from sequitr_tpu_torch.examples import run

    run(main, "/tmp/sequitr_quantify_demo")
