"""End-to-end example: lineage tracking, traces and a CTC export.

    python -m sequitr_tpu_torch.examples.track_lineage /tmp/sequitr_lineage_demo [--device cpu]

A steady mover and a cell that divides (mitotic class in its last frame):
localized into ``objects.h5``, then ``track_objects`` (Kalman, divisions
gated on the mitotic class), ``measure_objects``, ``measure_tracks`` and
``export_ctc`` filed up front by ``depends_on``; prints the lineage
(LBEP), the per-track reporter traces and the CTC export.
"""

import json
import os

import numpy as np

REQUIRES = ("h5py",)  # objects.h5


def make_scene(T=8, S=64):
    """A steady mover + a cell that divides at t=4 (mitotic at t=3).

    Returns (labels, reporter): labels carry class 1 everywhere except
    the dividing cell's final pre-division frame (class 2 = mitotic);
    the reporter channel is constant per cell so traces are readable.
    """
    labels = np.zeros((T, S, S), np.uint16)
    reporter = np.zeros((T, S, S), np.float32)

    def put(t, y, x, cls, level):
        labels[t, y:y + 6, x:x + 6] = cls
        reporter[t, y:y + 6, x:x + 6] = level

    for t in range(T):
        put(t, 4 + 3 * t, 4, 1, 10.0)  # the steady mover
    for t in range(4):  # the parent, mitotic in its final frame
        put(t, 28, 28 + 2 * t, 2 if t == 3 else 1, 20.0)
    for t in range(4, T):  # two children diverging in y
        d = 4 * (t - 3)
        put(t, 28 - d, 34 + 2 * (t - 3), 1, 30.0)
        put(t, 28 + d, 34 + 2 * (t - 3), 1, 40.0)
    return labels, reporter


def main(base: str, device: str = "cuda"):
    from sequitr_tpu_torch import localize
    from sequitr_tpu_torch.config import ServerConfiguration
    from sequitr_tpu_torch.data import tiff
    from sequitr_tpu_torch.server import ImageServer
    from sequitr_tpu_torch.server import jobs as jobs_lib

    os.makedirs(base, exist_ok=True)
    cfg = ServerConfiguration(
        jobs_dir=os.path.join(base, "jobs"),
        models_dir=os.path.join(base, "models"),
        device=device,
    )
    cfg.ensure_dirs()
    server = ImageServer(cfg)

    labels, reporter = make_scene()
    lab_path = os.path.join(base, "labels.tif")
    rep_path = os.path.join(base, "reporter.tif")
    tiff.write_stack(lab_path, labels)
    tiff.write_stack(rep_path, reporter)
    # the localization a segmentation serve performs (objects.h5 for the
    # tracker; n_classes covers the mitotic class)
    tables = [
        localize.localize_frame_table(labels[t], t=t, n_classes=3)
        for t in range(len(labels))
    ]
    h5 = os.path.join(base, "objects.h5")
    localize.export_btrack_h5_tables(h5, tables, n_frames=len(labels))

    trk_out = os.path.join(base, "tracks")
    meas_out = os.path.join(base, "measurements")
    traces_out = os.path.join(base, "traces")
    ctc_out = os.path.join(base, "ctc")
    # the whole analysis, filed up front (no client-side polling between
    # steps — depends_on queues each job until its inputs exist)
    steps = [
        ({"module": "track_objects",
          "params": {"max_distance": 12, "motion_model": "kalman",
                     "divisions": True, "mitotic_class": 2},
          "input": [h5], "output": trk_out}, []),
        ({"module": "measure_objects", "params": {},
          "input": [lab_path, rep_path], "output": meas_out}, []),
        ({"module": "measure_tracks", "params": {},
          "input": [meas_out, trk_out], "output": traces_out},
         [trk_out, meas_out]),
        ({"module": "export_ctc", "params": {},
          "input": [lab_path, trk_out], "output": ctc_out}, [trk_out]),
    ]
    for spec, deps in steps:
        if deps:
            spec = dict(spec, depends_on=deps)
        jobs_lib.submit_job(cfg.jobs_dir, spec)
    for _ in range(len(steps)):
        assert server.poll_once(), "no job ready"

    def status_of(out):
        with open(os.path.join(out, "status.json")) as f:
            st = json.load(f)
        assert st["state"] == "complete", st.get("error")
        return st

    st = status_of(trk_out)
    print("tracking:", json.loads(st["outputs"]["metrics"]))
    print("\nlineage (lbep: label begin end parent):")
    with open(os.path.join(trk_out, "lbep.txt")) as f:
        print(f.read().strip())

    st = status_of(traces_out)
    with open(st["outputs"]["traces"]) as f:
        rows = f.read().strip().split("\n")
    header = rows[0].split(",")
    i_mean = header.index("mean_c0")
    traces = {}
    for r in rows[1:]:
        cols = r.split(",")
        traces.setdefault(cols[0], []).append(float(cols[i_mean]))
    print("\nper-track reporter traces (constant per cell by design):")
    for tid, vals in sorted(traces.items(), key=lambda kv: int(kv[0])):
        print(f"  track {tid}: {vals}")

    status_of(ctc_out)
    masks = sorted(f for f in os.listdir(ctc_out) if f.startswith("mask"))
    print(f"\nCTC export: {len(masks)} masks + res_track.txt ->")
    with open(os.path.join(ctc_out, "res_track.txt")) as f:
        print(" ", f.read().strip().replace("\n", " | "))


if __name__ == "__main__":
    from sequitr_tpu_torch.examples import run

    run(main, "/tmp/sequitr_lineage_demo")
