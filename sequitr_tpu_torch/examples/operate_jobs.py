"""Operating running jobs: live progress, in-flight cancel, ledger stats.

    python -m sequitr_tpu_torch.examples.operate_jobs /tmp/sequitr_ops [--device cpu]

1. registers a tiny U-Net and writes a many-frame timelapse;
2. serves it while POLLING LIVE PROGRESS (`progress.json`, updated every
   ~2 s by every streaming/training job);
3. CANCELS the job mid-stack (`client.cancel_job` — the CLI equivalent is
   `python -m sequitr_tpu_torch cancel <id>`): the worker stops at its next
   frame, the job lands in the terminal ``cancelled`` state, and the
   server immediately takes the next job — no recycle, warm card;
4. re-submits and lets it complete;
5. prints the server-wide jobs ledger summary (the `stats` CLI reads the
   same jobs.jsonl).
"""

import json
import os
import threading
import time

import numpy as np


def main(base: str, device: str = "cuda"):
    import torch

    from sequitr_tpu_torch import client
    from sequitr_tpu_torch.config import ServerConfiguration
    from sequitr_tpu_torch.data import tiff
    from sequitr_tpu_torch.models import unet
    from sequitr_tpu_torch.server import ImageServer, save_model, submit_job

    os.makedirs(base, exist_ok=True)
    cfg = ServerConfiguration(
        jobs_dir=os.path.join(base, "jobs"),
        models_dir=os.path.join(base, "models"),
        log_dir=os.path.join(base, "logs"),
        poll_interval=0.2,
        device=device,
    )
    cfg.ensure_dirs()

    mcfg = unet.UNetConfig(
        in_channels=1, num_classes=2, depth=2, base_features=4,
        compute_dtype="float32",
    )
    model = unet.init(mcfg, torch.Generator().manual_seed(0), device="cpu")
    save_model(cfg.models_dir, "demo2d", "unet", mcfg, model)

    stack_path = os.path.join(base, "stack.tif")
    rng = np.random.default_rng(0)
    tiff.write_stack(
        stack_path, rng.random((200, 128, 128), dtype=np.float32) * 500
    )

    # a worker: drains the queue until told to stop (one `serve` process
    # in production; a thread keeps this example single-interpreter)
    server = ImageServer(cfg)
    stop = threading.Event()

    def worker():
        while not stop.is_set():
            if not server.poll_once():
                time.sleep(cfg.poll_interval)

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    def spec(out):
        return {
            "module": "segmentation_unet2d",
            "params": {"model": "demo2d", "patch": [64, 64],
                       "overlap": [16, 16], "localize": False},
            "input": [stack_path],
            "output": out,
        }

    # --- 1) serve + live progress + mid-stack cancel -----------------
    out1 = os.path.join(base, "out_cancelled")
    jid = submit_job(cfg.jobs_dir, spec(out1))
    print(f"submitted {jid}; waiting for live progress...")
    deadline = time.time() + 300
    prog = None
    while time.time() < deadline:
        prog = client.read_progress(out1)
        if prog and prog.get("done", 0) >= 1:
            break
        time.sleep(0.01)
    assert prog, "no progress.json appeared"
    print(f"  live: {prog['done']}/{prog.get('total')} frames "
          f"({prog.get('frames_per_sec', 0.0)} fps)")
    got = client.cancel_job(cfg.jobs_dir, jid)
    print(f"  cancel_job -> {got!r}")
    status = None
    while time.time() < deadline:
        try:
            with open(os.path.join(out1, "status.json")) as f:
                status = json.load(f)
        except (OSError, ValueError):
            status = None
        if status and status.get("state") in ("cancelled", "complete", "failed"):
            break
        time.sleep(0.2)
    assert status and status["state"] == "cancelled", status
    print(f"  terminal state: {status['state']} ({status['error']})")

    # --- 2) the worker is warm: the next job completes ----------------
    out2 = os.path.join(base, "out_done")
    submit_job(cfg.jobs_dir, spec(out2))
    status = client.wait_for_job(out2, timeout=600, poll=0.2)
    print(f"re-submitted run complete: "
          f"{json.loads(status['outputs']['metrics'])['n_frames']} frames")

    stop.set()
    t.join()

    # --- 3) the ledger: what `python -m sequitr_tpu_torch stats` summarizes
    with open(os.path.join(cfg.log_dir, "jobs.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    print("ledger:")
    for r in rows:
        print(f"  {r['id']}  {r['module']}  {r['state']:10s} "
              f"{r['elapsed_s']:7.2f}s  attempts={r['attempts']}")
    states = sorted(r["state"] for r in rows)
    assert states == ["cancelled", "complete"], states
    print("ok")


if __name__ == "__main__":
    from sequitr_tpu_torch.examples import run

    run(main, "/tmp/sequitr_ops")
