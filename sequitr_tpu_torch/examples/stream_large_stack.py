"""Constant-memory serving of a timelapse larger than a RAM budget.

    python -m sequitr_tpu_torch.examples.stream_large_stack /tmp/sequitr_stream [--device cpu]

1. writes a synthetic many-frame timelapse TIFF with the INCREMENTAL
   page-append writer (the stack never exists in memory);
2. registers a tiny U-Net and serves `segmentation_unet2d` over it —
   the pipeline streams disk -> host -> device -> disk with bounded
   buffers (lazy per-frame reads, H2D prefetch, page-append outputs);
3. measures the serve's peak host allocations with tracemalloc and
   prints them next to the full-stack size, demonstrating that peak
   memory does not scale with stack length.
"""

import json
import os
import tracemalloc

import numpy as np

REQUIRES = ("h5py",)  # the served jobs' objects.h5


def write_big_stack(path: str, t: int = 128, size: int = 96, seed: int = 0):
    """Append frames one at a time — O(frame) memory even for huge T."""
    from sequitr_tpu_torch.data import tiff

    rng = np.random.default_rng(seed)
    with tiff.TiffAppendWriter(path) as w:
        for _ in range(t):
            frame = rng.normal(80.0, 10.0, (size, size)).astype(np.float32)
            cy, cx = rng.integers(10, size - 10, 2)
            yy, xx = np.mgrid[:size, :size]
            frame[(yy - cy) ** 2 + (xx - cx) ** 2 < 25] += 400.0
            w.append(frame)
    return t * size * size * 4  # stack bytes


def main(base: str, device: str = "cuda"):
    import torch

    from sequitr_tpu_torch import client
    from sequitr_tpu_torch.config import ServerConfiguration
    from sequitr_tpu_torch.models import unet
    from sequitr_tpu_torch.server import ImageServer, save_model

    os.makedirs(base, exist_ok=True)
    cfg_srv = ServerConfiguration(
        jobs_dir=os.path.join(base, "jobs"),
        models_dir=os.path.join(base, "models"),
        device=device,
    )
    cfg_srv.ensure_dirs()
    server = ImageServer(cfg_srv)

    stack_path = os.path.join(base, "big_stack.tif")
    stack_bytes = write_big_stack(stack_path)
    print(f"stack on disk: {os.path.getsize(stack_path) / 1e6:.1f} MB")

    net_cfg = unet.UNetConfig(
        in_channels=1, num_classes=2, depth=2, base_features=8,
    )
    model = unet.init(net_cfg, torch.Generator().manual_seed(0), device="cpu")
    save_model(cfg_srv.models_dir, "stream_demo", "unet", net_cfg, model)

    def serve(name):
        out = os.path.join(base, name)
        spec = {
            "module": "segmentation_unet2d",
            "params": {"model": "stream_demo", "patch": [32, 32],
                       "overlap": [8, 8], "save_probs": True,
                       "probs_dtype": "float16"},
            "input": [stack_path],
            "output": out,
        }
        client.jobs_lib.submit_job(cfg_srv.jobs_dir, spec)
        assert server.poll_once(), "no job claimed"
        return client.wait_for_job(out, timeout=600)

    serve("warm")  # model load + caches outside the measurement
    tracemalloc.start()
    status = serve("measured")
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()

    metrics = json.loads(status["outputs"]["metrics"])
    print("serve metrics:", metrics)
    print(
        f"peak host allocations during serve: {peak / 1e6:.2f} MB "
        f"(full stack is {stack_bytes / 1e6:.2f} MB; labels+probs outputs "
        f"would add {stack_bytes / 4 * (1 + 2) / 1e6:.2f} MB if buffered)"
    )
    assert peak < stack_bytes, "streaming serve should not buffer the stack"


if __name__ == "__main__":
    from sequitr_tpu_torch.examples import run

    run(main, "/tmp/sequitr_stream")
