"""The row gather of the flow integrator, in each form PyTorch offers.

Every Euler step of ``ops.flows.follow_flows`` reads one packed row of
``2^nd * nd`` f32 (the multilinear corner neighbourhood) for every pixel.
The rows are narrow (32 bytes in 2D, 96 in 3D) and there are as many as
pixels, which PyTorch's ``index_select`` serves with a kernel built for
wide rows. This study times the forms that compute the same copy:

    python -m sequitr_tpu_torch.studies.flow_gather [--iters 50]

at the 2D frame (1024x1024 rows of 8) and the 3D volume (32x256x256 rows
of 24), each checked equal to ``index_select``, with the bytes each must
move (the rows read once, the index read once, the output written once) over
the card's memory rate beside it, then one JSON line.
"""

from __future__ import annotations

import argparse
import json

import torch

from sequitr_tpu_torch.utils import device_median_ms, resolve_device

__all__ = ["FORMS", "run", "main"]

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet

FORMS = {
    "index_select": lambda packed, idx: packed.index_select(0, idx),
    "advanced_index": lambda packed, idx: packed[idx],
    "gather": lambda packed, idx: torch.gather(packed, 0, idx[:, None].expand(-1, packed.shape[1])),
    "take_flat": lambda packed, idx: torch.take(
        packed, idx[:, None] * packed.shape[1] + torch.arange(packed.shape[1], device=idx.device)
    ),
}

SHAPES = {"2d 1024x1024 x 8": (1024 * 1024, 8), "3d 32x256x256 x 24": (32 * 256 * 256, 24)}


def run(iters: int = 50, device=None) -> dict:
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(0)
    out = {}
    for label, (rows, width) in SHAPES.items():
        packed = torch.rand((rows, width), generator=gen, device=device)
        # positions near their own pixel, as a converging flow's are
        idx = (torch.arange(rows, device=device) + torch.randint(-64, 65, (rows,), generator=gen, device=device))
        idx = idx.clamp(0, rows - 1)
        want = packed.index_select(0, idx)
        bound_ms = (2 * rows * width * 4 + rows * 8) / H100_BYTES_PER_S * 1e3
        times = {}
        for name, form in FORMS.items():
            if not torch.equal(form(packed, idx), want):
                raise AssertionError(f"{name} differs from index_select at {label}")
            times[name] = device_median_ms(lambda: form(packed, idx), iters)
            print(f"flow_gather {label}: {name} {times[name]:.5f} ms (bound {bound_ms:.5f} ms, bytes)")
        out[label] = dict(times, bound_ms=bound_ms)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=50)
    args = parser.parse_args(argv)
    print(json.dumps({"flow_gather": run(args.iters), "device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
