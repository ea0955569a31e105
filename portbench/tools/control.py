"""The control of ``correct``: the plain model at low precision, in the program's place.

    python3 portbench/tools/control.py --workload <cell> --seeds 1 2 3

For each seed, the cell's distinct input items and its weights are made as
a run makes them, and the configuration's kind (``kinds/<kind>.py``'s
``control_readings``) computes its plain model at the precision below the
configuration's (each kind module says which) in the program's place and
judges those answers as a run judges the program's. Prints one JSON line a
seed with the readings beside the cell's limits; every seed must fail one
of them. Runs on the card at the cell's own size.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def control_readings(root: str, workload: str, seed: int, device,
                     traffic: Optional[Dict] = None) -> Dict[str, float]:
    """The control's readings on one seed's items."""
    from portbench import inputs, spec

    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, workload)
    cfg = spec.config_of(bench, root, cell["config"])
    traffic = traffic or spec.traffic_of(root, cell["traffic"])
    kind = spec.kind_of(root, cfg["kind"])
    items = inputs.make_items(traffic["input"], seed)
    flat = kind.make_flat(cfg, seed, device, root)
    return kind.control_readings(cfg, traffic, items, flat, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import spec

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 3
    limits = spec.limits_of(ROOT, args.workload)
    for seed in args.seeds:
        r = control_readings(ROOT, args.workload, seed, torch.device("cuda"))
        fails = [k for k, v in r.items() if v > limits[k]]
        print(json.dumps({"workload": args.workload, "seed": seed, **r,
                          "limits": {k: limits[k] for k in r}, "fails": fails}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
