"""Readings for the limits of ``correct``, in one process (set-up paid
once: imports, the kernels, cuDNN).

    python3 portbench/tools/calibrate.py --workload <cell> --seconds 8 --seeds 1 2 ...
        [--control-seeds 1 2 3]

For each seed, one run of the cell as ``run.py`` makes it (its result line,
with the compared numbers under ``check``); for each control seed, the
control's readings (``control.py``). Prints JSON lines.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench import harness
    from portbench.tools.control import control_readings

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 3
    for seed in args.seeds:
        out, err = io.StringIO(), io.StringIO()
        rc = harness.run_cell(ROOT, args.workload, seed, args.seconds, False, time.perf_counter(),
                              out=out, err=err)
        line = {"workload": args.workload, "seed": seed, "rc": rc}
        if rc == 0:
            result = json.loads(out.getvalue().splitlines()[-1])
            line.update(correct=result["correct"], attempted=result["attempted"],
                        failed=result["failed"], metrics=result["metrics"], check=result["check"])
        line["log"] = [s for s in err.getvalue().splitlines() if s.startswith("portbench")]
        print(json.dumps(line), flush=True)
    for seed in args.control_seeds:
        r = control_readings(ROOT, args.workload, seed, torch.device("cuda"))
        print(json.dumps({"workload": args.workload, "control_seed": seed, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
