"""The benchmark of ``sequitr_tpu_torch`` on an NVIDIA card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Prints the checks on standard error and
one JSON result as the last line of standard output; exits non-zero and
prints no result without a CUDA card (never falls back to the CPU), with
fewer cards than the cell asks for, or when the window's process loaded
JAX or the JAX package.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the port builds its CUDA kernels with nvcc into sequitr_tpu_torch/_build,
# inside the checkout, so only a checkout's first run builds them
os.environ["USE_FLAX"] = "0"
# one process with few threads: torch's CPU pool (8 threads on an 8-core
# host by default) competes with the job thread's deflate for the cores
os.environ["OMP_NUM_THREADS"] = "2"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from portbench import spec

    bench = spec.load_benchmark(ROOT)
    cell = spec.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA card: the benchmark measures only on one", file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} cards, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    from portbench import harness

    return harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                            PROCESS_START)


if __name__ == "__main__":
    sys.exit(main())
