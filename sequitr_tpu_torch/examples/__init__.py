"""Runnable end-to-end walkthroughs of the port, one for each of the JAX
package's ``examples/*.py``, under the same name and with the same steps,
jobs, params and printed checks, through the port's server, ``client`` and
CLI::

    python -m sequitr_tpu_torch.examples.<name> <workspace> [--device cpu]

Every example runs on the CUDA card unless ``--device cpu`` is given.
``SEQUITR_EXAMPLE_STEPS=N`` caps every training run at N steps (the CPU
smoke lane, ``tests/test_torch_examples.py``); quality bars that need a
converged model are skipped under the cap, as the JAX examples skip them.
An example whose module sets ``REQUIRES`` needs those optional packages
(``h5py`` for ``objects.h5``). Importing an example does nothing.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Optional, Sequence

STEPS_ENV = "SEQUITR_EXAMPLE_STEPS"

NAMES = (
    "correct_illumination", "denoise_n2v", "distill_fast_model", "enhance_denoise",
    "localize_3d", "migrate_checkpoint", "operate_jobs", "qc_review", "quantify_workflow",
    "register_and_chain", "segment_instances_flows", "segment_instances_stars",
    "segment_timelapse", "segment_volume_3d", "stitch_mosaic", "stream_large_stack",
    "track_lineage",
)


def step_cap() -> int:
    """The ``SEQUITR_EXAMPLE_STEPS`` cap (0: none)."""
    return int(os.environ.get(STEPS_ENV, "0") or 0)


def steps(n: int) -> int:
    """``n`` training steps, or the smoke lane's cap if it is smaller."""
    cap = step_cap()
    return min(n, cap) if cap else n


def run(main: Callable[..., None], default_workspace: str, argv: Optional[Sequence[str]] = None) -> None:
    """Parse ``<workspace> [--device D]`` and call ``main(workspace, device=D)``."""
    ap = argparse.ArgumentParser(description=(main.__module__ or "").rsplit(".", 1)[-1])
    ap.add_argument("workspace", nargs="?", default=default_workspace)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    main(args.workspace, device=args.device)
