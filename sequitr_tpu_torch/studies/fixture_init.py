"""The GAN and N2V fixture recipes trained from given initial weights.

The fixture factory (``tools/make_fixtures.py``) draws each model's
initial weights from the port's own seeded generators. This study runs its
``gan_denoise`` and ``n2v_cells`` recipes unchanged (data, steps, schedule,
scorer) but starts them from weights read from a flat npz, one file a
fixture (``<DIR>/gan_denoise.npz``, ``<DIR>/n2v_cells.npz``) under the
interchange keys (``convert.to_flat``: the params, the batch-norm
statistics under ``state/``). Given the reference package's own draw
(``tests/jax_init_npz.py`` writes it on the CPU), a recipe that reaches
its committed holdout metric from that draw but not from the port's seeds
points at the draw; one that misses from both points at the trainer::

    JAX_PLATFORMS=cpu python tests/jax_init_npz.py --out INIT
    python -m sequitr_tpu_torch.studies.fixture_init --init INIT --out DIR [--only gan_denoise]

Each fixture is written into ``--out`` (never the committed directory) and
reported as the factory reports it: one JSON line, its holdout metric
beside the committed manifest's.
"""

from __future__ import annotations

import argparse
import logging
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence
from unittest import mock

import numpy as np

from sequitr_tpu_torch.models import convert
from sequitr_tpu_torch.pipeline import fit as fit_lib
from sequitr_tpu_torch.pipeline import train as train_lib
from sequitr_tpu_torch.tools import make_fixtures as factory
from sequitr_tpu_torch.utils import resolve_device

__all__ = ["RECIPES", "run", "main"]

# fixture -> (the fit function its maker calls, the maker, the state it starts from)
RECIPES = {
    "gan_denoise": ("fit_gan", factory.make_gan, train_lib.create_gan_state),
    "n2v_cells": ("fit_n2v", factory.make_n2v, train_lib.create_unet_state),
}


def run(init: str, out: str, targets: Sequence[str] = tuple(RECIPES), device=None) -> List[Dict]:
    """Train each of ``targets`` from ``<init>/<name>.npz`` into ``out``;
    returns the factory's report rows."""
    device = resolve_device(device)
    rows = []
    work = tempfile.mkdtemp(prefix="fixture-init-work-")
    try:
        for name in targets:
            fit_name, maker, create = RECIPES[name]
            with np.load(os.path.join(init, f"{name}.npz")) as z:
                flat = {k: z[k] for k in z.files}
            fit = getattr(fit_lib, fit_name)

            def fit_from_init(cfg, tc, fc, shards, fit=fit, create=create, flat=flat, **kw):
                model = convert.load_flat(cfg, flat, device=kw["device"])
                return fit(cfg, tc, fc, shards, init_state=create(cfg, tc, model=model), **kw)

            clock, t0 = factory.StepClock(device), time.perf_counter()
            with mock.patch.object(fit_lib, fit_name, fit_from_init):
                maker(factory.Run(work, os.path.abspath(out), device), clock)
            rows.append(factory._report(name, out, clock, t0))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return rows


def main(argv: Optional[Sequence[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--init", required=True, help="directory of <fixture>.npz initial weights")
    ap.add_argument("--out", required=True, help="directory the fixtures are written to")
    ap.add_argument("--only", default=None, help=f"comma list of: {' | '.join(RECIPES)}")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    targets = args.only.split(",") if args.only else list(RECIPES)
    if set(targets) - set(RECIPES):
        ap.error(f"unknown --only targets {sorted(set(targets) - set(RECIPES))}; choose from {tuple(RECIPES)}")
    return run(args.init, args.out, targets, args.device)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    main(sys.argv[1:])
