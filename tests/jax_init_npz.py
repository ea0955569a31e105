"""Write the JAX package's initial weights of the ``gan_denoise`` and
``n2v_cells`` fixture recipes as flat float32 npz files, on the CPU.

They are the draws the JAX ``tools/make_fixtures.py`` trains from:
``fit_gan`` and ``fit_n2v`` at ``FitConfig.seed`` 0 call
``create_gan_state`` / ``create_unet_state`` with ``PRNGKey(0)``, on the
recipe's zoo config at bfloat16. Keys are the interchange layout's
(``convert.flatten_params``: the params, the batch-norm statistics under
``state/``), which ``sequitr_tpu_torch.studies.fixture_init`` trains the
port's recipes from::

    JAX_PLATFORMS=cpu python tests/jax_init_npz.py --out DIR [--key K]

``--key`` draws from ``PRNGKey(K)`` instead, to sample the spread of the
reference's draws (not a test module: pytest collects ``test_*.py`` only).
"""

import argparse
import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sequitr_tpu.models import convert, zoo  # noqa: E402
from sequitr_tpu.pipeline import train  # noqa: E402

PRESETS = {"gan_denoise": "gan_enhance", "n2v_cells": "n2v_denoise"}


def flat_init(name: str, key: int = 0) -> dict:
    """The JAX recipe's initial weights of fixture ``name`` (from
    ``PRNGKey(key)``), flat f32."""
    cfg = dataclasses.replace(zoo.get(PRESETS[name]), compute_dtype=jnp.bfloat16)
    tc = train.TrainConfig()  # the optimizer's moments start at zero whatever it is
    rng = jax.random.PRNGKey(key)
    if name == "gan_denoise":
        state = train.create_gan_state(rng, cfg, tc)
    else:
        state = train.create_unet_state(rng, cfg, tc)
    flat = {k: np.asarray(v, np.float32) for k, v in convert.flatten_params(state.params).items()}
    flat.update(
        {f"state/{k}": np.asarray(v, np.float32) for k, v in convert.flatten_params(state.model_state).items()}
    )
    return flat


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--only", default=",".join(PRESETS))
    ap.add_argument("--key", type=int, default=0, help="the PRNGKey of the draw (the recipes' is 0)")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    for name in args.only.split(","):
        np.savez(os.path.join(args.out, f"{name}.npz"), **flat_init(name, args.key))
        print(f"{name}: {os.path.join(args.out, name + '.npz')}", flush=True)


if __name__ == "__main__":
    main()
