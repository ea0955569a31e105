"""Examples smoke lane of the port, as ``tests/test_examples.py`` is the JAX
package's: every ``sequitr_tpu_torch/examples/<name>.py`` runs as ``python
-m sequitr_tpu_torch.examples.<name> <workspace> --device cpu`` in a
subprocess, training capped by ``SEQUITR_EXAMPLE_STEPS=20`` and torch at
one thread; and every ``examples/*.py`` of the JAX package has a twin of
the same name.
"""

import glob
import importlib
import os
import subprocess
import sys

import pytest

from sequitr_tpu_torch import examples as torch_examples

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_EXAMPLES = sorted(
    os.path.basename(p)[:-3] for p in glob.glob(os.path.join(REPO, "examples", "*.py"))
)
TWINS = sorted(
    os.path.basename(p)[:-3]
    for p in glob.glob(os.path.join(REPO, "sequitr_tpu_torch", "examples", "*.py"))
    if not os.path.basename(p).startswith("_")
)

# per-example wall bound; each runs in well under a minute on one CPU thread
TIMEOUT_S = 240


def test_every_jax_example_has_a_twin():
    assert len(JAX_EXAMPLES) >= 17
    assert TWINS == JAX_EXAMPLES
    assert sorted(torch_examples.NAMES) == JAX_EXAMPLES


def test_importing_an_example_does_nothing(tmp_path, monkeypatch):
    """No module-level work: importing every twin creates no file, and each
    declares what optional packages it needs as a tuple of names."""
    monkeypatch.chdir(tmp_path)
    for name in TWINS:
        mod = importlib.import_module(f"sequitr_tpu_torch.examples.{name}")
        assert callable(mod.main)
        assert all(isinstance(r, str) for r in getattr(mod, "REQUIRES", ()))
    assert os.listdir(tmp_path) == []


@pytest.mark.parametrize("name", TWINS)
def test_example_runs(name, tmp_path):
    env = dict(os.environ, SEQUITR_EXAMPLE_STEPS="20", OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", f"sequitr_tpu_torch.examples.{name}", str(tmp_path / "ws"),
         "--device", "cpu"],
        capture_output=True, text=True, timeout=TIMEOUT_S, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, (
        f"{name} failed (rc={proc.returncode})\n"
        f"--- stdout ---\n{proc.stdout[-3000:]}\n"
        f"--- stderr ---\n{proc.stderr[-3000:]}"
    )
