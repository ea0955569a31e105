"""Tools run as modules: ``python -m sequitr_tpu_torch.tools.make_fixtures``
trains the fixture checkpoints (the JAX package's ``tools/make_fixtures.py``,
ported)."""
