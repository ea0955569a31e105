"""The port's fixture factory trained end to end on the CPU
(``python -m sequitr_tpu_torch.tools.make_fixtures --quick --device cpu``):

- ``n2v_cells``, the cheapest recipe, into ``tmp_path``, its zoo config
  narrowed (``zoo.get`` monkeypatched) on the recipe's own frames;
- the other seven in one ``main`` call with their zoo configs narrowed and
  their 2D scenes rendered at 64x64 (``synthetic.cells_frame`` and
  ``instances_frame`` monkeypatched; the recipes' frames and data are held
  to the JAX tool's in ``tests/test_torch_make_fixtures.py``), the
  students distilled from the run's own teacher;
- the GAN recipe's trainer against the JAX ``fit_gan`` over 200 steps from
  one carried init (narrowed, 32x32): their holdout PSNR curves agree.

Each manifest entry has the committed entry's keys, kind, task and recipe
keys, the quick step count and the (narrowed) config at f32 (the recipes
themselves are held against the JAX tool's in
``tests/test_torch_make_fixtures.py``); each saved fixture loads back and
runs. The committed fixtures' directory is never written.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from sequitr_tpu_torch.models import fixtures, gan
from sequitr_tpu_torch.tools import make_fixtures as tool


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _committed_untouched():
    before = {n: os.path.getmtime(os.path.join(fixtures.fixture_dir(), n))
              for n in os.listdir(fixtures.fixture_dir())}
    yield
    after = {n: os.path.getmtime(os.path.join(fixtures.fixture_dir(), n))
             for n in os.listdir(fixtures.fixture_dir())}
    assert after == before


NARROW_UNET = dict(depth=2, base_features=4, features_cap=8)
NARROW_GAN = dict(gen_depth=2, gen_base_features=4, disc_base_features=4)
SMALL_FRAME = (64, 64)


def _narrow(monkeypatch):
    real_get = tool.zoo.get

    def narrowed(name):
        cfg = real_get(name)
        return dataclasses.replace(cfg, **(NARROW_GAN if isinstance(cfg, gan.GANConfig) else NARROW_UNET))

    monkeypatch.setattr(tool.zoo, "get", narrowed)


def test_n2v_quick_runs_end_to_end_on_the_cpu(tmp_path, monkeypatch):
    _narrow(monkeypatch)
    out = str(tmp_path / "out")
    rows = tool.main(["--out", out, "--quick", "--device", "cpu", "--only", "n2v_cells"])
    assert [r["fixture"] for r in rows] == ["n2v_cells"]
    entry = fixtures.manifest(out)["n2v_cells"]
    committed = fixtures.manifest()["n2v_cells"]
    assert set(entry) == set(committed)
    assert entry["recipe"] == dict(committed["recipe"], steps=30, examples=64)
    assert entry["config"] == dict(committed["config"], compute_dtype="float32", **NARROW_UNET)
    assert np.isfinite(entry["holdout_psnr"])
    # the noisy input's PSNR does not depend on the weights
    assert entry["noisy_input_psnr"] == committed["noisy_input_psnr"]
    assert rows[0]["metrics"]["holdout_psnr"] == entry["holdout_psnr"] and rows[0]["steps"] == 30
    assert rows[0]["step_ms"] > 0 and rows[0]["wall_s"] > 0
    kind, cfg, model, _ = fixtures.load("n2v_cells", device="cpu", directory=out)
    assert kind == "n2v" and cfg.compute_dtype == "float32"
    assert sorted(os.listdir(out)) == ["manifest.json", "n2v_cells.npz"]


def test_other_makers_run_narrowed(tmp_path, monkeypatch):
    _narrow(monkeypatch)
    for fn in ("cells_frame", "instances_frame"):
        real = getattr(tool.synthetic, fn)
        monkeypatch.setattr(tool.synthetic, fn, lambda seed, shape, real=real: real(seed, SMALL_FRAME))
    out = str(tmp_path / "out")
    targets = [t for t in tool.TARGETS if t != "n2v_cells"]
    rows = tool.main(["--out", out, "--quick", "--device", "cpu", "--only", ",".join(targets)])
    names = [tool._FIXTURE.get(t, t) for t in targets]
    assert [r["fixture"] for r in rows] == names
    committed = fixtures.manifest()
    for row in rows:
        name = row["fixture"]
        entry = fixtures.manifest(out)[name]
        assert set(entry) == set(committed[name])
        assert set(entry["recipe"]) == set(committed[name]["recipe"])
        assert entry["recipe"]["steps"] == row["steps"] == (20 if name in ("unet3d_cells", "gan_denoise") else 30)
        assert entry["kind"] == committed[name]["kind"] and entry["task"] == committed[name]["task"]
        want_cfg = dict(committed[name]["config"], compute_dtype="float32")
        want_cfg.update(NARROW_GAN if entry["kind"] == "gan" else NARROW_UNET)
        assert entry["config"] == want_cfg
        assert all(np.isfinite(v) for v in row["metrics"].values()), row
        _, cfg, model, _ = fixtures.load(name, device="cpu", directory=out)
        x = torch.rand((1,) + ((8, 16, 16) if cfg.dims == 3 else (32, 32)) + (1,)) if not isinstance(
            cfg, gan.GANConfig) else torch.rand(1, 32, 32, 1)
        with torch.inference_mode():
            y = gan.generator_apply(model, x) if isinstance(cfg, gan.GANConfig) else model(x)
        assert torch.isfinite(y).all()


GAN_NARROW = dict(gen_depth=3, gen_base_features=8, disc_layers=2, disc_base_features=8)
GAN_TRACK_DB = 0.1  # holdout PSNR, port against JAX at each evaluation (measured gap <= 0.02 dB)


def test_gan_recipe_tracks_the_jax_trainer_over_200_steps(tmp_path):
    """The GAN recipe's trainer (``make_gan``'s TrainConfig: 2e-4, b1 0.5,
    no augmentation; holdout every 10th pair) at a narrowed width on 160
    pairs of 32x32 (the recipe's seeds), from one carried init, 200 steps:
    the holdout PSNR at each of 8 evaluations stays within 0.1 dB of the
    JAX ``fit_gan``'s. The GAN step draws nothing, so both runs take the
    same batches and a divergence would be the port's."""
    import json

    import jax
    import jax.numpy as jnp

    from sequitr_tpu.models import convert as jax_convert
    from sequitr_tpu.models import gan as jax_gan
    from sequitr_tpu.pipeline import fit as jax_fit
    from sequitr_tpu.pipeline import train as jax_train
    from sequitr_tpu_torch.models import convert
    from sequitr_tpu_torch.pipeline import fit, train

    shards = tool._pair_shards(str(tmp_path), 160, (32, 32))
    fkw = dict(steps=200, batch_size=8, holdout_every=10, eval_every=25, eval_limit=8,
               checkpoint_every=10**9, log_every=10)
    jcfg = jax_gan.GANConfig(compute_dtype=jnp.float32, **GAN_NARROW)
    jtc = jax_train.TrainConfig(learning_rate=2e-4, beta1=0.5, augment=False)
    jstate = jax_train.create_gan_state(jax.random.PRNGKey(0), jcfg, jtc)
    flat = dict(jax_convert.flatten_params(jstate.params))
    flat.update({f"state/{k}": v for k, v in jax_convert.flatten_params(jstate.model_state).items()})
    cfg = gan.GANConfig(compute_dtype="float32", **GAN_NARROW)
    tc = train.TrainConfig(learning_rate=2e-4, beta1=0.5, augment=False)
    model = convert.load_flat(cfg, {k: np.asarray(v) for k, v in flat.items()}, device="cpu")
    jpath, tpath = str(tmp_path / "jax.jsonl"), str(tmp_path / "port.jsonl")
    jax_fit.fit_gan(jcfg, jtc, jax_fit.FitConfig(metrics_path=jpath, **fkw), shards, init_state=jstate)
    fit.fit_gan(cfg, tc, fit.FitConfig(metrics_path=tpath, **fkw), shards,
                init_state=train.create_gan_state(cfg, tc, model=model), device="cpu")

    def evals(path):
        with open(path) as f:
            return [(r["step"], r["eval_psnr"]) for r in map(json.loads, f) if r["kind"] == "eval"]

    got, want = evals(tpath), evals(jpath)
    assert [s for s, _ in got] == [s for s, _ in want] == list(range(25, 201, 25))
    assert want[-1][1] > want[0][1] + 3  # it trains
    for (step, g), (_, w) in zip(got, want):
        assert abs(g - w) <= GAN_TRACK_DB, (step, g, w)
