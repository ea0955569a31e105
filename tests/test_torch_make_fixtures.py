"""The port's fixture factory (``python -m sequitr_tpu_torch.tools.
make_fixtures``) against the JAX package's ``tools/make_fixtures.py``,
imported by path.

- Recipes, data and scorers, one case a target: each tool's maker runs at
  ``--quick`` sizes with its fit function monkeypatched to record what it
  was given and to return the committed fixture's weights at f32 (the JAX
  tool's ``fixtures.save`` monkeypatched to record its entry, the port's
  writing into ``tmp_path``; ``round`` monkeypatched to the identity in
  both tools' modules, so the scores compare unrounded). The two tools
  build byte-equal record shards (the flows and stars targets too: the
  port's ``flow_targets`` and ``star_targets`` are numpy copies of the JAX
  package's and give the same bytes), give their fit functions the same
  config, ``TrainConfig``, ``FitConfig`` and N2V / distillation arguments,
  and write manifest entries with the same keys, task, recipe and config;
  the holdout scores agree within 1e-4 (mIoU, AP, matched IoU) and 1e-3 dB
  (PSNR).
  The students' cases start from the record shards each tool built once
  for the module, as a run's students take the teacher's.
- The students' teacher: the run's, else ``--out``'s, else the committed
  one (``make_student`` monkeypatched to record it). The committed
  fixtures' directory is never written.
- ``studies/fixture_init.py`` starts the GAN and N2V recipes from the
  weights ``tests/jax_init_npz.py`` writes from the JAX draw (both zoos'
  ``get`` monkeypatched to narrow configs, the fit functions to record the
  state they start from).

The trained runs are in ``tests/test_torch_make_fixtures_runs.py``.
"""

import dataclasses
import importlib.util
import os
import shutil
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequitr_tpu.models import fixtures as jax_fixtures
from sequitr_tpu_torch.data import records
from sequitr_tpu_torch.models import fixtures, unet
from sequitr_tpu_torch.tools import make_fixtures as tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUICK_MIOU_AP_TOL = 1e-4
PSNR_TOL_DB = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jtool():
    spec = importlib.util.spec_from_file_location(
        "_jax_make_fixtures", os.path.join(REPO, "tools", "make_fixtures.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True)
def _committed_untouched():
    before = {n: os.path.getmtime(os.path.join(fixtures.fixture_dir(), n))
              for n in os.listdir(fixtures.fixture_dir())}
    yield
    after = {n: os.path.getmtime(os.path.join(fixtures.fixture_dir(), n))
             for n in os.listdir(fixtures.fixture_dir())}
    assert after == before


@pytest.fixture(scope="module")
def seg2d_shards(jtool, tmp_path_factory):
    """Each tool's quick 2D segmentation shards, built once: the students'
    data (a run's students reuse the teacher's shards in its work dir)."""
    jdir, tdir = (str(tmp_path_factory.mktemp(d)) for d in ("jax_seg2d", "port_seg2d"))
    return jtool._seg_shards(jdir, 48, (256, 256)), tool._seg_shards(tdir, 48, (256, 256))


def _run(work, out):
    return tool.Run(work, out, torch.device("cpu"), quick=True)


_TEACHER = types.SimpleNamespace(params=None, model_state=None)

# target -> (fixture, fit function, JAX maker call, port maker call)
CASES = {
    "unet2d_cells": ("unet2d_cells", "fit_unet", lambda t, w: t.make_teacher(w, True),
                     lambda w, out: tool.make_teacher(_run(w, out))),
    "fast": ("unet2d_cells_fast", "fit_unet", lambda t, w: t.make_student(w, True, 2, None, _TEACHER),
             lambda w, out: tool.make_student(_run(w, out), 2, (None, None))),
    "fast4": ("unet2d_cells_fast4", "fit_unet", lambda t, w: t.make_student(w, True, 4, None, _TEACHER),
              lambda w, out: tool.make_student(_run(w, out), 4, (None, None))),
    "unet3d_cells": ("unet3d_cells", "fit_unet", lambda t, w: t.make_unet3d(w, True),
                     lambda w, out: tool.make_unet3d(_run(w, out))),
    "gan_denoise": ("gan_denoise", "fit_gan", lambda t, w: t.make_gan(w, True),
                    lambda w, out: tool.make_gan(_run(w, out))),
    "n2v_cells": ("n2v_cells", "fit_n2v", lambda t, w: t.make_n2v(w, True),
                  lambda w, out: tool.make_n2v(_run(w, out))),
    "flows_cells": ("flows_cells", "fit_flows", lambda t, w: t.make_flows(w, True),
                    lambda w, out: tool.make_flows(_run(w, out))),
    "stars_cells": ("stars_cells", "fit_stars", lambda t, w: t.make_stars(w, True),
                    lambda w, out: tool.make_stars(_run(w, out))),
}

METRIC_TOL = {
    "holdout_miou": QUICK_MIOU_AP_TOL, "holdout_ap50": QUICK_MIOU_AP_TOL,
    "holdout_matched_iou": QUICK_MIOU_AP_TOL, "holdout_psnr": PSNR_TOL_DB, "noisy_input_psnr": PSNR_TOL_DB,
}


def _identity_round(x, ndigits=None):
    return x


def _cfg_dict(cfg):
    d = dataclasses.asdict(cfg)
    d["compute_dtype"] = str(np.dtype(cfg.compute_dtype).name) if not isinstance(cfg.compute_dtype, str) \
        else cfg.compute_dtype
    return d


def _same_shards(jpaths, tpaths):
    assert [os.path.basename(p) for p in tpaths] == [os.path.basename(p) for p in jpaths]
    n = 0
    for jp, tp in zip(jpaths, tpaths):
        with open(jp, "rb") as a, open(tp, "rb") as b:
            assert a.read() == b.read(), os.path.basename(tp)
        n += sum(1 for _ in records.read_records(tp))
    return n


@pytest.mark.parametrize("target", list(CASES))
def test_recipes_data_and_scorers_equal_the_jax_tool(target, jtool, seg2d_shards, tmp_path, monkeypatch):
    name, fit_name, run_jax, run_port = CASES[target]
    got, want = {}, {}

    _, _, params, state, _ = jax_fixtures.load(name, compute_dtype=jnp.float32)

    def jax_fit(cfg, tc, fc, shards, **kw):
        want.update(cfg=cfg, tc=tc, fc=fc, shards=list(shards), kw=kw)
        return types.SimpleNamespace(params=params, model_state=state)

    def jax_save(n, kind, cfg, p, s, meta):
        want["entry"] = {"kind": kind, "config": _cfg_dict(cfg), **meta}
        want["name"] = n

    _, _, model, _ = fixtures.load(name, compute_dtype="float32", device="cpu")

    def port_fit(cfg, tc, fc, shards, **kw):
        got.update(cfg=cfg, tc=tc, fc=fc, shards=list(shards), kw=kw)
        return types.SimpleNamespace(model=model)

    monkeypatch.setattr(jtool.fit_lib, fit_name, jax_fit)
    monkeypatch.setattr(jtool.fixtures, "save", jax_save)
    monkeypatch.setattr(jtool, "round", _identity_round, raising=False)
    monkeypatch.setattr(tool.fit_lib, fit_name, port_fit)
    monkeypatch.setattr(tool, "round", _identity_round, raising=False)
    jwork, twork, out = (str(tmp_path / d) for d in ("jax", "port", "out"))
    os.makedirs(jwork)
    os.makedirs(twork)
    if target in ("fast", "fast4"):
        for paths, work in zip(seg2d_shards, (jwork, twork)):
            for p in paths:
                shutil.copy(p, work)
    run_jax(jtool, jwork)
    run_port(twork, out)

    # the same data
    assert _same_shards(want["shards"], got["shards"]) > 0
    # the same recipe
    assert _cfg_dict(got["cfg"]) == _cfg_dict(want["cfg"])
    assert dataclasses.asdict(got["tc"]) == dataclasses.asdict(want["tc"])
    assert dataclasses.asdict(got["fc"]) == dataclasses.asdict(want["fc"])
    assert got["kw"].pop("device") == torch.device("cpu")
    assert got["kw"].pop("progress") is None
    jd, td = want["kw"].pop("distill", None), got["kw"].pop("distill", None)
    if jd is not None:
        assert (td.alpha, td.temperature) == (jd.alpha, jd.temperature)
    assert got["kw"] == want["kw"]
    # the same manifest entry, the scores within their tolerances
    entry = fixtures.manifest(out)[name]
    assert want["name"] == name
    assert set(entry) == set(want["entry"]) == set(fixtures.manifest()[name])
    for key in set(entry) - set(METRIC_TOL):
        assert entry[key] == want["entry"][key], key
    for key in set(entry) & set(METRIC_TOL):
        assert abs(entry[key] - want["entry"][key]) <= METRIC_TOL[key] * (1 + 1e-9), (key, entry[key], want["entry"][key])


def test_students_take_the_runs_then_outs_then_the_committed_teacher(tmp_path, monkeypatch):
    seen = []
    monkeypatch.setattr(tool, "make_student", lambda run, s2d, teacher, clock=None: seen.append(teacher))
    monkeypatch.setattr(tool, "_report", lambda *a: {})
    out = str(tmp_path / "out")
    tool.main(["--out", out, "--device", "cpu", "--only", "fast,fast4"])
    assert len(seen) == 2 and seen[0] is seen[1]
    cfg, model = seen[0]
    _, want_cfg, want, _ = fixtures.load("unet2d_cells", device="cpu")
    assert cfg == want_cfg and cfg.compute_dtype == "bfloat16"  # the stored dtype
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(), want.state_dict().values()))
    # a teacher in --out comes first
    small = unet.UNetConfig(depth=2, base_features=4, compute_dtype="float32")
    fixtures.save("unet2d_cells", "unet", small, unet.init(small, torch.Generator().manual_seed(0), "cpu"),
                  {"task": "t"}, out)
    tool.main(["--out", out, "--device", "cpu", "--only", "fast"])
    assert seen[2][0] == small


def test_main_refuses_the_committed_directory_and_unknown_targets(tmp_path):
    with pytest.raises(SystemExit):
        tool.main(["--out", fixtures.fixture_dir(), "--device", "cpu", "--only", "n2v_cells"])
    with pytest.raises(SystemExit):
        tool.main(["--out", str(tmp_path), "--device", "cpu", "--only", "n2v"])
    assert os.listdir(str(tmp_path)) == []


def test_seed_reaches_every_recipe_and_the_dtype_follows_the_device(tmp_path, monkeypatch):
    """``--seed`` seeds the fit configs and is recorded in the recipe; the
    models compute in bf16 on the card and f32 on the CPU."""
    seen = []
    monkeypatch.setattr(tool, "make_n2v", lambda run, clock=None: seen.append(run))
    monkeypatch.setattr(tool, "_report", lambda *a: {})
    tool.main(["--out", str(tmp_path), "--device", "cpu", "--only", "n2v_cells"])
    tool.main(["--out", str(tmp_path), "--device", "cpu", "--only", "n2v_cells", "--seed", "2"])
    default, other = seen
    assert (default.seed, default.dtype, other.seed, other.dtype) == (0, "float32", 2, "float32")
    assert default.fit_config(30, 8, 8).seed == 0 and other.fit_config(30, 8, 8).seed == 2
    assert default.recipe(steps=30) == {"steps": 30} and other.recipe(steps=30) == {"steps": 30, "seed": 2}
    assert other.cfg("n2v_denoise").compute_dtype == "float32"
    assert tool.Run("w", "o", torch.device("cuda")).cfg("n2v_denoise").compute_dtype == "bfloat16"


def test_fixture_init_study_starts_the_recipes_from_the_jax_draw(tmp_path, monkeypatch):
    from sequitr_tpu.models import zoo as jax_zoo
    from sequitr_tpu_torch.models import convert, gan
    from sequitr_tpu_torch.studies import fixture_init

    spec = importlib.util.spec_from_file_location("_jax_init_npz", os.path.join(REPO, "tests", "jax_init_npz.py"))
    exporter = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(exporter)
    narrow = {"gan_enhance": dict(gen_depth=2, gen_base_features=4, disc_base_features=4),
              "n2v_denoise": dict(depth=2, base_features=4, features_cap=8)}
    for zoo_mod in (jax_zoo, tool.zoo):
        real_get = zoo_mod.get
        monkeypatch.setattr(zoo_mod, "get", lambda n, real_get=real_get: dataclasses.replace(real_get(n), **narrow[n]))
    init, out = str(tmp_path / "init"), str(tmp_path / "out")
    exporter.main(["--out", init])
    started = {}

    def recorder(fit_name):
        def fit(cfg, tc, fc, shards, init_state=None, **kw):
            started[fit_name] = init_state
            return types.SimpleNamespace(model=init_state.model)
        return fit

    for fit_name in ("fit_gan", "fit_n2v"):
        monkeypatch.setattr(tool.fit_lib, fit_name, recorder(fit_name))
    rows = fixture_init.main(["--init", init, "--out", out, "--device", "cpu"])
    assert [r["fixture"] for r in rows] == ["gan_denoise", "n2v_cells"]
    for name, fit_name in (("gan_denoise", "fit_gan"), ("n2v_cells", "fit_n2v")):
        state = started[fit_name]
        assert state.step == 0
        assert isinstance(state.model, gan.GAN) == (name == "gan_denoise")
        with np.load(os.path.join(init, f"{name}.npz")) as z:
            want = {k: z[k] for k in z.files}
        got = convert.to_flat(state.model)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert fixtures.manifest(out)[name]["config"] == dict(
            fixtures.manifest()[name]["config"], compute_dtype="float32", **narrow[
                "gan_enhance" if name == "gan_denoise" else "n2v_denoise"])
