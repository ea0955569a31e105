"""The port's instance segmentation (``ops.flows``, ``ops.stardist``, the
flows and stars inferrers, the ``segment_flows`` / ``segment_stars`` jobs)
against the JAX package's on the same numpy inputs and weights.

- ``follow_flows`` on the same f32 field: positions within 1e-3 on >= 99.9%
  of pixels, ``group_sinks`` instances equal; ``follow_flows_doubling``
  integer-equal.
- ``flow_targets`` / ``star_targets`` within 1e-6 of the goldens.
- The trained fixtures at f32 against the JAX package's jitted serving
  passes; at their bf16 compute dtype against the goldens.
- The jobs through both servers at f32 on small random models: labels
  matched at ap50 = 1.0, ``prob.tif`` within 1e-5, the same objects.h5 rows.
"""

import json
import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequitr_tpu.config import ServerConfiguration as JaxConfig
from sequitr_tpu.models import convert as jax_convert
from sequitr_tpu.models import fixtures as jax_fixtures
from sequitr_tpu.models import unet as jax_unet
from sequitr_tpu.ops import flows as jax_flows
from sequitr_tpu.ops import stardist as jax_sd
from sequitr_tpu.pipeline import infer as jax_infer
from sequitr_tpu.server import ImageServer as JaxServer
from sequitr_tpu.server import save_model as jax_save_model
from sequitr_tpu.server import submit_job as jax_submit
from sequitr_tpu_torch import __main__ as torch_main
from sequitr_tpu_torch.config import ServerConfiguration as TorchConfig
from sequitr_tpu_torch.data import synthetic
from sequitr_tpu_torch.data import tiff as torch_tiff
from sequitr_tpu_torch.models import fixtures as torch_fixtures
from sequitr_tpu_torch.models import unet as torch_unet
from sequitr_tpu_torch.ops import flows as torch_flows
from sequitr_tpu_torch.ops import stardist as torch_sd
from sequitr_tpu_torch.pipeline import infer as torch_infer
from sequitr_tpu_torch.server import ImageServer as TorchServer
from sequitr_tpu_torch.server import submit_job as torch_submit

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _golden(name):
    return np.load(os.path.join(GOLDENS, f"{name}.npz"))


def _field(shape, seed):
    """A flow field with sinks: the targets of a few ellipsoidal instances,
    plus noise; and its foreground mask."""
    rng = np.random.default_rng(seed)
    lab = np.zeros(shape, np.int32)
    grids = np.indices(shape)
    for k in range(6):
        c = rng.uniform(4, np.array(shape) - 4)
        r = np.array([2.5 if len(shape) == 3 and a == 0 else rng.uniform(4, 8) for a in range(len(shape))])
        q = sum(((g - ci) / ri) ** 2 for g, ci, ri in zip(grids, c, r))
        lab[(q < 1) & (lab == 0)] = k + 1
    flow, prob = jax_flows.flow_targets(lab)
    flow = flow + rng.normal(size=flow.shape).astype(np.float32) * 0.2
    return flow.astype(np.float32), prob > 0.5


SHAPES = [(64, 64), (16, 32, 32)]


@pytest.mark.parametrize("shape", SHAPES, ids=["2d", "3d"])
def test_follow_flows_matches_jax(shape):
    flow, mask = _field(shape, seed=len(shape))
    want = np.asarray(jax_flows.follow_flows(flow, mask))
    got = torch_flows.follow_flows(flow, mask, device="cpu")
    assert got.dtype == torch.float32 and tuple(got.shape) == shape + (len(shape),)
    got = got.numpy()
    close = np.abs(got - want).max(axis=-1) <= 1e-3
    assert close.mean() >= 0.999, close.mean()
    np.testing.assert_array_equal(
        torch_flows.group_sinks(got, mask), jax_flows.group_sinks(want, mask)
    )
    # a tensor stays on its device; the mask may be a tensor too
    again = torch_flows.follow_flows(torch.from_numpy(flow), torch.from_numpy(mask))
    assert torch.equal(again, torch.from_numpy(got))


@pytest.mark.parametrize("shape", SHAPES, ids=["2d", "3d"])
def test_follow_flows_doubling_is_integer_equal(shape):
    """Pointer doubling: the successor map rounds half to even as
    ``jnp.round``; 200 steps run as 256 on both sides."""
    flow, mask = _field(shape, seed=10 + len(shape))
    for n_iter in (200, 5):
        want = np.asarray(jax_flows.follow_flows_doubling(flow, mask, n_iter=n_iter))
        got = torch_flows.follow_flows_doubling(flow, mask, n_iter=n_iter, device="cpu").numpy()
        np.testing.assert_array_equal(got, want)
    # half-way flows: the rounding ties
    half = np.full(shape + (len(shape),), 0.5, np.float32)
    np.testing.assert_array_equal(
        torch_flows.follow_flows_doubling(half, n_iter=1, device="cpu").numpy(),
        np.asarray(jax_flows.follow_flows_doubling(half, n_iter=1)),
    )


def test_targets_match_the_goldens():
    """The host targets (copies of the JAX package's) within 1e-6."""
    g = _golden("flows_segment")
    t_flow, t_prob = torch_flows.flow_targets(g["labels"])
    np.testing.assert_allclose(t_flow, g["targets_flow"], atol=1e-6)
    np.testing.assert_array_equal(t_prob, g["targets_prob"])
    g = _golden("stars_predict")
    t_dist, t_prob = torch_sd.star_targets(g["labels"])
    np.testing.assert_allclose(t_dist, g["targets_dist"], atol=1e-6)
    np.testing.assert_allclose(t_prob, g["targets_prob"], atol=1e-6)
    for n in (4, 8, 32):
        for ax in (0, 1):
            np.testing.assert_array_equal(torch_sd.ray_flip_perm(n, ax), jax_sd.ray_flip_perm(n, ax))
        np.testing.assert_array_equal(torch_sd.ray_transpose_perm(n), jax_sd.ray_transpose_perm(n))


def _port_pass(name, dtype, tc_kw=None):
    _, cfg, model, _ = torch_fixtures.load(name, compute_dtype=dtype, device="cpu")
    tc = torch_infer.TileConfig(patch=(128, 128), overlap=(0, 0), normalize="exact", **(tc_kw or {}))
    if name == "flows_cells":
        return torch_infer.make_flows_segmenter(cfg, tc, (128, 128), device="cpu"), model
    return torch_infer.make_stars_predictor(cfg, tc, (128, 128), device="cpu"), model


@pytest.mark.parametrize("name", ["flows_cells", "stars_cells"])
def test_fixture_serving_matches_jax_at_f32(name):
    """The trained fixture at f32 on the golden's 128x128 image: the port's
    serving pass against the JAX package's jitted one. Flows: prob within
    1e-5, positions within 1e-3 on >= 99.9% of pixels, instances equal.
    Stars: prob within 1e-5, distances within 1e-4, instances equal."""
    g = _golden("flows_segment" if name == "flows_cells" else "stars_predict")
    _, jcfg, params, state, _ = jax_fixtures.load(name)
    jcfg = jax_unet.UNetConfig(**{**jcfg.__dict__, "compute_dtype": jnp.float32})
    jtc = jax_infer.TileConfig(patch=(128, 128), overlap=(0, 0), normalize="exact")
    fn, model = _port_pass(name, "float32")
    a, b = (t.numpy() for t in fn(model, g["image"]))
    if name == "flows_cells":
        jfin, jprob = jax.jit(jax_infer.make_flows_segmenter(jcfg, jtc, (128, 128)))(
            params, state, jnp.asarray(g["image"])
        )
        jfin, jprob = np.asarray(jfin), np.asarray(jprob)
        np.testing.assert_allclose(b, jprob, atol=1e-5)
        assert (np.abs(a - jfin).max(axis=-1) <= 1e-3).mean() >= 0.999
        np.testing.assert_array_equal(
            torch_flows.group_sinks(a, b > 0.5), jax_flows.group_sinks(jfin, jprob > 0.5)
        )
    else:
        jprob, jdist = jax.jit(jax_infer.make_stars_predictor(jcfg, jtc, (128, 128)))(
            params, state, jnp.asarray(g["image"])
        )
        jprob, jdist = np.asarray(jprob), np.asarray(jdist)
        np.testing.assert_allclose(a, jprob, atol=1e-5)
        np.testing.assert_allclose(b, jdist, atol=1e-4)
        np.testing.assert_array_equal(
            torch_sd.instances_from_rays(a, b), jax_sd.instances_from_rays(jprob, jdist)
        )


@pytest.mark.parametrize("name", ["flows_cells", "stars_cells"])
def test_fixture_goldens_at_bf16(name):
    """``flows_segment.npz`` / ``stars_predict.npz`` through the port at the
    fixtures' bf16 compute dtype: every committed instance recovered at IoU
    >= 0.9 (ap90 = 1.0) with at most 1% of labels flipped, converged
    positions within 1.0 px wherever the two foreground masks agree (on >=
    99.99% of pixels).

    The goldens hold the JAX package's jitted CPU numerics, in which XLA
    drops the bf16 rounding of each conv's output (``test_torch_infer.py``);
    the JAX package's own serving pass run op by op (``jax.disable_jit``),
    which rounds there as the port does, misses the golden's prob by
    0.019 and the 5e-3 term of ``test_goldens.py`` with it (the port at f32
    misses it by 0.027). So prob is held to 5e-3 on >= 95% of pixels (seen:
    99.2% flows, 96.5% stars) and 2.5e-2 on all (seen 0.019, 0.017), the ray
    distances to 5e-2 on >= 97% (seen 98.3%) and 0.25 on all (seen 0.19)."""
    g = _golden("flows_segment" if name == "flows_cells" else "stars_predict")
    fn, model = _port_pass(name, "bfloat16")
    a, b = (t.numpy() for t in fn(model, g["image"]))
    if name == "flows_cells":
        final, prob = a, b
        inst = torch_flows.group_sinks(final, prob > 0.5)
        agree = (prob > 0.5) == (g["prob"] > 0.5)
        assert agree.mean() >= 0.9999
        assert np.abs(final - g["final"]).max(axis=-1)[agree].max() <= 1.0
    else:
        prob, dist = a, b
        inst = torch_sd.instances_from_rays(prob, dist)
        d = np.abs(dist - g["dist"])
        assert (d <= 5e-2).mean() >= 0.97 and d.max() <= 0.25
    p = np.abs(prob - g["prob"])
    assert (p <= 5e-3).mean() >= 0.95 and p.max() <= 2.5e-2
    assert torch_flows.average_precision(g["instances"], inst, thresholds=(0.9,))["ap90"] == 1.0
    assert np.mean(inst != g["instances"]) <= 0.01


def test_average_precision_matches_jax():
    g = _golden("flows_segment")
    pred = g["instances"].copy()
    pred[pred == 3] = 0
    pred[:10, :10] = 99
    assert torch_flows.average_precision(g["instances"], pred) == jax_flows.average_precision(g["instances"], pred)


# ---------------------------------------------------------------------------
# the jobs through both servers
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """Models registered with both servers at f32: the trained
    ``flows_cells`` and ``stars_cells`` fixtures (2D) and a small random 3D
    flows model (biases and statistics moved off zero); a 3-frame 64x64
    uint16 instances stack and a 2-timepoint 8x32x32 volume file (``z:
    8``)."""
    tmp = tmp_path_factory.mktemp("instances")
    jax_models, torch_models = str(tmp / "jax_models"), str(tmp / "torch_models")
    models = {}
    for name in ("flows_cells", "stars_cells"):
        kind, cfg, params, state, _ = jax_fixtures.load(name)
        models[name] = (kind, jax_unet.UNetConfig(**{**cfg.__dict__, "compute_dtype": jnp.float32}), params, state)
    cfg = jax_unet.UNetConfig(dims=3, depth=2, base_features=8, num_classes=4, compute_dtype=jnp.float32)
    params, state = jax_unet.init(jax.random.PRNGKey(3), cfg)
    rng = np.random.default_rng(3)
    params = jax.tree.map(lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32), params)
    state = jax.tree.map(lambda a: a + 0.1 * rng.random(a.shape).astype(np.float32), state)
    models["flows3d"] = ("flows", cfg, params, state)
    for name, (kind, cfg, params, state) in models.items():
        jax_save_model(jax_models, name, kind, cfg, params, state)
        npz = str(tmp / f"{name}.npz")
        flat = jax_convert.flatten_params(params)
        np.savez(npz, **flat, **{f"state/{key}": v for key, v in jax_convert.flatten_params(state).items()})
        assert torch_main.main([
            "import-model", "--models-dir", torch_models, "--npz", npz,
            "--arch", os.path.join(jax_models, name, "config.json"), name,
        ]) == 0
    frames = np.stack(
        [synthetic.instances_frame(717_100 + i, (64, 64))[0] for i in range(3)]
    ).clip(0, 65535).astype(np.uint16)
    stack = str(tmp / "stack.tif")
    torch_tiff.write_stack(stack, frames)
    vols = np.stack(
        [synthetic.cells_volume(717_200 + t, (8, 32, 32))[0] for t in range(2)]
    ).clip(0, 65535).astype(np.uint16)
    paged = str(tmp / "paged.tif")
    torch_tiff.write_stack(paged, vols.reshape(16, 32, 32))
    return dict(
        tmp=tmp, stack=stack, paged=paged, jax_models=jax_models, torch_models=torch_models,
    )


def _serve(env, which, name, module, model, params, inputs):
    tmp = env["tmp"]
    out = str(tmp / f"{which}_{name}")
    jobs = str(tmp / f"{which}_jobs")
    spec = {"module": module, "params": dict(model=model, **params), "input": inputs, "output": out}
    if which == "jax":
        cfg = JaxConfig(jobs_dir=jobs, models_dir=env["jax_models"], compilation_cache_dir=None)
        jax_submit(jobs, spec)
        assert JaxServer(cfg).poll_once()
    else:
        cfg = TorchConfig(jobs_dir=jobs, models_dir=env["torch_models"], device="cpu")
        torch_submit(jobs, spec)
        assert TorchServer(cfg).poll_once()
    with open(os.path.join(out, "status.json")) as f:
        return json.load(f)


def _h5_arrays(path):
    out = {}
    with h5py.File(path, "r") as f:
        f.visititems(
            lambda name, obj: out.__setitem__(name, obj[()]) if isinstance(obj, h5py.Dataset) else None
        )
    return out


JOBS = {
    "flows_euler": ("segment_flows", "flows_cells", {"save_prob": True}, "stack"),
    "flows_doubling": ("segment_flows", "flows_cells", {"integrator": "doubling"}, "stack"),
    "flows_3d": ("segment_flows", "flows3d", {"z": 8, "save_prob": True, "min_area": 4}, "paged"),
    "stars": ("segment_stars", "stars_cells", {"save_prob": True}, "stack"),
    "stars_polyphase": ("segment_stars", "stars_cells", {"polyphase": True}, "stack"),
}


@pytest.mark.parametrize("job", sorted(JOBS))
def test_job_matches_the_jax_server(env, job):
    module, model, params, src = JOBS[job]
    st = {w: _serve(env, w, job, module, model, params, [env[src]]) for w in ("jax", "torch")}
    for w in st:
        assert st[w]["state"] == "complete", (w, st[w].get("error"))
    jo, to = st["jax"]["outputs"], st["torch"]["outputs"]
    metrics = json.loads(to["metrics"])
    if job == "flows_3d":
        pairs = [(jo["labels"].replace("*", f"{t:04d}"), to["labels"].replace("*", f"{t:04d}")) for t in range(2)]
        assert metrics["n_volumes"] == 2 and metrics["volumes_per_sec"] > 0
        probs = [(jo["prob"].replace("*", f"{t:04d}"), to["prob"].replace("*", f"{t:04d}")) for t in range(2)]
    else:
        pairs = [(jo["labels"], to["labels"])]
        assert metrics["n_frames"] == 3 and metrics["frames_per_sec"] > 0
        probs = [(jo["prob"], to["prob"])] if "prob" in jo else []
    n_objects = 0
    for jp, tp in pairs:
        want, got = torch_tiff.read_stack(jp), torch_tiff.read_stack(tp)
        assert got.dtype == np.uint16 and got.shape == want.shape
        frames = [(want, got)] if job == "flows_3d" else list(zip(want, got))
        for w, g in frames:
            n_objects += int(g.max())
            # ids renumbered 1..N per frame
            assert set(np.unique(g)) == set(range(int(g.max()) + 1))
            ap = torch_flows.average_precision(w.astype(np.int64), g.astype(np.int64), thresholds=(0.5,))
            assert ap["ap50"] == 1.0, ap
    assert n_objects > 0
    for jp, tp in probs:
        np.testing.assert_allclose(torch_tiff.read_stack(tp), torch_tiff.read_stack(jp), atol=1e-5)
    jh, th = _h5_arrays(jo["objects"]), _h5_arrays(to["objects"])
    assert sorted(jh) == sorted(th)
    for key in jh:
        np.testing.assert_allclose(th[key], jh[key], rtol=1e-5, atol=1e-4, err_msg=key)


@pytest.mark.parametrize("params,message", [
    ({"model": "flows_cells", "tta": 2}, "tta is unsupported for flow-field serving"),
    ({"model": "flows_cells", "integrator": "rk4"}, "integrator must be 'euler' or 'doubling'"),
    ({"model": "stars_cells", "tta": 4}, "tta is unsupported for star-convex serving"),
    ({"model": "stars_cells", "module": "segment_flows"}, "is kind 'stars', expected 'flows'"),
    ({"model": "flows3d", "module": "segment_stars"}, "is kind 'flows', expected 'stars'"),
    ({"model": "flows_cells", "polyphase": True, "patch": [33, 33], "overlap": [0, 0]}, "polyphase needs even"),
])
def test_job_refusals(env, params, message):
    params = dict(params)
    module = params.pop("module", "segment_stars" if params["model"] == "stars_cells" else "segment_flows")
    model = params.pop("model")
    st = _serve(env, "torch", "bad_" + "_".join(f"{k}{v}" for k, v in sorted(params.items())) + model,
                module, model, params, [env["stack"]])
    assert st["state"] == "failed" and "JobError" in st["error"] and message in st["error"], st["error"]


def test_inferrer_refusals():
    """The inferrers refuse what the JAX package's refuse: TTA, a head of
    the wrong width, 3D stars, an unknown integrator, polyphase outside the
    cover."""
    tc = torch_infer.TileConfig(patch=(32, 32), overlap=(0, 0))
    flows2d = torch_unet.UNetConfig(depth=2, base_features=4, num_classes=3)
    stars = torch_unet.UNetConfig(depth=2, base_features=4, num_classes=9)
    cases = [
        (lambda: torch_infer.make_flows_segmenter(flows2d, torch_infer.TileConfig(patch=(32, 32), overlap=(0, 0), tta=2), (32, 32), device="cpu"), "tta"),
        (lambda: torch_infer.make_flows_segmenter(stars, tc, (32, 32), device="cpu"), "dims \\+ 1"),
        (lambda: torch_infer.make_flows_segmenter(flows2d, tc, (32, 32), integrator="rk4", device="cpu"), "integrator"),
        (lambda: torch_infer.make_stars_predictor(stars, torch_infer.TileConfig(patch=(32, 32), overlap=(0, 0), tta=8), (32, 32), device="cpu"), "tta"),
        (lambda: torch_infer.make_stars_predictor(torch_unet.UNetConfig(depth=2, num_classes=7), tc, (32, 32), device="cpu"), "multiple of 4"),
        (lambda: torch_infer.make_stars_predictor(torch_unet.UNetConfig(dims=3, depth=2, num_classes=9), torch_infer.TileConfig(patch=(4, 32, 32), overlap=(0, 0, 0)), (4, 32, 32), device="cpu"), "2D only"),
        (lambda: torch_infer.make_stars_predictor(torch_unet.UNetConfig(depth=2, num_classes=9, space_to_depth=2), torch_infer.TileConfig(patch=(32, 32), overlap=(0, 0), polyphase=True), (32, 32), device="cpu"), "polyphase"),
    ]
    for call, match in cases:
        with pytest.raises(ValueError, match=match):
            call()
