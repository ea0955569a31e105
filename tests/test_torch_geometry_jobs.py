"""``register_stack``, ``stitch_mosaic`` and ``correct_illumination`` through
the JAX ``ImageServer`` and the port's ``ImageServer(device="cpu")`` on the
same job JSON.

Both servers must write the same files, the same output keys, the same
CSV columns and the same metrics keys. Values: shifts and positions within
1e-5 px plus one unit of the CSV's last digit (``%.4f``), responses at
rtol 1e-4 plus the ``%.3f`` rounding, rounded metrics within one unit of
their last digit; integer-mode ``registered.tif`` byte-equal; Fourier
resamples and composites within 2e-4 of values ~120 (two CPU FFT
libraries, see ``test_torch_registration.py``); the illumination outputs
(``corrected.tif``, ``gains.csv``, ``shading.tif``) byte-equal. Timing
metrics are compared by key only. Every JobError the JAX tests name
carries the same text (job ids masked).
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from sequitr_tpu.config import ServerConfiguration as JaxConfig
from sequitr_tpu.server import ImageServer as JaxServer
from sequitr_tpu.server import submit_job as jax_submit
from sequitr_tpu_torch.config import ServerConfiguration as TorchConfig
from sequitr_tpu_torch.data import tiff
from sequitr_tpu_torch.data.synthetic import bandlimited_scene
from sequitr_tpu_torch.server import ImageServer as TorchServer
from sequitr_tpu_torch.server import submit_job as torch_submit

SHIFT_TOL = 1e-5 + 1e-4  # 1e-5 px plus one unit of the CSV's %.4f
RESP_TOL = 1e-4  # relative, plus the %.3f rounding
PIXEL_TOL = 2e-4
TIMING = re.compile(r"(_s|_per_sec)$")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _fourier_shift(img, shift):
    """``img`` moved by ``shift`` (float64 Fourier shift, exact for the
    band-limited periodic scenes)."""
    spec = np.fft.fftn(img.astype(np.float64))
    phase = sum(
        np.fft.fftfreq(n).reshape([-1 if i == ax else 1 for i in range(img.ndim)]) * s
        for ax, (n, s) in enumerate(zip(img.shape, shift))
    )
    return np.fft.ifftn(spec * np.exp(-2j * np.pi * phase)).real


def _drifting(shape, n, seed, step=(0.9, -0.7), offset=None):
    rng = np.random.default_rng(seed)
    base = bandlimited_scene(shape, rng)
    traj = np.cumsum(np.vstack([np.zeros(len(shape)), rng.normal(step, 0.3, (n - 1, len(shape)))]), 0)
    if offset is not None:
        traj = traj + offset
    return np.stack([_fourier_shift(base, s) for s in traj]).astype(np.float32)


def _tiles(grid, tile=(64, 64), overlap=16, jitter=2.0, seed=3, t=1):
    """(T, R*C, H, W) tiles of one scene at grid spacing plus sub-pixel
    jitter, with a vignette and a per-tile fade; a scene drift per
    timepoint."""
    r, c = grid
    h, w = tile
    rng = np.random.default_rng(seed)
    scene = bandlimited_scene(((r - 1) * (h - overlap) + h + 16, (c - 1) * (w - overlap) + w + 16), rng)
    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    vig = 1.0 - 0.3 * (yy**2 + xx**2)
    fade = np.linspace(1.0, 0.75, r * c)
    jit = [rng.uniform(-jitter, jitter, 2) if k else np.zeros(2) for k in range(r * c)]
    out = []
    for ti in range(t):
        moved = _fourier_shift(scene, (0.7 * ti, -0.4 * ti))
        frame = []
        for k in range(r * c):
            y0, x0 = (k // c) * (h - overlap) + 8 + jit[k][0], (k % c) * (w - overlap) + 8 + jit[k][1]
            iy, ix = int(np.floor(y0)), int(np.floor(x0))
            cut = _fourier_shift(moved, (iy - y0, ix - x0))[iy:iy + h, ix:ix + w]
            frame.append(cut * vig * fade[k])
        out.append(frame)
    return np.asarray(out, np.float32)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("geometry")

    def write(name, arr):
        path = str(tmp / name)
        tiff.write_stack(path, arr)
        return path

    def write_dir(name, arrs):
        d = tmp / name
        d.mkdir()
        for i, a in enumerate(arrs):
            tiff.write_stack(str(d / f"{name}_{i:03d}.tif"), a)
        return str(d)

    stack = _drifting((48, 64), 6, seed=1)
    chan1 = _drifting((48, 64), 6, seed=1, offset=(1.3, -0.8)) * 0.8
    blank = stack.copy()
    blank[3] = 100.0  # a shutter drop: a featureless frame
    vols = _drifting((8, 32, 32), 3, seed=2, step=(0.4, 0.9, -0.6))
    vols1 = _drifting((8, 32, 32), 3, seed=2, step=(0.4, 0.9, -0.6), offset=(0.5, -1.0, 0.7))
    tiles = _tiles((2, 3))[0]
    snake = tiles[[0, 1, 2, 5, 4, 3]]
    lapse = _tiles((2, 3), seed=4, t=2)
    rng = np.random.default_rng(5)
    big = bandlimited_scene((40 + 8, 48 + 8), rng) + 100.0
    yy, xx = np.meshgrid(np.linspace(-1, 1, 40), np.linspace(-1, 1, 48), indexing="ij")
    vig = 1.0 - 0.35 * (yy**2 + xx**2)
    illum = np.stack([big[k:k + 40, k:k + 48] * vig * np.exp(-0.04 * k) for k in range(8)])
    return dict(
        tmp=tmp,
        stack=write("stack.tif", stack),
        stack_u16=write("stack_u16.tif", np.round(stack).astype(np.uint16)),
        chan1=write("chan1.tif", chan1),
        chan1_u16=write("chan1_u16.tif", np.round(chan1).astype(np.uint16)),
        blank=write("blank.tif", blank),
        vols=write_dir("vols", vols),
        vols_u16=write_dir("vols_u16", np.round(vols).astype(np.uint16)),
        vols1=write_dir("vols1", vols1),
        vols_z=write("vols_z.tif", vols.reshape(-1, 32, 32)),
        one_vol=write("one_vol.tif", vols[0]),
        tiles=write("tiles.tif", tiles),
        tiles_c1=write("tiles_c1.tif", tiles * 0.5 + 10.0),
        tiles_snake=write("tiles_snake.tif", snake),
        tiles_short=write("tiles_short.tif", tiles[:4]),
        tiles_auto=write("tiles_auto.tif", _tiles((2, 2), tile=(96, 96), overlap=24, seed=5)[0]),
        lapse=write_dir("lapse", [lapse[:, k] for k in range(6)]),
        illum=write("illum.tif", np.round(illum).astype(np.uint16)),
        illum_c1=write("illum_c1.tif", np.round(illum[:, ::-1] * 0.5 + 30).astype(np.uint16)),
        illum_f32=write("illum_f32.tif", illum.astype(np.float32)),
    )


def _serve(env, which, name, module, params, inputs, depends_on=None):
    tmp = env["tmp"]
    out = str(tmp / f"{which}_{name}")
    jobs = str(tmp / f"{which}_jobs")
    spec = {"module": module, "params": params, "input": [env.get(k, k) for k in inputs], "output": out}
    if depends_on is not None:
        spec["depends_on"] = str(tmp / f"{which}_{depends_on}")
        spec["params"] = {
            k: (spec["depends_on"] if v == "@dep" else v) for k, v in params.items()
        }
    if which == "jax":
        cfg = JaxConfig(jobs_dir=jobs, models_dir=str(tmp / "models"), compilation_cache_dir=None)
        jax_submit(jobs, spec)
        assert JaxServer(cfg).poll_once()
    else:
        cfg = TorchConfig(jobs_dir=jobs, models_dir=str(tmp / "models"), device="cpu")
        torch_submit(jobs, spec)
        assert TorchServer(cfg).poll_once()
    with open(os.path.join(out, "status.json")) as f:
        return json.load(f)


def _both(env, name, module, params, inputs, depends_on=None):
    return tuple(_serve(env, w, name, module, params, inputs, depends_on) for w in ("jax", "torch"))


def _job_error(status):
    assert status["state"] == "failed", status
    last = status["error"].strip().splitlines()[-1]
    assert "JobError: " in last, last
    return re.sub(r"job [0-9a-f-]+:", "job ID:", last.split("JobError: ", 1)[1])


def _same_errors(env, name, module, params, inputs):
    sj, st = _both(env, name, module, params, inputs)
    assert _job_error(st) == _job_error(sj)


def _decimals(x: float) -> int:
    s = repr(float(x))
    return len(s.split(".")[1]) if "." in s and "e" not in s else 0


def _same_metrics(mj, mt):
    """Keys equal; timings by key only; integers, strings and lists equal;
    floats within one unit of their printed last digit."""
    assert set(mt) == set(mj), (sorted(mt), sorted(mj))
    for k, a in mj.items():
        b = mt[k]
        if TIMING.search(k):
            continue
        if isinstance(a, float) or isinstance(b, float):
            unit = 10.0 ** -max(_decimals(a), _decimals(b), 1)
            assert abs(a - b) <= unit + 1e-4 * abs(a), (k, b, a)
        elif isinstance(a, list):
            np.testing.assert_allclose(np.asarray(b, float), np.asarray(a, float), atol=1.1e-4, err_msg=k)
        else:
            assert a == b, (k, b, a)


def _csv(path):
    with open(path) as f:
        lines = f.read().strip().splitlines()
    return lines[0], [row.split(",") for row in lines[1:]]


def _same_csv(pj, pt, tols):
    """Same header and row count; column ``k`` within ``tols[k]`` (absolute,
    or ``("rel", r)``), others equal as text."""
    hj, rj = _csv(pj)
    ht, rt = _csv(pt)
    assert ht == hj
    assert len(rt) == len(rj)
    cols = hj.split(",")
    for a, b in zip(rj, rt):
        for name, x, y in zip(cols, a, b):
            tol = tols.get(name)
            if tol is None or x == y:
                assert x == y, (name, y, x)
            elif isinstance(tol, tuple):
                assert abs(float(x) - float(y)) <= tol[1] * abs(float(x)) + 1e-3, (name, y, x)
            else:
                assert abs(float(x) - float(y)) <= tol, (name, y, x)


def _complete(sj, st):
    assert sj["state"] == "complete", sj.get("error")
    assert st["state"] == "complete", st.get("error")
    assert set(st["outputs"]) == set(sj["outputs"])
    oj, ot = sj["outputs"], st["outputs"]
    mj, mt = json.loads(oj["metrics"]), json.loads(ot["metrics"])
    _same_metrics(mj, mt)
    return oj, ot, mj, mt


def _same_files(env, name):
    tmp = env["tmp"]
    fj = sorted(f for f in os.listdir(tmp / f"jax_{name}") if not f.startswith("status"))
    ft = sorted(f for f in os.listdir(tmp / f"torch_{name}") if not f.startswith("status"))
    assert ft == fj


def _same_tiff(pj, pt, exact):
    a, b = tiff.read_stack(pj), tiff.read_stack(pt)
    assert b.shape == a.shape and b.dtype == a.dtype, (b.shape, a.shape, b.dtype, a.dtype)
    if exact:
        assert b.tobytes() == a.tobytes()
    else:
        np.testing.assert_allclose(b, a, atol=PIXEL_TOL)


SHIFT_COLS = {k: SHIFT_TOL for k in ("dz", "dy", "dx", "step_dz", "step_dy", "step_dx")}
SHIFT_COLS["response"] = ("rel", RESP_TOL)

REGISTER = {
    "previous": ({}, ["stack"]),
    "first": ({"mode": "first"}, ["stack"]),
    "first_frame_batch": ({"mode": "first", "frame_batch": 4}, ["stack"]),
    "first_data_parallel": ({"mode": "first", "data_parallel": True}, ["stack"]),
    "crop": ({"crop": True}, ["stack"]),
    "estimate_roi": ({"estimate_roi": [4, 4, 44, 60]}, ["stack"]),
    "estimate_only": ({"estimate_only": True, "refine": 3}, ["stack"]),
    "min_response": ({"min_response": 8.0}, ["blank"]),
    "min_response_first": ({"mode": "first", "min_response": 8.0, "frame_batch": 2}, ["blank"]),
    "window_off_refine1": ({"window": False, "refine": 1}, ["stack"]),
    "frame_range": ({"frame_range": [1, 5]}, ["stack"]),
    "two_channels": ({}, ["stack", "chan1"]),
    "align_channels": ({"align_channels": True}, ["stack", "chan1"]),
    "align_channels_crop": ({"align_channels": True, "crop": True}, ["stack", "chan1"]),
    "integer": ({"subpixel": False}, ["stack_u16"]),
    "integer_crop": ({"subpixel": False, "crop": True}, ["stack_u16"]),
    "integer_align": ({"subpixel": False, "align_channels": True}, ["stack_u16", "chan1_u16"]),
    "integer_first_batch": ({"subpixel": False, "mode": "first", "frame_batch": 3}, ["stack_u16"]),
    "dims3": ({"dims": 3}, ["vols"]),
    "dims3_first": ({"dims": 3, "mode": "first"}, ["vols"]),
    "dims3_z": ({"dims": 3, "z": 8}, ["vols_z"]),
    "dims3_crop": ({"dims": 3, "crop": True}, ["vols"]),
    "dims3_estimate_only": ({"dims": 3, "estimate_only": True}, ["vols"]),
    "dims3_integer": ({"dims": 3, "subpixel": False}, ["vols_u16"]),
    "dims3_align": ({"dims": 3, "align_channels": True}, ["vols", "vols1"]),
    "dims3_min_response": ({"dims": 3, "min_response": 1000.0}, ["vols"]),
}


@pytest.mark.parametrize("case", sorted(REGISTER))
def test_register_stack(env, case):
    params, inputs = REGISTER[case]
    name = f"reg_{case}"
    sj, st = _both(env, name, "register_stack", params, inputs)
    oj, ot, mj, mt = _complete(sj, st)
    _same_files(env, name)
    _same_csv(oj["shifts"], ot["shifts"], SHIFT_COLS)
    exact = params.get("subpixel") is False
    for key in oj:
        if key.startswith("registered") and not os.path.isdir(oj[key]):
            _same_tiff(oj[key], ot[key], exact)
    if params.get("dims") == 3 and "registered" in oj:
        for f in sorted(os.listdir(oj["registered"])):
            if f.startswith("registered_t"):
                _same_tiff(os.path.join(oj["registered"], f), os.path.join(ot["registered"], f), exact)
    if exact:
        # lossless: the output keeps the input's dtype, and every frame is
        # a whole-pixel roll of its input by the written shift
        reg = tiff.read_stack(ot.get("registered") or ot["registered_c0"]) if params.get("dims") != 3 else None
        if reg is not None and not params.get("crop"):
            src = tiff.read_stack(env[inputs[0]])
            assert reg.dtype == np.uint16
            _, rows = _csv(ot["shifts"])
            off = np.round(mt.get("chromatic_offsets_px", [[0, 0]])[0])
            for t, row in enumerate(rows):
                r = np.round(np.array([float(row[1]), float(row[2])]) + off).astype(int)
                np.testing.assert_array_equal(reg[t], np.roll(src[t], tuple(r), axis=(0, 1)))


STITCH = {
    "basic": ({"grid": [2, 3], "overlap": 16}, ["tiles"]),
    "flatfield_gains": ({"grid": [2, 3], "overlap": 16, "flatfield": True, "match_gains": True}, ["tiles"]),
    "flatfield_order4": ({"grid": [2, 3], "overlap": 0.25, "flatfield": 4}, ["tiles"]),
    "snake": ({"grid": [2, 3], "overlap": 16, "order": "snake"}, ["tiles_snake"]),
    "integer": ({"grid": [2, 3], "overlap": 16, "subpixel": False}, ["tiles"]),
    "min_response": ({"grid": [2, 3], "overlap": 16, "min_response": 12.5}, ["tiles"]),
    "two_channels": ({"grid": [2, 3], "overlap": 16, "flatfield": True}, ["tiles", "tiles_c1"]),
    "auto_overlap": ({"grid": [2, 2], "overlap": "auto"}, ["tiles_auto"]),
    "backend_cpu": ({"grid": [2, 3], "overlap": 16, "backend": "cpu"}, ["tiles"]),
    "backend_auto": ({"grid": [2, 3], "overlap": 16, "backend": "auto"}, ["tiles"]),
    "timelapse": ({"grid": [2, 3], "overlap": 16, "timelapse": True, "match_gains": True}, ["lapse"]),
    "timelapse_estimate_only": ({"grid": [2, 3], "overlap": 16, "timelapse": True, "estimate_only": True,
                                 "flatfield": True}, ["lapse"]),
    "inline_positions": ({"grid": [2, 3], "overlap": 16,
                          "positions": [[0, 0], [0, 48], [1, 96.5], [48, 0], [48.2, 48], [48, 96]]}, ["tiles"]),
    "estimate_only": ({"grid": [2, 3], "overlap": 16, "estimate_only": True, "flatfield": True,
                       "match_gains": True}, ["tiles"]),
}

POS_COLS = {"y": SHIFT_TOL, "x": SHIFT_TOL}
SEAM_COLS = {"dy": SHIFT_TOL, "dx": SHIFT_TOL, "response": ("rel", RESP_TOL)}


def _check_stitch(env, name, sj, st, params):
    oj, ot, mj, mt = _complete(sj, st)
    _same_files(env, name)
    assert ot["backend"] == oj["backend"]
    _same_csv(oj["positions"], ot["positions"], POS_COLS)
    _same_csv(oj["seams"], ot["seams"], SEAM_COLS)
    for key in oj:
        if key.startswith("mosaic"):
            _same_tiff(oj[key], ot[key], params.get("subpixel") is False)
    return oj, ot


@pytest.mark.parametrize("case", sorted(STITCH))
def test_stitch_mosaic(env, case):
    params, inputs = STITCH[case]
    name = f"stitch_{case}"
    sj, st = _both(env, name, "stitch_mosaic", params, inputs)
    oj, ot = _check_stitch(env, name, sj, st, params)
    if case == "backend_cpu":
        assert ot["backend"] == "cpu"
    if case == "backend_auto":
        assert ot["backend"] == "device"  # the server's device is the CPU


def test_stitch_positions_reuse_chain(env):
    """estimate_only, then a composite at the same positions (the first
    job's output dir, chained through depends_on)."""
    est = {"grid": [2, 3], "overlap": 16, "estimate_only": True}
    sj, st = _both(env, "chain_est", "stitch_mosaic", est, ["tiles"])
    _check_stitch(env, "chain_est", sj, st, est)
    reuse = {"grid": [2, 3], "overlap": 16, "positions": "@dep", "flatfield": True}
    sj, st = _both(env, "chain_reuse", "stitch_mosaic", reuse, ["tiles_c1"], depends_on="chain_est")
    oj, ot = _check_stitch(env, "chain_reuse", sj, st, reuse)
    assert open(ot["seams"]).read().strip() == "i,j,dy,dx,response,used"


def test_stitch_backend_auto_picks_the_host_on_a_card(env):
    """``auto`` keys on the server's device: a card picks the host for <= 16
    seams, as the JAX server does on an accelerator backend."""
    from sequitr_tpu_torch.server.jobs import Job
    from sequitr_tpu_torch.server.pipelines import geometry

    def resolve(params, device):
        job = Job(id="x", module="stitch_mosaic", func="run", params=params, input=[], output="")
        return geometry._resolve_mosaic_backend(job, device)

    card, cpu = torch.device("cuda"), torch.device("cpu")
    assert resolve({"backend": "auto", "grid": [3, 3]}, card) == "cpu"  # 12 seams
    assert resolve({"backend": "auto", "grid": [2, 5]}, card) == "cpu"  # 13 seams
    assert resolve({"backend": "auto", "grid": [4, 3]}, card) == "device"  # 17 seams
    assert resolve({"backend": "auto", "grid": [4, 4]}, card) == "device"  # 24 seams
    assert resolve({"backend": "auto", "grid": [3, 3], "data_parallel": True}, card) == "device"
    assert resolve({"backend": "auto", "grid": [3, 3]}, cpu) == "device"
    assert resolve({"backend": "auto", "grid": "x"}, card) == "device"
    assert resolve({"backend": "cpu", "grid": [9, 9]}, card) == "cpu"


ILLUM = {
    "exp": ({}, ["illum"]),
    "ratio": ({"bleach": "ratio"}, ["illum"]),
    "none": ({"bleach": "none"}, ["illum"]),
    "no_flatfield_ratio": ({"flatfield": False, "bleach": "ratio"}, ["illum"]),
    "order3_sampled": ({"flatfield_order": 3, "sample_frames": 3}, ["illum"]),
    "two_channels": ({"bleach": "ratio"}, ["illum", "illum_c1"]),
    "float_input_roi_range": ({"roi": [2, 3, 38, 45], "frame_range": [1, 7]}, ["illum_f32"]),
    "estimate_only": ({"estimate_only": True}, ["illum"]),
    "estimate_only_ratio": ({"estimate_only": True, "bleach": "ratio"}, ["illum"]),
}


def _check_illum(env, name, sj, st):
    oj, ot, mj, mt = _complete(sj, st)
    _same_files(env, name)
    assert open(ot["gains"]).read() == open(oj["gains"]).read()
    _same_tiff(oj["shading"], ot["shading"], True)
    for key in oj:
        if key.startswith("corrected"):
            _same_tiff(oj[key], ot[key], True)
    assert st.get("warnings") == sj.get("warnings")


@pytest.mark.parametrize("case", sorted(ILLUM))
def test_correct_illumination(env, case):
    params, inputs = ILLUM[case]
    name = f"illum_{case}"
    sj, st = _both(env, name, "correct_illumination", params, inputs)
    _check_illum(env, name, sj, st)


def test_illumination_shading_reuse_chain(env):
    cal = {"estimate_only": True, "bleach": "none"}
    sj, st = _both(env, "illum_cal", "correct_illumination", cal, ["illum"])
    _check_illum(env, "illum_cal", sj, st)
    apply = {"shading": "@dep", "bleach": "exp"}
    sj, st = _both(env, "illum_apply", "correct_illumination", apply, ["illum"], depends_on="illum_cal")
    _check_illum(env, "illum_apply", sj, st)


ERRORS = {
    # register_stack
    "reg_mode": ("register_stack", {"mode": "sideways"}, ["stack"]),
    "reg_refine": ("register_stack", {"refine": 0}, ["stack"]),
    "reg_min_response_text": ("register_stack", {"min_response": "x"}, ["stack"]),
    "reg_min_response_negative": ("register_stack", {"min_response": -1}, ["stack"]),
    "reg_dims3_dp": ("register_stack", {"dims": 3, "data_parallel": True}, ["vols"]),
    "reg_dims3_roi": ("register_stack", {"dims": 3, "estimate_roi": [0, 0, 8, 8]}, ["vols"]),
    "reg_dims3_batch": ("register_stack", {"dims": 3, "frame_batch": 2}, ["vols"]),
    "reg_dims4": ("register_stack", {"dims": 4}, ["stack"]),
    "reg_roi": ("register_stack", {"roi": [0, 0, 8, 8]}, ["stack"]),
    "reg_dp_previous": ("register_stack", {"data_parallel": True}, ["stack"]),
    "reg_batch_text": ("register_stack", {"mode": "first", "frame_batch": "x"}, ["stack"]),
    "reg_batch_zero": ("register_stack", {"mode": "first", "frame_batch": 0}, ["stack"]),
    "reg_batch_previous": ("register_stack", {"frame_batch": 2}, ["stack"]),
    "reg_align_one_channel": ("register_stack", {"align_channels": True}, ["stack"]),
    "reg_one_timepoint": ("register_stack", {"dims": 3}, ["one_vol"]),
    "reg_bad_roi": ("register_stack", {"estimate_roi": [0, 0, 80, 80]}, ["stack"]),
    "reg_estimate_roi_shape": ("register_stack", {"estimate_roi": [1, 2]}, ["stack"]),
    "reg_align_min_response": ("register_stack", {"align_channels": True, "min_response": 1e6}, ["stack", "chan1"]),
    "reg_missing_input": ("register_stack", {}, ["/nonexistent/stack.tif"]),
    "reg_bad_z": ("register_stack", {"dims": 3, "z": "x"}, ["vols_z"]),
    # stitch_mosaic
    "st_no_grid": ("stitch_mosaic", {}, ["tiles"]),
    "st_grid_short": ("stitch_mosaic", {"grid": [2]}, ["tiles"]),
    "st_grid_bool": ("stitch_mosaic", {"grid": [True, 2]}, ["tiles"]),
    "st_order": ("stitch_mosaic", {"grid": [2, 3], "order": "spiral"}, ["tiles"]),
    "st_overlap_small": ("stitch_mosaic", {"grid": [2, 3], "overlap": 2}, ["tiles"]),
    "st_overlap_text": ("stitch_mosaic", {"grid": [2, 3], "overlap": "big"}, ["tiles"]),
    "st_refine": ("stitch_mosaic", {"grid": [2, 3], "refine": 0}, ["tiles"]),
    "st_min_response": ("stitch_mosaic", {"grid": [2, 3], "min_response": "x"}, ["tiles"]),
    "st_tile_count": ("stitch_mosaic", {"grid": [3, 2]}, ["tiles_short"]),
    "st_backend": ("stitch_mosaic", {"grid": [2, 3], "backend": "gpu"}, ["tiles"]),
    "st_backend_cpu_dp": ("stitch_mosaic", {"grid": [2, 3], "backend": "cpu", "data_parallel": True}, ["tiles"]),
    "st_flatfield_order": ("stitch_mosaic", {"grid": [2, 3], "overlap": 16, "flatfield": 7}, ["tiles"]),
    "st_flatfield_text": ("stitch_mosaic", {"grid": [2, 3], "overlap": 16, "flatfield": "yes"}, ["tiles"]),
    "st_channel_mismatch": ("stitch_mosaic", {"grid": [2, 3], "overlap": 16}, ["tiles", "tiles_short"]),
    "st_timelapse_count": ("stitch_mosaic", {"grid": [3, 3], "overlap": 16, "timelapse": True}, ["lapse"]),
    "st_positions_missing": ("stitch_mosaic", {"grid": [2, 3], "overlap": 16,
                                               "positions": "/nonexistent/positions.csv"}, ["tiles"]),
    "st_positions_count": ("stitch_mosaic", {"grid": [2, 3], "overlap": 16, "positions": [[0, 0]]}, ["tiles"]),
    "st_positions_type": ("stitch_mosaic", {"grid": [2, 3], "overlap": 16, "positions": 7}, ["tiles"]),
    "st_positions_ragged": ("stitch_mosaic", {"grid": [2, 3], "overlap": 16, "positions": [[0, 0], [1]]}, ["tiles"]),
    "st_positions_nan": ("stitch_mosaic", {"grid": [2, 3], "overlap": 16,
                                           "positions": [[0, 0]] * 5 + [[None, 1]]}, ["tiles"]),
    # correct_illumination
    "il_bleach": ("correct_illumination", {"bleach": "linear"}, ["illum"]),
    "il_dims3": ("correct_illumination", {"dims": 3}, ["illum"]),
    "il_sample": ("correct_illumination", {"sample_frames": 1}, ["illum"]),
    "il_order": ("correct_illumination", {"flatfield_order": 9}, ["illum"]),
    "il_shading_off": ("correct_illumination", {"shading": "x.tif", "flatfield": False}, ["illum"]),
    "il_shading_missing": ("correct_illumination", {"shading": "/nonexistent/shading.tif"}, ["illum"]),
    "il_shading_shape": ("correct_illumination", {"shading": "stack"}, ["illum"]),
    "il_shading_nonpositive": ("correct_illumination", {"shading": "zeros"}, ["illum"]),
    "il_missing_input": ("correct_illumination", {}, ["/nonexistent/illum.tif"]),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_job_errors(env, case):
    module, params, inputs = ERRORS[case]
    if params.get("shading") in ("stack", "zeros"):
        if "zeros" not in env:
            env["zeros"] = str(env["tmp"] / "zeros.tif")
            tiff.write_stack(env["zeros"], np.zeros((40, 48), np.float32))
        params = dict(params, shading=env[params["shading"]])
    _same_errors(env, case, module, params, inputs)


@pytest.mark.parametrize("module,params", [
    ("register_stack", {"mode": "first", "data_parallel": True}),
    ("stitch_mosaic", {"grid": [2, 3], "overlap": 16, "data_parallel": True}),
])
def test_data_parallel_on_two_devices_equals_single_device(env, module, params):
    """On a pool of two devices (``parallel.virtual_devices(2)``) the job
    takes its data-parallel path (frames, or seam pairs, split over the
    devices) and writes the single-device outputs: the shifts, positions
    and seams within the JAX comparisons' bars, the images within
    ``PIXEL_TOL``, the metrics equal but ``n_devices`` (the stitch reports
    the pool it sharded over)."""
    from sequitr_tpu_torch import parallel

    inputs = ["stack" if module == "register_stack" else "tiles"]
    one = _serve(env, "torch", f"dp1_{module}", module, params, inputs)
    with parallel.virtual_devices(2):
        two = _serve(env, "torch", f"dp2_{module}", module, params, inputs)
    assert one["state"] == two["state"] == "complete", (one.get("error"), two.get("error"))
    o1, o2 = one["outputs"], two["outputs"]
    assert set(o2) == set(o1)
    m1, m2 = json.loads(o1["metrics"]), json.loads(o2["metrics"])
    if module == "stitch_mosaic":
        assert m2.pop("n_devices") == 2 and "n_devices" not in m1
        _same_csv(o1["positions"], o2["positions"], POS_COLS)
        _same_csv(o1["seams"], o2["seams"], SEAM_COLS)
    else:
        _same_csv(o1["shifts"], o2["shifts"], SHIFT_COLS)
    _same_metrics(m1, m2)
    for key in o1:
        if key.startswith(("registered", "mosaic")) and not os.path.isdir(o1[key]):
            _same_tiff(o1[key], o2[key], False)
