"""``localize_emitters`` (2D, ``dims: 3``, astigmatic), ``calibrate_astigmatism``
and ``deconvolve`` through the JAX ``ImageServer`` and the port's
``ImageServer(device="cpu")`` on the same job JSON, mirroring
``tests/test_server_optics.py``; then the three emitter meters against
the JAX meters.

Both servers must write the same files, output keys, CSV columns and
metrics keys, and the same rows of ``emitters.csv`` in the same order
(brightest first within a frame). Values: the goldens' bars (atol 1e-4,
rtol 1e-5) plus one unit of the CSV's last digit (``%.4f``); the
calibration's coefficients at rtol 1e-5; ``deconvolved*.tif`` at
``RL_REL`` of the frame's largest value (two CPU FFT libraries under
Richardson-Lucy's iterations, measured in ``test_torch_psf.py``). Every
JobError carries the JAX server's text (job ids masked); timing metrics
are compared by key only. ``data_parallel`` is served single-device and
equal to streaming.
"""

import json
import os
import re
import time

import numpy as np
import pytest
import torch

from sequitr_tpu import fidelity as jax_fidelity
from sequitr_tpu.config import ServerConfiguration as JaxConfig
from sequitr_tpu.server import ImageServer as JaxServer
from sequitr_tpu.server import submit_job as jax_submit
from sequitr_tpu_torch import fidelity as torch_fidelity
from sequitr_tpu_torch import psf as torch_psf
from sequitr_tpu_torch.config import ServerConfiguration as TorchConfig
from sequitr_tpu_torch.data import tiff
from sequitr_tpu_torch.server import ImageServer as TorchServer
from sequitr_tpu_torch.server import submit_job as torch_submit

ATOL, RTOL = 1e-4, 1e-5  # tests/test_goldens.py's localization bars
CSV_UNIT = 1e-4  # the CSV's %.4f
RL_REL = 2e-6  # deconvolved frames, relative to the item's largest value (test_torch_psf.py: <= 8.3e-7 measured)
TIMING = re.compile(r"(_s|_per_sec)$")
CALIB = {"qx": [1.05625e-05, -0.0063375, 2.640625], "qy": [1.05625e-05, 0.0063375, 2.640625],
         "z_range": [-600.0, 600.0]}  # the analytic curve of _astig_widths


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _astig_widths(z):
    sx = 1.3 * np.sqrt(1.0 + ((z - 300.0) / 400.0) ** 2)
    sy = 1.3 * np.sqrt(1.0 + ((z + 300.0) / 400.0) ** 2)
    return sy, sx


def _astig_frame(truth, shape=(64, 64), seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    frame = np.full(shape, 20.0)
    for cz, cy, cx in truth:
        sy, sx = _astig_widths(cz)
        frame += 3000.0 / (2 * np.pi * sx * sy) * np.exp(
            -((yy - cy) ** 2) / (2 * sy**2) - ((xx - cx) ** 2) / (2 * sx**2)
        )
    return (frame + rng.normal(0, 0.2, shape)).astype(np.float32)


def _emitter_volume(truth, shape=(13, 40, 40), seed=0):
    rng = np.random.default_rng(seed)
    zz, yy, xx = np.mgrid[: shape[0], : shape[1], : shape[2]]
    vol = np.full(shape, 20.0)
    for cz, cy, cx in truth:
        vol += 300.0 * np.exp(
            -((zz - cz) ** 2) / (2 * 1.4**2) - ((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 1.4**2)
        )
    return (vol + rng.normal(0, 0.5, shape)).astype(np.float32)


def _spots(n_t, shape, centres, seed, amp=80.0):
    rng = np.random.default_rng(seed)
    frames = rng.normal(10.0, 0.5, (n_t,) + shape).astype(np.float32)
    yy, xx = np.mgrid[: shape[0], : shape[1]]
    for t in range(n_t):
        for cy, cx in centres(t):
            frames[t] += amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 1.5**2))
    return frames


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("optics")

    def write(name, arr):
        path = str(tmp / name)
        tiff.write_stack(path, arr)
        return path

    def write_dir(name, arrs):
        d = tmp / name
        d.mkdir()
        for i, a in enumerate(arrs):
            tiff.write_stack(str(d / f"{name}_t{i:02d}.tif"), a)
        return str(d)

    truth = [(12.3, 40.6), (33.8, 15.2), (50.1, 50.9)]
    em = _spots(2, (64, 64), lambda t: truth, 0)
    bt = _spots(2, (32, 32), lambda t: [(15.5, 20.2)], 1)
    dp = _spots(11, (48, 48), lambda t: [(12.3 + t * 0.1, 30.6), (35.8, 15.2 - t * 0.1)], 7)
    truth_t = [[(4.3, 12.6, 25.1), (8.8, 30.2, 10.4)], [(5.1, 13.0, 25.5), (8.5, 29.8, 10.0)]]
    vols = [_emitter_volume(tr, seed=t) for t, tr in enumerate(truth_t)]
    dp_vols = [
        _emitter_volume([(4.0 + 0.2 * t, 12.0 + 0.5 * t, 25.0), (8.0, 30.0, 10.0 + 0.3 * t)], seed=100 + t)
        for t in range(5)
    ]
    zs = np.linspace(-600, 600, 17)
    scan = np.stack([_astig_frame([(z, 15.7, 16.2)], (32, 32), seed=9) for z in zs])
    astig_truth = [(250.0, 20.5, 40.2), (-380.0, 45.1, 18.7)]
    smlm = [(-160.0 + 80.0 * t, 20.0 + 1.0 * t, 32.0) for t in range(5)]
    rng = np.random.default_rng(8)
    return dict(
        tmp=tmp, truth=truth, truth_t=truth_t, astig_truth=astig_truth, smlm_truth=smlm,
        em=write("em.tif", em),
        em_u16=write("em_u16.tif", np.round(em * 10).astype(np.uint16)),
        bt=write("bt.tif", bt),
        dp=write("dp.tif", dp),
        vols=write_dir("vols", vols),
        vols_z=write("vols_z.tif", np.concatenate(vols)),
        dp_vols=write_dir("dp_vols", dp_vols),
        beads=write("beads.tif", scan),
        astig=write("astig.tif", _astig_frame(astig_truth)[None]),
        astig_dp=write("astig_dp.tif", np.stack([
            _astig_frame([(250.0 - 40 * t, 20.5, 40.2), (-380.0 + 30 * t, 45.1, 18.7)], seed=50 + t)
            for t in range(5)
        ])),
        smlm=write("smlm.tif", np.stack([_astig_frame([smlm[t]], seed=20 + t) for t in range(5)])),
        zeros3=write("zeros3.tif", np.zeros((3, 16, 16), np.float32)),
        zeros2=write("zeros2.tif", np.zeros((2, 16, 16), np.float32)),
        zeros5=write("zeros5.tif", np.zeros((5, 16, 16), np.float32)),
        zeros4=write("zeros4.tif", np.zeros((4, 16, 16), np.float32)),
        zeros4b=write("zeros4b.tif", np.zeros((4, 16, 16), np.float32)),
        frame16=write("frame16.tif", np.zeros((1, 16, 16), np.float32)),
        gamma=write("gamma.tif", rng.gamma(2.0, 50.0, (11, 24, 24)).astype(np.float32)),
        mc0=write("mc0.tif", rng.gamma(2.0, 50.0, (5, 24, 24)).astype(np.float32)),
        mc1=write("mc1.tif", rng.gamma(2.0, 80.0, (5, 24, 24)).astype(np.float32)),
        bad_cal=_bad_calibration(tmp),
    )


def _bad_calibration(tmp):
    path = str(tmp / "bad_cal.json")
    with open(path, "w") as f:
        json.dump({"qx": 1, "qy": [0, 0, 1], "z_range": [-1, 1]}, f)
    return path


def _spec(env, which, name, module, params, inputs, depends_on=None):
    tmp = env["tmp"]
    spec = {"module": module, "params": dict(params), "input": [env.get(k, k) for k in inputs],
            "output": str(tmp / f"{which}_{name}")}
    if depends_on is not None:
        dep = str(tmp / f"{which}_{depends_on}")
        spec["depends_on"] = [dep]
        spec["params"] = {k: (dep if v == "@dep" else v) for k, v in params.items()}
    return spec


def _server(env, which):
    tmp = env["tmp"]
    jobs = str(tmp / f"{which}_jobs")
    if which == "jax":
        return JaxServer(JaxConfig(jobs_dir=jobs, models_dir=str(tmp / "models"), compilation_cache_dir=None))
    return TorchServer(TorchConfig(jobs_dir=jobs, models_dir=str(tmp / "models"), device="cpu"))


def _serve(env, which, name, module, params, inputs, depends_on=None):
    srv = _server(env, which)
    spec = _spec(env, which, name, module, params, inputs, depends_on)
    (jax_submit if which == "jax" else torch_submit)(srv.config.jobs_dir, spec)
    assert srv.poll_once()
    with open(os.path.join(spec["output"], "status.json")) as f:
        return json.load(f)


def _both(env, name, module, params, inputs, depends_on=None):
    return tuple(_serve(env, w, name, module, params, inputs, depends_on) for w in ("jax", "torch"))


def _job_error(status):
    assert status["state"] == "failed", status
    last = status["error"].strip().splitlines()[-1]
    assert "JobError: " in last, last
    return re.sub(r"job [0-9a-f-]+:", "job ID:", last.split("JobError: ", 1)[1])


def _csv(path):
    with open(path) as f:
        lines = f.read().strip().split("\n")
    return lines[0], np.asarray([[float(v) for v in r.split(",")] for r in lines[1:]]).reshape(-1, lines[0].count(",") + 1)


def _same_csv(sj, st):
    """Same header, same rows in the same order; values within the golden
    bars plus one CSV unit."""
    hj, rj = _csv(sj["outputs"]["emitters"])
    ht, rt = _csv(st["outputs"]["emitters"])
    assert ht == hj
    assert rt.shape == rj.shape
    np.testing.assert_array_equal(rt[:, 0], rj[:, 0])
    np.testing.assert_allclose(rt, rj, atol=ATOL + CSV_UNIT, rtol=RTOL)
    return ht, rt


def _same_outputs(sj, st):
    assert st["state"] == "complete", st.get("error")
    assert sj["state"] == "complete", sj.get("error")
    assert set(st["outputs"]) == set(sj["outputs"])
    for k in ("n_emitters", "n_frames"):
        if k in sj["outputs"]:
            assert st["outputs"][k] == sj["outputs"][k]


def _same_h5(a, b, atol=ATOL):
    import h5py

    with h5py.File(a) as fa, h5py.File(b) as fb:
        np.testing.assert_allclose(fa["objects/obj_type_1/coords"][:], fb["objects/obj_type_1/coords"][:],
                                   atol=atol, rtol=RTOL)
        np.testing.assert_array_equal(fa["objects/obj_type_1/map"][:], fb["objects/obj_type_1/map"][:])


def _same_metrics(sj, st):
    mj, mt = json.loads(sj["outputs"]["metrics"]), json.loads(st["outputs"]["metrics"])
    assert set(mt) == set(mj), (sorted(mt), sorted(mj))
    for k, a in mj.items():
        if not TIMING.search(k):
            assert k in ("roundtrip_z_rmse", "roundtrip_z_rmse_frac") or mt[k] == a, (k, mt[k], a)
    return mj, mt


# -- localize_emitters ------------------------------------------------------


@pytest.mark.parametrize("inp", ["em", "em_u16"])
def test_localize_emitters_job(env, inp):
    params = {"threshold_sigmas": 8, "sigma": 1.5}
    sj, st = _both(env, f"em_{inp}", "localize_emitters", params, [inp])
    _same_outputs(sj, st)
    assert int(st["outputs"]["n_emitters"]) == 6  # 3 per frame
    hdr, rows = _same_csv(sj, st)
    assert hdr == "t,y,x,amplitude,background"
    for t, y, x, a, b in rows:
        assert min(abs(y - cy) + abs(x - cx) for cy, cx in env["truth"]) < 0.2


def test_emitters_btrack_output(env):
    sj, st = _both(env, "bt", "localize_emitters", {"threshold_sigmas": 8, "btrack": True}, ["bt"])
    _same_outputs(sj, st)
    _same_csv(sj, st)
    _same_h5(st["outputs"]["objects"], sj["outputs"]["objects"])
    import h5py

    with h5py.File(st["outputs"]["objects"]) as f:
        coords = f["objects/obj_type_1/coords"][:]
    assert coords.shape == (2, 5)
    np.testing.assert_allclose(coords[:, 2], 15.5, atol=0.1)
    np.testing.assert_allclose(coords[:, 1], 20.2, atol=0.1)


@pytest.mark.parametrize("inp,extra", [("vols", {}), ("vols_z", {"z": 13})])
def test_localize_emitters_3d_volume_timelapse(env, inp, extra):
    params = {"dims": 3, "threshold": 100, "btrack": True, "sigma": 1.4, "sigma_z": 1.4, "z_scale": 2.0, **extra}
    sj, st = _both(env, f"em3d_{inp}", "localize_emitters", params, [inp])
    _same_outputs(sj, st)
    assert int(st["outputs"]["n_emitters"]) == 4
    hdr, rows = _same_csv(sj, st)
    assert hdr == "t,z,y,x,amplitude,background"
    for t, z, y, x, a, b in rows:
        assert min(abs(z - cz) + abs(y - cy) + abs(x - cx) for cz, cy, cx in env["truth_t"][int(t)]) < 0.3
    _same_h5(st["outputs"]["objects"], sj["outputs"]["objects"])


def _chain(env, which, name, loc_params, frames):
    """calibrate_astigmatism -> localize_emitters (``astigmatism`` at the
    calibration job's output dir, chained by ``depends_on``) on one server."""
    srv = _server(env, which)
    submit = jax_submit if which == "jax" else torch_submit
    cal = _spec(env, which, f"{name}_cal", "calibrate_astigmatism", {"z_start": -600.0, "z_step": 75.0}, ["beads"])
    submit(srv.config.jobs_dir, cal, job_id="cal")
    loc = _spec(env, which, f"{name}_loc", "localize_emitters", dict(loc_params, astigmatism="@dep"), [frames],
                depends_on=f"{name}_cal")
    submit(srv.config.jobs_dir, loc, job_id="loc")
    deadline = time.time() + 120
    while time.time() < deadline and not os.path.exists(os.path.join(loc["output"], "status.json")):
        srv.poll_once()
    out = []
    for spec in (cal, loc):
        with open(os.path.join(spec["output"], "status.json")) as f:
            out.append(json.load(f))
    return out


def test_calibrate_then_localize_astig_chain(env):
    (cj, lj), (ct, lt) = (_chain(env, w, "chain", {"threshold": 40, "btrack": True}, "astig") for w in ("jax", "torch"))
    _same_outputs(cj, ct)
    mj, mt = _same_metrics(cj, ct)
    assert mt["roundtrip_z_rmse_frac"] < 0.02
    assert abs(mt["roundtrip_z_rmse"] - mj["roundtrip_z_rmse"]) < 1e-2
    with open(ct["outputs"]["calibration"]) as f:
        calt = json.load(f)
    with open(cj["outputs"]["calibration"]) as f:
        calj = json.load(f)
    assert set(calt) == set(calj) == {"qx", "qy", "z_range", "window"}
    for k in ("qx", "qy"):
        np.testing.assert_allclose(calt[k], calj[k], rtol=1e-5, atol=1e-12)
    assert calt["z_range"] == calj["z_range"] and calt["window"] == calj["window"]
    _same_outputs(lj, lt)
    assert any("z_scale" in w for w in lt.get("warnings", []))
    hdr, rows = _same_csv(lj, lt)
    assert hdr == "t,z,y,x,sigma_y,sigma_x,amplitude,background"
    assert len(rows) == 2
    for cz, cy, cx in env["astig_truth"]:
        r = min(rows, key=lambda g: abs(g[2] - cy) + abs(g[3] - cx))
        assert abs(r[2] - cy) < 0.1 and abs(r[3] - cx) < 0.1
        assert abs(r[1] - cz) < 25.0
    _same_h5(lt["outputs"]["objects"], lj["outputs"]["objects"], atol=1e-2)


def test_calibration_json_round_trips_between_packages(env, tmp_path):
    """A calibration the JAX package writes is read unchanged by the
    port, and the port's file by the JAX package."""
    from sequitr_tpu import psf as jax_psf

    calib = jax_psf.AstigCalibration(qx=(1e-6, -0.005, 2.7), qy=(1e-6, 0.005, 2.7), z_range=(-600.0, 600.0), window=13)
    p = str(tmp_path / "cal.json")
    calib.to_json(p)
    back = torch_psf.AstigCalibration.from_json(p)
    assert dataclass_tuple(back) == dataclass_tuple(calib)
    q = str(tmp_path / "cal_torch.json")
    back.to_json(q)
    assert jax_psf.AstigCalibration.from_json(q) == calib
    with open(p) as f, open(q) as g:
        assert f.read() == g.read()


def dataclass_tuple(c):
    return (c.qx, c.qy, c.z_range, c.window)


def test_localize_data_parallel_matches_streaming(env):
    outs = {}
    for name, extra in (("stream", {}), ("dp", {"data_parallel": True})):
        outs[name] = _serve(env, "torch", f"dp_{name}", "localize_emitters",
                            {"threshold_sigmas": 8, "btrack": True, **extra}, ["dp"])
        assert outs[name]["state"] == "complete", outs[name].get("error")
    assert "n_devices" not in outs["dp"]["outputs"]  # one device: served single-device
    a, b = (open(outs[k]["outputs"]["emitters"]).read() for k in ("dp", "stream"))
    assert a == b
    _same_h5(outs["dp"]["outputs"]["objects"], outs["stream"]["outputs"]["objects"], atol=0)
    sj = _serve(env, "jax", "dp_stream", "localize_emitters", {"threshold_sigmas": 8, "btrack": True}, ["dp"])
    _same_csv(sj, outs["stream"])


def test_smlm_workflow_chain(env):
    """calibrate -> astigmatic localize (z_scale-consistent btrack units)
    on the port; its objects.h5 feeds the JAX server's track_objects and
    the port's, which must both link one track whose z trend matches
    truth, into the same tracks.csv."""
    z_scale = 0.01
    _, loc = _chain(env, "torch", "smlm", {"threshold": 40, "btrack": True, "z_scale": z_scale}, "smlm")
    assert loc["state"] == "complete", loc.get("error")
    assert not any("z_scale" in w for w in loc.get("warnings", []))
    _, loc_j = _chain(env, "jax", "smlm", {"threshold": 40, "btrack": True, "z_scale": z_scale}, "smlm")
    _same_csv(loc_j, loc)
    _same_h5(loc["outputs"]["objects"], loc_j["outputs"]["objects"], atol=1e-3)
    st = _serve(env, "jax", "smlm_trk", "track_objects", {"max_distance": 5}, [loc["outputs"]["objects"]])
    assert st["state"] == "complete", st.get("error")
    st_t = _serve(env, "torch", "smlm_trk", "track_objects", {"max_distance": 5}, [loc["outputs"]["objects"]])
    assert st_t["state"] == "complete", st_t.get("error")
    assert open(st_t["outputs"]["tracks"]).read() == open(st["outputs"]["tracks"]).read()
    rows = open(st["outputs"]["tracks"]).read().strip().split("\n")
    hdr = rows[0].split(",")
    data = sorted((dict(zip(hdr, r.split(","))) for r in rows[1:]), key=lambda d: float(d["t"]))
    assert len({d["track_id"] for d in data}) == 1 and len(data) == 5
    ts = [float(d["t"]) for d in data]
    assert abs(np.polyfit(ts, [float(d["z"]) for d in data], 1)[0] - 80.0 * z_scale) < 0.1 * 80.0 * z_scale
    assert abs(np.polyfit(ts, [float(d["y"]) for d in data], 1)[0] - 1.0) < 0.05


def test_localize_corrupt_midstream_fails_fast(env, monkeypatch):
    from sequitr_tpu_torch.data.source import FrameSource

    orig = FrameSource.frame

    def bad(self, i):
        if i == 1:
            raise ValueError("corrupt LZW strip in page 1")
        return orig(self, i)

    monkeypatch.setattr(FrameSource, "frame", bad)
    t0 = time.time()
    st = _serve(env, "torch", "mid", "localize_emitters", {"threshold": 5}, ["zeros3"])
    elapsed = time.time() - t0
    assert st["state"] == "failed"
    assert "corrupt LZW strip" in st["error"]
    assert elapsed < TorchConfig().retry_backoff + 1.0  # no retry burn


def test_localize_3d_data_parallel_matches_streaming(env):
    params = {"dims": 3, "threshold": 100, "sigma": 1.4, "sigma_z": 1.4}
    st = _serve(env, "torch", "dp3d_st", "localize_emitters", params, ["dp_vols"])
    dp = _serve(env, "torch", "dp3d_dp", "localize_emitters", dict(params, data_parallel=True), ["dp_vols"])
    assert open(dp["outputs"]["emitters"]).read() == open(st["outputs"]["emitters"]).read()
    sj = _serve(env, "jax", "dp3d_st", "localize_emitters", params, ["dp_vols"])
    _, rows = _same_csv(sj, st)
    assert rows.shape == (10, 6)


def test_localize_astig_data_parallel_matches_streaming(env):
    params = {"astigmatism": CALIB, "threshold": 40}
    st = _serve(env, "torch", "dpa_st", "localize_emitters", params, ["astig_dp"])
    dp = _serve(env, "torch", "dpa_dp", "localize_emitters", dict(params, data_parallel=True), ["astig_dp"])
    assert open(dp["outputs"]["emitters"]).read() == open(st["outputs"]["emitters"]).read()
    sj = _serve(env, "jax", "dpa_st", "localize_emitters", params, ["astig_dp"])
    hdr, rows = _same_csv(sj, st)
    assert hdr == "t,z,y,x,sigma_y,sigma_x,amplitude,background" and rows.shape == (10, 8)


def test_astig_btrack_without_z_scale_warns(env):
    frame = str(env["tmp"] / "aw.tif")
    tiff.write_stack(frame, _astig_frame([(100.0, 30.0, 30.0)]))
    sj, st = _both(env, "aw", "localize_emitters", {"astigmatism": CALIB, "threshold": 40, "btrack": True}, [frame])
    _same_outputs(sj, st)
    assert st.get("warnings") == sj.get("warnings")
    assert any("z_scale" in w for w in st["warnings"])
    _same_csv(sj, st)
    s2 = _serve(env, "torch", "aw2", "localize_emitters",
                {"astigmatism": CALIB, "threshold": 40, "btrack": True, "z_scale": 0.01}, [frame])
    assert s2["state"] == "complete" and not any("z_scale" in w for w in s2.get("warnings") or [])


# -- JobErrors: every message the JAX server's ------------------------------

ERRORS = {
    "astig_bad_json": ("localize_emitters", {"astigmatism": "@bad_cal", "threshold": 5}, ["frame16"]),
    "astig_bad_dict": ("localize_emitters", {"astigmatism": {"qx": [1, 2], "qy": [1, 2, 3], "z_range": [0, 1]}},
                       ["frame16"]),
    "astig_missing": ("localize_emitters", {"astigmatism": "/nonexistent/cal.json"}, ["frame16"]),
    "astig_type": ("localize_emitters", {"astigmatism": 3}, ["frame16"]),
    "astig_dims3": ("localize_emitters", {"dims": 3, "astigmatism": {"qx": [0, 0, 1], "qy": [0, 0, 1],
                                                                     "z_range": [-1, 1]}}, ["zeros2"]),
    "roi_dims3": ("localize_emitters", {"dims": 3, "roi": [0, 0, 8, 8]}, ["zeros2"]),
    "dims4": ("localize_emitters", {"dims": 4}, ["zeros2"]),
    "cal_missing_z": ("calibrate_astigmatism", {}, ["zeros5"]),
    "cal_bad_z": ("calibrate_astigmatism", {"z_positions": ["a", 1]}, ["zeros5"]),
    "cal_z_step0": ("calibrate_astigmatism", {"z_step": 0}, ["zeros5"]),
    "cal_2d": ("calibrate_astigmatism", {"z_step": 1}, ["frame16"]),
    "cal_no_bead": ("calibrate_astigmatism", {"z_step": 1}, ["zeros5"]),
    "cal_few_planes": ("calibrate_astigmatism", {"z_step": 1}, ["zeros3"]),
    "dc_iterations": ("deconvolve", {"iterations": 0}, ["frame16"]),
    "dc_dp_volume": ("deconvolve", {"dims": 3, "data_parallel": True}, ["zeros4"]),
    "dc_volume_multi": ("deconvolve", {"dims": 3}, ["zeros4", "zeros4b"]),
    "dc_roi_dims3": ("deconvolve", {"dims": 3, "roi": [0, 0, 8, 8]}, ["zeros4"]),
    "dc_frame_range_volume": ("deconvolve", {"dims": 3, "frame_range": [0, 2]}, ["zeros4"]),
    "dc_bad_z": ("deconvolve", {"dims": 3, "z": "x"}, ["zeros4"]),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_job_errors_match_jax(env, case):
    module, params, inputs = ERRORS[case]
    params = {k: (env["bad_cal"] if v == "@bad_cal" else v) for k, v in params.items()}
    t0 = time.time()
    sj, st = _both(env, f"err_{case}", module, params, inputs)
    assert _job_error(st) == _job_error(sj)
    assert time.time() - t0 < 2 * TorchConfig().retry_backoff + 30.0  # no retry burn


# -- deconvolve --------------------------------------------------------------


def _same_tif(a, b, rel=RL_REL, volume=False):
    """Frames (or a volume, ``volume``) within ``rel`` of each item's
    largest value."""
    x, y = np.asarray(tiff.read_stack(a)), np.asarray(tiff.read_stack(b))
    assert x.dtype == y.dtype == np.float32 and x.shape == y.shape
    scale = np.abs(y).max() if volume else np.abs(y).reshape(y.shape[0], -1).max(axis=1)[:, None, None]
    assert float((np.abs(x - y) / scale).max()) <= rel
    return x, y


def test_deconvolve_sharpens_blurred_points(env):
    from sequitr_tpu import psf as jax_psf

    clean = np.zeros((2, 48, 48), np.float32)
    clean[0, 16, 20] = 100.0
    clean[1, 30, 10] = 80.0
    kernel = np.asarray(jax_psf.gaussian_psf_2d(9, 1.5))
    blurred = np.stack([np.asarray(jax_psf.psf_convolve(f, kernel)) for f in clean]).astype(np.float32)
    path = str(env["tmp"] / "blur.tif")
    tiff.write_stack(path, blurred)
    sj, st = _both(env, "dc", "deconvolve", {"iterations": 30, "sigma": 1.5, "psf_size": 9}, [path])
    _same_outputs(sj, st)
    _same_metrics(sj, st)
    got, _ = _same_tif(st["outputs"]["deconvolved"], sj["outputs"]["deconvolved"])
    for t in range(2):
        assert got[t].max() > 2.0 * blurred[t].max()
        assert np.unravel_index(got[t].argmax(), got[t].shape) == np.unravel_index(clean[t].argmax(), clean[t].shape)


def test_deconvolve_3d_volume(env):
    vol = np.zeros((8, 16, 16), np.float32)
    vol[4, 8, 8] = 50.0
    path = str(env["tmp"] / "v.tif")
    tiff.write_stack(path, vol)
    params = {"dims": 3, "iterations": 5, "sigma": 1.0, "psf_size": 5, "psf_size_z": 3, "sigma_z": 1.0}
    sj, st = _both(env, "dc3", "deconvolve", params, [path])
    _same_outputs(sj, st)
    _same_metrics(sj, st)
    got, _ = _same_tif(st["outputs"]["deconvolved"], sj["outputs"]["deconvolved"], volume=True)
    assert got.shape == (8, 16, 16) and np.isfinite(got).all()


def test_deconvolve_3d_timelapse(env):
    d = env["tmp"] / "dc_vols"
    d.mkdir()
    for t in range(3):
        v = np.zeros((8, 16, 16), np.float32)
        v[4, 6 + 2 * t, 8] = 50.0
        tiff.write_stack(str(d / f"t_{t}.tif"), v)
    params = {"dims": 3, "iterations": 5, "sigma": 1.0, "psf_size": 5, "psf_size_z": 3, "sigma_z": 1.0}
    sj, st = _both(env, "dct", "deconvolve", dict(params, frame_range=[1, 3]), [str(d)])
    _same_outputs(sj, st)
    _same_metrics(sj, st)
    out = st["outputs"]["deconvolved"]
    names = sorted(n for n in os.listdir(out) if n.startswith("deconvolved_t"))
    assert names == ["deconvolved_t0001.tif", "deconvolved_t0002.tif"]
    assert names == sorted(n for n in os.listdir(sj["outputs"]["deconvolved"]) if n.startswith("deconvolved_t"))
    for n in names:
        _same_tif(os.path.join(out, n), os.path.join(sj["outputs"]["deconvolved"], n), volume=True)
    single = _serve(env, "torch", "dc1", "deconvolve", params, [str(d / "t_1.tif")])
    np.testing.assert_array_equal(
        tiff.read_stack(os.path.join(out, "deconvolved_t0001.tif")), tiff.read_stack(single["outputs"]["deconvolved"])
    )


def test_deconvolve_dp_matches_streaming(env):
    outs = {}
    for name, extra in (("st", {}), ("dp", {"data_parallel": True})):
        outs[name] = _serve(env, "torch", f"dpd_{name}", "deconvolve", {"iterations": 4, "sigma": 1.2, **extra},
                            ["gamma"])
        assert outs[name]["state"] == "complete", outs[name].get("error")
    assert "n_devices" not in json.loads(outs["dp"]["outputs"]["metrics"])
    a, b = (np.asarray(tiff.read_stack(outs[k]["outputs"]["deconvolved"])) for k in ("dp", "st"))
    assert a.shape == (11, 24, 24)
    np.testing.assert_array_equal(a, b)
    sj = _serve(env, "jax", "dpd_st", "deconvolve", {"iterations": 4, "sigma": 1.2}, ["gamma"])
    _same_tif(outs["st"]["outputs"]["deconvolved"], sj["outputs"]["deconvolved"])


def test_deconvolve_per_channel_outputs_match_separate_runs(env):
    params = {"iterations": 3, "sigma": 1.2}
    mj, mt = _both(env, "mc_both", "deconvolve", params, ["mc0", "mc1"])
    _same_outputs(mj, mt)
    s0 = _serve(env, "torch", "mc_only0", "deconvolve", params, ["mc0"])
    s1 = _serve(env, "torch", "mc_only1", "deconvolve", params, ["mc1"])
    for k, single in ((0, s0), (1, s1)):
        a = np.asarray(tiff.read_stack(mt["outputs"][f"deconvolved_c{k}"]))
        np.testing.assert_array_equal(a, np.asarray(tiff.read_stack(single["outputs"]["deconvolved"])))
        _same_tif(mt["outputs"][f"deconvolved_c{k}"], mj["outputs"][f"deconvolved_c{k}"])


# -- the meters ---------------------------------------------------------------


@pytest.mark.parametrize("name,kwargs", [
    ("emitter_fidelity", {"n": 2}),
    ("emitter3d_fidelity", {"n": 1, "shape": (16, 128, 128), "n_emitters": 12}),
    ("astig_fidelity", {"n": 2}),
])
def test_emitter_meters_match_jax(name, kwargs):
    want = getattr(jax_fidelity, name)(**kwargs)
    got = getattr(torch_fidelity, name)(device="cpu", **kwargs)
    assert set(got) == set(want)
    for k, v in want.items():
        if k.startswith(("recall", "precision", "n_")):
            assert got[k] == v, (k, got[k], v)
        else:
            assert abs(got[k] - v) <= 1e-4 + 1e-3 * abs(v), (k, got[k], v)
