"""The quantify and interop jobs (``measure_objects``, ``count_spots``,
``measure_tracks``, ``track_objects``, ``export_ctc``, ``qc_stack``,
``project_stack``) through the JAX ``ImageServer`` and the port's
``ImageServer(device="cpu")`` on the same job JSON: the job cases of
``tests/test_measure.py``, ``tests/test_tracking.py``
(``TestTrackObjectsPipeline``, ``TestObjectsValidation``),
``tests/test_ctc_export.py``, ``tests/test_qc.py`` (the pipeline classes)
and ``tests/test_projection.py`` (``TestProjectStackPipeline``), each on
its own inputs.

Both servers must write the same files, output keys, metrics keys and
values (timings by key only) and warnings. The host jobs' CSVs, LBEP
tables and TIFFs are byte-equal. ``project_stack``'s outputs are equal
(selection methods in the input dtype, ``sum``/``mean``/``std``/
``median`` and the EDoF height map bit for bit), the EDoF blend at
``BLEND_RTOL``. ``qc.csv`` / ``qc_volumes.csv``: identical text except
the whole-frame reductions (``focus_vol``, ``tenengrad``, ``mean``,
``std``), held at ``QC_CSV_RTOL``; p01/p99/sat_frac, ``best_z`` and the
flags are identical. Every JobError carries the JAX server's text (job
ids masked).
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
from sequitr_tpu_torch import localize
from sequitr_tpu_torch.config import ServerConfiguration as TorchConfig
from sequitr_tpu_torch.data import tiff
from sequitr_tpu_torch.server import ImageServer as TorchServer
from sequitr_tpu_torch.server import submit_job as torch_submit

# qc.csv prints %.6g: a whole-frame sum a few f32 ulps apart (<= 1e-6
# relative, tests/test_torch_qc.py) can move the sixth digit by one unit.
# std is held relative to the plane's mean: its deviations are taken from
# a mean that carries the sum's rounding (a saturated constant plane reads
# 0.554688 in the JAX package and 0 here, 8.5e-6 of its mean 65535)
QC_CSV_RTOL = 2e-5
QC_REDUCED = ("focus_vol", "tenengrad", "mean", "std")
# the EDoF blend's power: XLA's pow against a float64 power rounded once
# (tests/test_torch_projection.py measures it)
BLEND_RTOL = 1e-6
TIMING = re.compile(r"(_s|_per_sec)$")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _blur(img, n):
    for _ in range(n):
        img = (
            img + np.roll(img, 1, 0) + np.roll(img, -1, 0)
            + np.roll(img, 1, 1) + np.roll(img, -1, 1)
        ) / 5.0
    return img


def _scene(rng, size=64, blur=0):
    return _blur(rng.random((size, size)).astype(np.float32) * 100, blur)


def _focus_volume(rng, z=5, size=48, sharp_z=2):
    base = rng.random((size, size)).astype(np.float32) * 100
    return np.stack([base if k == sharp_z else _blur(base, 4) for k in range(z)])


def _table(t, points, label=1):
    pts = np.asarray(points, np.float32).reshape(-1, 2)
    coords = np.zeros((len(pts), 5), np.float32)
    coords[:, 0] = t
    coords[:, 1:3] = pts
    coords[:, 4] = label
    return localize.FrameTable(
        coords=coords, area=np.full(len(pts), 10, np.int32),
        intensity_mean=np.full(len(pts), 1.0, np.float32),
    )


def _fission_tables():
    tabs = [_table(t, [[30, 30 + 2 * t]], label=2 if t == 3 else 1) for t in range(4)]
    for t in range(4, 9):
        d = 3.0 * (t - 3)
        y = 36 + 2 * (t - 3)
        tabs.append(_table(t, [[30 - d, y], [30 + d, y]]))
    return tabs


def _movers(T=6, S=48):
    labels = np.zeros((T, S, S), np.uint16)
    for t in range(T):
        labels[t, 4 + 2 * t:10 + 2 * t, 4:10] = 1
        labels[t, 30:36, 30 + 2 * t:36 + 2 * t] = 1
    return labels


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("quant")
    paths = {}

    def write(name, arr, **kw):
        paths[name] = str(tmp / f"{name}.tif")
        tiff.write_stack(paths[name], arr, **kw)

    def write_dir(name, arrs):
        d = tmp / name
        d.mkdir()
        for t, a in enumerate(arrs):
            tiff.write_stack(str(d / f"t{t:03d}.tif"), a)
        paths[name] = str(d)

    def write_text(name, text):
        paths[name] = str(tmp / name)
        with open(paths[name], "w") as f:
            f.write(text)

    def write_h5(name, tables, n_frames):
        paths[name] = str(tmp / f"{name}.h5")
        localize.export_btrack_h5_tables(paths[name], tables, n_frames=n_frames)

    # measure_objects: two constant-per-object channels
    lab = np.zeros((2, 24, 24), np.uint16)
    lab[0, 2:6, 2:6] = 1
    lab[0, 10:12, 12:18] = 2
    lab[1, 5:9, 5:9] = 1
    c0, c1 = np.zeros((2, 24, 24), np.float32), np.zeros((2, 24, 24), np.float32)
    c0[0, 2:6, 2:6], c0[0, 10:12, 12:18], c0[1, 5:9, 5:9] = 10.0, 20.0, 30.0
    c1[0, 2:6, 2:6], c1[0, 10:12, 12:18], c1[1, 5:9, 5:9] = 1.5, 2.5, 3.5
    write("mo_lab", lab)
    write("mo_c0", c0)
    write("mo_c1", c1)
    write("mo_c0_tall", np.zeros((2, 10, 8), np.float32))
    write("mo_c0_long", np.zeros((3, 24, 24), np.float32))
    # min_area + frame_range
    lab = np.zeros((3, 16, 16), np.uint16)
    lab[:, 4:8, 4:8] = 1
    lab[:, 12:13, 12:13] = 1
    write("ma_lab", lab)
    write("ma_ch", np.full((3, 16, 16), 7.0, np.float32))
    # split_touching
    yy, xx = np.mgrid[0:32, 0:32]
    m1 = (yy - 14) ** 2 + (xx - 12) ** 2 < 36
    m2 = (yy - 14) ** 2 + (xx - 21) ** 2 < 36
    write("st_lab", (m1 | m2).astype(np.uint16)[None])
    write("st_ch", (np.where(m1, 10.0, 0.0) + np.where(m2, 30.0, 0.0)).astype(np.float32)[None])
    # colocalize
    lab = np.zeros((1, 16, 16), np.uint16)
    lab[0, 1:3, 0:4], lab[0, 6:8, 0:4] = 1, 2
    a, b = np.zeros((1, 16, 16), np.float32), np.zeros((1, 16, 16), np.float32)
    ramp = np.tile(np.asarray([1, 2, 3, 4], np.float32), (2, 1))
    a[0, 1:3, 0:4], b[0, 1:3, 0:4] = ramp, 2 * ramp
    a[0, 6:8, 0:4], b[0, 6:8, 0:4] = ramp, np.tile(np.asarray([8, 6, 4, 2], np.float32), (2, 1))
    rng = np.random.default_rng(11)
    a[0] += rng.random((16, 16)).astype(np.float32)
    b[0] += rng.random((16, 16)).astype(np.float32)
    write("co_lab", lab)
    write("co_a", a)
    write("co_b", b)
    write("empty_lab", np.zeros((2, 8, 8), np.uint16))
    write("empty_c", np.zeros((2, 8, 8), np.float32))
    # count_spots
    lab = np.zeros((2, 20, 20), np.uint16)
    lab[0, 2:8, 2:8], lab[0, 12:16, 12:16], lab[0, 18, 18], lab[1, 5:9, 5:9] = 1, 2, 1, 1
    write("cs_lab", lab)
    write_text("cs_em.csv", "t,y,x,amplitude,background\n0,4.2,4.8,10,1\n0,6.0,3.0,11,1\n0,13.5,14.1,12,1\n"
                            "0,8.6,6.0,13,1\n0,0.0,19.0,14,1\n0,18.1,17.9,15,1\n")
    write_text("cs_bad.csv", "frame,row,col\n0,1,1\n")
    write_text("cs_malformed.csv", "t,y,x\n0,1.0,oops\n")
    lab = np.zeros((1, 20, 20), np.uint16)
    lab[0, 10, 10], lab[0, 13:17, 8:14] = 1, 1
    write("speck_lab", lab)
    write_text("speck_em.csv", "t,y,x\n0,11.0,10.0\n")
    lab = np.zeros((1, 12, 12), np.uint16)
    lab[0, 0:4, 0:4] = 1
    write("edge_lab", lab)
    write_text("edge_em.csv", "t,y,x\n0,-8.0,2.0\n0,2.0,30.0\n0,1.0,1.0\n")
    # volumes: a 2x3x3 block and a 1x2x2 plate, constant per object
    T, Z, H, W = 2, 4, 16, 16
    vl = np.zeros((T, Z, H, W), np.uint16)
    v0, v1 = np.zeros((T, Z, H, W), np.float32), np.zeros((T, Z, H, W), np.float32)
    for t in range(T):
        vl[t, 1:3, 2:5, 2:5], vl[t, 2, 10:12, 10:12] = 1, 2
        v0[t, 1:3, 2:5, 2:5], v0[t, 2, 10:12, 10:12] = 10.0 + t, 20.0
        v1[t, 1:3, 2:5, 2:5], v1[t, 2, 10:12, 10:12] = 2.0 * (10.0 + t), 40.0
    for name, arr in (("v_lab", vl), ("v_c0", v0), ("v_c1", v1)):
        write_dir(name, arr)
        write(name + "_pages", arr.reshape(T * Z, H, W))
    write_dir("v_bad", [np.zeros((3, 16, 16), np.float32)] * 2)
    vl = np.zeros((T, Z, H, W), np.uint16)
    vl[:, 1:3, 2:6, 2:6], vl[:, 3, 10:13, 10:13] = 1, 2
    write_dir("cs3_lab", vl)
    write_text("cs3_em.csv", "t,z,y,x\n0,1.2,3.0,4.0\n0,3.0,11.0,11.0\n0,0.0,3.0,4.0\n0,3.0,3.0,4.0\n"
                             "1,2.0,4.0,4.0\n1,-2.0,4.0,4.0\n")
    write_dir("ones3_lab", [np.ones((2, 8, 8), np.uint16)])
    write_text("yx_em.csv", "t,y,x\n0,1,1\n")
    # a garbled DEFLATE page mid-stack
    lab = np.zeros((4, 16, 16), np.uint16)
    lab[:, 4:8, 4:8] = 1
    write("cor_lab", lab)
    write("cor_ch", np.full((4, 16, 16), 3.0, np.float32), compression="deflate")
    with tiff.TiffReader(paths["cor_ch"]) as r:
        off, cnt = int(r._frames[-1][3][0]), int(r._frames[-1][4][0])
    with open(paths["cor_ch"], "r+b") as f:
        f.seek(off)
        f.write(bytes((i * 31 + 7) % 256 for i in range(cnt)))
    # instance ids
    lab = np.zeros((1, 24, 24), np.uint16)
    lab[0, 4:10, 4:10], lab[0, 4:10, 10:14], lab[0, 16:20, 16:20] = 1, 2, 7
    inten = np.zeros((1, 24, 24), np.float32)
    inten[0, 4:10, 4:10], inten[0, 4:10, 10:14], inten[0, 16:20, 16:20] = 10.0, 30.0, 50.0
    write("in_lab", lab)
    write("in_ch", inten)
    write_text("in_em.csv", "t,y,x,amplitude,background\n0,6.0,6.0,10,1\n0,6.0,11.5,11,1\n0,17.5,17.5,12,1\n")
    vl = np.zeros((4, 16, 16), np.uint16)
    vl[1:3, 4:8, 4:8], vl[1:3, 4:8, 8:12] = 1, 2
    write_dir("in3_lab", [vl])
    write_dir("in3_ch", [(np.where(vl == 1, 5.0, 0.0) + np.where(vl == 2, 9.0, 0.0)).astype(np.float32)])

    # track_objects
    write_h5("trk_two", [_table(t, [[10 + 2 * t, 10], [40, 40 + 2 * t]]) for t in range(6)], 6)
    write_h5("trk_still", [_table(t, [[10 + 4 * t, 10], [80, 80]]) for t in range(5)], 5)
    write_h5("trk_short", [_table(0, [[10, 10], [90, 90]]), _table(1, [[12, 10]]), _table(2, [[14, 10]])], 3)
    write_h5("trk_fission", _fission_tables(), 9)
    orphan = [_table(0, [[30, 30]]), _table(1, [[30, 32]]), _table(2, [[27, 34], [33, 34]])]
    orphan += [_table(t, [[27 - 3 * (t - 2), 34], [33 + 3 * (t - 2), 34]]) for t in range(3, 6)]
    write_h5("trk_orphan", orphan, 6)
    write_h5("trk_one", [_table(0, [[10, 10]])], 1)
    paths["junk.h5"] = str(tmp / "junk.h5")
    with open(paths["junk.h5"], "wb") as f:
        f.write(b"not an hdf5 file")
    import h5py

    paths["malformed.h5"] = str(tmp / "malformed.h5")
    with h5py.File(paths["malformed.h5"], "w") as f:
        grp = f.create_group("objects/obj_type_1")
        grp.create_dataset("coords", data=np.zeros((3, 4), np.float32))
        grp.create_dataset("map", data=np.asarray([[0, 3]], np.int32))
        props = grp.create_group("properties")
        props.create_dataset("area", data=np.ones(3, np.int32))
        props.create_dataset("intensity_mean", data=np.ones(3, np.float32))

    # export_ctc / measure_tracks: movers, a fission, a blip, instances
    def ctc_scene(name, labels, instances=False):
        write(name, labels)
        make = localize.localize_instances_table if instances else localize.localize_frame_table
        write_h5(name + "_h5", [make(labels[t], t=t) for t in range(len(labels))], len(labels))

    ctc_scene("mv", _movers())
    fis = np.zeros((7, 48, 48), np.uint16)
    fis[:3, 20:26, 20:26] = 1
    for t in range(3, 7):
        d = 4 * (t - 2)
        fis[t, 20:26, 20 - d:26 - d] = 1
        fis[t, 20:26, 20 + d:26 + d] = 1
    ctc_scene("fis", fis)
    blip = _movers()
    blip[2, 40:43, 4:7] = 1
    ctc_scene("blip", blip)
    early = _movers()
    early[0, 40:44, 40:44] = 1
    ctc_scene("early", early)
    touch = np.zeros((4, 32, 32), np.uint16)
    for t in range(4):
        touch[t, 8:14, 6 + t:12 + t], touch[t, 8:14, 12 + t:18 + t] = 1, 2
    ctc_scene("touch", touch, instances=True)
    inten = np.zeros((6, 48, 48), np.float32)
    for t in range(6):
        inten[t, 4 + 2 * t:10 + 2 * t, 4:10] = 11.0
        inten[t, 30:36, 30 + 2 * t:36 + 2 * t] = 22.0
    write("mv_ch", inten)
    write("blip_ch", np.full(blip.shape, 5.0, np.float32))
    (tmp / "not_trk").mkdir()
    paths["not_trk"] = str(tmp / "not_trk")
    for name, extra in (("pair", 0), ("pair_long", 5)):
        meas, trk = tmp / f"{name}_meas", tmp / f"{name}_trk"
        meas.mkdir()
        trk.mkdir()
        with open(meas / "measurements.csv", "w") as f:
            f.write("t,id,class,area,z,y,x,mean_c0\n")
            for t in range(3):
                f.write(f"{t},1,1,10,1.0000,10.0000,10.0000,5\n{t},2,1,10,5.0000,10.0000,10.0000,9\n")
        with open(trk / "tracks.csv", "w") as f:
            f.write("track_id,t,x,y,z,label,area,intensity_mean\n")
            for t in range(3):
                f.write(f"0,{t},10.000,10.000,1.000,1,10,1.0\n1,{t},10.000,10.000,5.000,1,10,1.0\n")
            for t in range(3, 3 + extra):
                f.write(f"0,{t},10.000,10.000,1.000,1,10,1.0\n")
        paths[name + "_meas"], paths[name + "_trk"] = str(meas), str(trk)
        paths[name + "_meas_csv"], paths[name + "_trk_csv"] = str(meas / "measurements.csv"), str(trk / "tracks.csv")
    far = tmp / "far"
    far.mkdir()
    with open(far / "tracks.csv", "w") as f:
        f.write("track_id,t,x,y,z,label,area,intensity_mean\n")
        for t in range(6):
            f.write(f"0,{t},999.0,999.0,0.0,1,10,1.0\n")
    paths["far"] = str(far)

    # qc_stack
    rng = np.random.default_rng(2)
    st = np.stack([_scene(rng, 48) for _ in range(10)])
    st[3] = _scene(rng, 48, blur=8)
    st[6] *= 0.05
    st = (st * 400).astype(np.uint16)
    st[8, :24] = 65535
    write("qc_stack", st)
    rng = np.random.default_rng(3)
    q0 = np.stack([_scene(rng, 32) for _ in range(6)])
    q1 = np.stack([_scene(rng, 32) for _ in range(6)])
    q1[4] *= 0.01
    write("qc_c0", q0.astype(np.float32))
    write("qc_c1", q1.astype(np.float32))
    write("qc_ones3", np.ones((3, 16, 16), np.float32))
    write("qc_ones2", np.ones((2, 16, 16), np.float32))
    rng = np.random.default_rng(4)
    sharp = _scene(rng, 32)
    vols = []
    for t in range(6):
        vol = np.stack([_scene(rng, 32, blur=6) for _ in range(5)])
        vol[min(t, 4)] = sharp + rng.normal(0, 1, (32, 32))
        if t == 3:
            vol = np.stack([_scene(rng, 32, blur=8) for _ in range(5)])
        vols.append(vol.astype(np.float32))
    write_dir("qc_vols", vols)
    rng = np.random.default_rng(5)
    write("qc_tz", np.stack([_scene(rng, 24) for _ in range(12)]).astype(np.float32))
    rng = np.random.default_rng(6)
    spiked = []
    for t in range(3):
        vol = np.stack([_scene(rng, 24) * 200 for _ in range(8)]).astype(np.uint16)
        if t == 1:
            vol[5] = 65535
        spiked.append(vol)
    write_dir("qc_spiked", spiked)

    # project_stack
    rng = np.random.default_rng(4)
    write("pj_vols", (rng.random((3, 4, 32, 32)) * 1000).astype(np.uint16).reshape(12, 32, 32))
    rng = np.random.default_rng(5)
    write("pj_focus", np.stack([_focus_volume(rng, z=5, sharp_z=(2 + t) % 5) for t in range(3)]).reshape(15, 48, 48))
    rng = np.random.default_rng(6)
    for ch, sz in (("pj_e0", 1), ("pj_e1", 2)):
        write(ch, np.stack([_focus_volume(rng, z=3, sharp_z=sz) for _ in range(2)]).reshape(6, 48, 48))
    rng = np.random.default_rng(8)
    write("pj_u16", np.stack([
        np.round(_focus_volume(rng, z=6, size=40, sharp_z=(1 + 2 * t) % 6) * 300).astype(np.uint16) for t in range(2)
    ]).reshape(12, 40, 40))
    return tmp, paths


def _server(tmp, which):
    jobs = str(tmp / f"{which}_jobs")
    if which == "jax":
        return JaxServer(JaxConfig(jobs_dir=jobs, models_dir=str(tmp / "models"), compilation_cache_dir=None))
    return TorchServer(TorchConfig(jobs_dir=jobs, models_dir=str(tmp / "models"), device="cpu"))


def _serve_chain(env, which, case, steps):
    """Serve ``steps`` [(name, module, params, inputs)] in order on one
    server; an input "@name" is the output directory of an earlier step
    (or a path inside it). Returns the last step's status and output
    directory."""
    tmp, paths = env
    srv = _server(tmp, which)
    submit = jax_submit if which == "jax" else torch_submit
    for name, module, params, inputs in steps:
        out = str(tmp / f"{which}_{case}_{name}")
        resolved = [str(tmp / f"{which}_{case}_{i[1:]}") if i.startswith("@") else paths[i] for i in inputs]
        submit(srv.config.jobs_dir, {"module": module, "params": params, "input": resolved, "output": out})
        assert srv.poll_once()
        with open(os.path.join(out, "status.json")) as f:
            status = json.load(f)
    return status, out


def _job_error(status):
    assert status["state"] == "failed", status
    last = status["error"].strip().splitlines()[-1]
    assert "JobError: " in last, last
    return re.sub(r"job [0-9a-f-]+:", "job ID:", last.split("JobError: ", 1)[1])


def _qc_rows(path):
    with open(path) as f:
        lines = f.read().strip().split("\n")
    return lines[0].split(","), [r.split(",") for r in lines[1:]]


def _same_qc_csv(pj, pt):
    hj, rj = _qc_rows(pj)
    ht, rt = _qc_rows(pt)
    assert ht == hj and len(rt) == len(rj)
    for a, b in zip(rj, rt):
        assert len(a) == len(b)
        row = dict(zip(hj, a))
        for col, va, vb in zip(hj, a, b):
            if col in QC_REDUCED:
                scale = max(abs(float(va)), abs(float(row["mean"]))) if col == "std" else abs(float(va))
                assert abs(float(vb) - float(va)) <= QC_CSV_RTOL * scale, (col, va, vb)
            else:
                assert vb == va, (col, va, vb)


def _same_tif(pj, pt, blend):
    a, b = tiff.read_stack(pj), tiff.read_stack(pt)
    assert a.dtype == b.dtype and a.shape == b.shape
    if blend:
        np.testing.assert_allclose(b, a, rtol=BLEND_RTOL, atol=BLEND_RTOL * float(np.abs(a).max()))
    else:
        np.testing.assert_array_equal(b, a)
        with open(pj, "rb") as fa, open(pt, "rb") as fb:
            assert fa.read() == fb.read()


def _same_outputs(sj, st, out_j, out_t, blend=False):
    assert sj["state"] == "complete", sj.get("error")
    assert st["state"] == "complete", st.get("error")
    assert set(st["outputs"]) == set(sj["outputs"])
    assert st.get("warnings", []) == sj.get("warnings", [])
    mj, mt = json.loads(sj["outputs"]["metrics"]), json.loads(st["outputs"]["metrics"])
    assert set(mt) == set(mj), (sorted(mt), sorted(mj))
    for k, v in mj.items():
        if not TIMING.search(k):
            assert mt[k] == v, (k, mt[k], v)
    assert sorted(os.listdir(out_t)) == sorted(os.listdir(out_j))
    for name in sorted(os.listdir(out_j)):
        pj, pt = os.path.join(out_j, name), os.path.join(out_t, name)
        if name in ("qc.csv", "qc_volumes.csv"):
            _same_qc_csv(pj, pt)
        elif name.endswith(".tif"):
            _same_tif(pj, pt, blend and name.startswith("projected"))
        elif name.endswith((".csv", ".txt")):
            with open(pj) as fa, open(pt) as fb:
                assert fb.read() == fa.read(), name
    return mt


# (case id, steps, expected state); the last step is the job under test
CASES = [
    # measure_objects
    ("mo_two_channel", [("j", "measure_objects", {}, ["mo_lab", "mo_c0", "mo_c1"])], "complete"),
    ("mo_min_area_range", [("j", "measure_objects", {"min_area": 4, "frame_range": [1, 3]}, ["ma_lab", "ma_ch"])],
     "complete"),
    ("mo_too_few", [("j", "measure_objects", {}, ["mo_lab"])], "failed"),
    ("mo_spatial", [("j", "measure_objects", {}, ["mo_lab", "mo_c0_tall"])], "failed"),
    ("mo_length", [("j", "measure_objects", {}, ["mo_lab", "mo_c0_long"])], "failed"),
    ("mo_plain", [("j", "measure_objects", {"split_touching": False, "min_distance": 4}, ["st_lab", "st_ch"])],
     "complete"),
    ("mo_split", [("j", "measure_objects", {"split_touching": True, "min_distance": 4}, ["st_lab", "st_ch"])],
     "complete"),
    ("mo_coloc", [("j", "measure_objects", {"colocalize": True, "coloc_threshold": 5.0}, ["co_lab", "co_a", "co_b"])],
     "complete"),
    ("mo_coloc_otsu", [("j", "measure_objects", {"colocalize": True}, ["co_lab", "co_a", "co_b"])], "complete"),
    ("mo_coloc_one", [("j", "measure_objects", {"colocalize": True}, ["co_lab", "co_a"])], "failed"),
    ("mo_coloc_bad_thr", [("j", "measure_objects", {"colocalize": True, "coloc_threshold": "median"},
                           ["empty_lab", "empty_c", "empty_c"])], "failed"),
    ("mo_corrupt", [("j", "measure_objects", {}, ["cor_lab", "cor_ch"])], "failed"),
    ("mo_instances", [("j", "measure_objects", {"instances": True}, ["in_lab", "in_ch"])], "complete"),
    ("mo_ccl", [("j", "measure_objects", {"instances": False}, ["in_lab", "in_ch"])], "complete"),
    ("mo_conflict", [("j", "measure_objects", {"instances": True, "split_touching": True}, ["in_lab", "in_ch"])],
     "failed"),
    ("mo3_dirs", [("j", "measure_objects", {"dims": 3}, ["v_lab", "v_c0", "v_c1"])], "complete"),
    ("mo3_pages", [("j", "measure_objects", {"dims": 3, "z": 4}, ["v_lab_pages", "v_c0_pages", "v_c1_pages"])],
     "complete"),
    ("mo3_coloc_range", [("j", "measure_objects", {"dims": 3, "colocalize": True, "coloc_threshold": 0.0,
                                                   "frame_range": [1, 2]}, ["v_lab", "v_c0", "v_c1"])], "complete"),
    ("mo3_shape", [("j", "measure_objects", {"dims": 3}, ["v_lab", "v_bad"])], "failed"),
    ("mo_bad_dims", [("j", "measure_objects", {"dims": 4}, ["v_lab", "v_c0"])], "failed"),
    ("mo3_instances", [("j", "measure_objects", {"dims": 3, "instances": True}, ["in3_lab", "in3_ch"])], "complete"),
    # count_spots
    ("cs_strict", [("j", "count_spots", {"min_area": 2, "capture_radius": 0.0}, ["cs_lab", "cs_em.csv"])],
     "complete"),
    ("cs_radius", [("j", "count_spots", {"min_area": 2, "capture_radius": 3.0}, ["cs_lab", "cs_em.csv"])],
     "complete"),
    ("cs_one_input", [("j", "count_spots", {}, ["cs_lab"])], "failed"),
    ("cs_columns", [("j", "count_spots", {}, ["cs_lab", "cs_bad.csv"])], "failed"),
    ("cs_malformed", [("j", "count_spots", {}, ["cs_lab", "cs_malformed.csv"])], "failed"),
    ("cs_radius_negative", [("j", "count_spots", {"capture_radius": -1}, ["cs_lab", "cs_em.csv"])], "failed"),
    ("cs_swapped", [("j", "count_spots", {"min_area": 2}, ["cs_em.csv", "cs_lab"])], "complete"),
    ("cs_speck", [("j", "count_spots", {"min_area": 2, "capture_radius": 3.0}, ["speck_lab", "speck_em.csv"])],
     "complete"),
    ("cs_edge_strict", [("j", "count_spots", {"capture_radius": 0.0}, ["edge_lab", "edge_em.csv"])], "complete"),
    ("cs_edge_radius", [("j", "count_spots", {"capture_radius": 2.0}, ["edge_lab", "edge_em.csv"])], "complete"),
    ("cs3_strict", [("j", "count_spots", {"dims": 3, "capture_radius": 0.0}, ["cs3_lab", "cs3_em.csv"])],
     "complete"),
    ("cs3_radius", [("j", "count_spots", {"dims": 3, "capture_radius": 1.5}, ["cs3_lab", "cs3_em.csv"])],
     "complete"),
    ("cs3_no_z", [("j", "count_spots", {"dims": 3}, ["ones3_lab", "yx_em.csv"])], "failed"),
    ("cs_instances", [("j", "count_spots", {"instances": True}, ["in_lab", "in_em.csv"])], "complete"),
    # track_objects
    ("trk_two", [("j", "track_objects", {"max_distance": 6}, ["trk_two"])], "complete"),
    ("trk_summaries", [("j", "track_objects", {"max_distance": 6}, ["trk_still"])], "complete"),
    ("trk_min_len", [("j", "track_objects", {"max_distance": 5, "min_track_length": 2}, ["trk_short"])], "complete"),
    ("trk_kalman_div", [("j", "track_objects", {"max_distance": 12, "motion_model": "kalman", "divisions": True,
                                                "mitotic_class": 2}, ["trk_fission"])], "complete"),
    ("trk_orphan", [("j", "track_objects", {"max_distance": 10, "divisions": True, "min_track_length": 3},
                     ["trk_orphan"])], "complete"),
    ("trk_bad_model", [("j", "track_objects", {"motion_model": "imm"}, ["trk_one"])], "failed"),
    ("trk_junk", [("j", "track_objects", {}, ["junk.h5"])], "failed"),
    ("trk_malformed", [("j", "track_objects", {}, ["malformed.h5"])], "failed"),
    ("trk_two_inputs", [("j", "track_objects", {}, ["trk_one", "trk_two"])], "failed"),
    # export_ctc (track_objects first, on the same server)
    ("ctc_movers", [("t", "track_objects", {"max_distance": 6}, ["mv_h5"]),
                    ("j", "export_ctc", {}, ["mv", "@t"])], "complete"),
    ("ctc_division", [("t", "track_objects", {"max_distance": 12, "divisions": True}, ["fis_h5"]),
                      ("j", "export_ctc", {}, ["fis", "@t"])], "complete"),
    ("ctc_blip", [("t", "track_objects", {"max_distance": 6, "min_track_length": 3}, ["blip_h5"]),
                  ("j", "export_ctc", {}, ["blip", "@t"])], "complete"),
    ("ctc_one_input", [("j", "export_ctc", {}, ["mv"])], "failed"),
    ("ctc_not_trk", [("j", "export_ctc", {}, ["mv", "not_trk"])], "failed"),
    ("ctc_frame_range", [("t", "track_objects", {"max_distance": 6}, ["early_h5"]),
                         ("j", "export_ctc", {"frame_range": [2, 5]}, ["early", "@t"])], "complete"),
    ("ctc_swapped", [("t", "track_objects", {"max_distance": 6}, ["mv_h5"]),
                     ("j", "export_ctc", {}, ["@t", "mv"])], "complete"),
    ("ctc_mismatch", [("t", "track_objects", {"max_distance": 6}, ["mv_h5"]),
                      ("j", "export_ctc", {"min_area": 10_000}, ["mv", "@t"])], "failed"),
    ("ctc_bad_tol", [("t", "track_objects", {"max_distance": 6}, ["mv_h5"]),
                     ("j", "export_ctc", {"match_tol": 0}, ["mv", "@t"])], "failed"),
    ("ctc_instances", [("t", "track_objects", {"max_distance": 6}, ["touch_h5"]),
                       ("j", "export_ctc", {"instances": True}, ["touch", "@t"])], "complete"),
    # measure_tracks (measure_objects and track_objects first)
    ("mt_traces", [("m", "measure_objects", {}, ["mv", "mv_ch"]),
                   ("t", "track_objects", {"max_distance": 6}, ["mv_h5"]),
                   ("j", "measure_tracks", {}, ["@m", "@t"])], "complete"),
    ("mt_unjoined", [("m", "measure_objects", {}, ["blip", "blip_ch"]),
                     ("t", "track_objects", {"max_distance": 6, "min_track_length": 3}, ["blip_h5"]),
                     ("j", "measure_tracks", {}, ["@m", "@t"])], "complete"),
    ("mt_zero_join", [("m", "measure_objects", {}, ["blip", "blip_ch"]),
                      ("j", "measure_tracks", {}, ["@m", "far"])], "failed"),
    ("mt_one_input", [("j", "measure_tracks", {}, ["pair_meas"])], "failed"),
    ("mt_z_join", [("j", "measure_tracks", {}, ["pair_meas", "pair_trk"])], "complete"),
    ("mt_swapped_files", [("j", "measure_tracks", {}, ["pair_trk_csv", "pair_meas_csv"])], "complete"),
    ("mt_partial", [("j", "measure_tracks", {}, ["pair_long_meas", "pair_long_trk"])], "complete"),
    ("mt_unresolved", [("j", "measure_tracks", {}, ["pair_meas", "pair_long_meas"])], "failed"),
    # qc_stack
    ("qc_flags", [("j", "qc_stack", {}, ["qc_stack"])], "complete"),
    ("qc_channels_range", [("j", "qc_stack", {"frame_range": [2, 6]}, ["qc_c0", "qc_c1"])], "complete"),
    ("qc_saturation_level", [("j", "qc_stack", {"saturation_level": 90.5}, ["qc_c0"])], "complete"),
    ("qc_disagree", [("j", "qc_stack", {}, ["qc_ones3", "qc_ones2"])], "failed"),
    ("qc_mad_k", [("j", "qc_stack", {"focus_mad_k": 0}, ["qc_ones3"])], "failed"),
    ("qc_dark_fraction", [("j", "qc_stack", {"dark_fraction": 1.5}, ["qc_ones3"])], "failed"),
    ("qc_mad_k_text", [("j", "qc_stack", {"focus_mad_k": "3,5"}, ["qc_ones3"])], "failed"),
    ("qc_sat_text", [("j", "qc_stack", {"saturation_level": "auto"}, ["qc_ones3"])], "failed"),
    ("qc3_drift", [("j", "qc_stack", {"dims": 3}, ["qc_vols"])], "complete"),
    ("qc3_pages", [("j", "qc_stack", {"dims": 3, "z": 4}, ["qc_tz"])], "complete"),
    ("qc_bad_dims", [("j", "qc_stack", {"dims": 4}, ["qc_tz"])], "failed"),
    ("qc3_spike", [("j", "qc_stack", {"dims": 3}, ["qc_spiked"])], "complete"),
    # project_stack
    ("pj_max", [("j", "project_stack", {"z": 4}, ["pj_vols"])], "complete"),
    ("pj_min_compressed", [("j", "project_stack", {"z": 4, "method": "min", "compress_output": True},
                            ["pj_vols"])], "complete"),
    ("pj_sum", [("j", "project_stack", {"z": 4, "method": "sum"}, ["pj_vols"])], "complete"),
    ("pj_mean", [("j", "project_stack", {"z": 6, "method": "mean"}, ["pj_u16"])], "complete"),
    ("pj_std", [("j", "project_stack", {"z": 6, "method": "std"}, ["pj_u16"])], "complete"),
    ("pj_median", [("j", "project_stack", {"z": 4, "method": "median", "frame_range": [1, 3]}, ["pj_vols"])],
     "complete"),
    ("pj_best_focus", [("j", "project_stack", {"z": 5, "method": "best_focus", "z_range": [1, 5]}, ["pj_focus"])],
     "complete"),
    ("pj_best_focus_u16", [("j", "project_stack", {"z": 6, "method": "best_focus"}, ["pj_u16"])], "complete"),
    ("pj_edof_channels", [("j", "project_stack", {"z": 3, "method": "edof", "save_height": True},
                           ["pj_e0", "pj_e1"])], "complete"),
    ("pj_edof_select", [("j", "project_stack", {"z": 6, "method": "edof", "edof_mode": "select",
                                                "save_height": True, "z_range": [1, 6]}, ["pj_u16"])], "complete"),
    ("pj_edof_params", [("j", "project_stack", {"z": 6, "method": "edof", "edof_radius": 2, "edof_gamma": 2.5},
                         ["pj_u16"])], "complete"),
    ("pj_bad_method", [("j", "project_stack", {"z": 4, "method": "nope"}, ["pj_vols"])], "failed"),
    ("pj_z_range_high", [("j", "project_stack", {"z": 4, "z_range": [3, 9]}, ["pj_vols"])], "failed"),
    ("pj_z_range_order", [("j", "project_stack", {"z": 4, "z_range": [2, 1]}, ["pj_vols"])], "failed"),
    ("pj_z_range_text", [("j", "project_stack", {"z": 4, "z_range": "1:3"}, ["pj_vols"])], "failed"),
    ("pj_save_height", [("j", "project_stack", {"z": 4, "save_height": True}, ["pj_vols"])], "failed"),
    ("pj_z_pages", [("j", "project_stack", {"z": 5}, ["pj_vols"])], "failed"),
    ("pj_radius", [("j", "project_stack", {"z": 4, "method": "edof", "edof_radius": -1}, ["pj_vols"])], "failed"),
    ("pj_gamma", [("j", "project_stack", {"z": 4, "method": "edof", "edof_gamma": 0}, ["pj_vols"])], "failed"),
    ("pj_mode", [("j", "project_stack", {"z": 4, "method": "edof", "edof_mode": "soft"}, ["pj_vols"])], "failed"),
]


@pytest.mark.parametrize("case,steps,state", CASES, ids=[c[0] for c in CASES])
def test_job_matches_the_jax_server(env, case, steps, state):
    (sj, out_j), (st, out_t) = (_serve_chain(env, w, case, steps) for w in ("jax", "torch"))
    assert sj["state"] == state, sj.get("error")
    if state == "failed":
        assert _job_error(st) == _job_error(sj)
        return
    module, params = steps[-1][1], steps[-1][2]
    blend = module == "project_stack" and params.get("method") == "edof" and params.get("edof_mode") != "select"
    _same_outputs(sj, st, out_j, out_t, blend=blend)


def test_qc_flags_the_injected_frames(env):
    """The port's qc_stack flags what the JAX test injected: a defocused,
    a dark and a saturated frame; the volumetric job follows the focal
    plane and flags the defocused volume."""
    st, _ = _serve_chain(env, "torch", "injected", [("flags", "qc_stack", {}, ["qc_stack"])])
    _, rows = _qc_rows(st["outputs"]["qc"])
    by_t = {int(r[0]): r[-1] for r in rows}
    assert "focus" in by_t[3] and "dark" in by_t[6] and "saturated" in by_t[8]
    assert all(by_t[t] == "" for t in range(10) if t not in (3, 6, 8))
    st, _ = _serve_chain(env, "torch", "injected", [("drift", "qc_stack", {"dims": 3}, ["qc_vols"])])
    _, rows = _qc_rows(st["outputs"]["qc_volumes"])
    by_t = {int(r[0]): r for r in rows}
    assert [int(by_t[t][2]) for t in (0, 1, 2, 4)] == [0, 1, 2, 4]
    assert "focus" in by_t[3][-1]
    assert json.loads(st["outputs"]["metrics"])["best_z_drift"] >= 2


def test_served_objects_h5_tracks_like_the_jax_server(env):
    """A port serve's objects.h5 (``localize_emitters`` with ``btrack``)
    feeds the port's track_objects; the same chain on the JAX server
    writes the same tracks, summaries and LBEP."""
    tmp, paths = env
    rng = np.random.default_rng(21)
    yy, xx = np.mgrid[:40, :40]
    frames = rng.normal(10.0, 0.5, (6, 40, 40)).astype(np.float32)
    for t in range(6):
        for cy, cx in ((10.3 + 1.5 * t, 12.2), (28.1, 30.4 - 1.2 * t)):
            frames[t] += 80.0 * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 1.5**2))
    paths["spots"] = str(tmp / "spots.tif")
    tiff.write_stack(paths["spots"], frames)
    steps = [("loc", "localize_emitters", {"threshold_sigmas": 8, "btrack": True}, ["spots"]),
             ("trk", "track_objects", {"max_distance": 4, "motion_model": "kalman"}, ["@loc/objects.h5"])]
    (sj, out_j), (st, out_t) = (_serve_chain(env, w, "served", steps) for w in ("jax", "torch"))
    mt = _same_outputs(sj, st, out_j, out_t)
    assert mt["n_tracks"] == 2 and mt["n_detections"] == 12
