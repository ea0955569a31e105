"""The port's host copies — ``tracking``, ``ops.colocalize`` and the
tracking meters of ``fidelity`` — against the JAX package's on the CPU.

``tracking_scene`` generates the same scene (tables, identities,
divisions) from the same seed; ``link_tables`` on it gives the same
per-frame track ids and ``Track`` records (lineage fields included) for
the nearest and Kalman models with divisions and ``max_gap`` 1, and the
three writers (tracks.csv, track_summaries.csv, lbep.txt) write the same
bytes, also after ``reindex_lineage``. ``tracking_fidelity`` reads the
same numbers. The colocalization statistics (Otsu, Pearson, Manders) are
equal, NaN conventions and validation messages included.
"""

import dataclasses

import numpy as np
import pytest
import torch

from sequitr_tpu import fidelity as jax_fidelity
from sequitr_tpu import tracking as jax_tracking
from sequitr_tpu.localize import FrameTable as JaxFrameTable
from sequitr_tpu.ops import colocalize as jax_coloc
from sequitr_tpu_torch import fidelity, tracking
from sequitr_tpu_torch.ops import colocalize


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


SCENE = dict(n_objects=30, n_frames=24, field=(160, 160), n_divisions=4, speed=3.0, seed=575_003)


def _as_jax(tables):
    return [JaxFrameTable(coords=t.coords, area=t.area, intensity_mean=t.intensity_mean) for t in tables]


def test_tracking_scene_matches_jax():
    tables, gt, divs = fidelity.tracking_scene(**SCENE)
    tj, gj, dj = jax_fidelity.tracking_scene(**SCENE)
    assert len(tables) == len(tj) == SCENE["n_frames"]
    for a, b in zip(tables, tj):
        np.testing.assert_array_equal(a.coords, b.coords)
        np.testing.assert_array_equal(a.area, b.area)
        np.testing.assert_array_equal(a.intensity_mean, b.intensity_mean)
    for a, b in zip(gt, gj):
        np.testing.assert_array_equal(a, b)
    assert [(int(p), tuple(int(c) for c in cs), int(t)) for p, cs, t in divs] == \
        [(int(p), tuple(int(c) for c in cs), int(t)) for p, cs, t in dj]


@pytest.mark.parametrize("motion_model", ["nearest", "kalman"])
@pytest.mark.parametrize("mitotic_class", [None, 2])
def test_link_tables_matches_jax(tmp_path, motion_model, mitotic_class):
    tables, _, _ = fidelity.tracking_scene(**SCENE)
    kw = dict(max_distance=12.0, max_gap=1, motion_model=motion_model, divisions=True,
              division_distance=12.0, mitotic_class=mitotic_class)
    ids, tracks = tracking.link_tables(tables, **kw)
    ids_j, tracks_j = jax_tracking.link_tables(_as_jax(tables), **kw)
    assert len(ids) == len(ids_j)
    for a, b in zip(ids, ids_j):
        np.testing.assert_array_equal(a, b)
    assert [dataclasses.asdict(t) for t in tracks] == [dataclasses.asdict(t) for t in tracks_j]
    assert any(t.parent_id >= 0 for t in tracks)  # the scene divides
    # the writers, before and after a compact relabel
    for stage in ("linked", "reindexed"):
        if stage == "reindexed":
            keep = [t for t in tracks if t.n_points >= 3]
            keep_j = [t for t in tracks_j if t.n_points >= 3]
            tracks, remap = tracking.reindex_lineage(keep)
            tracks_j, remap_j = jax_tracking.reindex_lineage(keep_j)
            assert remap == remap_j
        for name, write, write_j, args, args_j in (
            ("lbep.txt", tracking.write_lbep, jax_tracking.write_lbep, (tracks,), (tracks_j,)),
            ("track_summaries.csv", tracking.write_track_summaries_csv, jax_tracking.write_track_summaries_csv,
             (tracks,), (tracks_j,)),
            ("tracks.csv", tracking.write_tracks_csv, jax_tracking.write_tracks_csv, (tables, ids),
             (_as_jax(tables), ids_j)),
        ):
            p, pj = tmp_path / f"port_{stage}_{name}", tmp_path / f"jax_{stage}_{name}"
            assert write(str(p), *args) == write_j(str(pj), *args_j)
            assert p.read_bytes() == pj.read_bytes(), name


def test_link_tables_validation_matches_jax():
    for kw in (dict(max_distance=0.0), dict(max_distance=5.0, max_gap=-1), dict(motion_model="imm"),
               dict(divisions=True, division_distance=-1.0)):
        with pytest.raises(ValueError) as e_port:
            tracking.link_tables([], **kw)
        with pytest.raises(ValueError) as e_jax:
            jax_tracking.link_tables([], **kw)
        assert str(e_port.value) == str(e_jax.value)


def test_tracking_fidelity_matches_jax():
    kw = dict(n_objects=24, n_frames=20, field=(120, 120), n_divisions=3)
    got = fidelity.tracking_fidelity(**kw)
    assert got == jax_fidelity.tracking_fidelity(**kw)
    assert got["link_accuracy"] >= got["link_accuracy_nearest"] - 0.05
    assert got["n_divisions_true"] == 3


def test_otsu_and_pair_statistics_match_jax():
    rng = np.random.default_rng(5)
    inst = np.zeros((40, 40), np.int32)
    inst[2:12, 2:12], inst[15:30, 5:20], inst[30:38, 30:38], inst[0, 39] = 1, 2, 3, 4
    chans = [rng.gamma(2.0, 50.0, (40, 40)) + 60000.0 * (k == 1) for k in range(3)]
    chans[2][inst == 3] = 5.0  # constant inside one object
    chans[0][inst == 4] = 0.0  # zero intensity: Manders NaN
    for c in chans:
        assert colocalize.otsu_threshold(c) == jax_coloc.otsu_threshold(c)
    assert colocalize.otsu_threshold(np.full((4, 4), 3.0)) == jax_coloc.otsu_threshold(np.full((4, 4), 3.0))
    for spec in ("otsu", None, 20.0, [10.0, 60050.0, 30.0]):
        thr = colocalize.resolve_thresholds(chans, spec)
        assert thr == jax_coloc.resolve_thresholds(chans, spec)
        got = colocalize.object_coloc_pairs(inst, 4, chans, thr)
        want = jax_coloc.object_coloc_pairs(inst, 4, chans, thr)
        assert set(got) == set(want) == {(0, 1), (0, 2), (1, 2)}
        for pair in want:
            for k in ("pearson", "m1", "m2"):
                np.testing.assert_array_equal(got[pair][k], want[pair][k])
    assert np.isnan(got[(0, 1)]["m1"][3]) and np.isnan(got[(0, 2)]["m1"][3])


@pytest.mark.parametrize("spec", ["median", [1.0], [1.0, "a"], True, {"a": 1}])
def test_threshold_spec_messages_match_jax(spec):
    with pytest.raises(ValueError) as e_port:
        colocalize.validate_threshold_spec(spec, 2)
    with pytest.raises(ValueError) as e_jax:
        jax_coloc.validate_threshold_spec(spec, 2)
    assert str(e_port.value) == str(e_jax.value)
