"""``sequitr_tpu_torch.mosaic`` and ``ops.illumination`` against the JAX
package's modules on the same inputs (CPU).

Bars: seam shifts, offsets and positions within 1e-5 px, responses at rtol
1e-4, composites within 2e-4 of values ~120 (each CPU FFT library lands
some 7e-5 from the float64 resample, independently: see
``test_torch_registration.py``), whole-pixel composites and every host
helper exact. The corrector and its median are bit-equal to the JAX
package's jitted corrector (``jnp.percentile(·, 50)``).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequitr_tpu import mosaic as J
from sequitr_tpu.ops import illumination as JI
from sequitr_tpu_torch import mosaic as T
from sequitr_tpu_torch.data.synthetic import bandlimited_scene
from sequitr_tpu_torch.ops import illumination as TI

POS_TOL = 1e-5
RESP_RTOL = 1e-4
BLEND_TOL = 2e-4
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens", "mosaic_stitch.npz")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def grid_tiles(grid, tile=(64, 64), overlap=16, jitter=2.5, seed=3, gains=None):
    """Tiles cut from one band-limited scene at grid spacing plus known
    sub-pixel jitter (float64 Fourier cuts), row-major."""
    r, c = grid
    h, w = tile
    rng = np.random.default_rng(seed)
    scene = bandlimited_scene(((r - 1) * (h - overlap) + h + 16, (c - 1) * (w - overlap) + w + 16), rng)
    spec = np.fft.fft2(scene.astype(np.float64))
    fy = np.fft.fftfreq(scene.shape[0])[:, None]
    fx = np.fft.fftfreq(scene.shape[1])[None, :]
    tiles = []
    for k in range(r * c):
        jy, jx = rng.uniform(-jitter, jitter, 2) if k else (0.0, 0.0)
        y0, x0 = (k // c) * (h - overlap) + 8 + jy, (k % c) * (w - overlap) + 8 + jx
        iy, ix = int(np.floor(y0)), int(np.floor(x0))
        moved = np.fft.ifft2(spec * np.exp(-2j * np.pi * (fy * (iy - y0) + fx * (ix - x0)))).real
        tiles.append(moved[iy:iy + h, ix:ix + w])
    tiles = np.stack(tiles).astype(np.float32)
    if gains is not None:
        tiles = tiles * np.asarray(gains, np.float32)[:, None, None]
    return tiles


def _same_result(rt, rj, blend_tol=BLEND_TOL):
    np.testing.assert_allclose(rt.positions, rj.positions, atol=POS_TOL)
    np.testing.assert_array_equal(rt.edges, rj.edges)
    np.testing.assert_allclose(rt.offsets, rj.offsets, atol=POS_TOL)
    np.testing.assert_allclose(rt.responses, rj.responses, rtol=RESP_RTOL)
    np.testing.assert_array_equal(rt.used, rj.used)
    assert abs(rt.rms_residual - rj.rms_residual) <= POS_TOL
    if rj.mosaic is None:
        assert rt.mosaic is None
    else:
        assert rt.mosaic.shape == rj.mosaic.shape and rt.mosaic.dtype == np.float32
        np.testing.assert_allclose(rt.mosaic, rj.mosaic, atol=blend_tol)


@pytest.mark.parametrize("ov", [16, 0.25, [12, 20], [0.2, 10], 3, 0.7, 40, "x"])
def test_normalize_overlap(ov):
    try:
        want = J.normalize_overlap(ov, (64, 72))
    except (ValueError, TypeError) as e:
        with pytest.raises(type(e), match=str(e)[:20]):
            T.normalize_overlap(ov, (64, 72))
    else:
        assert T.normalize_overlap(ov, (64, 72)) == want


@pytest.mark.parametrize("grid", [(1, 3), (2, 2), (3, 2), (3, 4)])
def test_host_helpers(grid):
    np.testing.assert_array_equal(T.snake_indices(grid), J.snake_indices(grid))
    tiles = np.arange(grid[0] * grid[1] * 4, dtype=np.float32).reshape(-1, 2, 2)
    np.testing.assert_array_equal(T.snake_to_row_major(tiles, grid), J.snake_to_row_major(tiles, grid))
    assert T._grid_edges(grid) == J._grid_edges(grid)
    np.testing.assert_array_equal(T._feather((20, 24), (4, 6)), J._feather((20, 24), (4, 6)))


@pytest.mark.parametrize("min_response", [0.0, 12.0])
def test_solve_positions(min_response):
    rng = np.random.default_rng(1)
    edges = np.asarray(T._grid_edges((2, 3))[0] + T._grid_edges((2, 3))[1])
    nominals = rng.uniform(40, 50, (len(edges), 2))
    offsets = nominals + rng.normal(0, 1, nominals.shape)
    responses = rng.uniform(5, 20, len(edges))
    got = T.solve_positions(6, edges, offsets, responses, nominals, min_response=min_response)
    want = J.solve_positions(6, edges, offsets, responses, nominals, min_response=min_response)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]


def test_flatfield_and_gains():
    yy, xx = np.meshgrid(np.linspace(-1, 1, 64), np.linspace(-1, 1, 64), indexing="ij")
    vig = (1.0 - 0.35 * (yy**2 + xx**2)).astype(np.float32)
    tiles = grid_tiles((2, 3), gains=np.linspace(1.0, 0.7, 6)) * vig[None]
    np.testing.assert_array_equal(T.estimate_flatfield(tiles), J.estimate_flatfield(tiles))
    np.testing.assert_array_equal(T.estimate_flatfield(tiles, order=4), J.estimate_flatfield(tiles, order=4))
    np.testing.assert_array_equal(
        T.solve_tile_gains(tiles, (2, 3), (16, 16)), J.solve_tile_gains(tiles, (2, 3), (16, 16))
    )
    with pytest.raises(ValueError, match="tiles must be"):
        T.estimate_flatfield(tiles[0])


@pytest.mark.parametrize("window", [True, False])
@pytest.mark.parametrize("refine", [1, 2, 3])
def test_correlate_strips(refine, window):
    tiles = grid_tiles((2, 3))
    hor, _ = T._grid_edges((2, 3))
    refs = np.stack([tiles[i][:, 48:] for i, _ in hor])
    movs = np.stack([tiles[j][:, :16] for _, j in hor])
    st, rt = T._correlate_strips(refs, movs, True, window, refine, "cpu")
    sj, rj = J._correlate_strips(jnp.asarray(refs), jnp.asarray(movs), True, window, refine)
    assert st.dtype == np.float64 and st.shape == (len(hor), 2)
    np.testing.assert_allclose(st, np.asarray(sj), atol=POS_TOL)
    np.testing.assert_allclose(rt, np.asarray(rj), rtol=RESP_RTOL)


@pytest.mark.parametrize("grid", [(2, 2), (2, 3), (3, 1)])
def test_pair_offsets_and_overlap(grid):
    tiles = grid_tiles(grid, seed=5)
    got = T.pair_offsets(tiles, grid, (16, 16), device="cpu")
    want = J.pair_offsets(tiles, grid, (16, 16))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=POS_TOL)
    np.testing.assert_allclose(got[2], want[2], rtol=RESP_RTOL)
    np.testing.assert_array_equal(got[3], want[3])
    try:
        want_ov = J.estimate_overlap(tiles, grid)
    except ValueError as e:  # 2x3: weak whole-tile correlations on both
        with pytest.raises(ValueError, match="could not estimate the tile overlap"):
            T.estimate_overlap(tiles, grid, device="cpu")
        assert "could not estimate the tile overlap" in str(e)
    else:
        assert T.estimate_overlap(tiles, grid, device="cpu") == want_ov


@pytest.mark.parametrize("subpixel", [True, False])
def test_blend(subpixel):
    tiles = grid_tiles((2, 3), seed=6)
    positions = np.array([[0, 0], [0.4, 47.7], [1.2, 96.3], [48.5, 0.2], [47.9, 48.0], [48.1, 95.6]])
    got = T.blend_mosaic(tiles, positions, (16, 16), subpixel=subpixel, device="cpu")
    want = J.blend_mosaic(tiles, positions, (16, 16), subpixel=subpixel)
    assert got.shape == want.shape and got.dtype == np.float32
    if subpixel:
        np.testing.assert_allclose(got, want, atol=BLEND_TOL)
    else:
        np.testing.assert_array_equal(got, want)


STITCH = {
    "2x2": ((2, 2), dict(overlap=16)),
    "2x3": ((2, 3), dict(overlap=16)),
    "2x3_auto_overlap": ((2, 3), dict(overlap="auto")),
    "2x3_snake": ((2, 3), dict(overlap=16, order="snake")),
    "2x3_integer": ((2, 3), dict(overlap=0.25, subpixel=False)),
    "2x3_min_response": ((2, 3), dict(overlap=16, min_response=30.0)),
    "2x3_refine3_nowindow": ((2, 3), dict(overlap=16, refine=3, window=False)),
    "2x3_estimate_only": ((2, 3), dict(overlap=16, blend=False)),
    "1x1": ((1, 1), dict(overlap=16)),
}


@pytest.mark.parametrize("case", sorted(STITCH))
def test_stitch_grid(case):
    grid, kw = STITCH[case]
    tiles = grid_tiles(grid, seed=7)
    rt = T.stitch_grid(tiles, grid, device="cpu", **kw)
    rj = J.stitch_grid(tiles, grid, **kw)
    _same_result(rt, rj, 0.0 if kw.get("subpixel") is False else BLEND_TOL)


def test_stitch_errors():
    tiles = grid_tiles((2, 2))
    for args, kw in [((tiles[:3], (2, 2)), {}), ((tiles, (2, 2)), dict(order="zigzag")),
                     ((tiles, (2, 2)), dict(overlap="big")), ((tiles[:, 0], (2, 2)), {})]:
        with pytest.raises(ValueError) as ej:
            J.stitch_grid(*args, **kw)
        with pytest.raises(ValueError) as et:
            T.stitch_grid(*args, device="cpu", **kw)
        assert str(et.value) == str(ej.value)


def _shift_tiles_f64(tiles, shifts, device=None):
    """``mosaic._shift_tiles`` in float64 numpy: the exact resample."""
    out = []
    for tile, s in zip(tiles, np.asarray(shifts, np.float32).astype(np.float64)):
        fy = np.fft.fftfreq(tile.shape[0])[:, None]
        fx = np.fft.fftfreq(tile.shape[1])[None, :]
        ramp = np.exp(-2j * np.pi * (fy * s[0] + fx * s[1]))
        out.append(np.fft.ifft2(np.fft.fft2(tile.astype(np.float64)) * ramp).real)
    return np.stack(out).astype(np.float32)


def test_mosaic_golden(monkeypatch):
    """``test_goldens.py::test_mosaic_stitch`` on the port, at its tolerances
    for positions, offsets and responses. The composite is 1.297e-4 from the
    golden bytes on 1 of 66,049 pixels (bar 1e-4; PyTorch 2.13's CPU FFT
    against XLA's, each some 7e-5 from the float64 resample), so it is held
    within 1.4e-4 of the golden and within 1e-4 of the same blend with the
    float64 resample."""
    g = np.load(GOLDEN)
    res = T.stitch_grid(np.asarray(g["tiles"]), (2, 2), overlap=24, device="cpu")
    np.testing.assert_allclose(res.positions.astype(np.float32), g["positions"], atol=1e-5)
    np.testing.assert_allclose(res.offsets.astype(np.float32), g["offsets"], atol=1e-5)
    np.testing.assert_allclose(res.responses.astype(np.float32), g["responses"], rtol=1e-4)
    np.testing.assert_allclose(res.mosaic, g["mosaic"], atol=1.4e-4)
    monkeypatch.setattr(T, "_shift_tiles", _shift_tiles_f64)
    exact = T.blend_mosaic(np.asarray(g["tiles"]), res.positions, (24, 24), device="cpu")
    np.testing.assert_allclose(res.mosaic, exact, atol=1e-4)


# -- illumination -------------------------------------------------------------


def _stack(t=6, shape=(40, 48), rate=0.05, seed=9):
    rng = np.random.default_rng(seed)
    h, w = shape
    big = bandlimited_scene((h + t, w + t), rng) + 100.0
    yy, xx = np.meshgrid(np.linspace(-1, 1, h), np.linspace(-1, 1, w), indexing="ij")
    vig = 1.0 - 0.35 * (yy**2 + xx**2)
    frames = np.stack([big[k:k + h, k:k + w] for k in range(t)])
    return (frames * vig[None] * np.exp(-rate * np.arange(t))[:, None, None]).astype(np.float32)


@pytest.mark.parametrize("order", [1, 2, 4])
def test_fit_shading(order):
    stack = _stack()
    np.testing.assert_array_equal(TI.fit_shading(stack, order), JI.fit_shading(stack, order))
    np.testing.assert_array_equal(TI.fit_shading(np.zeros((3, 8, 8))), JI.fit_shading(np.zeros((3, 8, 8))))
    with pytest.raises(ValueError, match="order=7"):
        TI.fit_shading(stack, 7)


@pytest.mark.parametrize("case", ["decay", "degenerate", "one_sample", "growth"])
def test_estimate_bleach_exp(case):
    times = np.array([0, 3, 7, 12, 19])
    meds = {"decay": 100 * np.exp(-0.04 * times), "degenerate": np.zeros(5),
            "one_sample": np.array([50.0, 0, 0, 0, 0]), "growth": 10 * np.exp(0.5 * times)}[case]
    gt, rt = TI.estimate_bleach_exp(times, meds, 20)
    gj, rj = JI.estimate_bleach_exp(times, meds, 20)
    np.testing.assert_array_equal(gt, gj)
    assert rt == rj


@pytest.mark.parametrize("shape", [(48, 64), (47, 63), (1, 1), (2, 1), (5, 3), (1000, 1001)])
def test_median_is_jax_percentile(shape):
    """Even and odd counts, with ties and negatives: bit-equal to
    ``jnp.percentile(·, 50)`` as the JAX corrector runs it, under
    ``jax.jit``. (Called eagerly, JAX divides 50 by 100 in a dispatch of its
    own that lands below 0.5, and at 47x63 picks -0.33207223 where the
    jitted graph and numpy pick the middle value -0.3320713.)"""
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(0, 50, shape + (2,)).astype(np.float32)
    x[..., 1] = np.round(x[..., 1] / 10)  # many ties
    flat = x.reshape(-1, 2)
    got = TI._median_linear(torch.from_numpy(flat), 0).numpy()
    want = np.asarray(jax.jit(lambda a: jnp.percentile(a, 50.0, axis=0))(jnp.asarray(flat)))
    assert got.tobytes() == want.tobytes()
    corrector = JI.make_corrector("none")(
        jnp.asarray(x), jnp.ones(x.shape, jnp.float32), jnp.ones(2, jnp.float32), jnp.ones(2, jnp.float32)
    )
    assert got.tobytes() == np.asarray(corrector[1]).tobytes()


@pytest.mark.parametrize("mode", ["exp", "ratio", "none"])
@pytest.mark.parametrize("dtype", [np.uint16, np.float32])
def test_make_corrector(mode, dtype):
    stack = _stack(t=3, shape=(48, 64))
    frame = np.stack([stack[2], stack[1] * 0.5], axis=-1)
    frame = np.round(frame).astype(dtype) if dtype == np.uint16 else frame
    shading = np.stack([TI.fit_shading(stack), np.ones((48, 64), np.float32)], axis=-1)
    gain = np.array([1.3, 0.9], np.float32)
    for ref_med in (np.array([80.0, 40.0], np.float32), np.array([0.0, 40.0], np.float32)):
        got = TI.make_corrector(mode)(torch.from_numpy(frame), torch.from_numpy(shading),
                                      torch.from_numpy(gain), torch.from_numpy(ref_med))
        want = JI.make_corrector(mode)(jnp.asarray(frame), jnp.asarray(shading),
                                       jnp.asarray(gain), jnp.asarray(ref_med))
        for a, b in zip(got, want):
            assert a.dtype == torch.float32
            assert a.numpy().tobytes() == np.asarray(b).tobytes()
    with pytest.raises(ValueError, match="mode must be"):
        TI.make_corrector("log")
