"""The Euler kernel (``csrc/flows.cu``, ``ops/kernels/flows.py``) against
the plain eager loop (``ops.flows.follow_flows_reference``).

- On the CPU, a numpy mirror of the kernel's per-pixel scheme (only the
  mask's pixels step, with the masked corner reads; every other pixel stays
  at its coordinate) equals ``follow_flows(..., device="cpu")`` bit for bit:
  stepping the foreground alone changes no position.
- On the CPU, ``csrc/flows.cu`` itself, compiled with ``g++`` against the
  stand-in headers of ``tests/torch_conv_rehearsal`` (see
  ``test_torch_histogram_rehearsal.py``), gives the eager loop's positions
  bit for bit, and refuses what it does not take.
- On the card (marked ``cuda``, skipped without one; run there with
  ``python -m pytest --noconftest -p no:cacheprovider -m cuda
  tests/test_torch_flows_kernel.py``): ``follow_flows`` launches the kernel
  once a call (``euler.launches``) and equals the eager loop on the card with
  ``torch.equal``, on a 1024x1024 field of the benchmark's scenes and on
  random fields in 2D and 3D; the kernel's wrapper raises on what it does
  not take.

This file imports no JAX, so that the card's tests run where JAX is not
installed.
"""

import ctypes
import itertools
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from portbench import scenes
from sequitr_tpu_torch.ops import flows as flows_ops
from sequitr_tpu_torch.ops.kernels import flows as flow_kernels

HERE = os.path.dirname(os.path.abspath(__file__))
STUBS = os.path.join(HERE, "torch_conv_rehearsal")
SOURCE = os.path.join(os.path.dirname(HERE), "sequitr_tpu_torch", "csrc", "flows.cu")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _cells_field(shape, seed, noise=0.2):
    """The flow targets of a few ellipsoidal cells, two of them cut by the
    frame's edges, plus noise; and the cells' mask."""
    rng = np.random.default_rng(seed)
    grids = np.indices(shape)
    lab = np.zeros(shape, np.int32)
    hi = np.array(shape, float) - 1
    centres = [np.zeros(len(shape)), hi] + [rng.uniform(0.2 * hi, 0.8 * hi) for _ in range(4)]
    for k, c in enumerate(centres):
        r = np.array([2.5 if len(shape) == 3 and a == 0 else rng.uniform(4, 8) for a in range(len(shape))])
        q = sum(((g - ci) / ri) ** 2 for g, ci, ri in zip(grids, c, r))
        lab[(q < 1) & (lab == 0)] = k + 1
    flow, prob = flows_ops.flow_targets(lab)
    flow = flow + rng.normal(size=flow.shape).astype(np.float32) * noise
    return flow.astype(np.float32), prob > 0.5


def _random_field(shape, seed):
    """Flows of unit scale in every direction and a random mask: positions
    wander into every edge and corner."""
    rng = np.random.default_rng(seed)
    flow = rng.normal(size=tuple(shape) + (len(shape),)).astype(np.float32)
    return flow, rng.random(shape) < 0.4


# (name, field, mask kept, step): cells cut by the edges, volumes, axes of
# length 1 and 2, a half step, no mask
CASES = [
    ("cells_2d", lambda: _cells_field((48, 40), 1), True, 1.0),
    ("cells_3d", lambda: _cells_field((6, 20, 24), 2), True, 1.0),
    ("random_2d_rows_of_2", lambda: _random_field((2, 40), 3), True, 1.0),
    ("random_2d_one_column", lambda: _random_field((24, 1), 4), True, 1.0),
    ("random_3d_one_plane", lambda: _random_field((1, 20, 24), 5), True, 1.0),
    ("random_3d_thin", lambda: _random_field((6, 2, 24), 6), True, 1.0),
    ("cells_2d_half_step", lambda: _cells_field((48, 40), 7), True, 0.5),
    ("cells_2d_no_mask", lambda: _cells_field((48, 40), 8), False, 1.0),
    ("random_3d_no_mask", lambda: _random_field((6, 20, 24), 9), False, 1.0),
]
IDS = [c[0] for c in CASES]


def _case(make, keep_mask):
    flow, mask = make()
    return flow, (mask if keep_mask else None)


def mirror(flow, mask, n_iter, step):
    """The kernel's scheme in numpy float32: the mask's pixels alone take
    ``n_iter`` steps, each reading its 2^nd corners' flow times the mask
    there; every other pixel keeps its coordinate."""
    nd = flow.shape[-1]
    spatial = flow.shape[:-1]
    n = np.array(spatial)
    lim = (n - 1).astype(np.float32)
    top = np.maximum(n - 2, 0).astype(np.float32)
    zero, one, step = np.float32(0), np.float32(1), np.float32(step)
    grid = np.indices(spatial).reshape(nd, -1).T.astype(np.float32)
    rows = flow.reshape(-1, nd)
    fg = np.ones(len(grid), bool) if mask is None else mask.ravel()
    m = None if mask is None else mask.ravel().astype(np.float32)
    p = grid[fg]
    for _ in range(n_iter):
        base, weights = [], []
        for a in range(nd):
            x = np.clip(p[:, a], zero, lim[a])
            x0 = np.clip(np.floor(x), zero, top[a])
            f = x - x0
            base.append(x0.astype(np.int64))
            weights.append((one - f, f))
        v = None
        for corner in itertools.product((0, 1), repeat=nd):
            at, wc = 0, None
            for a, o in enumerate(corner):
                at = at * n[a] + np.minimum(base[a] + o, n[a] - 1)
                wc = weights[a][o] if wc is None else wc * weights[a][o]
            g = rows[at] if m is None else rows[at] * m[at][:, None]
            gw = g * wc[:, None]
            v = gw if v is None else v + gw
        p = np.minimum(np.maximum(p + step * v, zero), lim)
    out = grid.copy()
    out[fg] = p
    return out.reshape(tuple(spatial) + (nd,))


@pytest.mark.parametrize("name,make,keep_mask,step", CASES, ids=IDS)
def test_the_foreground_alone_steps_to_the_same_bits(name, make, keep_mask, step):
    flow, mask = _case(make, keep_mask)
    want = flows_ops.follow_flows(flow, mask, n_iter=200, step=step, device="cpu").numpy()
    got = mirror(flow, mask, 200, step)
    assert np.array_equal(got, want)
    if mask is not None:
        # the background keeps its coordinate in the eager loop too
        grid = np.moveaxis(np.indices(mask.shape), 0, -1).astype(np.float32)
        assert np.array_equal(want[~mask], grid[~mask])
        assert not np.array_equal(want[mask], grid[mask])


def test_the_cpu_runs_the_plain_loop_and_launches_nothing():
    flow, mask = _cells_field((48, 40), 11)
    before = flow_kernels.euler.launches
    got = flows_ops.follow_flows(torch.from_numpy(flow), torch.from_numpy(mask), n_iter=30)
    want = flows_ops.follow_flows_reference(flow, mask, n_iter=30, device="cpu")
    assert got.device.type == "cpu" and torch.equal(got, want)
    assert flow_kernels.euler.launches == before


# --- the kernel's source, rehearsed on the CPU ---


@pytest.fixture(scope="module")
def rehearsal(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the rehearsal with")
    tmp = tmp_path_factory.mktemp("flows_rehearsal")
    out = tmp / "libflows_cpu.so"
    # -ffp-contract=off: every operation rounds on its own, as -fmad=false
    # makes nvcc do
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-pthread", "-ffp-contract=off", "-x", "c++", "-shared",
         "-fPIC", "-I", STUBS, "-o", str(out), SOURCE],
        check=True,
    )
    lib = ctypes.CDLL(str(out))
    flow_kernels.bind(lib)
    return lib


def _rehearse(lib, flow, mask, n_iter, step, ptr_offset=0):
    flow = torch.from_numpy(flow)
    spatial = tuple(flow.shape[:-1])
    z, h, w = (1,) * (3 - len(spatial)) + spatial
    out = torch.full_like(flow, float("nan"))
    m = None if mask is None else torch.from_numpy(np.ascontiguousarray(mask))
    rc = lib.seq_follow_flows(
        flow.data_ptr() + ptr_offset, None if m is None else m.data_ptr(), len(spatial), z, h, w,
        n_iter, step, out.data_ptr(), None,
    )
    return rc, out


@pytest.mark.parametrize("name,make,keep_mask,step", CASES, ids=IDS)
def test_the_kernel_source_is_the_eager_loop(rehearsal, name, make, keep_mask, step):
    flow, mask = _case(make, keep_mask)
    rc, got = _rehearse(rehearsal, flow, mask, 200, step)
    assert rc == 0
    want = flows_ops.follow_flows_reference(flow, mask, n_iter=200, step=step, device="cpu")
    assert torch.equal(got, want)


def test_the_kernel_source_refuses_what_it_does_not_take(rehearsal):
    flow, mask = _random_field((8, 8), 12)
    rc, got = _rehearse(rehearsal, flow, mask, 0, 1.0)
    assert rc == 0  # no step: every pixel at its coordinate
    assert torch.equal(got, torch.from_numpy(np.moveaxis(np.indices((8, 8)), 0, -1).astype(np.float32)))
    assert _rehearse(rehearsal, flow, mask, 5, 1.0, ptr_offset=4)[0] != 0  # not 8-byte aligned
    assert _rehearse(rehearsal, flow, mask, -1, 1.0)[0] != 0
    out = torch.empty(8, 8, 2)
    for nd, z in ((4, 1), (2, 2), (3, 0)):
        rc = rehearsal.seq_follow_flows(flow.ctypes.data, None, nd, z, 8, 8, 5, 1.0, out.data_ptr(), None)
        assert rc != 0


# --- on the card ---


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the Euler kernel is CUDA C++ with no CPU mode")
    yield torch.device("cuda")
    torch.cuda.synchronize()


def _on_card_equal(flow, mask, n_iter=200, step=1.0):
    dev = torch.device("cuda")
    flow = torch.as_tensor(flow, device=dev)
    mask = None if mask is None else torch.as_tensor(mask, device=dev)
    before = flow_kernels.euler.launches
    got = flows_ops.follow_flows(flow, mask, n_iter=n_iter, step=step)
    assert flow_kernels.euler.launches == before + 1
    want = flows_ops.follow_flows_reference(flow, mask, n_iter=n_iter, step=step)
    torch.cuda.synchronize()
    assert got.is_cuda and got.dtype == torch.float32 and got.shape == want.shape
    assert torch.equal(got, want)
    return got


@pytest.mark.cuda
def test_card_kernel_is_the_eager_loop_on_a_benchmark_frame(card):
    _, inst = scenes.cells_scene([23, 0], (1024, 1024))
    flow, _ = flows_ops.flow_targets(inst)
    flow = flow + np.random.default_rng(23).normal(0, 0.05, flow.shape).astype(np.float32)
    mask = inst > 0
    got = _on_card_equal(flow, mask).cpu().numpy()
    grid = np.moveaxis(np.indices(mask.shape), 0, -1).astype(np.float32)
    assert np.array_equal(got[~mask], grid[~mask])


@pytest.mark.cuda
@pytest.mark.parametrize("shape,step,keep_mask", [
    ((256, 200), 1.0, True), ((256, 200), 0.5, False), ((8, 64, 64), 1.0, True),
    ((8, 64, 64), 1.0, False), ((1, 33, 2), 1.0, True), ((32, 256, 256), 1.0, True),
], ids=["2d", "2d_half_no_mask", "3d", "3d_no_mask", "3d_thin", "3d_served_volume"])
def test_card_kernel_is_the_eager_loop_on_random_fields(card, shape, step, keep_mask):
    flow, mask = _random_field(shape, sum(shape))
    _on_card_equal(flow, mask if keep_mask else None, step=step)


@pytest.mark.cuda
def test_card_numpy_input_and_the_cpu_count_nothing_twice(card):
    flow, mask = _cells_field((48, 40), 13)
    before = flow_kernels.euler.launches
    got = flows_ops.follow_flows(flow, mask, n_iter=50)  # numpy goes to the card
    assert got.is_cuda and flow_kernels.euler.launches == before + 1
    flows_ops.follow_flows(flow, mask, n_iter=50, device="cpu")
    assert flow_kernels.euler.launches == before + 1
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_card_wrapper_refuses_what_the_kernel_does_not_take(card):
    flow = torch.zeros(16, 12, 2, device="cuda")
    mask = torch.ones(16, 12, dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        flow_kernels.euler(flow.transpose(0, 1), None, 5, 1.0)
    with pytest.raises(TypeError, match="float32"):
        flow_kernels.euler(flow.double(), None, 5, 1.0)
    with pytest.raises(ValueError, match=r"\(H, W, 2\)"):
        flow_kernels.euler(torch.zeros(16, 12, 3, device="cuda"), None, 5, 1.0)
    with pytest.raises(ValueError, match=r"\(H, W, 2\)"):
        flow_kernels.euler(torch.zeros(4, 16, 12, 2, device="cuda"), None, 5, 1.0)
    with pytest.raises(ValueError, match="bool mask"):
        flow_kernels.euler(flow, mask.float(), 5, 1.0)
    with pytest.raises(ValueError, match="8-byte"):
        flow_kernels.euler(torch.zeros(16 * 12 * 2 + 1, device="cuda")[1:].view(16, 12, 2), None, 5, 1.0)
    with pytest.raises(ValueError, match="cuda"):
        flow_kernels.euler(flow.cpu(), None, 5, 1.0)
    before = flow_kernels.euler.launches
    assert torch.equal(flow_kernels.euler(flow, mask, 5, 1.0), flows_ops.follow_flows_reference(flow, mask, 5))
    assert flow_kernels.euler.launches == before + 1  # a refusal launches nothing
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_card_segmenter_counts_the_kernel_once_a_frame(card):
    from sequitr_tpu_torch import tracing
    from sequitr_tpu_torch.models import cpnet
    from sequitr_tpu_torch.pipeline import infer

    cfg = cpnet.CPnetConfig(nbase=(2, 8, 16, 32, 64), compute_dtype="float32")
    model = cpnet.init(cfg, generator=torch.Generator().manual_seed(0), device="cuda")
    tc = infer.TileConfig(patch=(32, 32), overlap=(8, 8), normalize="pallas")
    seg = infer.make_flows_segmenter(cfg, tc, (48, 48), n_iter=5, zero_channels=1, device="cuda")
    frame = torch.from_numpy(scenes.cells_scene([1, 0], (48, 48))[0].clip(0, 65535).astype(np.uint16))
    seg(model, frame)
    tracer = tracing.enable()
    try:
        seg(model, frame)
        seg(model, frame)
    finally:
        tracing.disable()
    # the wrapper counts its launch inside flows.integrate, before the frame's steps
    frame_counts = [("flows.tiles", 4), ("flows.euler_kernel", 1), ("flows.euler_steps", 5)]
    assert [(c.name, c.n) for c in tracer.counts()] == frame_counts * 2
    torch.cuda.synchronize()
