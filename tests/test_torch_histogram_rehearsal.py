"""``csrc/histogram.cu`` rehearsed on the CPU: its walk over the slices, its
atomics, its last-block ticket and its CDF inversion, without a card.

The source is compiled with ``g++`` against the stand-in headers of
``tests/torch_conv_rehearsal`` (one ``std::thread`` per CUDA thread, blocks
and launches one after another, atomics as ``std::atomic_ref``, shuffles
through a per-warp exchange, ``griddepcontrol`` as no-ops) and its
``extern "C"`` launchers are called on CPU tensors. Counts must be
integer-equal and lo, scale and quantiles bit-equal to the plain PyTorch
version (``quantile_pass_reference``), and the scratch must come back zeroed
after every call. The pretend card has 2 SMs. What only the card can show
(that ``nvcc`` takes the source, that blocks really run at once, times) is
``chip_smoke.py``'s part.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from sequitr_tpu_torch.ops.kernels import histogram as kernels

HERE = os.path.dirname(os.path.abspath(__file__))
STUBS = os.path.join(HERE, "torch_conv_rehearsal")
SOURCE = os.path.join(os.path.dirname(HERE), "sequitr_tpu_torch", "csrc", "histogram.cu")
QS = [0.05, 0.5, 0.995]


def cpu_source(text: str) -> str:
    """The .cu source as g++ takes it: the PTX operations replaced by their
    emulation, dynamic shared memory by the stand-ins'."""
    text, n = re.subn(
        r"// --- PTX operations.*?// --- end of the PTX operations ---",
        '#include "ptx_emulation.h"', text, flags=re.S,
    )
    assert n == 1
    text, n = re.subn(
        r"extern __shared__ __align__\(16\) unsigned char smem\[\];",
        "unsigned char* smem = emu_smem();", text,
    )
    assert n == 2
    return text


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the rehearsal with")
    tmp = tmp_path_factory.mktemp("histogram_rehearsal")
    src, out = tmp / "histogram_cpu.cpp", tmp / "libhistogram_cpu.so"
    with open(SOURCE) as f:
        src.write_text(cpu_source(f.read()))
    # -ffp-contract=off: every operation rounds on its own, as -fmad=false
    # makes nvcc do
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-pthread", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", STUBS, "-o", str(out), str(src)],
        check=True,
    )
    lib = ctypes.CDLL(str(out))
    kernels._bind(lib)
    return lib


def _pass(lib, x, qs, bins, scratch, blocks=0):
    slices, n = x.shape
    counts = torch.full((slices, bins), -1, dtype=torch.int32)
    lo = torch.full((slices,), float("nan"))
    scale = torch.full((slices,), float("nan"))
    q = torch.full((slices, len(qs)), float("nan"))
    q32 = kernels._q32(qs)
    rc = lib.seq_quantile_pass(
        x.data_ptr(), n, slices, bins, (ctypes.c_float * len(q32))(*q32), len(q32),
        counts.data_ptr(), lo.data_ptr(), scale.data_ptr(), q.data_ptr(), scratch.data_ptr(),
        blocks, None,
    )
    assert rc == 0
    return lo, scale, counts, q


def _hold(lib, x, qs=QS, bins=1024, blocks=0, scratch=None):
    """One pass against the plain version; the scratch comes back zeroed."""
    if scratch is None:
        scratch = torch.zeros(lib.seq_histogram_scratch_words(x.shape[0], bins), dtype=torch.int32)
    got = _pass(lib, x, qs, bins, scratch, blocks)
    want = kernels.quantile_pass_reference(x, qs, bins)
    for name, g, w in zip(("lo", "scale", "counts", "quantiles"), got, want):
        assert torch.equal(g, w), (name, g, w)
    assert int(scratch.abs().sum()) == 0
    return got


def _gamma(seed, slices, n, scale=60.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.gamma(2.0, scale, (slices, n)).astype(np.float32))


@pytest.mark.parametrize(
    "slices,n,blocks",
    [
        (1, 16384, 0),  # the default grid: one block a pretend SM
        (3, 1001, 0),  # ragged n: every slice after the first starts unaligned
        (2, 2053, 3),  # several blocks a slice, a head and a tail each
        (1, 7, 0),  # fewer pixels than one float4 and its head
        (4, 300, 5),  # more blocks than pixels: blocks with nothing to count
    ],
)
def test_pass_matches_plain(lib, slices, n, blocks):
    _hold(lib, _gamma(slices * 1000 + n, slices, n), blocks=blocks)


@pytest.mark.parametrize("bins", [64, 4096])
def test_pass_other_bins(lib, bins):
    _hold(lib, _gamma(bins, 2, 3001), bins=bins, blocks=2)


def test_unaligned_base(lib):
    """A view that starts 4 bytes into its storage: every slice has a head."""
    x = _gamma(8, 1, 4 * 999 + 1)
    view = x.reshape(-1)[1:].reshape(3, 1332)
    assert view.data_ptr() % 16 == 4 and view.is_contiguous()
    _hold(lib, view, blocks=2)


def test_two_calls_in_a_row(lib):
    """The accumulator, tickets and min/max keys come back zeroed: a second
    call on the same scratch, with other pixels, is right again."""
    scratch = torch.zeros(lib.seq_histogram_scratch_words(2, 1024), dtype=torch.int32)
    a = _hold(lib, _gamma(1, 2, 5000), scratch=scratch, blocks=3)
    b = _hold(lib, _gamma(2, 2, 5000, 900.0) - 400.0, scratch=scratch, blocks=3)
    assert not torch.equal(a[3], b[3])
    _hold(lib, _gamma(1, 2, 5000), scratch=scratch, blocks=3)


def test_constant_and_negative_slices(lib):
    """hi == lo: every pixel in bin 0; negative pixels: keys below zero's."""
    x = torch.stack([
        torch.full((999,), 37.5),
        -_gamma(3, 1, 999)[0],
        torch.full((999,), -2.0),
    ])
    lo, scale, counts, q = _hold(lib, x, qs=[0.05, 0.995, 1.5], blocks=2)
    assert int(counts[0, 0]) == 999 and float(lo[0]) == 37.5
    assert float(lo[1]) < 0 and float(lo[2]) == -2.0


def test_tie_frame(lib):
    """cum[0] / n = 5 / 100 is exactly f32(0.05): bin 0."""
    x = torch.cat([torch.zeros(5), torch.linspace(1.0, 100.0, 95)])[None]
    lo, scale, counts, q = _hold(lib, x)
    assert float(q[0, 0]) < 0.05


def test_histogram_mode(lib):
    """Lo and scale given: the counting launch alone, as the TPU
    histogram_2d; it leaves the scratch zeroed and writes nothing else."""
    x = _gamma(5, 3, 2501)
    lo, hi = torch.aminmax(x, dim=1)
    scale = kernels.scale_of(lo, hi, 1024)
    scratch = torch.zeros(lib.seq_histogram_scratch_words(3, 1024), dtype=torch.int32)
    for blocks in (0, 4):
        counts = torch.full((3, 1024), -1, dtype=torch.int32)
        rc = lib.seq_histogram_f32(
            x.data_ptr(), x.shape[1], 3, lo.data_ptr(), scale.data_ptr(), 1024,
            counts.data_ptr(), scratch.data_ptr(), blocks, None,
        )
        assert rc == 0
        assert torch.equal(counts, kernels.histogram_2d_reference(x, lo, scale))
        assert int(scratch.abs().sum()) == 0


def test_grid_and_refused_arguments(lib):
    """One block a pretend SM over all slices, at least one float4 a
    thread; arguments the kernels do not take are refused, not launched."""
    assert lib.seq_histogram_blocks(1 << 20, 1, 0) == 2
    assert lib.seq_histogram_blocks(1 << 20, 2, 0) == 1
    assert lib.seq_histogram_blocks(1 << 20, 8, 0) == 1
    assert lib.seq_histogram_blocks(100, 1, 0) == 1
    assert lib.seq_histogram_blocks(1 << 20, 1, 7) == 7
    x = torch.zeros(1, 16)
    buf = torch.zeros(16, dtype=torch.int32)
    qs = (ctypes.c_float * 9)(*([0.5] * 9))
    for bins, nq in ((1024, 0), (1024, 9), (8193, 1)):
        rc = lib.seq_quantile_pass(
            x.data_ptr(), 16, 1, bins, qs, nq, buf.data_ptr(), buf.data_ptr(),
            buf.data_ptr(), buf.data_ptr(), buf.data_ptr(), 0, None,
        )
        assert rc != 0
    assert lib.seq_histogram_f32(x.data_ptr(), 16, 1, None, None, 64, buf.data_ptr(),
                                 buf.data_ptr(), 0, None) != 0
