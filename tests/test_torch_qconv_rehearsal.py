"""``csrc/qconv.cu`` rehearsed on the CPU on the wrapper's packed weights
(``pack_weights``): its tap walk for the three convs (3^d SAME, 1^d, 2^d
stride-2 transposed), its four-channel words and its three epilogues,
without a card.

The source is compiled with ``g++`` against the stand-in headers of
``tests/torch_conv_rehearsal`` (one ``std::thread`` per CUDA thread, blocks
one after another, ``__dp4a`` as the PTX manual defines ``dp4a.s32.s32``,
``__float2int_rn`` nearest-even and saturating, ``-ffp-contract=off`` as
``-fmad=false`` makes ``nvcc`` round every product and sum on its own) and
its ``extern "C"`` launcher is called on CPU tensors. On ragged 2D and 3D
shapes, C_in = 1, odd and aligned widths and C_out no multiple of 16, the
int32 sums must equal the plain version (``qconv_reference``) exactly and
the dequantized f32 and requantized int8 outputs bit for bit. What only the
card can show (that ``nvcc`` takes the source, times) is ``chip_smoke.py``'s
part.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from sequitr_tpu_torch.ops.kernels import qconv as kernels

HERE = os.path.dirname(os.path.abspath(__file__))
STUBS = os.path.join(HERE, "torch_conv_rehearsal")
SOURCE = os.path.join(os.path.dirname(HERE), "sequitr_tpu_torch", "csrc", "qconv.cu")
MODES = {(3, False): 0, (1, False): 1, (2, True): 2}


def cpu_source(text: str) -> str:
    """The .cu source as g++ takes it: ``__dp4a`` from the emulation."""
    head = "#include <cuda_runtime.h>\n"
    assert text.count(head) == 1
    return text.replace(head, head + '#include "ptx_emulation.h"\n')


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the rehearsal with")
    tmp = tmp_path_factory.mktemp("qconv_rehearsal")
    src, out = tmp / "qconv_cpu.cpp", tmp / "libqconv_cpu.so"
    with open(SOURCE) as f:
        src.write_text(cpu_source(f.read()))
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-pthread", "-ffp-contract=off", "-shared", "-fPIC",
         "-I", STUBS, "-o", str(out), str(src)],
        check=True,
    )
    return kernels.bind(ctypes.CDLL(str(out)))


def _run(lib, x, w, transpose, epilogue, scale=None, bias=None, relu=False, inv_next=0.0):
    dims = x.ndim - 2
    n, *spatial, c_in = x.shape
    c_out = w.shape[-1]
    d, h, wd = ([1] + spatial) if dims == 2 else spatial
    mode = MODES[(w.shape[0], transpose)]
    wp = kernels.pack_weights(w)
    assert wp.numel() == lib.seq_qconv_packed_words(mode, dims, c_in, c_out)
    dtype = {"raw": torch.int32, "dequant": torch.float32, "requant": torch.int8}[epilogue]
    y = torch.full((n, *kernels.out_spatial(spatial, transpose), c_out), 99, dtype=dtype)
    rc = lib.seq_qconv(
        x.data_ptr(), wp.data_ptr(), None if scale is None else scale.data_ptr(),
        None if bias is None else bias.data_ptr(), y.data_ptr(),
        n, d, h, wd, c_in, c_out, dims, mode, kernels.EPILOGUES.index(epilogue), int(relu),
        inv_next, None,
    )
    assert rc == 0
    return y


# (dims, N, spatial, C_in, C_out, k, transposed)
CASES = [
    (2, 2, (5, 7), 1, 5, 3, False),  # C_in = 1: words from single bytes
    (2, 1, (9, 13), 7, 17, 3, False),  # odd widths, a second partial group of outputs
    (2, 1, (6, 10), 32, 32, 3, False),  # aligned four-channel words
    (2, 2, (5, 6), 33, 3, 1, False),  # the head: 1x1, few classes
    (2, 1, (4, 5), 12, 8, 2, True),  # the transposed up-conv
    (3, 1, (3, 5, 6), 5, 4, 3, False),
    (3, 2, (2, 3, 4), 16, 20, 1, False),
    (3, 1, (2, 3, 3), 6, 5, 2, True),
]
IDS = [f"{d}d-{'x'.join(map(str, sp))}-{ci}to{co}-k{k}{'t' if t else ''}" for d, _, sp, ci, co, k, t in CASES]


def _inputs(case):
    dims, n, spatial, c_in, c_out, k, transpose = case
    rng = np.random.default_rng(sum(spatial) * 100 + c_in)
    x = torch.from_numpy(rng.integers(-127, 128, size=(n, *spatial, c_in)).astype(np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, size=(k,) * dims + (c_in, c_out)).astype(np.int8))
    scale = torch.from_numpy(rng.uniform(1e-5, 1e-3, c_out).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.5, c_out).astype(np.float32))
    return x, w, transpose, scale, bias


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_qconv_kernel_on_the_cpu(lib, case):
    x, w, transpose, scale, bias = _inputs(case)
    raw = _run(lib, x, w, transpose, "raw")
    assert torch.equal(raw, kernels.qconv_reference(x, w, transpose))
    for relu in (False, True):
        got = _run(lib, x, w, transpose, "dequant", scale, bias, relu)
        want = kernels.qconv_reference(x, w, transpose, "dequant", scale, bias, relu)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    got = _run(lib, x, w, transpose, "requant", scale, bias, True, 25.0)
    want = kernels.qconv_reference(x, w, transpose, "requant", scale, bias, True, 25.0)
    assert torch.equal(got, want)
    assert 0 < int((want != 0).sum()) and int((want.abs() == 127).sum()) > 0


def test_signed_bytes_and_wide_sums(lib):
    """Every byte of a word is signed, -128 included, and the int32 sums of
    a wide 1x1 conv (C_in = 260) reach millions: exact in both versions."""
    rng = np.random.default_rng(5)
    x = np.full((1, 3, 4, 260), -128, np.int8)
    x[0, 1] = rng.choice(np.array([-128, -127, 127], np.int8), size=(4, 260))
    w = np.stack([np.full(260, 127), np.full(260, -128), rng.integers(-128, 128, 260)], -1)
    x, w = torch.from_numpy(x), torch.from_numpy(w.astype(np.int8)[None, None])
    got = _run(lib, x, w, False, "raw")
    assert torch.equal(got, kernels.qconv_reference(x, w))
    assert int(got[0, 0, 0, 0]) == -128 * 127 * 260 and int(got[0, 0, 0, 1]) == 128 * 128 * 260


def test_weights_are_packed_once_a_tensor():
    """``qconv`` packs a weight tensor once and keeps the words with it: the
    same words on the next call, new ones after an in-place change, none
    kept once the tensor is gone."""
    import gc

    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.integers(-127, 128, size=(3, 3, 5, 6)).astype(np.int8))
    first = kernels._packed(w)
    assert kernels._packed(w) is first
    w.add_(1)
    again = kernels._packed(w)
    assert again is not first and torch.equal(again, kernels.pack_weights(w))
    key = id(w)
    del w
    gc.collect()
    assert key not in kernels._PACKED
