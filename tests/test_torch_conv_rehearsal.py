"""``csrc/conv3x3.cu`` rehearsed on the CPU: its index arithmetic, its ring of
tiles and its choice of body, without a card.

The source is compiled with ``g++`` against the stand-in headers of
``tests/torch_conv_rehearsal`` (one ``std::thread`` per CUDA thread, barriers
for ``__syncthreads`` and ``__syncwarp``, the PTX operations emulated as the
PTX manual defines them, ``cp.async`` carried out only when its group is
waited for) and its ``extern "C"`` launchers are called on CPU tensors. The
results are held against the plain PyTorch versions: f32 to 1e-4 (sums of at
most 576 products in another order), bf16 to two bf16 steps with >= 99% of
outputs bit-equal. The pretend card has 2 SMs, so a persistent block walks
several tiles. What only the card can show (that ``nvcc`` takes the source,
bank conflicts, times) is ``chip_smoke.py``'s part.
"""

import ctypes
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from sequitr_tpu_torch.ops.kernels import conv3x3 as kernels
from sequitr_tpu_torch.studies import conv2d_gemm as g
from sequitr_tpu_torch.studies import conv2d_gemm2 as g2

HERE = os.path.dirname(os.path.abspath(__file__))
STUBS = os.path.join(HERE, "torch_conv_rehearsal")
SOURCE = os.path.join(
    os.path.dirname(HERE), "sequitr_tpu_torch", "csrc", "conv3x3.cu"
)
CUDA_CORES, MMA_SYNCHRONOUS, MMA_PIPELINED = 0, 1, 2
TYPES = {torch.float32: 0, torch.bfloat16: 1}


def cpu_source(text: str) -> str:
    """The .cu source as g++ takes it: the PTX operations replaced by their
    emulation, dynamic shared memory and ``<<<>>>`` by the stand-ins'."""
    text, n = re.subn(
        r"// --- PTX operations.*?// --- end of the PTX operations ---",
        '#include "ptx_emulation.h"', text, flags=re.S,
    )
    assert n == 1
    text, n = re.subn(
        r"extern __shared__ __align__\(16\) unsigned char smem\[\];",
        "unsigned char* smem = emu_smem();", text,
    )
    assert n == 4
    text, n = re.subn(
        r"kernel<<<(dim3\([^)]*\)), ([^,]+), ([^,]+), stream>>>\(",
        r"emu_launch(kernel, \1, \2, \3, ", text,
    )
    assert n == 6
    return text


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to compile the rehearsal with")
    tmp = tmp_path_factory.mktemp("conv_rehearsal")
    src, out = tmp / "conv3x3_cpu.cpp", tmp / "libconv3x3_cpu.so"
    with open(SOURCE) as f:
        src.write_text(cpu_source(f.read()))
    subprocess.run(
        [gxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC", "-I", STUBS,
         "-o", str(out), str(src)],
        check=True,
    )
    lib = ctypes.CDLL(str(out))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.seq_conv3x3_nhwc.argtypes = [ptr] * 4 + [i32] * 7 + [ptr]
    lib.seq_conv3x3_flat_chw.argtypes = [ptr] * 4 + [i32] * 9 + [ptr]
    lib.seq_conv3x3_body.argtypes = [i32, ptr, ptr] + [i32] * 8 + [ptr]
    return lib


def _body(lib, flat, x, y, h, w_img, wb, margin, c_in, c_out, in_dtype, out_dtype):
    info = (ctypes.c_int * 5)()
    rc = lib.seq_conv3x3_body(
        flat, x.data_ptr(), y.data_ptr(), h, w_img, wb, margin, c_in, c_out,
        TYPES[in_dtype], TYPES[out_dtype], info,
    )
    assert rc == 0
    return tuple(info)


def _hold(got, want, dtype):
    got, want = got.float().numpy(), want.float().numpy()
    if dtype == torch.float32:
        assert np.max(np.abs(got - want)) <= 1e-4
        return
    scale = np.maximum(np.abs(got), np.abs(want)) * 2.0**-7
    excess = np.maximum(np.abs(got - want) - 1e-4, 0.0)
    steps = np.where(excess > 0, excess / np.maximum(scale, 1e-30), 0.0)
    assert steps.max() <= 2, steps.max()
    assert np.mean(got == want) >= 0.99


# (H, W, C_in, C_out, input dtype, output dtype, relu, body of the NHWC
# launcher, body of the flat launcher at row stride W+8)
CASES = [
    # ragged: partial tiles; W+8 = 108 is no multiple of 8: synchronous staging
    (70, 100, 32, 32, torch.bfloat16, torch.bfloat16, 1, MMA_PIPELINED, MMA_SYNCHRONOUS),
    # aligned and ragged, C_out less than a block of channels
    (72, 104, 16, 8, torch.bfloat16, torch.bfloat16, 1, MMA_PIPELINED, MMA_PIPELINED),
    # C_out no multiple of 32: a second, partial block of channels
    (24, 40, 48, 40, torch.bfloat16, torch.bfloat16, 0, MMA_PIPELINED, MMA_PIPELINED),
    # an image smaller than one tile
    (5, 7, 16, 8, torch.bfloat16, torch.bfloat16, 1, MMA_PIPELINED, MMA_SYNCHRONOUS),
    # fewer tiles (2) than ring stages
    (8, 56, 32, 32, torch.bfloat16, torch.bfloat16, 1, MMA_PIPELINED, MMA_PIPELINED),
    # 3 stages at one block an SM, f32 output from bf16 input, odd C_out
    (20, 64, 64, 5, torch.bfloat16, torch.float32, 1, MMA_PIPELINED, MMA_PIPELINED),
    # the CUDA-core body: f32 input, and bf16 input that fills no k = 16 step
    (13, 21, 3, 5, torch.float32, torch.float32, 1, CUDA_CORES, CUDA_CORES),
    (16, 24, 8, 16, torch.bfloat16, torch.bfloat16, 0, CUDA_CORES, CUDA_CORES),
]
IDS = [f"{h}x{w}-{ci}to{co}-{str(di)[6:]}-{str(do)[6:]}" for h, w, ci, co, di, do, *_ in CASES]


def _inputs(h, w_img, c_in, c_out, dtype):
    rng = np.random.default_rng(h * 1000 + w_img)
    x = torch.from_numpy(rng.normal(size=(h, w_img, c_in)).astype(np.float32)).to(dtype)
    w = torch.from_numpy((rng.normal(size=(3, 3, c_in, c_out)) * 0.1).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(c_out,)).astype(np.float32))
    return (x,) + kernels.pack_weights(w, b, dtype)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_nhwc_kernel_on_the_cpu(lib, case):
    h, w_img, c_in, c_out, dtype, out_dtype, relu, body, _ = case
    x, wk, bk = _inputs(h, w_img, c_in, c_out, dtype)
    y = torch.full((h, w_img, c_out), float("nan"), dtype=out_dtype)
    info = _body(lib, 0, x, y, h, w_img, 0, 0, c_in, c_out, dtype, out_dtype)
    assert info[0] == body
    if body == MMA_PIPELINED:
        assert info[1] in (2, 3) and info[2] >= 1
    rc = lib.seq_conv3x3_nhwc(
        x.data_ptr(), wk.data_ptr(), bk.data_ptr(), y.data_ptr(), h, w_img, c_in,
        c_out, relu, TYPES[dtype], TYPES[out_dtype], None,
    )
    assert rc == 0
    act = "relu" if relu else "none"
    _hold(y, kernels.conv3x3_nhwc_reference(x, wk, bk, act, out_dtype), out_dtype)


@pytest.mark.parametrize("stride", ["w+8", "wb2"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_flat_kernel_on_the_cpu(lib, case, stride):
    h, w_img, c_in, c_out, dtype, out_dtype, relu, _, body = case
    x, wk, bk = _inputs(h, w_img, c_in, c_out, dtype)
    if stride == "wb2":  # a multiple of 128: aligned whatever W is
        wb, xf = g2.wb2(w_img), g2.flatten_chw2(x)
        body = CUDA_CORES if body == CUDA_CORES else MMA_PIPELINED
    else:
        wb, xf = w_img + 8, g.flatten_chw(x)
    xf = xf.contiguous()
    y = torch.full((c_out, h * wb), float("nan"), dtype=out_dtype)
    info = _body(lib, 1, xf, y, h, w_img, wb, g.MARGIN, c_in, c_out, dtype, out_dtype)
    assert info[0] == body
    assert info[1] == 1 if body != MMA_PIPELINED else info[1] in (2, 3)
    rc = lib.seq_conv3x3_flat_chw(
        xf.data_ptr(), wk.data_ptr(), bk.data_ptr(), y.data_ptr(), h, w_img, wb,
        g.MARGIN, c_in, c_out, relu, TYPES[dtype], TYPES[out_dtype], None,
    )
    assert rc == 0
    act = "relu" if relu else "none"
    want = kernels.conv3x3_flat_chw_reference(xf, wk, bk, h, w_img, wb, g.MARGIN, act, out_dtype)
    _hold(y, want, out_dtype)
    cols = y.reshape(c_out, h, wb)
    assert bool((cols[:, :, 0] == 0).all()) and bool((cols[:, :, w_img + 1:] == 0).all())


def test_misaligned_bases_take_the_other_bodies(lib):
    """A base that is not 16-byte aligned (a view with an offset) cannot be
    copied in 16-byte pieces: the launchers see it in their arguments."""
    h, w_img, c_in, c_out = 16, 24, 16, 8
    x, wk, bk = _inputs(h, w_img, c_in, c_out, torch.bfloat16)
    y = torch.empty((h, w_img, c_out), dtype=torch.bfloat16)
    shifted = torch.empty(x.numel() + 1, dtype=torch.bfloat16)[1:].view_as(x).copy_(x)
    assert shifted.data_ptr() % 16 == 2
    assert _body(lib, 0, x, y, h, w_img, 0, 0, c_in, c_out, x.dtype, y.dtype)[0] == MMA_PIPELINED
    assert _body(lib, 0, shifted, y, h, w_img, 0, 0, c_in, c_out, x.dtype, y.dtype)[0] == CUDA_CORES
    got = torch.full_like(y, float("nan"))
    assert lib.seq_conv3x3_nhwc(
        shifted.data_ptr(), wk.data_ptr(), bk.data_ptr(), got.data_ptr(), h, w_img,
        c_in, c_out, 1, 1, 1, None,
    ) == 0
    _hold(got, kernels.conv3x3_nhwc_reference(x, wk, bk), torch.bfloat16)
    wb = w_img + 8
    xf = g.flatten_chw(x).contiguous()
    yf = torch.empty((c_out, h * wb), dtype=torch.bfloat16)
    xs = torch.empty(xf.numel() + 1, dtype=torch.bfloat16)[1:].view_as(xf).copy_(xf)
    args = (h, w_img, wb, g.MARGIN, c_in, c_out, x.dtype, y.dtype)
    assert _body(lib, 1, xf, yf, *args)[0] == MMA_PIPELINED
    assert _body(lib, 1, xs, yf, *args)[0] == MMA_SYNCHRONOUS
    # an unaligned y only changes how the rows are stored (info[4]: tiles by TMA)
    assert _body(lib, 1, xf, yf.view(-1)[1:], *args)[::4] == (MMA_PIPELINED, 1)
    got = torch.full((c_out * h * wb + 1,), float("nan"), dtype=torch.bfloat16)
    assert lib.seq_conv3x3_flat_chw(
        xf.data_ptr(), wk.data_ptr(), bk.data_ptr(), got[1:].data_ptr(), h, w_img, wb,
        g.MARGIN, c_in, c_out, 1, 1, 1, None,
    ) == 0
    want = kernels.conv3x3_flat_chw_reference(xf, wk, bk, h, w_img, wb, g.MARGIN)
    _hold(got[1:].view_as(want), want, torch.bfloat16)


def test_ring_depth_follows_shared_memory(lib):
    """A third stage where it costs no resident block (the header note of the
    source gives the sizes); 48 channels have no TMA swizzle and go by cp.async."""
    x = torch.empty(16, dtype=torch.bfloat16)

    def plan(flat, c_in):
        info = _body(lib, flat, x, x, 64, 64, 72, 128, c_in, 32, x.dtype, x.dtype)
        return info[1], info[2], info[4]  # stages, blocks an SM, tiles by TMA

    assert {c: plan(0, c) for c in (16, 32, 48, 64)} == {
        16: (3, 3, 1), 32: (2, 3, 1), 48: (2, 2, 0), 64: (3, 1, 1)}
    assert {c: plan(1, c) for c in (16, 32, 48, 64)} == {
        16: (3, 3, 1), 32: (3, 2, 1), 48: (3, 1, 0), 64: (3, 1, 1)}
