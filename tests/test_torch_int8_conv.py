"""The int8 conv of the port (``ops.kernels.qconv`` on the CPU: its plain
version) against the JAX package's XLA int8 convs, and the int8 conv study.

The same seeded int8 inputs go through ``jax.lax.conv_general_dilated`` /
``conv_transpose`` with ``preferred_element_type=int32`` (the calls of
``sequitr_tpu/studies/int8_conv.py::_conv`` and ``ptq_unet.py::_qconv``) and
through ``qconv``: the int32 sums must be equal, exactly, for the 3^d SAME,
1^d and 2^d stride-2 transposed convs, 2D and 3D, C_in = 1, odd and wide
widths, ragged shapes and an asymmetric transposed kernel. The epilogues are
held bit for bit against the same arithmetic run eagerly in JAX (the dequant
of ``ptq_unet._qconv``, the requantizing layer of ``int8_conv.run``). The
kernel itself is rehearsed in ``test_torch_qconv_rehearsal.py`` and held
against the plain version on the card by ``chip_smoke.py --phases quant``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequitr_tpu.models import unet as jax_unet
from sequitr_tpu.studies import int8_conv as jax_int8
from sequitr_tpu_torch.ops.kernels import qconv as kernels
from sequitr_tpu_torch.studies import int8_conv


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _jax_conv(x, w, transpose):
    dims = x.ndim - 2
    if transpose:
        dn = ("NHWC", "HWIO", "NHWC") if dims == 2 else ("NDHWC", "DHWIO", "NDHWC")
        return jax.lax.conv_transpose(
            x, jnp.swapaxes(w, -1, -2), strides=(2,) * dims, padding="VALID",
            dimension_numbers=dn, transpose_kernel=True, preferred_element_type=jnp.int32,
        )
    if dims == 2 and w.shape[0] == 3:
        return jax_int8._conv(x, w, jnp.int32)
    return jax.lax.conv_general_dilated(
        x, w, (1,) * dims, "SAME", dimension_numbers=jax_unet._conv_dim_numbers(dims),
        preferred_element_type=jnp.int32,
    )


# (spatial, C_in, C_out, k, transposed)
CASES = [
    ((9, 11), 1, 5, 3, False),
    ((9, 11), 7, 3, 3, False),
    ((8, 10), 32, 16, 3, False),
    ((6, 7), 256, 9, 3, False),  # sums past 2^24: f32 would round them
    ((9, 11), 33, 17, 1, False),
    ((5, 6), 8, 3, 2, True),
    ((4, 9), 7, 5, 2, True),
    ((5, 9, 11), 1, 5, 3, False),
    ((4, 6, 5), 13, 4, 3, False),
    ((4, 6, 5), 6, 6, 1, False),
    ((3, 4, 5), 9, 4, 2, True),
]
IDS = [f"{len(sp)}d-{'x'.join(map(str, sp))}-{ci}to{co}-k{k}{'t' if t else ''}" for sp, ci, co, k, t in CASES]


def _ints(rng, shape):
    return rng.integers(-127, 128, size=shape).astype(np.int8)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_int32_equals_xla(case):
    spatial, c_in, c_out, k, transpose = case
    rng = np.random.default_rng(sum(spatial) + 7 * c_in)
    x = _ints(rng, (2, *spatial, c_in))
    w = _ints(rng, (k,) * len(spatial) + (c_in, c_out))
    if c_in == 256:  # large same-signed values: sums of ~2e7
        x, w = np.abs(x) // 2 + 64, np.abs(w) // 2 + 64
    want = np.asarray(_jax_conv(jnp.asarray(x), jnp.asarray(w), transpose))
    got = kernels.qconv(torch.from_numpy(x), torch.from_numpy(w), transpose=transpose)
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if c_in == 256:
        assert np.abs(want).max() > 2**24


def test_transposed_kernel_is_not_flipped():
    """One input pixel, an asymmetric 2x2 kernel: output pixel (2i + a, 2j
    + b) holds w[a, b], as the JAX call's flip and transposition leave it."""
    x = np.zeros((1, 2, 2, 1), np.int8)
    x[0, 1, 0, 0] = 1
    w = np.arange(1, 5, dtype=np.int8).reshape(2, 2, 1, 1)
    want = np.asarray(_jax_conv(jnp.asarray(x), jnp.asarray(w), True))
    got = kernels.qconv(torch.from_numpy(x), torch.from_numpy(w), transpose=True).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 2:4, 0:2, 0], [[1, 2], [3, 4]])


@pytest.mark.parametrize("relu", [False, True])
def test_dequant_epilogue_is_ptq_unets(relu):
    rng = np.random.default_rng(3)
    x, w = _ints(rng, (1, 12, 10, 24)), _ints(rng, (3, 3, 24, 20))
    xs = np.float32(0.0123)
    ws = rng.uniform(1e-4, 1e-2, 20).astype(np.float32)
    b = rng.normal(0, 0.3, 20).astype(np.float32)
    acc = _jax_conv(jnp.asarray(x), jnp.asarray(w), False)
    want = acc.astype(jnp.float32) * (jnp.float32(xs) * jnp.asarray(ws)) + jnp.asarray(b)
    if relu:
        want = jax.nn.relu(want)
    xw = torch.tensor(xs) * torch.from_numpy(ws)
    got = kernels.qconv(torch.from_numpy(x), torch.from_numpy(w), epilogue="dequant", scale=xw,
                        bias=torch.from_numpy(b), relu=relu)
    np.testing.assert_array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32))


def test_requant_epilogue_is_the_studys_layer():
    rng = np.random.default_rng(4)
    x, w = _ints(rng, (1, 16, 16, 32)), _ints(rng, (3, 3, 32, 32))
    s = rng.uniform(1e-4, 1e-3, 32).astype(np.float32)
    b = (rng.normal(size=32) * 0.01).astype(np.float32)
    acc = _jax_conv(jnp.asarray(x), jnp.asarray(w), False)
    y = jax.nn.relu(acc.astype(jnp.float32) * jnp.asarray(s) + jnp.asarray(b))
    want = jnp.clip(jnp.round(y * jnp.float32(25.0)), -127, 127).astype(jnp.int8)
    got = kernels.qconv(torch.from_numpy(x), torch.from_numpy(w), epilogue="requant",
                        scale=torch.from_numpy(s), bias=torch.from_numpy(b), relu=True, inv_next=25.0)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < int((got == 127).sum()) < got.numel()


def test_qconv_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((1, 4, 4, 3), dtype=torch.int8)
    with pytest.raises(TypeError):
        kernels.qconv(x.float(), torch.zeros((3, 3, 3, 2), dtype=torch.int8))
    with pytest.raises(ValueError):  # a 2x2 kernel is the transposed conv only
        kernels.qconv(x, torch.zeros((2, 2, 3, 2), dtype=torch.int8))
    with pytest.raises(ValueError):  # channels
        kernels.qconv(x, torch.zeros((3, 3, 4, 2), dtype=torch.int8))
    with pytest.raises(ValueError):  # dequant without scale
        kernels.qconv(x, torch.zeros((3, 3, 3, 2), dtype=torch.int8), epilogue="dequant")
    with pytest.raises(ValueError):  # neither cuda nor cpu
        kernels.qconv(x.to("meta"), torch.zeros((3, 3, 3, 2), dtype=torch.int8, device="meta"))


def test_shapes_are_the_jax_studys():
    assert int8_conv.SHAPES == jax_int8.SHAPES


def test_bounds_are_the_data_sheets():
    """enc0b at 1024^2, 32 -> 32: 33.5 MB in and 134.2 MB of int32 out at
    3.35 TB/s (0.050 ms) against 19.3 G int8 operations at 1979 TOPS
    (0.0098 ms): bound by its bytes; with an int8 out, 0.020 ms."""
    ms, by = int8_conv.bound_ms((1024, 1024), 32, 32, 4)
    assert by == "bytes" and ms == pytest.approx(0.0501, abs=2e-4)
    ms, by = int8_conv.bound_ms((1024, 1024), 32, 32, 1)
    assert by == "bytes" and ms == pytest.approx(0.0200, abs=2e-4)


def test_study_rows_on_the_cpu():
    """``run`` on the CPU at two small shapes: every key of a row, a time
    for each path, the bound from the shape (no card: no library row)."""
    rows = int8_conv.run(iters=2, device="cpu", shapes=[("a", (16, 12), 1, 8), ("b", (8, 8), 16, 24)])
    assert [r["shape"] for r in rows] == ["a", "b"]
    for r in rows:
        assert r["device"] == "cpu" and r["int_mm_ms"] is None
        assert min(r["bf16_ms"], r["int8_ms"], r["ptq_layer_ms"]) > 0
        assert r["bound_ms"] > r["bound_ptq_ms"] > 0
