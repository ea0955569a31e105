"""The port's conv studies against ``sequitr_tpu.studies`` on the same inputs.

Seeded numpy inputs go through the Pallas study kernels (run by the Pallas
interpreter on the CPU, as ``tests/test_studies.py`` runs them) and through
``sequitr_tpu_torch.studies`` on CPU tensors, where each entry point runs
its kernel's plain PyTorch version. f32 results agree to 1e-4 (sums of at
most 576 products of unit-scale values, taken in another order); bf16
results to two bf16 steps (one rounding each, from f32 sums that differ in
their last bits). The CUDA kernels themselves are held against the same
plain versions on the card by ``chip_smoke.py``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequitr_tpu.studies import pallas_conv2d as jax_nhwc
from sequitr_tpu.studies import pallas_conv2d_gemm as jax_g
from sequitr_tpu.studies import pallas_conv2d_gemm2 as jax_g2
from sequitr_tpu.studies import winograd as jax_wino
from sequitr_tpu_torch.models import convert as torch_convert
from sequitr_tpu_torch.ops.kernels import build as torch_build
from sequitr_tpu_torch.ops.kernels import conv3x3 as torch_kernels
from sequitr_tpu_torch.studies import conv2d as torch_nhwc
from sequitr_tpu_torch.studies import conv2d_gemm as torch_g
from sequitr_tpu_torch.studies import conv2d_gemm2 as torch_g2
from sequitr_tpu_torch.studies import conv3x3_parts as torch_parts
from sequitr_tpu_torch.studies import winograd as torch_wino


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


# kind -> (seed, (H, W, C_in), C_out): the cases of tests/test_studies.py
CASES = {
    "nhwc": (0, (64, 128, 16), 8),
    "gemm": (1, (64, 64, 32), 16),
    "gemm2": (2, (32, 120, 16), 8),
}
# ... and, as "kind:shape", the shapes that reach every branch of the CUDA
# kernels' tensor-core bodies on the card (chip_smoke.py's conv kernel phase):
# ragged with an unaligned flat stride, aligned and ragged, a partial block
# of output channels, smaller than one tile, fewer tiles than ring stages
CARD_SHAPES = [
    ((70, 100, 32), 32), ((72, 104, 16), 8), ((40, 72, 48), 40), ((5, 7, 16), 8),
    ((8, 56, 32), 32),
]
for _i, (_shape, _c_out) in enumerate(CARD_SHAPES):
    for _kind in ("nhwc", "gemm", "gemm2"):
        CASES[f"{_kind}:{_shape[0]}x{_shape[1]}x{_shape[2]}to{_c_out}"] = (10 + _i, _shape, _c_out)
FLAT = {
    "gemm": (jax_g, jax_g.flatten_chw, jax_g.unflatten_chw, jax_g.conv3x3_gemm,
             torch_g.flatten_chw, torch_g.unflatten_chw, torch_g.conv3x3_gemm,
             torch_g.repad_chw, lambda w: w + 8),
    "gemm2": (jax_g2, jax_g2.flatten_chw2, jax_g2.unflatten_chw2, jax_g2.conv3x3_gemm2,
              torch_g2.flatten_chw2, torch_g2.unflatten_chw2, torch_g2.conv3x3_gemm2,
              torch_g2.repad_chw2, torch_g2.wb2),
}


def _inputs(kind, c_out=None, border=1.0):
    seed, shape, c_out_case = CASES[kind]
    c_out = c_out or c_out_case
    rng = np.random.default_rng(seed)
    x = rng.normal(size=shape).astype(np.float32)
    if border != 1.0:
        x[0] *= border
        x[-1] *= border
        x[:, 0] *= border
        x[:, -1] *= border
    w = (rng.normal(size=(3, 3, shape[2], c_out)) * 0.1).astype(np.float32)
    b = rng.normal(size=(c_out,)).astype(np.float32)
    return x, w, b


def _jax_plain_conv(x, w, b, act="relu"):
    """``jax.lax.conv_general_dilated`` + bias + activation with the study
    kernels' rounding points: operands in x's dtype, f32 sums, one rounding."""
    y = jax.lax.conv_general_dilated(
        x[None].astype(jnp.float32), w.astype(x.dtype).astype(jnp.float32), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), precision=jax.lax.Precision.HIGHEST,
    )[0] + b
    y = jnp.maximum(y, 0.0) if act == "relu" else y
    return np.asarray(y.astype(x.dtype).astype(jnp.float32))


def _jax_conv(kind, x, w, b, **kw):
    """The Pallas study kernel in interpret mode -> (H, W, C_out) array;
    where its TPU tile rules refuse the shape, the plain JAX conv."""
    h, w_img = x.shape[:2]
    kind = kind.split(":")[0]
    try:
        if kind == "nhwc":
            return np.asarray(
                jax_nhwc.conv3x3_bias_act(x, w, b, interpret=True, **kw).astype(jnp.float32)
            )
        _, flatten, unflatten, conv = FLAT[kind][:4]
        yf = conv(flatten(x), w, b, h, w_img, interpret=True, **kw)
        return np.asarray(unflatten(yf, h, w_img).astype(jnp.float32))
    except ValueError:
        return _jax_plain_conv(x, w, b, **kw)


def _torch_conv(kind, x, w, b, **kw):
    h, w_img = x.shape[:2]
    kind = kind.split(":")[0]
    if kind == "nhwc":
        return torch_nhwc.conv3x3_bias_act(x, w, b, **kw).float().numpy()
    flatten, unflatten, conv = FLAT[kind][4:7]
    yf = conv(flatten(x), w, b, h, w_img, **kw)
    return unflatten(yf, h, w_img).float().numpy()


def _t(*arrays, dtype=None):
    out = [torch.from_numpy(np.asarray(a)) for a in arrays]
    if dtype is not None:
        out[0] = out[0].to(dtype)
    return out


@pytest.mark.parametrize("act", ["relu", "none"])
@pytest.mark.parametrize("kind", sorted(CASES))
def test_conv_matches_pallas_f32(kind, act):
    x, w, b = _inputs(kind)
    want = _jax_conv(kind, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), act=act)
    got = _torch_conv(kind, *_t(x, w, b), act=act)
    assert got.shape == want.shape == x.shape[:2] + (w.shape[-1],)
    assert np.max(np.abs(got - want)) <= 1e-4
    if act == "none":
        assert got.min() < 0  # no activation was applied


def _bf16_steps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got - want| in bf16 steps of the larger value (a step is at most
    2^-7 of it), after taking off the 1e-4 that the f32 sums behind the two
    roundings may differ by (near zero, 1e-7 against 0 is no bf16 step)."""
    scale = np.maximum(np.abs(got), np.abs(want)) * 2.0**-7
    excess = np.maximum(np.abs(got - want) - 1e-4, 0.0)
    return np.where(excess > 0, excess / np.maximum(scale, 1e-30), 0.0)


@pytest.mark.parametrize("kind", sorted(CASES))
def test_conv_matches_pallas_bf16(kind):
    x, w, b = _inputs(kind)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    want = _jax_conv(kind, xj, jnp.asarray(w), jnp.asarray(b))
    got = _torch_conv(kind, *_t(x, w, b, dtype=torch.bfloat16))
    steps = _bf16_steps(got, want)
    assert steps.max() <= 2, steps.max()
    assert np.mean(got == want) >= 0.99


@pytest.mark.parametrize("kind", sorted(FLAT))
def test_flat_layout_equals_jax(kind):
    x, w, b = _inputs(kind)
    jmod, jflat, junflat, jconv, tflat, tunflat, tconv, _, wb_of = FLAT[kind]
    h, w_img, c = x.shape
    xf = tflat(torch.from_numpy(x))
    np.testing.assert_array_equal(xf.numpy(), np.asarray(jflat(jnp.asarray(x))))
    assert xf.shape == (c, jmod.MARGIN + (h + 16) * wb_of(w_img))
    y = np.random.default_rng(9).normal(size=(5, h * wb_of(w_img))).astype(np.float32)
    np.testing.assert_array_equal(
        tunflat(torch.from_numpy(y), h, w_img).numpy(),
        np.asarray(junflat(jnp.asarray(y), h, w_img)),
    )
    # the whole flat output, pad columns included, not only the pixels
    yj = np.asarray(jconv(jflat(jnp.asarray(x)), jnp.asarray(w), jnp.asarray(b), h, w_img, interpret=True))
    yt = tconv(xf, *_t(w, b), h, w_img).numpy()
    assert yt.shape == yj.shape
    assert np.max(np.abs(yt - yj)) <= 1e-4
    cols = yt.reshape(-1, h, wb_of(w_img))
    assert np.all(cols[:, :, 0] == 0) and np.all(cols[:, :, w_img + 1:] == 0)
    assert np.any(cols[:, :, 1] != 0) and np.any(cols[:, :, w_img] != 0)


@pytest.mark.parametrize("kind", sorted(FLAT))
def test_two_layer_chain_in_flat_layout(kind):
    """The output of one layer, re-padded as the layout contract says, feeds
    the next: equal to two NHWC convs. Border pixels are 40x the rest, so a
    row that wrapped into its neighbour, or a dirty ring, would show."""
    x, w1, b1 = _inputs(kind, border=40.0)
    c_mid = w1.shape[-1]
    rng = np.random.default_rng(77)
    w2 = (rng.normal(size=(3, 3, c_mid, 6)) * 0.1).astype(np.float32)
    b2 = rng.normal(size=(6,)).astype(np.float32)
    tflat, tunflat, tconv, repad = FLAT[kind][4:8]
    h, w_img = x.shape[:2]
    xt, w1t, b1t, w2t, b2t = _t(x, w1, b1, w2, b2)
    y1 = tconv(tflat(xt), w1t, b1t, h, w_img)
    x2 = repad(y1, w_img)
    assert torch.equal(x2, tflat(tunflat(y1, h, w_img)))
    got = tunflat(tconv(x2, w2t, b2t, h, w_img), h, w_img).numpy()
    want = torch_nhwc.conv3x3_bias_act(
        torch_nhwc.conv3x3_bias_act(xt, w1t, b1t), w2t, b2t
    ).numpy()
    scale = np.abs(want).max()
    assert scale > 10  # the border did reach the output
    assert np.max(np.abs(got - want)) <= 1e-5 * scale


def test_flat_reference_reads_the_ring_and_margin():
    """The plain flat version works on the layout itself: a non-zero ring or
    margin changes its result (it does not go through ``unflatten``)."""
    x, w, b = _inputs("gemm")
    h, w_img = x.shape[:2]
    xt, wt, bt = _t(x, w, b)
    xf = torch_g.flatten_chw(xt)
    clean = torch_g.conv3x3_gemm(xf, wt, bt, h, w_img)
    dirty = xf.clone()
    dirty[:, torch_g.MARGIN - 1] = 100.0  # last element of the margin
    dirty[:, torch_g.MARGIN + (w_img + 8)] = 100.0  # ring column of row 1
    out = torch_g.conv3x3_gemm(dirty, wt, bt, h, w_img)
    assert not torch.equal(out, clean)
    cols = out.reshape(-1, h, w_img + 8)
    assert torch.all(cols[:, :, 0] == 0)  # the mask holds all the same


def test_out_dtype_and_ragged_shapes():
    """Any H, W, C_in, C_out runs (the TPU tiling rules do not apply), and
    ``out_dtype`` rounds once from the f32 sum."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(13, 21, 3)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(3, 3, 3, 5)) * 0.1).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(5,)).astype(np.float32))
    y32 = torch_nhwc.conv3x3_bias_act(x, w, b)
    y16 = torch_nhwc.conv3x3_bias_act(x, w, b, out_dtype=torch.bfloat16)
    assert y32.shape == (13, 21, 5) and y16.dtype == torch.bfloat16
    assert torch.equal(y16, y32.to(torch.bfloat16))
    for flatten, unflatten, conv in (FLAT["gemm"][4:7], FLAT["gemm2"][4:7]):
        yf = unflatten(conv(flatten(x), w, b, 13, 21), 13, 21)
        assert torch.allclose(yf, y32, atol=1e-5)


def test_pack_weights_tap_order():
    """Row (dy*3 + dx)*C_in + ci of the packing is tap (dy, dx), channel ci."""
    w = np.arange(3 * 3 * 2 * 4, dtype=np.float32).reshape(3, 3, 2, 4)
    wk, bk = torch_convert.pack_conv3x3(w, np.zeros(4, np.float32), device="cpu")
    assert wk.shape == (18, 4) and bk.dtype == torch.float32
    np.testing.assert_array_equal(wk[(2 * 3 + 1) * 2 + 1].numpy(), w[2, 1, 1])
    # same packing as the Pallas wrappers: (9*C_in, C_out), and its transpose
    np.testing.assert_array_equal(wk.numpy(), w.reshape(18, 4))


def test_wrappers_check_inputs():
    x = torch.zeros(8, 8, 2)
    w, b = torch.zeros(3, 3, 2, 3), torch.zeros(3)
    with pytest.raises(TypeError):
        torch_nhwc.conv3x3_bias_act(x.double(), w, b)
    with pytest.raises(ValueError):
        torch_nhwc.conv3x3_bias_act(x, w, b, act="gelu")
    with pytest.raises(ValueError):
        torch_nhwc.conv3x3_bias_act(x, torch.zeros(3, 3, 4, 3), b)
    with pytest.raises(ValueError):
        torch_g.conv3x3_gemm(torch.zeros(2, 100), w, b, 8, 8)
    with pytest.raises(ValueError):
        torch_g.conv3x3_gemm(torch_g2.flatten_chw2(x), w, b, 8, 8)  # wrong stride


def test_no_card_raises_and_cpu_never_counts_launches(monkeypatch):
    """Without a card nothing runs the plain version in the kernel's place:
    a device request raises, a tensor that is neither on the CPU nor on a
    card raises, and a build without nvcc raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    w, b = np.zeros((3, 3, 2, 3), np.float32), np.zeros(3, np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        torch_convert.pack_conv3x3(w, b)
    wk, bk = torch_convert.pack_conv3x3(w, b, device="cpu")
    with pytest.raises(ValueError, match="cuda or cpu"):
        torch_kernels.conv3x3_nhwc(torch.zeros(4, 4, 2, device="meta"), wk.to("meta"), bk.to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        torch_kernels.conv3x3_flat_chw(
            torch_g.flatten_chw(torch.zeros(4, 4, 2)).to("meta"),
            wk.to("meta"), bk.to("meta"), 4, 4, 12, 128,
        )
    monkeypatch.setattr(torch_build, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        torch_build.build("conv3x3", force=True)
    with pytest.raises(ValueError, match="unknown kernel"):
        torch_build.build("conv5x5")
    before = (torch_kernels.conv3x3_nhwc.launches, torch_kernels.conv3x3_flat_chw.launches)
    torch_kernels.conv3x3_nhwc(torch.zeros(4, 4, 2), wk, bk)
    assert before == (torch_kernels.conv3x3_nhwc.launches, torch_kernels.conv3x3_flat_chw.launches)


def test_failed_build_leaves_no_file(monkeypatch):
    """Neither a missing nvcc nor one that fails leaves a temporary file in
    the build directory."""
    def leftovers():
        d = torch_build._BUILD_DIR
        return sorted(f for f in os.listdir(d) if f.endswith(".tmp")) if os.path.isdir(d) else []

    assert leftovers() == []
    monkeypatch.setattr(torch_build, "_nvcc", lambda: (_ for _ in ()).throw(
        RuntimeError("nvcc not found")))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        torch_build.build("conv3x3", force=True)
    assert leftovers() == []
    monkeypatch.setattr(torch_build, "_nvcc", lambda: "false")  # exits 1, writes nothing
    with pytest.raises(RuntimeError, match="build failed"):
        torch_build.build("histogram", force=True)
    assert leftovers() == []


def test_build_variants_and_card_only_study():
    """A study builds a variant of a kernel under its own name, from the
    same source with switches set; the parts study refuses to run without a
    card instead of timing the CPU."""
    src, lib = torch_build._paths("conv3x3", "without_stores")
    assert src.endswith("csrc/conv3x3.cu") and lib.endswith("libconv3x3-without_stores.so")
    assert torch_build._paths("conv3x3")[1].endswith("libconv3x3.so")
    with pytest.raises(ValueError, match="variant"):
        torch_build.build("conv3x3", defines=("CONV3X3_WITHOUT_STORES",))
    with open(src) as f:
        text = f.read()
    for defines in torch_parts.VARIANTS.values():
        assert all(f"#ifdef {d}" in text or f"#ifndef {d}" in text for d in defines)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            torch_parts.run()


def test_build_flags_are_per_kernel():
    """The histogram keeps -fmad=false (bucket parity); the conv must not
    have it: its accumulation is made of fused multiply-adds."""
    assert "-fmad=false" in torch_build.NVCC_FLAGS["histogram"]
    assert "-fmad=false" not in torch_build.NVCC_FLAGS["conv3x3"]
    for flags in torch_build.NVCC_FLAGS.values():
        assert "arch=compute_90a,code=sm_90a" in flags


def test_winograd_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 16, 24, 8)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 8, 4)) * 0.2).astype(np.float32)
    b = rng.normal(size=(4,)).astype(np.float32)
    want = np.asarray(jax_wino.winograd_conv3x3(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = torch_wino.winograd_conv3x3(*_t(x, w, b)).numpy()
    assert got.shape == want.shape == (2, 16, 24, 4)
    assert np.max(np.abs(got - want)) <= 1e-4
    np.testing.assert_allclose(
        torch_wino.transform_weights(torch.from_numpy(w)).numpy(),
        np.asarray(jax_wino.transform_weights(jnp.asarray(w))), atol=1e-6,
    )
    # and against the direct conv of this package
    direct = torch.stack([
        torch_nhwc.conv3x3_bias_act(xi, *_t(w, b), act="none") for xi in torch.from_numpy(x)
    ]).numpy()
    assert np.max(np.abs(got - direct)) <= 1e-4
    with pytest.raises(ValueError):
        torch_wino.winograd_conv3x3(torch.zeros(1, 5, 4, 1), torch.zeros(3, 3, 1, 1))


def test_winograd_differentiable():
    x = torch.ones(1, 8, 8, 2)
    w = (torch.ones(3, 3, 2, 2) * 0.1).requires_grad_()
    (torch_wino.winograd_conv3x3(x, w) ** 2).sum().backward()
    assert torch.all(torch.isfinite(w.grad))
    g = jax.grad(lambda ww: jnp.sum(jax_wino.winograd_conv3x3(jnp.ones((1, 8, 8, 2)), ww) ** 2))(
        jnp.ones((3, 3, 2, 2)) * 0.1
    )
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(g), rtol=1e-4)
