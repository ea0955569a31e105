"""The port's volumetric polyphase forward (``polyphase.apply3d``) against
``sequitr_tpu.models.polyphase.apply3d`` and against the port's own 3D
forward, on identical weights.

The JAX forward runs op by op (``jax.disable_jit``). At f32 polyphase and
standard forwards hold the same sums in another order: relative error <
1e-5, argmax agreement >= 0.999. At bf16 the port's up-conv and head round
their output where ``UNet._conv`` rounds (the JAX package's einsums keep
f32 there), so the port's polyphase forward agrees with its own standard
forward, not with the JAX polyphase forward, to a bf16 step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequitr_tpu.models import convert as jax_convert
from sequitr_tpu.models import polyphase as jax_poly
from sequitr_tpu.models import unet as jax_unet
from sequitr_tpu_torch.data import synthetic
from sequitr_tpu_torch.models import convert as torch_convert
from sequitr_tpu_torch.models import fixtures as torch_fixtures
from sequitr_tpu_torch.models import polyphase as torch_poly
from sequitr_tpu_torch.models import unet as torch_unet


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _pair(seed=0, depth=3, in_channels=1, num_classes=3):
    """A folded f32 3D U-Net as JAX pytrees and as the port's model."""
    cfg = jax_unet.UNetConfig(
        dims=3, depth=depth, base_features=4, in_channels=in_channels,
        num_classes=num_classes, compute_dtype=jnp.float32,
    )
    params, state = jax_unet.init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed + 1)
    params = jax.tree.map(lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)
    state = jax.tree.map(lambda a: a + 0.1 * rng.random(a.shape).astype(np.float32), state)
    flat = jax_convert.flatten_params(params)
    flat.update({f"state/{k}": v for k, v in jax_convert.flatten_params(state).items()})
    tcfg = torch_unet.UNetConfig(**{**dataclasses.asdict(cfg), "compute_dtype": "float32"})
    model = torch_unet.fold_batchnorm(torch_convert.load_flat(tcfg, flat, device="cpu"))
    return jax_unet.fold_batchnorm(cfg, params, state), model


def _rel_err(a, b):
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-9)


def _to_dhwio(w: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(w.permute(2, 3, 4, 1, 0).numpy())


@pytest.mark.parametrize("c_in,c_out", [(1, 4), (3, 2)])
def test_phase_kernel3d_bit_equal_after_layout_map(c_in, c_out):
    w = np.random.default_rng(c_in + c_out).normal(size=(3, 3, 3, c_in, c_out)).astype(np.float32)
    want = np.asarray(jax_poly.phase_kernel3d(jnp.asarray(w)))
    got = torch_poly.phase_kernel3d(torch.from_numpy(np.transpose(w, (4, 3, 0, 1, 2)).copy()))
    assert got.shape == (4 * c_out, 4 * c_in, 3, 3, 3)
    np.testing.assert_array_equal(_to_dhwio(got), want)
    with pytest.raises(ValueError):
        torch_poly.phase_kernel3d(torch.zeros(2, 2, 3, 3))


def test_phase_up_kernel3d_is_both_parities_stacked():
    w = np.random.default_rng(7).normal(size=(2, 2, 2, 5, 3)).astype(np.float32)
    even, odd = (np.asarray(m) for m in jax_poly.phase_up_kernel3d(jnp.asarray(w)))
    # the stored DHWIO kernel in the port's transposed layout (C_in, C_out, 2, 2, 2)
    got = torch_poly.phase_up_kernel3d(torch.from_numpy(np.transpose(w, (3, 4, 0, 1, 2)).copy()))
    assert got.shape == (24, 5, 1, 1, 1)
    np.testing.assert_array_equal(got[:, :, 0, 0, 0].numpy().T, np.concatenate([even, odd], axis=1))
    with pytest.raises(ValueError):
        torch_poly.phase_up_kernel3d(torch.zeros(5, 3, 2, 2))


@pytest.mark.parametrize("depth,shape", [(2, (2, 4, 12, 16)), (3, (1, 8, 16, 8))])
def test_matches_jax_apply3d_and_standard_forward(depth, shape):
    (fcfg, fp, fs), model = _pair(depth=depth)
    x = np.random.default_rng(depth).gamma(2.0, 1.0, shape + (1,)).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jax_poly.apply3d(fcfg, fp, fs, jnp.asarray(x)))
    with torch.inference_mode():
        got = torch_poly.apply3d(model, torch.from_numpy(x)).numpy()
        base = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == shape + (3,)
    assert _rel_err(got, want) < 1e-5
    assert _rel_err(got, base) < 1e-5
    assert np.mean(got.argmax(-1) == base.argmax(-1)) >= 0.999
    assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.999


def test_multichannel_multiclass():
    (fcfg, fp, fs), model = _pair(seed=2, depth=2, in_channels=2, num_classes=4)
    x = np.random.default_rng(2).normal(size=(1, 2, 8, 8, 2)).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(jax_poly.apply3d(fcfg, fp, fs, jnp.asarray(x)))
    with torch.inference_mode():
        got = torch_poly.apply3d(model, torch.from_numpy(x)).numpy()
    assert _rel_err(got, want) < 1e-5


@pytest.mark.parametrize("dtype,bar", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_unet3d_cells_polyphase_matches_standard(dtype, bar):
    """The committed 3D fixture, folded, on an 8x32x32 synthetic volume."""
    _, _, model, _ = torch_fixtures.load("unet3d_cells", compute_dtype=dtype, device="cpu")
    model = torch_unet.fold_batchnorm(model)
    vol, _ = synthetic.cells_volume(31_400, (8, 32, 32))
    x = torch.from_numpy((vol / vol.max()).astype(np.float32))[None, ..., None]
    with torch.inference_mode():
        base = model(x).numpy()
        got = torch_poly.apply3d(model, x).numpy()
    assert _rel_err(got, base) < bar
    assert np.mean(got.argmax(-1) == base.argmax(-1)) >= 0.999


def test_bf16_up_conv_and_head_round_where_unet_conv_does(monkeypatch):
    """At bf16 every phase conv of the port, the 1x1x1 up-conv and head
    included, emits bf16 and adds its f32 bias after the upcast, as
    ``UNet._conv`` does for the standard forward's transposed conv and head;
    the JAX package's apply3d keeps the up-conv's and head's f32 einsum
    sums. Both stay within a bf16 step of the standard forward."""
    import torch.nn.functional as F

    (fcfg, fp, fs), model = _pair(seed=4, depth=2)
    bf = torch_unet.UNet(dataclasses.replace(model.cfg, compute_dtype="bfloat16"), device="cpu")
    bf.load_state_dict(model.state_dict())
    emitted = []

    class Recording:
        def __getattr__(self, name):
            return getattr(F, name)

        def conv3d(self, x, w, **kw):
            y = F.conv3d(x, w, **kw)
            emitted.append((tuple(w.shape[2:]), y.dtype))
            return y

    monkeypatch.setattr(torch_poly, "F", Recording())
    x = np.random.default_rng(4).gamma(2.0, 1.0, (1, 4, 16, 16, 1)).astype(np.float32)
    with torch.inference_mode():
        got = torch_poly.Polyphase3d(bf)(torch.from_numpy(x)).numpy()
        base = bf(torch.from_numpy(x)).numpy()
    assert [k for k, _ in emitted] == [(3, 3, 3)] * 2 + [(1, 1, 1)] + [(3, 3, 3)] * 2 + [(1, 1, 1)]
    assert all(dt == torch.bfloat16 for _, dt in emitted)
    with jax.disable_jit():
        jcfg = dataclasses.replace(fcfg, compute_dtype=jnp.bfloat16)
        want = np.asarray(jax_poly.apply3d(jcfg, fp, fs, jnp.asarray(x)))
    assert np.mean(got.argmax(-1) == base.argmax(-1)) >= 0.999
    assert _rel_err(got, base) < 2e-2 and _rel_err(want, base) < 2e-2


def test_rejects_unsupported_configs():
    cfg = torch_unet.UNetConfig(dims=3, depth=2, base_features=4, compute_dtype="float32")
    x = torch.zeros(1, 4, 8, 8, 1)
    with pytest.raises(ValueError, match="folded"):
        torch_poly.apply3d(torch_unet.UNet(cfg, device="cpu"), x)
    for bad in (dict(upsample="resize"), dict(depth=1)):
        model = torch_unet.UNet(dataclasses.replace(cfg, norm="none", **bad), device="cpu")
        with pytest.raises(ValueError):
            torch_poly.Polyphase3d(model)
    ok = torch_unet.UNet(dataclasses.replace(cfg, norm="none"), device="cpu")
    with pytest.raises(ValueError, match="even"):
        torch_poly.apply3d(ok, torch.zeros(1, 4, 6, 8, 1)[:, :, :5])
    with pytest.raises(ValueError, match="2D models"):
        torch_poly.apply(ok, x)
    assert isinstance(torch_poly.serving(ok), torch_poly.Polyphase3d)
    assert torch_poly.eligible3d(ok.cfg, (5, 8, 8)) and not torch_poly.eligible3d(ok.cfg, (4, 8, 7))
    assert not torch_poly.eligible3d(ok.cfg, (8, 8))
    assert torch_poly.eligible3d(ok.cfg, (5, 8, 8)) == jax_poly.eligible3d(
        jax_unet.UNetConfig(dims=3, depth=2, norm="none"), (5, 8, 8)
    )
