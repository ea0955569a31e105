"""The port's GAN (generator, ``fold_generator``, PatchGAN discriminator),
GAN enhancer and Noise2Void denoiser against ``sequitr_tpu.models.gan`` and
``sequitr_tpu.pipeline.infer`` on identical weights, at f32 within 1e-4,
and against the ``gan_generator`` and ``n2v_denoiser`` goldens."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequitr_tpu.models import convert as jax_convert
from sequitr_tpu.models import fixtures as jax_fixtures
from sequitr_tpu.models import gan as jax_gan
from sequitr_tpu.models import unet as jax_unet
from sequitr_tpu.pipeline import infer as jax_infer
from sequitr_tpu_torch.models import convert as torch_convert
from sequitr_tpu_torch.models import fixtures as torch_fixtures
from sequitr_tpu_torch.models import gan as torch_gan
from sequitr_tpu_torch.models import unet as torch_unet
from sequitr_tpu_torch.pipeline import infer as torch_infer

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _flat(params, state):
    flat = jax_convert.flatten_params(params)
    flat.update({f"state/{k}": v for k, v in jax_convert.flatten_params(state).items()})
    return flat


def _gan_pair(activation="sigmoid", seed=0, in_channels=1, out_channels=1):
    cfg = jax_gan.GANConfig(
        in_channels=in_channels, out_channels=out_channels, gen_depth=3,
        gen_base_features=4, disc_layers=2, disc_base_features=4,
        compute_dtype=jnp.float32, output_activation=activation,
    )
    params, state = jax_gan.init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed + 1)
    params = jax.tree.map(lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)
    state = jax.tree.map(lambda a: a + 0.1 * rng.random(a.shape).astype(np.float32), state)
    tcfg = torch_gan.GANConfig(**{**dataclasses.asdict(cfg), "compute_dtype": "float32"})
    return cfg, params, state, tcfg, torch_convert.load_flat(tcfg, _flat(params, state), device="cpu")


def test_fixture_round_trip_all_keys():
    """Every key of gan_denoise.npz (102: gen/..., disc/..., state/gen/...)."""
    with np.load(jax_fixtures.fixture_dir() + "/gan_denoise.npz") as npz:
        flat = {k: npz[k] for k in npz.files}
    assert len(flat) == 102
    kind, cfg, model, _ = torch_fixtures.load("gan_denoise", device="cpu")
    assert kind == "gan" and isinstance(cfg, torch_gan.GANConfig)
    assert model.disc.convs[0].w.shape == (64, 2, 4, 4)
    assert model.disc.head.w.shape == (1, 512, 4, 4)
    back = torch_convert.to_flat(model)
    assert set(back) == set(flat)
    for k, v in flat.items():
        np.testing.assert_array_equal(back[k], v.astype(np.float32), err_msg=k)


@pytest.mark.parametrize("activation", ["sigmoid", "tanh", "linear"])
def test_generator_and_fold_match_jax(activation):
    cfg, params, state, _, model = _gan_pair(activation)
    x = np.random.default_rng(2).random((2, 16, 24, 1)).astype(np.float32)
    want = np.asarray(jax_gan.generator_apply(cfg, params, state, jnp.asarray(x))[0])
    fcfg, fp, fs = jax_gan.fold_generator(cfg, params, state)
    want_f = np.asarray(jax_gan.generator_apply(fcfg, fp, fs, jnp.asarray(x))[0])
    folded = torch_gan.fold_generator(model)
    assert folded.cfg == torch_gan.GANConfig(**{**dataclasses.asdict(fcfg), "compute_dtype": "float32"})
    assert folded.disc is model.disc and torch_gan.fold_generator(folded) is folded
    with torch.inference_mode():
        got = torch_gan.generator_apply(model, torch.from_numpy(x)).numpy()
        got_f = torch_gan.generator_apply(folded, torch.from_numpy(x)).numpy()
    assert got.shape == (2, 16, 24, 1)
    assert np.max(np.abs(got - want)) < 1e-4
    assert np.max(np.abs(got_f - want_f)) < 1e-4


@pytest.mark.parametrize("shape", [(16, 16), (24, 40), (20, 28)])
def test_discriminator_matches_jax(shape):
    """k4 SAME convs: stride 2 pads (1, 1) on an even axis and (1, 2) on an
    odd one, stride 1 pads (1, 2) — XLA's asymmetric SAME."""
    cfg, params, _, _, model = _gan_pair(seed=3, in_channels=2, out_channels=1)
    rng = np.random.default_rng(4)
    x = rng.random((2,) + shape + (2,)).astype(np.float32)
    y = rng.random((2,) + shape + (1,)).astype(np.float32)
    want = np.asarray(jax_gan.discriminator_apply(cfg, params, jnp.asarray(x), jnp.asarray(y)))
    with torch.inference_mode():
        got = torch_gan.discriminator_apply(model, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) < 1e-4
    assert torch_gan._same_pads(16, 4, 1) == (1, 2) and torch_gan._same_pads(16, 4, 2) == (1, 1)


@pytest.mark.parametrize(
    "patch,overlap,tta,poly,batch",
    [
        ((32, 40), (0, 0), 1, False, None),
        ((16, 16), (4, 4), 4, False, None),
        ((32, 40), (0, 0), 8, False, 3),
        ((16, 16), (4, 8), 2, True, 2),
    ],
)
def test_gan_enhancer_matches_jax(patch, overlap, tta, poly, batch):
    cfg, params, state, tcfg, model = _gan_pair(seed=5)
    spatial = (32, 40) if tta != 8 else (32, 32)
    patch = patch if tta != 8 else spatial
    frames = np.random.default_rng(6).gamma(2.0, 60.0, (batch or 1,) + spatial).astype(np.float32)
    kw = dict(patch=patch, overlap=overlap, tta=tta, polyphase=poly)
    fcfg, fp, fs = jax_gan.fold_generator(cfg, params, state)
    enhance = jax_infer.make_gan_enhancer(fcfg, jax_infer.TileConfig(**kw), spatial)
    want = np.stack([np.asarray(enhance(fp, fs, jnp.asarray(f))) for f in frames])
    tc = torch_infer.TileConfig(**kw)
    if batch is None:
        got = torch_infer.make_gan_enhancer(tcfg, tc, spatial, device="cpu")(model, frames[0])[None]
    else:
        got = torch_infer.cached_gan_enhancer(tcfg, tc, spatial, batch, "cpu")(model, frames)
    assert got.shape == want.shape == (batch or 1,) + spatial + (1,)
    assert np.max(np.abs(got.numpy() - want)) < 1e-4


def test_enhancer_output_dtype_and_unfolded_model():
    """``probs_dtype`` is the enhanced map's dtype; an unfolded model is
    folded once and served like the folded one."""
    _, _, _, tcfg, model = _gan_pair(seed=7)
    frame = np.random.default_rng(8).random((16, 16)).astype(np.float32)
    tc = torch_infer.TileConfig(patch=(16, 16), overlap=(0, 0), probs_dtype="float16")
    run = torch_infer.make_gan_enhancer(tcfg, tc, (16, 16), device="cpu")
    a, b = run(model, frame), run(torch_gan.fold_generator(model), frame)
    assert a.dtype == torch.float16 and a.shape == (16, 16, 1)
    assert torch.equal(a, b)


def test_gan_generator_golden():
    """tests/goldens/gan_generator.npz: the folded bf16 gan_denoise
    generator on an exactly normalized 128x128 frame, made op by op
    (unet.py's rounding points, as the port's). Measured on the CPU: 85.6%
    of outputs equal, the rest a bf16 step of a sum in another order apart
    (max 2.5e-3 after the sigmoid)."""
    g = np.load(os.path.join(GOLDENS, "gan_generator.npz"))
    _, cfg, model, _ = torch_fixtures.load("gan_denoise", device="cpu")
    tc = torch_infer.TileConfig(patch=(128, 128), overlap=(0, 0), normalize="exact")
    out = torch_infer.make_gan_enhancer(cfg, tc, (128, 128), device="cpu")(model, g["image"])
    err = np.abs(out.numpy()[..., 0] - g["output"])
    assert np.mean(err == 0) >= 0.8
    assert np.quantile(err, 0.999) <= 2e-3
    assert err.max() <= 5e-3


def _n2v_pair(seed=9):
    cfg = jax_unet.UNetConfig(depth=2, base_features=4, num_classes=1, compute_dtype=jnp.float32)
    params, state = jax_unet.init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda a: a + 0.05 * rng.normal(size=a.shape).astype(np.float32), params)
    state = jax.tree.map(lambda a: a + 0.1 * rng.random(a.shape).astype(np.float32), state)
    tcfg = torch_unet.UNetConfig(**{**dataclasses.asdict(cfg), "compute_dtype": "float32"})
    return cfg, params, state, tcfg, torch_convert.load_flat(tcfg, _flat(params, state), device="cpu")


@pytest.mark.parametrize(
    "patch,overlap,tta,poly,normalize",
    [
        ((32, 32), (0, 0), 1, False, "none"),
        ((16, 16), (4, 4), 8, False, "auto"),
        ((16, 16), (4, 4), 2, True, "exact"),
    ],
)
def test_denoiser_matches_jax(patch, overlap, tta, poly, normalize):
    cfg, params, state, tcfg, model = _n2v_pair()
    frame = np.random.default_rng(10).gamma(2.0, 0.3, (32, 32)).astype(np.float32)
    kw = dict(patch=patch, overlap=overlap, tta=tta, polyphase=poly, normalize=normalize)
    want = np.asarray(jax_infer.make_denoiser(cfg, jax_infer.TileConfig(**kw), (32, 32))(
        params, state, jnp.asarray(frame)
    ))
    got = torch_infer.make_denoiser(tcfg, torch_infer.TileConfig(**kw), (32, 32), device="cpu")(
        model, frame
    )
    assert got.shape == want.shape == (32, 32, 1)
    assert np.max(np.abs(got.numpy() - want)) < 1e-4


def test_n2v_cells_f32_matches_jax_and_golden():
    """n2v_cells at f32 against the JAX denoiser (within 1e-4), and at its
    bf16 compute dtype against tests/goldens/n2v_denoiser.npz. The golden
    was made under jax.jit, whose CPU graph drops the bf16 rounding of each
    conv's output (ROADMAP Queue 3); the JAX denoiser run op by op misses
    it by as much as the port (measured on the CPU: max 1.2e-2, 99.9th
    percentile 6.8e-3 op by op; the port 1.4e-2 / 7.0e-3), so it is graded
    by the 99.9th percentile and the maximum."""
    g = np.load(os.path.join(GOLDENS, "n2v_denoiser.npz"))
    tc = torch_infer.TileConfig(patch=(128, 128), overlap=(0, 0), normalize="none")
    _, cfg, model, _ = torch_fixtures.load("n2v_cells", device="cpu")
    out = torch_infer.make_denoiser(cfg, tc, (128, 128), device="cpu")(model, g["noisy"])
    err = np.abs(out.numpy()[..., 0] - g["output"])
    assert np.quantile(err, 0.999) <= 1e-2
    assert err.max() <= 2e-2

    _, jcfg, params, state, _ = jax_fixtures.load("n2v_cells")
    jcfg = dataclasses.replace(jcfg, compute_dtype=jnp.float32)
    crop = g["noisy"][:64, :64]
    jtc = jax_infer.TileConfig(patch=(64, 64), overlap=(0, 0), normalize="none")
    want = np.asarray(jax_infer.make_denoiser(jcfg, jtc, (64, 64))(params, state, jnp.asarray(crop)))
    _, cfg32, model32, _ = torch_fixtures.load("n2v_cells", compute_dtype="float32", device="cpu")
    tc64 = torch_infer.TileConfig(patch=(64, 64), overlap=(0, 0), normalize="none")
    got = torch_infer.make_denoiser(cfg32, tc64, (64, 64), device="cpu")(model32, crop)
    assert np.max(np.abs(got.numpy() - want)) < 1e-4
