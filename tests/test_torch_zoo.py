"""The model presets and the architecture JSON against the JAX package.

``models/zoo.py``: the same 14 presets field for field (dtypes compared by
name), the same ``KeyError`` text, ``create`` through the port's inits.
The architecture JSON builds the JAX package's network:
``unet_config_from_params`` reads the JAX server's fields only (no
``features_cap``, no ``upsample``; ``preset`` returns the preset and
ignores the rest), and ``import-model --kind gan`` reads the seven keys of
the JAX CLI (no ``output_activation``, no ``gen_norm``).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sequitr_tpu import __main__ as jax_main
from sequitr_tpu.models import convert as jax_convert
from sequitr_tpu.models import gan as jax_gan
from sequitr_tpu.models import zoo as jax_zoo
from sequitr_tpu.server.server import unet_config_from_params as jax_unet_config
from sequitr_tpu_torch import __main__ as torch_main
from sequitr_tpu_torch.models import convert as torch_convert
from sequitr_tpu_torch.models import zoo
from sequitr_tpu_torch.server.server import config_from_arch, unet_config_from_params


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d["compute_dtype"] = np.dtype(cfg.compute_dtype).name if not isinstance(cfg.compute_dtype, str) else cfg.compute_dtype
    return type(cfg).__name__, d


def test_presets_match_the_reference_field_for_field():
    assert zoo.names() == jax_zoo.names() and len(zoo.names()) == 14
    for name in zoo.names():
        assert _fields(zoo.get(name)) == _fields(jax_zoo.get(name)), name


def test_unknown_preset_has_the_reference_text():
    with pytest.raises(KeyError) as ours:
        zoo.get("unet9d")
    with pytest.raises(KeyError) as theirs:
        jax_zoo.get("unet9d")
    assert str(ours.value) == str(theirs.value)
    assert "unknown preset 'unet9d'; available: [" in str(ours.value)


@pytest.mark.parametrize("name", ["n2v_denoise", "gan_enhance"])
def test_create_builds_the_reference_shapes(name):
    cfg, model = zoo.create(name, torch.Generator().manual_seed(0), device="cpu")
    assert cfg is zoo.get(name)
    _, params, state = jax_zoo.create(name, jax.random.PRNGKey(0))
    want = dict(jax_convert.flatten_params(params))
    want.update({f"state/{k}": v for k, v in jax_convert.flatten_params(state).items()})
    got = torch_convert.to_flat(model)
    assert {k: tuple(v.shape) for k, v in got.items()} == {k: tuple(np.shape(v)) for k, v in want.items()}


ARCHS = {
    "fields": {"in_channels": 2, "num_classes": 4, "depth": 3, "base_features": 16, "dims": 2,
               "norm": "none", "compute_dtype": "float32", "space_to_depth": 2},
    # fields the JAX server does not read stay at their defaults
    "features_cap_upsample": {"depth": 3, "features_cap": 16, "upsample": "resize", "bn_momentum": 0.5},
    "defaults": {},
    "volume": {"dims": 3, "depth": 2, "base_features": 8},
    # a preset: every other field ignored
    "preset": {"preset": "unet3d_binary", "depth": 2, "num_classes": 7, "features_cap": 16},
    "preset_fast": {"preset": "n2v_denoise_fast"},
}


@pytest.mark.parametrize("case", sorted(ARCHS))
def test_unet_config_from_params_builds_the_reference_config(case):
    p = ARCHS[case]
    got = unet_config_from_params(dict(p))
    assert _fields(got) == _fields(jax_unet_config(dict(p)))
    assert _fields(config_from_arch("n2v", dict(p))) == _fields(got)
    if case == "features_cap_upsample":
        assert (got.features_cap, got.upsample, got.bn_momentum) == (512, "transpose", 0.9)


def test_unknown_preset_in_an_arch_fails_with_the_reference_text():
    with pytest.raises(KeyError) as ours:
        unet_config_from_params({"preset": "nope"})
    with pytest.raises(KeyError) as theirs:
        jax_unet_config({"preset": "nope"})
    assert str(ours.value) == str(theirs.value)


GAN_ARCH = {"gen_depth": 2, "gen_base_features": 8, "disc_layers": 2, "disc_base_features": 8,
            "compute_dtype": "float32", "output_activation": "tanh", "gen_norm": "none", "in_channels": 1}


def test_import_model_gan_registers_the_reference_config(tmp_path):
    """The same npz and arch through both CLIs: the same config.json (the
    arch's ``output_activation`` and ``gen_norm`` ignored, as the JAX CLI
    does)."""
    jcfg = jax_gan.GANConfig(gen_depth=2, gen_base_features=8, disc_layers=2, disc_base_features=8,
                             compute_dtype=jnp.float32)
    params, state = jax_gan.init(jax.random.PRNGKey(0), jcfg)
    npz = str(tmp_path / "gan.npz")
    np.savez(npz, **jax_convert.flatten_params(params),
             **{f"state/{k}": v for k, v in jax_convert.flatten_params(state).items()})
    arch = str(tmp_path / "arch.json")
    with open(arch, "w") as f:
        json.dump(GAN_ARCH, f)
    cfg = config_from_arch("gan", GAN_ARCH)
    assert (cfg.output_activation, cfg.gen_norm) == ("sigmoid", "batch")
    for main, where in ((torch_main.main, "torch"), (jax_main.main, "jax")):
        assert main(["import-model", "--models-dir", str(tmp_path / where), "--npz", npz, "--arch", arch,
                     "--kind", "gan", "g"]) == 0
    configs = []
    for where in ("torch", "jax"):
        with open(tmp_path / where / "g" / "config.json") as f:
            configs.append(json.load(f))
    assert configs[0] == configs[1]
    assert configs[0]["output_activation"] == "sigmoid" and configs[0]["__kind__"] == "gan"
