"""The port's public surface is complete: every module of ``sequitr_tpu/``
has a module at the same relative path in ``sequitr_tpu_torch/``, and every
name in every ``__all__`` of ``sequitr_tpu/`` resolves in that module (a
top-level definition, assignment or import, or a name of its ``__all__``),
unless ``MODULE_MAP`` / ``NAME_MAP`` below gives its counterpart under
another path or name, with the reason. Each mapped counterpart must itself
resolve. Both packages are parsed with ``ast``; nothing is imported.

A JAX name or module added later without a counterpart fails here.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "sequitr_tpu")
PORT_PKG = os.path.join(REPO, "sequitr_tpu_torch")

# JAX module -> (port module, reason); paths relative to the package roots
MODULE_MAP = {
    "ops/pallas/__init__.py": (
        "ops/kernels/__init__.py", "the TPU kernels' package is the hand-written CUDA kernels' package"),
    "ops/pallas/histogram.py": (
        "ops/kernels/histogram.py", "the Pallas histogram is csrc/histogram.cu behind this wrapper"),
    "studies/pallas_conv2d.py": (
        "studies/conv2d.py", "the Pallas conv study is the CUDA conv study"),
    "studies/pallas_conv2d_gemm.py": (
        "studies/conv2d_gemm.py", "the Pallas GEMM conv study is the CUDA one"),
    "studies/pallas_conv2d_gemm2.py": (
        "studies/conv2d_gemm2.py", "the Pallas flat-CHW GEMM study is the CUDA one"),
}

# (JAX module, JAX name) -> (port module, port name, reason)
NAME_MAP = {
    ("utils.py", "force_cpu"): (
        "utils.py", "resolve_device",
        "no process-wide platform switch: every entry point takes device='cpu'"),
    ("ops/augment.py", "random_flip"): (
        "ops/augment.py", "draw_flip",
        "draws are made apart from their applies (draw_* / apply_*), so a step replays given draws"),
    ("ops/augment.py", "random_rot90"): (
        "ops/augment.py", "draw_rot90", "as random_flip: the draw; apply_rot90 applies it"),
    ("ops/augment.py", "photometric_jitter"): (
        "ops/augment.py", "draw_photometric", "as random_flip: the draw; apply_photometric applies it"),
    ("ops/qc.py", "make_frame_qc"): (
        "ops/qc.py", "frame_qc", "a jit factory; the eager function needs no factory"),
    ("ops/qc.py", "cached_frame_qc"): (
        "ops/qc.py", "frame_qc", "a jit cache; eager calls need no cache"),
    ("ops/projection.py", "cached_projector"): (
        "ops/projection.py", "make_projector", "a jit cache; eager projectors need no cache"),
    ("ops/tiling.py", "extract_patches_scan"): (
        "ops/tiling.py", "extract_patches",
        "an XLA graph-size variant of the same function (pipeline/infer.py:168)"),
    ("ops/tiling.py", "stitch_patches_scan"): (
        "ops/tiling.py", "stitch_patches", "an XLA graph-size variant of the same function"),
    ("models/unet.py", "apply"): (
        "models/unet.py", "UNet", "the forward is UNet.forward / forward_train on its parameters and buffers"),
    ("ops/pallas/histogram.py", "pallas_quantiles"): (
        "ops/kernels/histogram.py", "kernel_quantiles", "the quantile pass of csrc/histogram.cu"),
}


def _modules(root):
    out = []
    for base, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(base, f), root))
    return sorted(out)


def _parse(path):
    """``(__all__ or None, names bound at the module's top level)``."""
    tree = ast.parse(open(path).read(), path)
    exported, bound, literals = None, set(), {}

    def bind(node):
        for n in ast.walk(node):
            if isinstance(n, ast.Name):
                bound.add(n.id)

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            bound.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                bind(t)
            names = [t.id for t in node.targets if isinstance(t, ast.Name)]
            if "__all__" in names:
                # a list of strings, with *NAME of an earlier literal tuple
                exported = []
                for elt in node.value.elts:
                    if isinstance(elt, ast.Starred):
                        exported.extend(literals[elt.value.id])
                    else:
                        exported.append(ast.literal_eval(elt))
            else:
                try:
                    value = ast.literal_eval(node.value)
                except ValueError:
                    continue
                literals.update((n, value) for n in names)
        elif isinstance(node, ast.AnnAssign):
            bind(node.target)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for a in node.names:
                bound.add((a.asname or a.name).split(".")[0])
    return exported, bound


def _resolves(module, name):
    path = os.path.join(PORT_PKG, module)
    if not os.path.exists(path):
        return False
    exported, bound = _parse(path)
    return name in bound or name in (exported or ())


def _port_module(module):
    return MODULE_MAP[module][0] if module in MODULE_MAP else module


JAX_MODULES = _modules(JAX_PKG)
JAX_EXPORTS = [(m, n) for m in JAX_MODULES for n in (_parse(os.path.join(JAX_PKG, m))[0] or ())]


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_jax_module_has_a_port_module(module):
    assert os.path.exists(os.path.join(PORT_PKG, _port_module(module))), (
        f"sequitr_tpu/{module} has no counterpart in sequitr_tpu_torch/; port it or map it in MODULE_MAP"
    )


def test_every_jax_export_resolves_in_the_port():
    missing = []
    for module, name in JAX_EXPORTS:
        if (module, name) in NAME_MAP:
            continue
        if not _resolves(_port_module(module), name):
            missing.append(f"sequitr_tpu/{module}:{name}")
    assert not missing, "public JAX names the port lacks (port them or map them in NAME_MAP):\n" + "\n".join(missing)


@pytest.mark.parametrize("key", sorted(NAME_MAP), ids=lambda k: f"{k[0]}:{k[1]}")
def test_each_mapped_name_is_needed_and_resolves(key):
    module, name = key
    port_module, port_name, reason = NAME_MAP[key]
    assert key in JAX_EXPORTS, f"{key} is no longer a JAX export: drop it from NAME_MAP"
    assert not _resolves(port_module, name) or port_name == name, f"{key} resolves under its own name now"
    assert _resolves(port_module, port_name), f"the mapped counterpart {port_module}:{port_name} does not resolve"
    assert reason


@pytest.mark.parametrize("module", sorted(MODULE_MAP))
def test_each_mapped_module_is_needed_and_exists(module):
    assert module in JAX_MODULES and not os.path.exists(os.path.join(PORT_PKG, module))
    assert os.path.exists(os.path.join(PORT_PKG, MODULE_MAP[module][0])) and MODULE_MAP[module][1]


@pytest.mark.parametrize("module, name", [
    ("models/fixtures.py", "save"),
    ("models/convert.py", "flatten_params"),
    ("models/convert.py", "unflatten_like"),
    ("models/convert.py", "load_npz_weights"),
    ("data/prefetch.py", "batch_iterator"),
    ("ops/losses.py", "softmax_label_map"),
    ("models/unet.py", "param_count"),
    ("ops/registration.py", "hann2d"),
    ("parallel/mesh.py", "make_dp_frame_mapper"),
    ("models/tf_reference.py", "measure_tf_cpu_fps"),
])
def test_the_names_once_missing_are_ported_under_their_own_names(module, name):
    assert (module, name) in JAX_EXPORTS and (module, name) not in NAME_MAP
    exported, bound = _parse(os.path.join(PORT_PKG, module))
    assert name in bound and name in (exported or ())
