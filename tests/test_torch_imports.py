"""The port loads no JAX and nothing of ``sequitr_tpu``, and runs on the
card unless the caller asks for the CPU.

Checked in a fresh interpreter: this test process has JAX loaded already.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "sequitr_tpu_torch",
    "sequitr_tpu_torch.__main__",
    "sequitr_tpu_torch.config",
    "sequitr_tpu_torch.utils",
    "sequitr_tpu_torch.native",
    "sequitr_tpu_torch.localize",
    "sequitr_tpu_torch.data",
    "sequitr_tpu_torch.data.tiff",
    "sequitr_tpu_torch.data.source",
    "sequitr_tpu_torch.data.synthetic",
    "sequitr_tpu_torch.models",
    "sequitr_tpu_torch.models.unet",
    "sequitr_tpu_torch.models.convert",
    "sequitr_tpu_torch.models.fixtures",
    "sequitr_tpu_torch.models.polyphase",
    "sequitr_tpu_torch.ops",
    "sequitr_tpu_torch.ops.normalize",
    "sequitr_tpu_torch.ops.tiling",
    "sequitr_tpu_torch.ops.kernels",
    "sequitr_tpu_torch.ops.kernels.build",
    "sequitr_tpu_torch.ops.kernels.histogram",
    "sequitr_tpu_torch.ops.kernels.conv3x3",
    "sequitr_tpu_torch.pipeline",
    "sequitr_tpu_torch.pipeline.infer",
    "sequitr_tpu_torch.server",
    "sequitr_tpu_torch.server.jobs",
    "sequitr_tpu_torch.server.server",
    "sequitr_tpu_torch.server.pipelines",
    "sequitr_tpu_torch.server.pipelines.segmentation",
    "sequitr_tpu_torch.studies",
    "sequitr_tpu_torch.studies.conv2d",
    "sequitr_tpu_torch.studies.conv2d_gemm",
    "sequitr_tpu_torch.studies.conv2d_gemm2",
    "sequitr_tpu_torch.studies.winograd",
    "sequitr_tpu_torch.studies.polyphase_conv",
    "sequitr_tpu_torch.studies.conv3x3_parts",
    "sequitr_tpu_torch.studies.normalize_pass",
]

PROBE = """
import importlib, sys
for name in {modules!r}:
    importlib.import_module(name)
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.")
    or m == "sequitr_tpu" or m.startswith("sequitr_tpu.")
)
assert not bad, bad

import torch
torch.cuda.is_available = lambda: False  # the check holds with or without a card
from sequitr_tpu_torch import utils
from sequitr_tpu_torch.config import ServerConfiguration
from sequitr_tpu_torch.models import convert, unet
from sequitr_tpu_torch.pipeline import infer
from sequitr_tpu_torch.studies import polyphase_conv
from sequitr_tpu_torch.server import ImageServer

assert utils.DEFAULT_DEVICE == "cuda"
assert ServerConfiguration().device == "cuda"
cfg = unet.UNetConfig(depth=2, base_features=4)
tc = infer.TileConfig(patch=(16, 16), overlap=(0, 0))
calls = [
    lambda: utils.resolve_device(),
    lambda: unet.UNet(cfg),
    lambda: infer.make_frame_inferrer(cfg, tc, (16, 16)),
    lambda: convert.pack_conv3x3(torch.zeros(3, 3, 1, 1).numpy(), torch.zeros(1).numpy()),
    lambda: polyphase_conv.run(size=16, iters=1),
    lambda: polyphase_conv.main(["--size", "16", "--iters", "1"]),
    lambda: ImageServer(ServerConfiguration(jobs_dir={jobs!r}, models_dir={models!r})),
]
for call in calls:
    try:
        call()
    except RuntimeError as e:
        assert "no CUDA device" in str(e), e
    else:
        raise AssertionError("ran without a card and without device='cpu'")
assert utils.resolve_device("cpu").type == "cpu"
unet.UNet(cfg, device="cpu")
infer.make_frame_inferrer(cfg, tc, (16, 16), device="cpu")
ImageServer(ServerConfiguration(jobs_dir={jobs!r}, models_dir={models!r}, device="cpu"))
print("ok")
"""


def test_port_imports_no_jax_and_defaults_to_cuda(tmp_path):
    probe = PROBE.format(
        modules=MODULES, jobs=str(tmp_path / "jobs"), models=str(tmp_path / "models")
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-c", probe], cwd=str(tmp_path), env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")


def test_every_port_module_is_probed():
    """MODULES is exactly the package's modules, so the probe misses none."""
    pkg = os.path.join(REPO, "sequitr_tpu_torch")
    found = set()
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                name = rel.replace(os.sep, ".")
                found.add(name[: -len(".__init__")] if name.endswith(".__init__") else name)
    assert found == set(MODULES)
