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
    "sequitr_tpu_torch.client",
    "sequitr_tpu_torch.examples",
    "sequitr_tpu_torch.config",
    "sequitr_tpu_torch.fidelity",
    "sequitr_tpu_torch.utils",
    "sequitr_tpu_torch.native",
    "sequitr_tpu_torch.localize",
    "sequitr_tpu_torch.mosaic",
    "sequitr_tpu_torch.psf",
    "sequitr_tpu_torch.tracking",
    "sequitr_tpu_torch.tracing",
    "sequitr_tpu_torch.data",
    "sequitr_tpu_torch.data.tiff",
    "sequitr_tpu_torch.data.source",
    "sequitr_tpu_torch.data.synthetic",
    "sequitr_tpu_torch.data.records",
    "sequitr_tpu_torch.data.prefetch",
    "sequitr_tpu_torch.models",
    "sequitr_tpu_torch.models.unet",
    "sequitr_tpu_torch.models.cpnet",
    "sequitr_tpu_torch.models.convert",
    "sequitr_tpu_torch.models.fixtures",
    "sequitr_tpu_torch.models.gan",
    "sequitr_tpu_torch.models.polyphase",
    "sequitr_tpu_torch.models.torch_reference",
    "sequitr_tpu_torch.models.tf_reference",
    "sequitr_tpu_torch.models.zoo",
    "sequitr_tpu_torch.ops",
    "sequitr_tpu_torch.ops.normalize",
    "sequitr_tpu_torch.ops.tiling",
    "sequitr_tpu_torch.ops.losses",
    "sequitr_tpu_torch.ops.augment",
    "sequitr_tpu_torch.ops.weightmaps",
    "sequitr_tpu_torch.ops.flows",
    "sequitr_tpu_torch.ops.stardist",
    "sequitr_tpu_torch.ops.registration",
    "sequitr_tpu_torch.ops.illumination",
    "sequitr_tpu_torch.ops.qc",
    "sequitr_tpu_torch.ops.projection",
    "sequitr_tpu_torch.ops.colocalize",
    "sequitr_tpu_torch.ops.kernels",
    "sequitr_tpu_torch.ops.kernels.build",
    "sequitr_tpu_torch.ops.kernels.histogram",
    "sequitr_tpu_torch.ops.kernels.conv3x3",
    "sequitr_tpu_torch.ops.kernels.qconv",
    "sequitr_tpu_torch.pipeline",
    "sequitr_tpu_torch.pipeline.infer",
    "sequitr_tpu_torch.pipeline.optim",
    "sequitr_tpu_torch.pipeline.train",
    "sequitr_tpu_torch.pipeline.fit",
    "sequitr_tpu_torch.parallel",
    "sequitr_tpu_torch.parallel.mesh",
    "sequitr_tpu_torch.parallel.spatial",
    "sequitr_tpu_torch.parallel.spatial_train",
    "sequitr_tpu_torch.server",
    "sequitr_tpu_torch.server.jobs",
    "sequitr_tpu_torch.server.server",
    "sequitr_tpu_torch.server.pipelines",
    "sequitr_tpu_torch.server.pipelines.gan_denoise",
    "sequitr_tpu_torch.server.pipelines.geometry",
    "sequitr_tpu_torch.server.pipelines.optics",
    "sequitr_tpu_torch.server.pipelines.instances",
    "sequitr_tpu_torch.server.pipelines.segmentation",
    "sequitr_tpu_torch.server.pipelines.training",
    "sequitr_tpu_torch.server.pipelines.quantify",
    "sequitr_tpu_torch.server.pipelines.interop",
    "sequitr_tpu_torch.studies",
    "sequitr_tpu_torch.studies.conv2d",
    "sequitr_tpu_torch.studies.conv2d_gemm",
    "sequitr_tpu_torch.studies.conv2d_gemm2",
    "sequitr_tpu_torch.studies.winograd",
    "sequitr_tpu_torch.studies.polyphase_conv",
    "sequitr_tpu_torch.studies.conv3x3_parts",
    "sequitr_tpu_torch.studies.normalize_pass",
    "sequitr_tpu_torch.studies.flow_gather",
    "sequitr_tpu_torch.studies.fixture_init",
    "sequitr_tpu_torch.studies.ptq_unet",
    "sequitr_tpu_torch.studies.int8_conv",
    "sequitr_tpu_torch.studies.roofline",
    "sequitr_tpu_torch.tools",
    "sequitr_tpu_torch.tools.make_fixtures",
] + [
    f"sequitr_tpu_torch.examples.{name}"
    for name in (
        "correct_illumination", "denoise_n2v", "distill_fast_model", "enhance_denoise",
        "localize_3d", "migrate_checkpoint", "operate_jobs", "qc_review", "quantify_workflow",
        "register_and_chain", "segment_instances_flows", "segment_instances_stars",
        "segment_timelapse", "segment_volume_3d", "stitch_mosaic", "stream_large_stack",
        "track_lineage",
    )
]

PROBE = """
import importlib, sys
for name in {modules!r}:
    importlib.import_module(name)
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.")
    or m == "sequitr_tpu" or m.startswith("sequitr_tpu.")
    or m == "tensorflow" or m.startswith("tensorflow.")
)
assert not bad, bad
from sequitr_tpu_torch.server.server import REGISTRY
for job in (
    "evaluate_unet2d", "evaluate_unet3d", "parity_check", "evaluate_gan",
    "evaluate_denoise", "evaluate_flows", "evaluate_stars", "build_gan_pairs",
    "train_gan", "train_n2v", "train_flows", "train_stars", "register_stack",
    "stitch_mosaic", "correct_illumination", "localize_emitters",
    "calibrate_astigmatism", "deconvolve", "measure_objects", "count_spots",
    "measure_tracks", "track_objects", "export_ctc", "qc_stack", "project_stack",
    "finetune_spatial",
):
    assert job in REGISTRY.names(), job
# the test hooks register only under SEQUITR_TEST_WEDGE / SEQUITR_TEST_SLOW
assert "__test_wedge__" not in REGISTRY.names() and "__test_slow__" not in REGISTRY.names()

import torch
torch.cuda.is_available = lambda: False  # the check holds with or without a card
from sequitr_tpu_torch import fidelity, mosaic, parallel, psf, utils
from sequitr_tpu_torch.config import ServerConfiguration
from sequitr_tpu_torch.models import convert, gan, unet, zoo
from sequitr_tpu_torch.ops import flows
from sequitr_tpu_torch.pipeline import fit, infer, train
from sequitr_tpu_torch.studies import flow_gather, int8_conv, polyphase_conv, roofline
from sequitr_tpu_torch.server import ImageServer
from sequitr_tpu_torch.tools import make_fixtures

assert utils.DEFAULT_DEVICE == "cuda"
assert ServerConfiguration().device == "cuda"
cfg = unet.UNetConfig(depth=2, base_features=4)
cfg3 = unet.UNetConfig(dims=3, depth=2, base_features=4)
gcfg = gan.GANConfig(gen_depth=2, gen_base_features=4)
tc = infer.TileConfig(patch=(16, 16), overlap=(0, 0))
tc3 = infer.TileConfig(patch=(4, 16, 16), overlap=(0, 0, 0))
calls = [
    lambda: utils.resolve_device(),
    lambda: unet.UNet(cfg),
    lambda: unet.UNet(cfg3),
    lambda: gan.GAN(gcfg),
    lambda: infer.make_frame_inferrer(cfg, tc, (16, 16)),
    lambda: infer.make_frame_inferrer(cfg3, tc3, (4, 16, 16)),
    lambda: infer.make_gan_enhancer(gcfg, tc, (16, 16)),
    lambda: infer.make_denoiser(cfg3, tc3, (4, 16, 16)),
    lambda: infer.make_flows_segmenter(unet.UNetConfig(depth=2, num_classes=3), tc, (16, 16)),
    lambda: infer.make_stars_predictor(unet.UNetConfig(depth=2, num_classes=9), tc, (16, 16)),
    lambda: flows.follow_flows(torch.zeros(8, 8, 2).numpy()),
    lambda: flows.follow_flows_doubling(torch.zeros(8, 8, 2).numpy()),
    lambda: convert.pack_conv3x3(torch.zeros(3, 3, 1, 1).numpy(), torch.zeros(1).numpy()),
    lambda: polyphase_conv.run(size=16, iters=1),
    lambda: polyphase_conv.main(["--size", "16", "--iters", "1"]),
    lambda: flow_gather.run(iters=1),
    lambda: roofline.run(size=16, iters=1),
    lambda: int8_conv.run(iters=1, shapes=[("a", (8, 8), 1, 8)]),
    lambda: ImageServer(ServerConfiguration(jobs_dir={jobs!r}, models_dir={models!r})),
    lambda: unet.init(cfg),
    lambda: train.create_unet_state(cfg, train.TrainConfig()),
    lambda: fit.fit_unet(cfg, train.TrainConfig(), fit.FitConfig(), []),
    lambda: gan.init(gcfg),
    lambda: train.create_gan_state(gcfg, train.TrainConfig()),
    lambda: fit.fit_gan(gcfg, train.TrainConfig(), fit.FitConfig(), []),
    lambda: zoo.create("n2v_denoise"),
    lambda: zoo.create("gan_enhance"),
    lambda: fit.fit_n2v(unet.UNetConfig(depth=2, num_classes=1), train.TrainConfig(), fit.FitConfig(), []),
    lambda: fit.fit_flows(unet.UNetConfig(depth=2, num_classes=3), train.TrainConfig(), fit.FitConfig(), []),
    lambda: fit.fit_stars(unet.UNetConfig(depth=2, num_classes=9), train.TrainConfig(), fit.FitConfig(), []),
    lambda: fidelity.seg_fidelity("unet2d_cells", (64, 64), n=1),
    lambda: fidelity.gan_fidelity(frame_shape=(64, 64), n=1),
    lambda: fidelity.n2v_fidelity(frame_shape=(64, 64), n=1),
    lambda: fidelity.flows_fidelity(frame_shape=(64, 64), n=1),
    lambda: fidelity.stars_fidelity(frame_shape=(64, 64), n=1),
    lambda: fidelity.train_fidelity("gan", steps=1, batch=1, size=32),
    lambda: fidelity.register_fidelity(n=2, shape=(32, 32)),
    lambda: fidelity.mosaic_fidelity(grid=(1, 2), tile=(32, 32), overlap=8),
    lambda: fidelity.illum_fidelity(t=2, shape=(16, 16)),
    lambda: mosaic.stitch_grid(torch.zeros(2, 16, 16).numpy(), (1, 2), overlap=4),
    lambda: mosaic.blend_mosaic(torch.zeros(1, 16, 16).numpy(), [[0.5, 0.0]], (4, 4)),
    lambda: psf.gaussian_psf_2d(9, 1.5),
    lambda: psf.gaussian_psf_3d(9, 5, 1.5, 3.0),
    lambda: psf.localize_emitters(torch.zeros(16, 16).numpy(), 1.0),
    lambda: psf.localize_emitters_3d(torch.zeros(8, 16, 16).numpy(), 1.0),
    lambda: psf.localize_emitters_astig(torch.zeros(16, 16).numpy(), 1.0, psf.AstigCalibration((0, 0, 1), (0, 0, 1), (-1, 1), 7)),
    lambda: psf.calibrate_astigmatism(torch.zeros(5, 16, 16).numpy(), [0, 1, 2, 3, 4]),
    lambda: psf.z_from_widths([1.0], [1.0], psf.AstigCalibration((0, 0, 1), (0, 0, 1), (-1, 1))),
    lambda: fidelity.emitter_fidelity(n=1, shape=(32, 32), n_emitters=2),
    lambda: fidelity.emitter3d_fidelity(n=1, shape=(8, 32, 32), n_emitters=2),
    lambda: fidelity.astig_fidelity(n=1, shape=(32, 32), n_emitters=2),
    lambda: parallel.device_pool(),
    lambda: parallel.make_mesh(),
    lambda: parallel.make_mesh2d((1, 1)),
    lambda: make_fixtures.main(["--out", {models!r}, "--quick", "--only", "n2v_cells"]),
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
gan.GAN(gcfg, device="cpu")
infer.make_frame_inferrer(cfg, tc, (16, 16), device="cpu")
infer.make_gan_enhancer(gcfg, tc, (16, 16), device="cpu")
train.create_unet_state(cfg, train.TrainConfig(), device="cpu")
train.create_gan_state(gcfg, train.TrainConfig(), device="cpu")
ImageServer(ServerConfiguration(jobs_dir={jobs!r}, models_dir={models!r}, device="cpu"))
zoo.create("stars_cells", device="cpu")
mosaic.stitch_grid(torch.rand(2, 16, 16).numpy(), (1, 2), overlap=4, device="cpu")
psf.localize_emitters(torch.zeros(16, 16).numpy(), 1.0, device="cpu")
psf.localize_emitters_3d(torch.zeros(8, 16, 16).numpy(), 1.0, device="cpu")
psf.richardson_lucy(torch.rand(16, 16), psf.gaussian_psf_2d(5, 1.0, device="cpu"), 2)
# QC and projections run where their tensors lie; the tracker is host numpy
from sequitr_tpu_torch.ops import projection, qc
assert qc.frame_qc(torch.zeros(2, 8, 8, dtype=torch.uint16), float("inf")).shape == (2, 7)
for method in projection.METHODS:
    projection.make_projector(method)(torch.zeros(3, 8, 8, dtype=torch.uint16))
fidelity.tracking_fidelity(n_objects=4, n_frames=12, n_divisions=1)
# the N2V masking's draw and apply, and the flips, run where their tensors lie
img = torch.zeros(2, 16, 16, 1)
draws = train.n2v_draw_mask(None, img.shape, 8, (5, 5), "median")
train.n2v_mask_apply(img, draws, (5, 5), "median")
train.n2v_flip_batch(img, train.n2v_draw_flip(None, img.shape))
train.flows_flip_batch(img, torch.zeros(2, 16, 16, 2), torch.zeros(2, 16, 16), torch.zeros(2, 2, dtype=torch.bool))
for make, n in ((train.make_n2v_train_step, 1), (train.make_flows_train_step, 3), (train.make_stars_train_step, 9)):
    make(unet.UNetConfig(depth=2, num_classes=n), train.TrainConfig())
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
