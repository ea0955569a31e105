"""sequitr_tpu_torch — the PyTorch/CUDA port of ``sequitr_tpu``.

The same filesystem job server, job JSON and outputs as ``sequitr_tpu``,
running on an NVIDIA Hopper card: plain tensor code is PyTorch (cuDNN for
the convolutions), and every kernel the JAX package wrote in Pallas becomes
a hand-written CUDA kernel (``sequitr_tpu_torch.ops.kernels``).

This package imports ``torch`` and never ``jax`` or ``sequitr_tpu``; host
helpers it shares with the JAX package are copies. Entry points run on the
card (``device="cuda"``) unless the caller passes ``device="cpu"``; without
a CUDA device they raise instead of quietly running on the CPU.

Ported so far (34 of the JAX server's 37 jobs): the ``segmentation_unet2d``
serving path (percentile normalize on the histogram kernel, U-Net2D,
standard or polyphase forward, tiling/stitch, labels.tif and objects.h5),
3D segmentation, GAN and N2V serving, the instance families' serving
(``segment_flows``, ``segment_stars``), the evaluation and parity jobs with
the fidelity meters (``fidelity``), the training jobs (standard or
polyphase forward), geometry and illumination, the PSF jobs, acquisition
QC and z-projection on the card (``ops.qc``, ``ops.projection``), the host
quantification and tracking jobs (``tracking``) and the conv studies
(``studies``: the fused 3x3 conv kernels, Winograd, the polyphase A/B).
Subpackages import lazily so ``import sequitr_tpu_torch`` stays
light.
"""

__version__ = "0.1.0"

_LAZY = (
    "config", "data", "fidelity", "localize", "models", "native", "ops", "pipeline",
    "server", "studies", "utils",
)

__all__ = ["__version__", *_LAZY]


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f"sequitr_tpu_torch.{name}")
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'sequitr_tpu_torch' has no attribute {name!r}")
