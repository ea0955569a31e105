"""Hand-written CUDA kernels, each beside its plain PyTorch version.

``histogram`` (``csrc/histogram.cu``) is the port of the Pallas streaming
histogram, grown into the normalize's whole quantile pass; ``conv3x3`` (``csrc/conv3x3.cu``) holds the fused 3x3 conv + bias
+ activation kernels behind the conv studies; ``qconv`` (``csrc/qconv.cu``) the
int8 convolution of the quantization studies; ``flows`` (``csrc/flows.cu``)
the Euler integrator of the flow-field serving pass. ``build`` compiles and
loads them; each wrapper launches inside ``on_device``, since a launch goes
to the current device.
"""

import contextlib

import torch

__all__ = ["on_device"]


def on_device(device: torch.device):
    """The launch's device made current, where it is not already."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
