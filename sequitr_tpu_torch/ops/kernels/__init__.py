"""Hand-written CUDA kernels, each beside its plain PyTorch version.

One kernel so far: ``histogram`` (``csrc/histogram.cu``), the port of the
Pallas streaming histogram. ``build`` compiles and loads them.
"""
