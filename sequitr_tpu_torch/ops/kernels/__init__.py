"""Hand-written CUDA kernels, each beside its plain PyTorch version.

``histogram`` (``csrc/histogram.cu``) is the port of the Pallas streaming
histogram; ``conv3x3`` (``csrc/conv3x3.cu``) holds the fused 3x3 conv + bias
+ activation kernels behind the conv studies. ``build`` compiles and loads
them.
"""
