"""Hand-written CUDA kernels, each beside its plain PyTorch version.

``histogram`` (``csrc/histogram.cu``) is the port of the Pallas streaming
histogram, grown into the normalize's whole quantile pass; ``conv3x3`` (``csrc/conv3x3.cu``) holds the fused 3x3 conv + bias
+ activation kernels behind the conv studies; ``qconv`` (``csrc/qconv.cu``) the
int8 convolution of the quantization studies. ``build`` compiles and loads
them.
"""
