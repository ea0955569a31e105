"""Device-side operations (port of ``sequitr_tpu.ops``): normalize, tiling, kernels."""
