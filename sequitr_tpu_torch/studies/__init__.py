"""Measured experiments beside the served path (port of ``sequitr_tpu.studies``).

* ``conv2d``, ``conv2d_gemm``, ``conv2d_gemm2`` — the fused 3x3 conv + bias +
  activation in three layouts, on the hand-written kernels of
  ``csrc/conv3x3.cu``. Not wired into the model, as in the JAX package.
* ``winograd`` — Winograd F(2x2, 3x3) in plain tensor ops.
* ``polyphase_conv`` — the standard forward against the polyphase forward
  (``models.polyphase``), error and time:
  ``python -m sequitr_tpu_torch.studies.polyphase_conv``.
* ``normalize_pass`` — what the percentile normalize costs on the card (the
  quantile pass, ``torch.histc``, ``infer._normalize``'s device operations),
  for this checkout's port or another's:
  ``python sequitr_tpu_torch/studies/normalize_pass.py [--root DIR]``.
* ``ptq_unet`` — post-training int8 quantization of the U-Net (calibrate,
  quantize, the int8 forward) on the int8 conv kernel of ``csrc/qconv.cu``.
* ``int8_conv`` — int8 against bf16 convs at the U-Net's conv shapes, with
  the kernel's bound and cuBLASLt's int8 GEMM beside them:
  ``python -m sequitr_tpu_torch.studies.int8_conv``.
* ``roofline`` — the 1024x1024 forward sliced into its nine stages, each
  timed against its raw convs' ceiling:
  ``python -m sequitr_tpu_torch.studies.roofline``.
"""
