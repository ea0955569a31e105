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

``roofline``, ``int8_conv`` and ``ptq_unet`` are not ported yet.
"""
