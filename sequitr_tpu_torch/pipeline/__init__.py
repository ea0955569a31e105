"""Frame inference (port of ``sequitr_tpu.pipeline``)."""
