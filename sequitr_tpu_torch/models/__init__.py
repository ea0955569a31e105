"""Network definitions and weight interchange (port of ``sequitr_tpu.models``)."""
