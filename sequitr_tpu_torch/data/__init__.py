"""Host-side data I/O: TIFF stacks, frame sources, synthetic scenes (copies)."""
