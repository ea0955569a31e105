"""Per-family pipeline modules.

Importing a module registers its pipelines with the shared registry in
``sequitr_tpu_torch.server.server``; ``server.py`` imports all of them at
the bottom, so constructing an ``ImageServer`` always sees the full
registry. Ported so far:

- ``segmentation``: ``segmentation_unet2d``, ``segmentation_unet3d``,
  ``evaluate_unet2d``, ``evaluate_unet3d``, ``parity_check``;
- ``gan_denoise``: ``enhancement_gan``, ``denoise``, ``evaluate_gan``,
  ``evaluate_denoise``;
- ``training``: ``build_records``, ``train_unet2d``, ``train_unet3d``,
  ``build_gan_pairs``, ``train_gan``, ``train_n2v``;
- ``instances``: ``segment_flows``, ``segment_stars``, ``evaluate_flows``,
  ``evaluate_stars``, ``train_flows``, ``train_stars``;
- ``geometry``: ``register_stack`` (2D and ``dims: 3``), ``stitch_mosaic``;
- ``optics``: ``localize_emitters`` (2D, ``dims: 3``, astigmatic),
  ``calibrate_astigmatism``, ``deconvolve``, ``correct_illumination``;
- ``quantify``: ``measure_objects``, ``count_spots`` (2D and ``dims: 3``
  each), ``measure_tracks``, ``track_objects``;
- ``interop``: ``export_ctc``, ``qc_stack`` (2D and ``dims: 3``),
  ``project_stack``.
"""
