"""Per-family pipeline modules.

Importing a module registers its pipelines with the shared registry in
``sequitr_tpu_torch.server.server``; ``server.py`` imports all of them at
the bottom, so constructing an ``ImageServer`` always sees the full
registry. Ported so far: ``segmentation`` (``segmentation_unet2d``,
``segmentation_unet3d``), ``gan_denoise`` (``enhancement_gan``,
``denoise``), ``training`` (``build_records``, ``train_unet2d``,
``train_unet3d``) and ``instances`` (``segment_flows``, ``segment_stars``).
"""
