"""Multi-device parallelism: mesh, data-parallel sharding, spatial halo
exchange (port of ``sequitr_tpu.parallel``), in one process over a mesh of
``torch.device``s (``mesh.device_pool``, ``mesh.virtual_devices``)."""

from sequitr_tpu_torch.parallel import spatial  # noqa: F401
from sequitr_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    device_pool,
    virtual_devices,
    make_mesh,
    make_mesh2d,
    replicated,
    batch_sharded,
    shard_batch,
    make_dp_train_step,
    make_dp_frame_inferrer,
    make_dp_frame_mapper,
    make_dp_registerer,
    make_dp_localizer,
    make_dp_localizer3d,
    make_dp_localizer_astig,
    make_dp_deconvolver,
    make_dp_seam_correlator,
)


def __getattr__(name):
    # spatial_train pulls the training stack (pipeline.train) into the
    # process; serving-only workers do not pay that import at start-up
    if name == "spatial_train":
        import importlib

        return importlib.import_module("sequitr_tpu_torch.parallel.spatial_train")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
