"""Parallelism of the port: data, spatial and hybrid sharding over a
``DeviceMesh`` of ranks (one process per device), and the multi-process
bring-up. The counterpart of ``supernet_tpu/parallel``; the names are the
JAX package's."""

from supernet_tpu_torch.parallel.spatial import (
    halo_exchange_rows,
    make_spatial_encoder_block,
    make_spatial_forward,
    make_spatial_forward3d,
    make_spatial_train_step,
    make_spatial_train_step3d,
    make_spatial_vconv,
    trim_valid,
)
from supernet_tpu_torch.parallel.multihost import (
    global_batch,
    global_mesh,
    initialize_from_env,
    process_local_rows,
)
from supernet_tpu_torch.parallel.hybrid import (
    make_hybrid_forward,
    make_hybrid_train_step,
    make_hybrid_train_step3d,
    make_mesh2d,
)
from supernet_tpu_torch.parallel.data_parallel import (
    make_dp_train_step3d,
    make_mesh,
    make_mesh_for_batch,
    make_sharded_forward,
    make_sharded_train_step,
    replicate,
    shard_batch,
)

__all__ = [
    "global_batch",
    "global_mesh",
    "initialize_from_env",
    "process_local_rows",
    "halo_exchange_rows",
    "make_spatial_encoder_block",
    "make_spatial_forward",
    "make_spatial_forward3d",
    "make_spatial_train_step",
    "make_spatial_train_step3d",
    "make_spatial_vconv",
    "trim_valid",
    "make_hybrid_forward",
    "make_hybrid_train_step",
    "make_hybrid_train_step3d",
    "make_mesh",
    "make_mesh2d",
    "make_mesh_for_batch",
    "make_sharded_forward",
    "make_sharded_train_step",
    "make_dp_train_step3d",
    "replicate",
    "shard_batch",
]
