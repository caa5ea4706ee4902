"""Parallelism over ``torch.distributed`` processes and devices (port of
human_pose_tpu/parallel/): the process group, the data mesh, per-group
BatchNorm and the gather of the sharded COCO evaluation; the (data, space,
model) mesh of spatial and tensor parallelism for training; the pipeline
of inference. ``parallel/dryrun.py::dryrun_multichip`` runs the three
strategies on CPU processes against one process."""

from .distributed import finalize_distributed, setup_distributed
from .mesh import (
    DATA_AXIS, Mesh, all_reduce_mean_, average_gradients_, average_running_stats_, barrier,
    gather_to_main, local_batch_to_global, make_mesh, replicate_global,
)
from .pipeline import DEFAULT_PARTITION, PipelinedModel, build_units, partition_for
from .spatial import SPACE_AXIS, gather_rows, make_mesh_2d, shard_batch_spatial
from .sync_bn import LocalBatchNorm
from .tensor import TENSOR_AXIS, make_mesh_3d, shard_state_tensor, tensor_spec, whole_state_dicts

__all__ = ["DATA_AXIS", "DEFAULT_PARTITION", "LocalBatchNorm", "Mesh", "PipelinedModel",
           "SPACE_AXIS", "TENSOR_AXIS", "all_reduce_mean_", "average_gradients_",
           "average_running_stats_", "barrier", "build_units", "finalize_distributed",
           "gather_rows", "gather_to_main", "local_batch_to_global", "make_mesh", "make_mesh_2d",
           "make_mesh_3d", "partition_for", "replicate_global", "setup_distributed",
           "shard_batch_spatial", "shard_state_tensor", "tensor_spec", "whole_state_dicts"]
