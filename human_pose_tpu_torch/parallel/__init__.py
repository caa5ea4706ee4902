"""Data-parallel training over ``torch.distributed`` processes (port of
human_pose_tpu/parallel/: the process group, the data mesh, per-group
BatchNorm; the gather of the sharded COCO evaluation). Spatial, tensor and pipeline parallelism are ROADMAP 14c."""

from .distributed import finalize_distributed, setup_distributed
from .mesh import (
    DATA_AXIS, Mesh, all_reduce_mean_, average_gradients_, average_running_stats_, barrier,
    gather_to_main, local_batch_to_global, make_mesh, replicate_global,
)
from .sync_bn import LocalBatchNorm

__all__ = ["DATA_AXIS", "LocalBatchNorm", "Mesh", "all_reduce_mean_", "average_gradients_",
           "average_running_stats_", "barrier", "finalize_distributed", "gather_to_main",
           "local_batch_to_global", "make_mesh", "replicate_global", "setup_distributed"]
