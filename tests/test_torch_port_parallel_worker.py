"""The worker of ``tests/test_torch_port_parallel.py``'s gloo processes, in
a module of its own that imports only torch and the port (no JAX), so a
process starts in half the time. It holds no tests.
"""

from __future__ import annotations

import numpy as np
import torch

from human_pose_tpu_torch.configs import ClassificationConfig, KeypointsConfig
from human_pose_tpu_torch.models.norm import BatchNorm2d
from human_pose_tpu_torch.parallel import finalize_distributed, make_mesh, setup_distributed
from human_pose_tpu_torch.train import DeviceBatch, Meters

K, S, N_GLOBAL, STEPS = 17, 64, 4, 2
TINY = {"C": 8, "num_blocks_per_stage": [1, 1, 1, 1], "num_units": 1, "num_deconv_resid_blocks": 1}


CLS_TINY = {"C": 8, "num_classes": 10, "num_blocks_per_stage": [1, 1, 1, 1], "num_units": 1}
# one step at 128^2: the first SGD step moves the kaiming-initialized stem
# by ~5%, so the second step's ReLU decisions at the head's 4x4 maps flip on
# rounding (the parameters of two steps parted by 1.4e-3)
CLS_S, CLS_STEPS = 128, 1


def dp_config(sync: bool, net: dict = TINY) -> dict:
    """The data-parallel run's config: the shallow C=8 net (``net``) on the
    CPU, SGD (momentum 0.9, lr 0.01), seed 3."""
    return {"setup": {"seed": 3}, "trainer": {"accelerator": "cpu", "use_DDP": True,
                                              "sync_batchnorm": sync},
            "net": {"params": net},
            "module": {"optimizers": {"optim": {"name": "SGD",
                                                "params": {"lr": 0.01, "momentum": 0.9}}}}}


def classification_batch() -> dict:
    """A seeded global batch of ``N_GLOBAL`` uint8 images at ``CLS_S``^2
    and labels of ``CLS_TINY``'s 10 classes."""
    rs = np.random.RandomState(6)
    return {"images": torch.from_numpy(rs.randint(0, 256, (N_GLOBAL, 3, CLS_S, CLS_S)).astype(np.uint8)),
            "labels": torch.from_numpy(rs.randint(0, 10, N_GLOBAL).astype(np.int64))}


def global_batch() -> dict:
    """A seeded global batch of ``N_GLOBAL`` at 64x64 in the steps' NCHW
    layout (uint8 images, heatmaps at 1/4 and 1/2, crowd masks, joints)."""
    rs = np.random.RandomState(5)
    n, h4, h2 = N_GLOBAL, S // 4, S // 2
    joints = np.stack([rs.randint(0, h4, (n, 5, K)), rs.randint(0, h4, (n, 5, K)),
                       rs.rand(n, 5, K) > 0.5], -1).astype(np.int32)
    return {"images": torch.from_numpy(rs.randint(0, 256, (n, 3, S, S)).astype(np.uint8)),
            "heatmaps": [torch.from_numpy(rs.rand(n, K, h, h).astype(np.float32)) for h in (h4, h2)],
            "masks": [torch.from_numpy((rs.rand(n, h, h) > 0.2).astype(np.float32)) for h in (h4, h2)],
            "joints": torch.from_numpy(joints)}


def _shard(batch: dict, rank: int, world: int) -> dict:
    n = N_GLOBAL // world

    def take(v):
        return [take(x) for x in v] if isinstance(v, list) else v[rank * n:(rank + 1) * n]
    return {k: take(v) for k, v in batch.items()}


def _train(module, batch, steps: int = STEPS) -> dict:
    metrics = [{k: float(v) for k, v in module.training_step(DeviceBatch(batch)).items()}
               for _ in range(steps)]
    return {"metrics": metrics, "state": {k: v.clone() for k, v in module.model.state_dict().items()},
            "bn": sorted({type(m).__name__ for m in module.model.modules() if isinstance(m, BatchNorm2d)})}


def worker(out_path: str) -> None:
    """One process of a launch with torchrun's environment: both BatchNorm
    scopes through the keypoints config's mesh and module on this rank's
    shard, the classification module with per-process BatchNorm, and an
    ``AverageMeter`` of value rank + 1 over rank + 1 samples reduced over
    the processes; the results to ``out_path``."""
    torch.set_num_threads(1)
    rank = setup_distributed("cpu")
    try:
        world = torch.distributed.get_world_size()
        out = {"rank": rank, "world": world, "backend": torch.distributed.get_backend()}
        for sync in (False, True):
            cfg = KeypointsConfig.from_dict(dp_config(sync))
            mesh = cfg.make_mesh()
            out[sync] = _train(cfg.create_module(mesh=mesh), _shard(global_batch(), rank, world))
        cls_cfg = ClassificationConfig.from_dict(dp_config(False, CLS_TINY))
        out["classification"] = _train(cls_cfg.create_module(mesh=cls_cfg.make_mesh()),
                                       _shard(classification_batch(), rank, world), CLS_STEPS)
        meters = Meters()
        meters.update({"a": float(rank + 1)}, n=rank + 1)
        meters.all_reduce(make_mesh())
        m = meters.meters["a"]
        out["meter"] = (m.sum, m.count, m.avg)
        torch.save(out, out_path)
    finally:
        finalize_distributed()
