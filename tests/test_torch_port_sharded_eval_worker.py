"""The worker of ``tests/test_torch_port_sharded_eval.py``'s gloo processes,
in a module of its own that imports only torch and the port (no JAX), so a
process starts in half the time. It holds no tests.
"""

from __future__ import annotations

import json

import torch

from human_pose_tpu_torch.configs import KeypointsConfig
from human_pose_tpu_torch.data import CocoKeypointsDataset
from human_pose_tpu_torch.inference import BatchedKeypointsEvaluator, image_id_from_path
from human_pose_tpu_torch.parallel import finalize_distributed, make_mesh, setup_distributed


def worker(cfg_path: str, batch_size: int, out_path: str) -> None:
    """One process of a launch with torchrun's environment: the batched
    evaluator over the config's val split on the mesh of the gloo group,
    each process adding its shard; this rank's detections, OKS values,
    batches, shard and buckets to ``out_path`` (json)."""
    torch.set_num_threads(1)
    setup_distributed("cpu")
    try:
        cfg = KeypointsConfig.from_dict(KeypointsConfig.from_yaml_to_dict(cfg_path, []))
        im = cfg.create_inference_model()
        ds = CocoKeypointsDataset(cfg.dataloader.val_ds.root, cfg.dataloader.val_ds.split)
        ev = BatchedKeypointsEvaluator(im, batch_size=batch_size, mesh=make_mesh())
        shard = list(ev.shard(len(ds)))
        for idx in shard:
            ev.add(ds.load_image(idx), image_id_from_path(ds.images_filepaths[idx], idx),
                   ds.load_annot(idx), index=idx)
        dets, oks = ev.finish()
        with open(out_path, "w") as f:
            json.dump({"dets": dets, "oks": oks, "n_batches": ev.n_batches, "shard": shard,
                       "local_batch_size": ev.local_batch_size,
                       "buckets": sorted(map(str, ev.buckets))}, f)
    finally:
        finalize_distributed()
