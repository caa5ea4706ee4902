"""Shared train entry (port of human_pose_tpu/bin/train.py; counterpart of
reference src/base/bin/train.py).

Joins torchrun's process group when launched by it
(``parallel.setup_distributed``: NCCL on ``cuda:LOCAL_RANK``, gloo with
``trainer.accelerator: cpu``), builds the config, sets up the run's logging
and the per-rank seed, applies the ``cudnn`` section, and runs
``Trainer.fit`` on the datamodule and module from the config, data-parallel
over the group's processes (``make_mesh``). ``trainer.accelerator: cpu``
trains on the CPU; anything else trains on the card, and a missing card
raises. The group is destroyed at the end, also after a failure.

    python -m torch.distributed.run --nproc_per_node=N -m human_pose_tpu_torch.bin.train_keypoints \\
        --config=...
"""

from __future__ import annotations

from ..device import resolve_device
from ..loggers.pylogger import log
from ..parallel.distributed import finalize_distributed, setup_distributed


def train(cfg_dict: dict, ConfigClass):
    """Build everything from ``cfg_dict`` and fit; returns the ``Trainer``
    (its module, storage and run directory), also after a
    ``KeyboardInterrupt``, which the trainer has finalized KILLED."""
    accelerator = (cfg_dict.get("trainer") or {}).get("accelerator")
    setup_distributed("cpu" if accelerator == "cpu" else "cuda")
    try:
        cfg = ConfigClass.from_dict(cfg_dict)
        # no card, or targets the net cannot train on: raise before any
        # run directory is made
        resolve_device(cfg.target_device())
        cfg.check_trainable()
        cfg.initialize_logging()
        cfg.seed()
        cfg.apply_cudnn()
        mesh = cfg.make_mesh()
        log.info(f"starting {cfg.setup.experiment_name}/{cfg.setup.run_name} "
                 f"(arch={cfg.setup.architecture}, device={cfg.target_device()}, "
                 f"dtype={str(cfg.compute_dtype()).split('.')[-1]}, "
                 f"mesh={mesh.shape if mesh else None})")
        datamodule = cfg.create_datamodule()
        module = cfg.create_module(mesh=mesh)
        trainer = cfg.create_trainer()
        try:
            trainer.fit(module, datamodule, pretrained_ckpt_path=cfg.setup.pretrained_ckpt_path,
                        ckpt_path=cfg.setup.ckpt_path)
        except KeyboardInterrupt:
            pass  # the trainer has finalized the run KILLED
        return trainer
    finally:
        finalize_distributed()
