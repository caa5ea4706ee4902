"""Shared train entry (port of human_pose_tpu/bin/train.py; counterpart of
reference src/base/bin/train.py).

Builds the config, sets up the run's logging and the per-rank seed, applies
the ``cudnn`` section, and runs ``Trainer.fit`` on the datamodule and module
from the config. ``trainer.accelerator: cpu`` trains on the CPU; anything
else trains on the card, and a missing card raises. One process: the JAX
package's multi-process setup (``setup_distributed``) is ROADMAP module 14,
and a launch with more than one process refuses.
"""

from __future__ import annotations

import os

from ..device import resolve_device
from ..loggers.pylogger import log
from ..utils.utils import process_count


def train(cfg_dict: dict, ConfigClass):
    """Build everything from ``cfg_dict`` and fit; returns the ``Trainer``
    (its module, storage and run directory), also after a
    ``KeyboardInterrupt``, which the trainer has finalized KILLED."""
    world = max(process_count(), int(os.environ.get("WORLD_SIZE", 1)))
    if world > 1:
        raise NotImplementedError(f"training in {world} processes comes with the port's "
                                  "parallelism, ROADMAP module 14")
    cfg = ConfigClass.from_dict(cfg_dict)
    resolve_device(cfg.target_device())  # no card: raise before any run directory is made
    cfg.initialize_logging()
    cfg.seed()
    cfg.apply_cudnn()
    log.info(f"starting {cfg.setup.experiment_name}/{cfg.setup.run_name} "
             f"(arch={cfg.setup.architecture}, device={cfg.target_device()}, "
             f"dtype={str(cfg.compute_dtype()).split('.')[-1]})")
    datamodule = cfg.create_datamodule()
    module = cfg.create_module()
    trainer = cfg.create_trainer()
    try:
        trainer.fit(module, datamodule, pretrained_ckpt_path=cfg.setup.pretrained_ckpt_path,
                    ckpt_path=cfg.setup.ckpt_path)
    except KeyboardInterrupt:
        pass  # the trainer has finalized the run KILLED
    return trainer
