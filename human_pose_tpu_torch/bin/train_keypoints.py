"""Keypoints training CLI (port of human_pose_tpu/bin/train_keypoints.py;
counterpart of reference src/keypoints/bin/train.py).

Usage:
    python -m human_pose_tpu_torch.bin.train_keypoints \
        [--config=experiments/keypoints/higher_hrnet_32.yaml] [--a.b.c=v ...]

Trains on the card unless ``--trainer.accelerator=cpu``; the repo's yamls
(``accelerator: tpu``) train in bfloat16 there, as in the JAX package.
Resume with ``--setup.ckpt_path=<run>/checkpoints/last.pt`` or
``--setup.ckpt_path=auto`` (the newest ``last.pt`` of the experiment).
"""

from __future__ import annotations

import sys

from ..configs.keypoints import KeypointsConfig
from .train import train

DEFAULT_CFG = "experiments/keypoints/higher_hrnet_32.yaml"


def main(argv: list[str] | None = None):
    """Train from ``argv`` (default ``sys.argv[1:]``); returns the trainer."""
    argv = sys.argv[1:] if argv is None else list(argv)
    cfg_path = DEFAULT_CFG
    for tok in argv:
        if tok.startswith("--config="):
            cfg_path = tok.split("=", 1)[1]
    cfg_dict = KeypointsConfig.from_yaml_to_dict(cfg_path, argv)
    return train(cfg_dict, KeypointsConfig)


if __name__ == "__main__":
    main()
