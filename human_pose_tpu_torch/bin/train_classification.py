"""Classification training CLI (port of human_pose_tpu/bin/train_classification.py;
counterpart of reference src/classification/bin/train.py).

Usage:
    python -m human_pose_tpu_torch.bin.train_classification \
        [--config=experiments/classification/hrnet_32.yaml] [--a.b.c=v ...]

Trains on the card unless ``--trainer.accelerator=cpu``; the repo's yaml
(``accelerator: tpu``) trains in bfloat16 there, as in the JAX package. Its
``last.pt`` is the keypoints config's ``setup.pretrained_ckpt_path``: the
backbone's names are HigherHRNet's. Resume as ``train_keypoints`` does.
"""

from __future__ import annotations

import sys

from ..configs.classification import ClassificationConfig
from .train import train

DEFAULT_CFG = "experiments/classification/hrnet_32.yaml"


def main(argv: list[str] | None = None):
    """Train from ``argv`` (default ``sys.argv[1:]``); returns the trainer."""
    argv = sys.argv[1:] if argv is None else list(argv)
    cfg_path = DEFAULT_CFG
    for tok in argv:
        if tok.startswith("--config="):
            cfg_path = tok.split("=", 1)[1]
    cfg_dict = ClassificationConfig.from_yaml_to_dict(cfg_path, argv)
    return train(cfg_dict, ClassificationConfig)


if __name__ == "__main__":
    main()
