"""Classification training (ClassificationHRNet): the program's
``classification_train_step`` on a pool of batches made on the device from
the seed (``gpubench/training.py`` has the step, the window and the check).

Parameters: ``batch`` uint8 images a batch at ``size`` x ``size`` with
labels uniform over the configuration's classes, a ``pool`` of distinct
batches cycled, ``check_steps`` steps read for the check, ``trace_units``
steps traced.
"""

from __future__ import annotations

import torch

from gpubench.training import TrainCell


def classification_batch(gen, dev, n: int, size: int, classes: int) -> dict:
    return {"images": torch.randint(0, 256, (n, 3, size, size), generator=gen, device=dev,
                                    dtype=torch.uint8),
            "labels": torch.randint(0, classes, (n,), generator=gen, device=dev)}


class Cell(TrainCell):
    MODEL = "ClassificationHRNet"

    @staticmethod
    def make_batches(seed: int, config: dict, p: dict, dev) -> list:
        """The cell's ``pool`` batches, made on ``dev`` from the seed."""
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed % 2**63)
        return [classification_batch(gen, dev, p["batch"], p["size"], config["num_classes"])
                for _ in range(p["pool"])]

    def build(self, c: dict, dev):
        from human_pose_tpu_torch.models import ClassificationHRNet

        return ClassificationHRNet(C=c["C"], num_classes=c["num_classes"],
                                   num_blocks_per_stage=tuple(c["num_blocks_per_stage"]),
                                   num_units=c["num_units"], device=dev)

    def step(self, state, batch: dict, lr) -> dict:
        from human_pose_tpu_torch.train import steps

        return steps.classification_train_step(state, batch["images"], batch["labels"], lr)[1]
