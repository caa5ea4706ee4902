"""Keypoints training (port of human_pose_tpu/train/): the pose losses, the
train state, the optimizers and schedulers, and the train, validation and
gradient-accumulation steps. The classification loss and steps come with
the classification model; the engine (module, trainer, callbacks,
checkpoints) comes later."""

from .losses import TAG_LOSS_WEIGHT, ae_grouping_loss, ae_keypoints_loss, heatmaps_loss
from .optim import LRScheduler, create_lr_scheduler, create_optimizer, set_learning_rate
from .state import TrainState
from .steps import accumulated_keypoints_train_step, keypoints_train_step, keypoints_val_step

__all__ = [
    "TrainState",
    "heatmaps_loss",
    "ae_grouping_loss",
    "ae_keypoints_loss",
    "TAG_LOSS_WEIGHT",
    "create_optimizer",
    "create_lr_scheduler",
    "set_learning_rate",
    "LRScheduler",
    "accumulated_keypoints_train_step",
    "keypoints_train_step",
    "keypoints_val_step",
]
