"""Keypoints training (port of human_pose_tpu/train/): the pose losses, the
train state, the optimizers and schedulers, the train, validation and
gradient-accumulation steps, the task modules (``KeypointsModule``), the
device prefetch and the ``DataModule``. The classification loss, steps and
module come with the classification model; the ``Trainer``, callbacks and
checkpoints with the training engine (ROADMAP module 10d)."""

from .losses import TAG_LOSS_WEIGHT, ae_grouping_loss, ae_keypoints_loss, heatmaps_loss
from .module import BaseModule, ClassificationModule, KeypointsModule, metrics_to_host
from .optim import LRScheduler, create_lr_scheduler, create_optimizer, set_learning_rate
from .prefetch import DeviceBatch, DevicePrefetcher, host_batch_to_device
from .state import TrainState
from .steps import accumulated_keypoints_train_step, keypoints_train_step, keypoints_val_step
from .trainer import DataModule, Trainer

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
    "BaseModule",
    "ClassificationModule",
    "KeypointsModule",
    "metrics_to_host",
    "DeviceBatch",
    "DevicePrefetcher",
    "host_batch_to_device",
    "DataModule",
    "Trainer",
]
