"""Training (port of human_pose_tpu/train/): the classification, pose and
top-down losses, the train state, the optimizers and schedulers, the train,
validation and gradient-accumulation steps of both tasks, the task modules
(``ClassificationModule``, ``KeypointsModule``), the device prefetch, and
the engine: ``Trainer`` and ``DataModule``, the callbacks, checkpoints,
meters and metric storage, and the metric plots."""

from .callbacks import (
    ArtifactsLoggerCallback,
    BaseCallback,
    Callbacks,
    DatasetExamplesCallback,
    MetricsLogger,
    MetricsPlotterCallback,
    MetricsSaverCallback,
    ModelSummary,
    ResultsPlotterCallback,
    SaveModelCheckpoint,
    SystemMetricsMonitoringCallback,
    default_callbacks,
)
from .checkpoint import (
    AsyncCheckpointWriter,
    load_checkpoint,
    load_params_partial,
    load_train_state,
    save_checkpoint,
)
from .losses import (
    TAG_LOSS_WEIGHT, ae_grouping_loss, ae_keypoints_loss, classification_loss, heatmaps_loss,
    joints_mse_loss,
)
from .meters import AverageMeter, Meters
from .module import BaseModule, ClassificationModule, KeypointsModule, metrics_to_host
from .optim import LRScheduler, create_lr_scheduler, create_optimizer, set_learning_rate
from .prefetch import DeviceBatch, DevicePrefetcher, host_batch_to_device
from .state import TrainState
from .steps import (
    accumulated_classification_train_step, accumulated_keypoints_train_step,
    accumulated_sppe_train_step, classification_train_step, classification_val_step,
    keypoints_train_step, keypoints_val_step, sppe_train_step, sppe_val_step, topk_error,
)
from .storage import MetricsStorage, SystemMonitoringStorage
from .trainer import DataModule, Trainer

__all__ = [
    "TrainState",
    "classification_loss",
    "heatmaps_loss",
    "ae_grouping_loss",
    "ae_keypoints_loss",
    "joints_mse_loss",
    "TAG_LOSS_WEIGHT",
    "create_optimizer",
    "create_lr_scheduler",
    "set_learning_rate",
    "LRScheduler",
    "accumulated_classification_train_step",
    "accumulated_keypoints_train_step",
    "accumulated_sppe_train_step",
    "classification_train_step",
    "classification_val_step",
    "topk_error",
    "keypoints_train_step",
    "keypoints_val_step",
    "sppe_train_step",
    "sppe_val_step",
    "BaseModule",
    "ClassificationModule",
    "KeypointsModule",
    "metrics_to_host",
    "DeviceBatch",
    "DevicePrefetcher",
    "host_batch_to_device",
    "DataModule",
    "Trainer",
    "AverageMeter",
    "Meters",
    "MetricsStorage",
    "SystemMonitoringStorage",
    "AsyncCheckpointWriter",
    "save_checkpoint",
    "load_checkpoint",
    "load_train_state",
    "load_params_partial",
    "BaseCallback",
    "Callbacks",
    "SaveModelCheckpoint",
    "MetricsPlotterCallback",
    "MetricsSaverCallback",
    "MetricsLogger",
    "ModelSummary",
    "SystemMetricsMonitoringCallback",
    "ArtifactsLoggerCallback",
    "DatasetExamplesCallback",
    "ResultsPlotterCallback",
    "default_callbacks",
]
