"""Configs: the yaml + ``--a.b.c=v`` plumbing and the classification and
keypoints configs (port of human_pose_tpu/configs)."""

from .base import (
    BaseConfig,
    DataloaderConfig,
    DatasetConfig,
    InferenceConfig,
    ModuleConfig,
    NetConfig,
    SetupConfig,
    TrainerConfig,
    TransformConfig,
)
from .classification import ClassificationConfig, ClassificationTransformConfig
from .cli import parse_args_for_config, parse_cli_value, update_config, update_dict
from .keypoints import KeypointsConfig, KeypointsTransformConfig
from .structured import structure, unstructure

__all__ = [
    "BaseConfig",
    "SetupConfig",
    "TrainerConfig",
    "DataloaderConfig",
    "DatasetConfig",
    "TransformConfig",
    "ModuleConfig",
    "NetConfig",
    "InferenceConfig",
    "ClassificationConfig",
    "ClassificationTransformConfig",
    "KeypointsConfig",
    "KeypointsTransformConfig",
    "structure",
    "unstructure",
    "parse_cli_value",
    "update_dict",
    "parse_args_for_config",
    "update_config",
]
