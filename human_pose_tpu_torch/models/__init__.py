from .classification import ClassificationHead, ClassificationHRNet
from .higher_hrnet import DeconvHeatmapsHead, HigherHRNet
from .hrnet import HRNetBackbone, stage_configs
from .init import init_classification_weights_, init_flax_default_, init_keypoints_weights_

__all__ = ["ClassificationHead", "ClassificationHRNet", "DeconvHeatmapsHead", "HigherHRNet",
           "HRNetBackbone", "init_classification_weights_", "init_flax_default_",
           "init_keypoints_weights_", "stage_configs"]
