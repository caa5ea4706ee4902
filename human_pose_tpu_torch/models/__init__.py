from .higher_hrnet import DeconvHeatmapsHead, HigherHRNet
from .hrnet import HRNetBackbone, stage_configs
from .init import init_flax_default_, init_keypoints_weights_

__all__ = ["DeconvHeatmapsHead", "HigherHRNet", "HRNetBackbone", "init_flax_default_",
           "init_keypoints_weights_", "stage_configs"]
