from .classification import ClassificationHead, ClassificationHRNet
from .helpers import ConvBnAct, SEBlock
from .higher_hrnet import DeconvHeatmapsHead, HigherHRNet
from .hourglass import AEHourglassNet, HourglassModule, HourglassNet, ResidualModule
from .hrnet import BasicBlock, Bottleneck, HRNetBackbone, HRNetSPPE, stage_configs
from .init import init_classification_weights_, init_flax_default_, init_keypoints_weights_
from .resnet import RESNET_SPECS, ResNet
from .simple_baseline import SimpleBaseline

__all__ = ["AEHourglassNet", "BasicBlock", "Bottleneck", "ClassificationHead",
           "ClassificationHRNet", "ConvBnAct", "DeconvHeatmapsHead", "HigherHRNet",
           "HourglassModule", "HourglassNet", "HRNetBackbone", "HRNetSPPE", "RESNET_SPECS",
           "ResidualModule", "ResNet", "SEBlock", "SimpleBaseline",
           "init_classification_weights_", "init_flax_default_", "init_keypoints_weights_",
           "stage_configs"]
