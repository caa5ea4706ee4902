"""SimpleBaseline pose network, NCHW (port of
human_pose_tpu/models/simple_baseline.py; counterpart of reference
src/keypoints/architectures/simple_baseline.py): a ResNet backbone, three
deconvs (k4 s2) with BN and ReLU, a 1x1 head: one heatmap stage at 1/4
resolution, float32 whatever the compute dtype.

Submodules carry the JAX model's names (``backbone`` with torchvision's
names inside, ``deconv{i}``, ``deconv_bn{i}``, ``final``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from .norm import batch_norm
from .resnet import ResNet


class SimpleBaseline(nn.Module):
    def __init__(self, num_kpts: int = 17, backbone: str = "resnet50",
                 deconv_features: int = 256, device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.backbone = ResNet(backbone, device=dev)
        cin = self.backbone.out_channels
        for i in range(3):
            # ConvTranspose2d(k4, s2, p1) is flax's 'SAME' transposed conv
            # with the taps flipped (utils/weights.py)
            self.add_module(f"deconv{i}", nn.ConvTranspose2d(cin, deconv_features, 4, 2, 1,
                                                             bias=False))
            self.add_module(f"deconv_bn{i}", batch_norm(deconv_features))
            cin = deconv_features
        self.final = nn.Conv2d(deconv_features, num_kpts, 1)
        self.to(dev)

    def forward(self, images: torch.Tensor) -> list:
        x = self.backbone(images)
        for i in range(3):
            x = torch.relu(getattr(self, f"deconv_bn{i}")(getattr(self, f"deconv{i}")(x)))
        return [self.final(x).float()]
