"""ResNet backbone family, NCHW (port of human_pose_tpu/models/resnet.py;
counterpart of reference src/base/architectures/backbones/resnet.py, a
torchvision-style ResNet).

Submodules carry torchvision's names (``conv1``, ``bn1``,
``layer{L}.{i}.conv{j}`` / ``.bn{j}``, ``layer{L}.{i}.downsample.{0,1}``,
``fc``), so a torchvision state dict loads with a strict
``load_state_dict`` (``utils.weights.load_torchvision_backbone``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from .hrnet import conv_bn
from .norm import batch_norm

RESNET_SPECS = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
}


class _StridedBasic(nn.Module):
    """Two 3x3 convs (the stride on the first), a 1x1 projection where the
    width or the stride changes."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, features, 3, stride, 1, bias=False)
        self.bn1 = batch_norm(features)
        self.conv2 = nn.Conv2d(features, features, 3, 1, 1, bias=False)
        self.bn2 = batch_norm(features)
        self.downsample = (conv_bn(cin, features, 1, stride)
                           if cin != features or stride != 1 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class _StridedBottleneck(nn.Module):
    """1x1 -> 3x3 (strided) -> 1x1 to ``features`` (= 4x the inner width),
    a 1x1 projection where the width or the stride changes."""

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        mid = features // 4
        self.conv1 = nn.Conv2d(cin, mid, 1, bias=False)
        self.bn1 = batch_norm(mid)
        self.conv2 = nn.Conv2d(mid, mid, 3, stride, 1, bias=False)
        self.bn2 = batch_norm(mid)
        self.conv3 = nn.Conv2d(mid, features, 1, bias=False)
        self.bn3 = batch_norm(features)
        self.downsample = (conv_bn(cin, features, 1, stride)
                           if cin != features or stride != 1 else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.relu(out + residual)


class ResNet(nn.Module):
    """Standard ResNet returning the final 1/32-resolution feature map, or
    float32 logits when ``num_classes`` > 0; built on ``device`` (default
    ``"cuda"``: raises when no card is present)."""

    def __init__(self, variant: str = "resnet50", num_classes: int = 0,
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        block_type, layers = RESNET_SPECS[variant]
        self.variant = variant
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = batch_norm(64)
        # pads with -inf, as flax's max_pool
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin = 64
        for s, (features, stride) in enumerate(zip((64, 128, 256, 512), (1, 2, 2, 2))):
            units = []
            for i in range(layers[s]):
                if block_type == "bottleneck":
                    units.append(_StridedBottleneck(cin, features * 4, stride if i == 0 else 1))
                    cin = features * 4
                else:
                    units.append(_StridedBasic(cin, features, stride if i == 0 else 1))
                    cin = features
            self.add_module(f"layer{s + 1}", nn.Sequential(*units))
        self.fc = nn.Linear(cin, num_classes) if num_classes > 0 else None
        self.to(dev)

    @property
    def out_channels(self) -> int:
        block_type, _ = RESNET_SPECS[self.variant]
        return 512 * (4 if block_type == "bottleneck" else 1)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(torch.relu(self.bn1(self.conv1(images))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.fc is None:
            return x
        return self.fc(x.mean((2, 3))).float()
