"""ClassificationHRNet, NCHW (port of human_pose_tpu/models/classification.py).

Counterpart of reference src/classification/architectures/hrnet.py:7-74:
the 4-scale HRNet backbone (all four scales out), then a head that
bottlenecks each scale to [128, 256, 512, 1024] channels and cascades them
from high to low resolution (a biased stride-2 3x3 conv + BN + ReLU added
to the next scale's bottleneck), a biased 1x1 conv to 2048 channels + BN +
ReLU, the global mean and a Linear classifier. Logits are float32 whatever
the compute dtype (autocast bf16 on the card).

Submodules carry the reference's names (the JAX bridge's
``classification_head.chann_incr_blocks.{i}``, ``.downsample_blocks.{i}``,
``.final_conv``, ``.classifier``), so a reference ``.pt`` loads strictly and
the backbone's names are HigherHRNet's: a classification checkpoint is the
keypoints config's ``pretrained_ckpt_path``.
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from ..utils.profiling import span
from .hrnet import Bottleneck, HRNetBackbone
from .norm import batch_norm

HEAD_CHANNELS = (128, 256, 512, 1024)
FINAL_CHANNELS = 2048


class ClassificationHead(nn.Module):
    def __init__(self, C: int, num_classes: int = 1000):
        super().__init__()
        branches = [C * 2 ** i for i in range(len(HEAD_CHANNELS))]
        self.chann_incr_blocks = nn.ModuleList(
            Bottleneck(cin, cout) for cin, cout in zip(branches, HEAD_CHANNELS)
        )
        # the reference's downsample convs carry a bias (hrnet.py:20-31)
        self.downsample_blocks = nn.ModuleList(
            nn.Sequential(nn.Conv2d(cin, cout, 3, 2, 1, bias=True), batch_norm(cout),
                          nn.ReLU(inplace=True))
            for cin, cout in zip(HEAD_CHANNELS[:-1], HEAD_CHANNELS[1:])
        )
        self.final_conv = nn.Sequential(
            nn.Conv2d(HEAD_CHANNELS[-1], FINAL_CHANNELS, 1, bias=True), batch_norm(FINAL_CHANNELS),
            nn.ReLU(inplace=True),
        )
        self.classifier = nn.Linear(FINAL_CHANNELS, num_classes)

    def forward(self, xs: list) -> torch.Tensor:
        out = self.chann_incr_blocks[0](xs[0])
        for incr, down, x in zip(self.chann_incr_blocks[1:], self.downsample_blocks, xs[1:]):
            out = incr(x) + down(out)
        out = self.final_conv(out)
        return self.classifier(out.mean((2, 3))).float()


class ClassificationHRNet(nn.Module):
    """HRNet-W{C} + classification head (41,232,680 parameters at W32 and
    1000 classes), built on ``device`` (default ``"cuda"``: raises when no
    card is present). ``remat`` is the backbone's (``models/hrnet.py``)."""

    def __init__(self, C: int = 32, num_classes: int = 1000,
                 num_blocks_per_stage: tuple = (1, 1, 4, 3), num_units: int = 4,
                 remat: bool | tuple = False, device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.backbone = HRNetBackbone(
            C, final_stage_single_scale=False,
            num_blocks_per_stage=num_blocks_per_stage, num_units=num_units, remat=remat,
        )
        self.classification_head = ClassificationHead(C, num_classes)
        self.to(dev)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        feats = self.backbone(images)
        with span("net.head"):
            return self.classification_head(feats)
