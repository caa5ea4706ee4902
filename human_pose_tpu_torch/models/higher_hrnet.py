"""HigherHRNet bottom-up pose network, NCHW (port of
human_pose_tpu/models/higher_hrnet.py).

* HRNet backbone with a single 1/4-resolution, C-channel output
* ``init_heatmaps_head``: 1x1 conv C -> 2K (K heatmaps + K AE tag maps, 1/4)
* deconv head: concat(feats, init) -> ConvTranspose(k4 s2 p1) + BN + ReLU ->
  BasicBlocks -> 1x1 conv -> K heatmaps at 1/2 resolution

Returns ``([hm_quarter, hm_half], tags)`` in NCHW, all float32 whatever the
compute dtype (autocast bf16 on the card).
"""

from __future__ import annotations

import torch
from torch import nn

from ..device import resolve_device
from ..utils.profiling import span
from .hrnet import BasicBlock, HRNetBackbone, rematerialized, remat_selection
from .norm import batch_norm


class DeconvHeatmapsHead(nn.Module):
    """ConvTranspose 2x upsample + residual refinement + 1x1 heatmap conv."""

    def __init__(self, cin: int, features: int, num_kpts: int, num_resid_blocks: int = 4):
        super().__init__()
        self.deconv = nn.Sequential(
            nn.ConvTranspose2d(cin, features, 4, 2, 1, bias=False),
            batch_norm(features),
            nn.ReLU(inplace=True),
        )
        self.resid_blocks = nn.ModuleList(
            BasicBlock(features, features) for _ in range(num_resid_blocks)
        )
        self.final_layer = nn.Conv2d(features, num_kpts, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.deconv(x)
        for block in self.resid_blocks:
            x = block(x)
        return self.final_layer(x)


class HigherHRNet(nn.Module):
    """HigherHRNet-W{C}: backbone + init head + one deconv stage.

    Built on ``device`` (default ``"cuda"``; raises when no card is present).
    Weights come from ``load_state_dict`` (see ``utils.weights``) or
    ``models.init.init_flax_default_``. ``remat`` is the JAX model's: in
    train mode the selected parts recompute their forward in the backward
    (``True`` all; a tuple of 0-3 for stages, 4 for the deconv head, 5 for
    the stem), with the same results."""

    def __init__(self, num_kpts: int = 17, C: int = 32,
                 num_blocks_per_stage: tuple = (1, 1, 4, 3), num_units: int = 4,
                 num_deconv_resid_blocks: int = 4, remat: bool | tuple = False,
                 device: str | torch.device = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.num_kpts = num_kpts
        self.remat_head = 4 in remat_selection(remat)
        self.backbone = HRNetBackbone(
            C, final_stage_single_scale=True,
            num_blocks_per_stage=num_blocks_per_stage, num_units=num_units, remat=remat,
        )
        self.init_heatmaps_head = nn.Conv2d(C, 2 * num_kpts, 1)
        self.deconv_layers = nn.ModuleList([
            DeconvHeatmapsHead(C + 2 * num_kpts, C, num_kpts, num_deconv_resid_blocks)
        ])
        self.to(dev)

    def forward(self, images: torch.Tensor):
        return self.head(self.backbone(images)[0])

    @span("net.head")
    def head(self, feats: torch.Tensor):
        """``init_heatmaps_head`` and the deconv head on the backbone's 1/4
        map ``feats``: ``([hm_quarter, hm_half], tags)`` in float32."""
        init = self.init_heatmaps_head(feats)
        head, head_in = self.deconv_layers[0], torch.cat([feats, init], dim=1)
        deconv = rematerialized(head, head_in) if self.remat_head and self.training else head(head_in)
        k = self.num_kpts
        heatmaps = [init[:, :k].float(), deconv.float()]
        return heatmaps, init[:, k:].float()
