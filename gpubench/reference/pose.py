"""The published inference front end of bottom-up pose estimation on the
reference network: flip test, stage aggregation and the resize to the
decode size (HigherHRNet's ``get_multi_stage_outputs`` and
``aggregate_results`` at scale 1)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .nets import Net
from .train import normalize

# COCO's left/right joint swap (HigherHRNet's FLIP_CONFIG["COCO"])
FLIP_INDEX = (0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15)


def flip_back(maps: torch.Tensor) -> torch.Tensor:
    return maps.flip(3)[:, list(FLIP_INDEX)]


def resize(maps: torch.Tensor, hw: tuple) -> torch.Tensor:
    return F.interpolate(maps, size=hw, mode="bilinear", align_corners=False)


@torch.no_grad()
def maps(net: Net, images: torch.Tensor, flip: bool, hw: tuple):
    """uint8 ``images [N, 3, H, W]`` -> (heatmaps averaged over stages
    ``[N, K, h, w]``, list of tag maps ``[N, K, h, w]``, two with ``flip``),
    at ``hw``."""
    x = normalize(images)
    n = x.shape[0]
    if flip:
        stages, tags = net(torch.cat([x, x.flip(3)]))
        stages = [(s[:n] + flip_back(s[n:])) / 2 for s in stages]
        tags = [tags[:n], flip_back(tags[n:])]
    else:
        stages, tags = net(x)
        tags = [tags]
    last = stages[-1].shape[2:]
    avg = sum(resize(s, last) if s.shape[2:] != last else s for s in stages) / len(stages)
    return resize(avg, hw), [resize(t, hw) for t in tags]
