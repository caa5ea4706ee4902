"""End-to-end batched keypoint decode: model outputs -> grouped persons
(port of human_pose_tpu/ops/decode.py::decode_batch, dense path).

1. resize the heatmap stages to the largest stage and average them
2. resize the averaged heatmaps and each tag map to the model input size
3. stack the tag maps (two with flip TTA) as the embedding dim
4. parse: NMS -> top-k -> AE grouping -> adjust -> refine
"""

from __future__ import annotations

import torch

from .grouping import parse_batch
from .heatmaps import average_stages, resize_bilinear


@torch.no_grad()
def decode_batch(stages_kpts_heatmaps: list, tags_heatmaps_list: list, input_hw: tuple,
                 max_num_people: int = 30, det_thr: float = 0.05, tag_thr: float = 0.5,
                 do_adjust: bool = True, do_refine: bool = True):
    """Decode a batch of model outputs on their device.

    Args:
      stages_kpts_heatmaps: list of ``[N, K, h_s, w_s]`` maps (per stage)
      tags_heatmaps_list: list of ``[N, K, h_t, w_t]`` tag maps (two with
        flip TTA, one otherwise), stacked as embedding dims
      input_hw: ``(H, W)`` model input size to decode at

    Returns:
      ``joints [N, P, K, 3+E]`` float32, ``person_scores [N, P]`` float32,
      ``valid [N, P]`` bool.
    """
    h, w = input_hw
    stages = [x.to(torch.float32) for x in stages_kpts_heatmaps]
    kpts = resize_bilinear(average_stages(stages), h, w)  # [N, K, H, W]
    tags = torch.stack(
        [resize_bilinear(t.to(torch.float32), h, w) for t in tags_heatmaps_list], dim=2
    )  # [N, K, E, H, W]
    return parse_batch(
        kpts, tags, max_num_people=max_num_people, det_thr=det_thr, tag_thr=tag_thr,
        do_adjust=do_adjust, do_refine=do_refine,
    )
