"""End-to-end batched keypoint decode: model outputs -> grouped persons
(port of human_pose_tpu/ops/decode.py).

``decode_batch``, the dense path:

1. resize the heatmap stages to the largest stage and average them
2. resize the averaged heatmaps and each tag map to the model input size
3. stack the tag maps (two with flip TTA) as the embedding dim
4. parse: NMS -> top-k -> AE grouping -> adjust -> refine

``decode_batch_fused``, the second front end: one kernel pass aggregates,
upsamples and NMS-suppresses the two heatmap stages into the 4x4 phase
layout (``cuda_aggregate.fused_aggregate``), the tag maps stay at quarter
resolution (sampled two-tap at the candidates, upsampled inside the refine
kernel), and the grouping is the dense path's. As in JAX, ``decode_batch``
is not routed to it.
"""

from __future__ import annotations

import torch

from ..utils.profiling import span
from .cuda_aggregate import fused_aggregate
from .grouping import (
    _top_k, adjust_phase, group_from_candidates, parse_batch, refine_batch_phase,
)
from .heatmaps import average_stages, resize_bilinear
from .phase import phase_index, sample_tags_bilinear


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
    with span("decode.resize"):
        stages = [x.to(torch.float32) for x in stages_kpts_heatmaps]
        kpts = resize_bilinear(average_stages(stages), h, w)  # [N, K, H, W]
        tags = torch.stack(
            [resize_bilinear(t.to(torch.float32), h, w) for t in tags_heatmaps_list], dim=2
        )  # [N, K, E, H, W]
    return parse_batch(
        kpts, tags, max_num_people=max_num_people, det_thr=det_thr, tag_thr=tag_thr,
        do_adjust=do_adjust, do_refine=do_refine,
    )


def _check_fused_shapes(stages: list, tags_list: list, input_hw: tuple, max_num_people: int):
    """The fused front end's shape set: two heatmap stages at 1/4 and 1/2 of
    a 4-aligned input, tags at 1/4, and at least ``max_num_people`` rows."""
    h, w = input_hw
    if len(stages) != 2:
        raise ValueError(f"the fused front end takes two heatmap stages, got {len(stages)}")
    if h % 4 or w % 4:
        raise ValueError(f"input size {input_hw} is not a multiple of 4")
    h4, w4 = h // 4, w // 4
    if tuple(stages[0].shape[2:]) != (h4, w4) or tuple(stages[1].shape[2:]) != (2 * h4, 2 * w4):
        raise ValueError(f"stages {[tuple(s.shape) for s in stages]} are not at 1/4 and 1/2 "
                         f"of {input_hw}")
    if not tags_list or any(tuple(t.shape[2:]) != (h4, w4) for t in tags_list):
        raise ValueError(f"tag maps {[tuple(t.shape) for t in tags_list]} are not at 1/4 "
                         f"of {input_hw}")
    if 4 * h4 < max_num_people:
        raise ValueError(f"{4 * h4} rows cannot hold max_num_people={max_num_people}")


@torch.no_grad()
def decode_batch_fused(stages_kpts_heatmaps: list, tags_heatmaps_list: list, input_hw: tuple,
                       max_num_people: int = 30, det_thr: float = 0.05, tag_thr: float = 0.5,
                       do_adjust: bool = True, do_refine: bool = True):
    """Decode through the fused front end; arguments and results as
    ``decode_batch``, for two stages at 1/4 and 1/2 of ``input_hw`` and tags
    at 1/4 (``ValueError`` otherwise). The same decisions as the dense path
    where the two resize formulations give the same values; F.interpolate
    and the phase lerps may differ by an ulp elsewhere."""
    _check_fused_shapes(stages_kpts_heatmaps, tags_heatmaps_list, input_hw, max_num_people)
    with span("decode.resize"):
        q = stages_kpts_heatmaps[0].to(torch.float32).contiguous()
        h2 = stages_kpts_heatmaps[1].to(torch.float32).contiguous()
        tags_lo = torch.stack([t.to(torch.float32) for t in tags_heatmaps_list],
                              dim=2).contiguous()
        avg_phase, sup_phase, cmax = fused_aggregate(q, h2)
    b, k, h4, w4 = q.shape
    w = 4 * w4
    m = max_num_people

    with span("decode.topk"):
        # exact top-M with one image row as the chunk (as _chunked_top_k): the
        # M rows of largest maxima, kept in ascending order, then an exact
        # top-M over their values, so ties go to the lowest flat index
        _, row_ids = _top_k(cmax.transpose(2, 3).reshape(b, k, 4 * h4), m)
        row_ids, _ = torch.sort(row_ids, dim=-1)  # [B, K, M]
        xs = torch.arange(w, device=q.device)
        gidx = phase_index(row_ids[..., None], xs, h4, w4).reshape(b, k, m * w)
        rows = torch.gather(sup_phase.reshape(b, k, -1), 2, gidx)
        scores_k, pos = _top_k(rows, m)
        x = pos % w
        y = torch.gather(row_ids, 2, pos // w)
        coords_k = torch.stack([x, y], dim=-1).to(torch.int32)
        tags_k = sample_tags_bilinear(tags_lo, y, x)  # [B, K, M, E]

    with span("decode.group"):
        grouped, valid = group_from_candidates(tags_k, coords_k, scores_k,
                                               det_thr=det_thr, tag_thr=tag_thr)
    if do_adjust:
        with span("decode.adjust"):
            grouped = adjust_phase(grouped, avg_phase)
    person_scores = grouped[..., 2].mean(dim=2)
    if do_refine:
        with span("decode.refine"):
            grouped = refine_batch_phase(avg_phase, tags_lo, grouped)
    return grouped, person_scores, valid
