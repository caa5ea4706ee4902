from .cuda_decode import refine_argmax_batch, refine_argmax_batch_plain
from .cuda_match import match_by_tag_batched, match_by_tag_batched_plain
from .decode import decode_batch
from .grouping import (
    JOINTS_ORDER, adjust, group_from_candidates, joints_order_for, match_by_tag, nms,
    parse_batch, refine_batch, top_k,
)
from .heatmaps import average_stages, match_heatmaps_size, resize_bilinear
from .hungarian import hungarian
from .images import prep_images

__all__ = [
    "JOINTS_ORDER", "adjust", "average_stages", "decode_batch", "group_from_candidates",
    "hungarian", "joints_order_for", "match_by_tag", "match_by_tag_batched",
    "match_by_tag_batched_plain", "match_heatmaps_size", "nms", "parse_batch", "prep_images",
    "refine_argmax_batch", "refine_argmax_batch_plain", "refine_batch", "resize_bilinear",
    "top_k",
]
