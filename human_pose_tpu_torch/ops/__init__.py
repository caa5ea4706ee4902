from .cuda_aggregate import (
    fused_aggregate, fused_aggregate_plain, refine_argmax_phase_batch,
    refine_argmax_phase_batch_plain,
)
from .cuda_conv import (
    fold_basic_block, fold_conv_bn, fused_basic_block, fused_basic_block_plain,
    reference_basic_block,
)
from .cuda_decode import refine_argmax, refine_argmax_batch, refine_argmax_batch_plain
from .cuda_match import match_by_tag_batched, match_by_tag_batched_plain, match_by_tag_per_image
from .decode import decode_batch, decode_batch_fused
from .flip import COCO_FLIP_INDEX, flip_back, merge_flip_heatmaps, stack_flip_tags
from .grouping import (
    JOINTS_ORDER, adjust, adjust_phase, group_from_candidates, joints_order_for, match_by_tag,
    nms, parse, parse_batch, refine, refine_batch, refine_batch_phase, top_k,
)
from .heatmaps import average_stages, match_heatmaps_size, resize_bilinear
from .hungarian import hungarian, hungarian_batch
from .images import prep_images
from .phase import phase_gather, phase_index, sample_tags_bilinear
from .sppe import sppe_parse

__all__ = [
    "COCO_FLIP_INDEX", "JOINTS_ORDER", "adjust", "adjust_phase", "average_stages", "decode_batch",
    "decode_batch_fused", "flip_back", "fold_basic_block", "fold_conv_bn", "fused_aggregate",
    "fused_aggregate_plain", "fused_basic_block", "fused_basic_block_plain",
    "group_from_candidates", "hungarian", "hungarian_batch", "joints_order_for", "match_by_tag",
    "match_by_tag_batched", "match_by_tag_batched_plain", "match_by_tag_per_image",
    "match_heatmaps_size", "merge_flip_heatmaps", "nms", "parse", "parse_batch", "phase_gather",
    "phase_index", "prep_images", "reference_basic_block", "refine", "refine_argmax",
    "refine_argmax_batch", "refine_argmax_batch_plain", "refine_argmax_phase_batch",
    "refine_argmax_phase_batch_plain", "refine_batch", "refine_batch_phase", "resize_bilinear",
    "sample_tags_bilinear", "sppe_parse", "stack_flip_tags", "top_k",
]
