"""Idle device time (ms) a batch while the host is inside the program's
``infer.decode`` stage (``InferenceKeypointsModel.decode_masked``: resize,
NMS and top-k, the grouping, adjust, refine)."""

from gpubench.layer_metrics._spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "infer.decode")
