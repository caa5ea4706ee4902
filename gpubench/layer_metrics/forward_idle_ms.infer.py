"""Idle device time (ms) a batch while the host is inside the program's
``infer.forward`` stage (``InferenceKeypointsModel.forward_scale``: the
network's launches, the flip merge and the resizes)."""

from gpubench.layer_metrics._spans import idle_ms


def read(ctx):
    return idle_ms(ctx, "infer.forward")
