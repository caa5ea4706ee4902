"""Device time (ms) a batch of the operations launched inside the
harness's ``forward`` span (``InferenceKeypointsModel.forward_scale``)."""

from gpubench.layer_metrics._common import per_unit_ms


def read(ctx):
    if ctx.trace is None:
        return None
    return per_unit_ms(ctx, sum(op[1] for op in ctx.trace.ops if op[2] == "forward"))
