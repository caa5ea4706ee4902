"""Device time (ms) a step of the BatchNorm backward kernels (kernel names
holding ``batch_norm_backward``)."""

from gpubench.layer_metrics._common import per_unit_ms


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernel_rows("batch_norm_backward"):
        return None
    return per_unit_ms(ctx, ctx.trace.kernel_seconds("batch_norm_backward"))
