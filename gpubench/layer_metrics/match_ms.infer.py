"""Device time (ms) a batch of the grouping kernel (``match_kernel``,
``csrc/match_by_tag.cu``)."""

from gpubench.layer_metrics._common import per_unit_ms


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernel_rows("match_kernel"):
        return None
    return per_unit_ms(ctx, ctx.trace.kernel_seconds("match_kernel"))
