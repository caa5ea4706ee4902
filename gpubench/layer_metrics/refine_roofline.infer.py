"""The refine kernel's share of its roofline (per cent): the least time the
H100 could take for the inputs the traced batches fed it
(``counts.refine_bound``, summed over the batches), over the traced time of
its two kernels (``csrc/refine_argmax.cu``: scan and merge)."""


def read(ctx):
    if ctx.trace is None:
        return None
    seconds = sum(ctx.trace.kernel_seconds(k) for k in ctx.extra["refine_kernels"])
    if seconds <= 0:
        return None
    return ctx.extra["refine_bound_s"] / seconds * 100
