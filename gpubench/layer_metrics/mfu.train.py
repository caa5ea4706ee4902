"""The whole step's share of the H100's dense bf16 peak (989 TFLOP/s, per
cent): the reference network's operation count (``gpubench/counts.py``)
of every unit of the window, over the window's host seconds."""

from gpubench.layer_metrics._common import mfu


def read(ctx):
    return mfu(ctx)
