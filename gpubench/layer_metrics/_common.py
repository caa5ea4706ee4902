"""Arithmetic the per-layer readers share: a metric of a trace is None when
the run made no whole trace."""

from __future__ import annotations


def per_unit_ms(ctx, seconds: float):
    """``seconds`` of the traced window as milliseconds a traced unit."""
    return seconds / ctx.params["trace_units"] * 1e3


def idle_share(ctx):
    """Per cent of the traced window with no device operation running."""
    tr = ctx.trace
    if tr is None or tr.window_s <= 0:
        return None
    return (1 - tr.busy_s / tr.window_s) * 100


def mfu(ctx):
    """Per cent of the H100's dense bf16 peak that the reference count of
    the window's operations makes over the window's host seconds."""
    from gpubench.counts import PEAK_BF16_S

    if not ctx.units or ctx.window_s <= 0:
        return None
    return ctx.extra["flops_per_unit"] * ctx.units / ctx.window_s / PEAK_BF16_S * 100
