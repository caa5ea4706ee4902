"""Idle device time while the host is inside a stage of the program.

The program marks each stage ``<name>`` with ``human_pose_tpu_torch.utils.
profiling.span``: under the profiler, an empty ``record_function`` block
``hp:<name>`` at its entry and another, ``hp:<name>:end``, at its exit.
``trace.parse`` keeps both among the trace's spans, window-relative; the
stage's host interval runs from the end of the entry mark to the start of
the exit mark. The idle time of a stage is the part of those intervals in
which no device operation of the traced window runs: the overlap of the
device's idle time with the stage, wherever the gap began (``Trace.gaps``
charges a whole gap to the span open at its start instead).
"""

from __future__ import annotations

from bisect import bisect_right

from gpubench.layer_metrics._common import per_unit_ms

PREFIX = "hp:"


def stage_intervals(trace, name: str) -> list:
    """The host intervals ``[(start_s, end_s)]`` of stage ``name``, merged
    and in order: each ``hp:<name>`` mark with the ``hp:<name>:end`` mark
    that closes it (the innermost open one first). ``ValueError`` for a
    mark that has no partner."""
    entry, leave = PREFIX + name, PREFIX + name + ":end"
    opened, found = [], []
    for span, start, end in sorted(trace.spans, key=lambda s: s[1]):
        if span == entry:
            opened.append(end)
        elif span == leave:
            if not opened:
                raise ValueError(f"{leave} at {start} s closes no {entry}")
            found.append((opened.pop(), start))
    if opened:
        raise ValueError(f"{entry} at {opened[-1]} s is never closed by {leave}")
    return merge(found)


def merge(intervals) -> list:
    """The union of ``(start, end)`` intervals, as sorted disjoint ones."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def busy_intervals(trace) -> list:
    """The union of the device operations' intervals (start ``op[3]``,
    duration ``op[1]``), window-relative seconds."""
    return merge((op[3], op[3] + op[1]) for op in trace.ops)


def idle_in(busy: list, a: float, b: float) -> float:
    """Seconds of ``[a, b]`` that the disjoint sorted ``busy`` intervals
    leave uncovered."""
    idle = b - a
    i = max(bisect_right(busy, (a, float("inf"))) - 1, 0)
    for s, e in busy[i:]:
        if s >= b:
            break
        idle -= max(min(e, b) - max(s, a), 0.0)
    return idle


def idle_ms(ctx, name: str):
    """Idle device milliseconds a traced unit inside stage ``name``; None
    when the run made no whole trace or the trace holds no mark of the
    stage (a program without the stage's span)."""
    tr = ctx.trace
    if tr is None:
        return None
    stages = stage_intervals(tr, name)
    if not stages:
        return None
    busy = busy_intervals(tr)
    return per_unit_ms(ctx, sum(idle_in(busy, a, b) for a, b in stages))
