"""Profiling a few steady units of a cell's work, and reading the trace.

``profile_units`` runs ``unit(i)`` under ``torch.profiler`` (CPU and CUDA
activities; one untraced unit first so that the profiler's start-up falls
outside the trace, and a synchronize after it, so that none of its device
work is still queued when the trace begins), each inside a ``unit`` span,
and a final synchronize
inside a ``sync`` span; the traced window runs from the first traced unit's
host start to the end of that synchronize. The harness and the cell's
traffic put named spans (``record_function``) around the calls into the
program; every device operation is charged to the innermost such span
that was open on the host when it was launched (the CUDA runtime call of
the same correlation id).

A trace is whole when every kernel launch inside the window has its kernel
row and every expected kernel count is met; otherwise the units are
profiled again, ``attempts`` times at most.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
from dataclasses import dataclass, field

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    window_s: float
    busy_s: float
    ops: list  # (name, seconds, span, start_s) of every device operation in the window
    gaps: list  # (span, seconds) of every idle stretch in the window
    spans: list  # (name, start_s, end_s) host spans, window-relative
    missing_launches: int
    counts: dict = field(default_factory=dict)  # expected kernel fragment -> rows seen

    def kernel_seconds(self, fragment: str, span: str | None = None) -> float:
        return sum(op[1] for op in self.ops
                   if fragment in op[0] and (span is None or op[2] == span))

    def kernel_rows(self, fragment: str) -> int:
        return sum(1 for op in self.ops if fragment in op[0])

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict = {}
        for n, s, *_ in self.ops:
            by_name[n] = by_name.get(n, 0.0) + s
        by_span: dict = {}
        for sp, s in self.gaps:
            by_span[sp] = by_span.get(sp, 0.0) + s
        return {"device_ops": [[n[:120], s] for n, s in
                               sorted(by_name.items(), key=lambda kv: -kv[1])[:top]],
                "idle_gaps": [[n, s] for n, s in
                              sorted(by_span.items(), key=lambda kv: -kv[1])[:top]]}


def _record(unit, n_units: int, counters: dict):
    """The chrome-trace events of the traced units, and how far each
    counter of ``counters`` (name -> function of nothing) moved over them."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=n_units, repeat=1)) as prof:
        for i in range(n_units + 1):
            if i == 1:
                before = {k: f() for k, f in counters.items()}
            with record_function("unit"):
                unit(i)
            if i == 0:  # the untraced unit's device work ends before the window opens
                torch.cuda.synchronize()
            if i == n_units:
                with record_function("sync"):
                    torch.cuda.synchronize()
            prof.step()
    moved = {k: f() - before[k] for k, f in counters.items()}
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"], moved
    finally:
        os.unlink(path)


def parse(events: list) -> Trace:
    """The window, device operations, idle gaps and spans of a chrome trace's
    events."""
    spans = [e for e in events if e.get("cat") == "user_annotation"]
    units = [e for e in spans if e["name"] == "unit"]
    syncs = [e for e in spans if e["name"] == "sync"]
    if not units or not syncs:
        raise RuntimeError("the trace holds no unit or sync span")
    t0 = min(e["ts"] for e in units)
    t1 = max(e["ts"] + e["dur"] for e in syncs)
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    named = sorted((e for e in spans if e["name"] not in ("unit", "sync")),
                   key=lambda e: (e["ts"], -e["dur"]))

    def span_at(ts: float) -> str:
        inner = "other"
        for e in named:
            if e["ts"] > ts:
                break
            if ts <= e["ts"] + e["dur"]:
                inner = e["name"]
        return inner

    ops, intervals, seen = [], [], set()
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
        if b <= a:
            continue
        corr = e.get("args", {}).get("correlation")
        seen.add(corr)
        ops.append((e["name"], (b - a) / 1e6, span_at(launch_ts.get(corr, e["ts"])),
                    (a - t0) / 1e6))
        intervals.append((a, b))
    missing = sum(1 for e in events if e.get("cat") == "cuda_runtime"
                  and "Launch" in e["name"] and t0 <= e["ts"] <= t1
                  and e["args"].get("correlation") not in seen)
    busy, gaps, end = 0.0, [], t0
    for a, b in sorted(intervals):
        if a > end:
            gaps.append((span_at(end), (a - end) / 1e6))
        if b > end:
            busy += b - max(a, end)
            end = b
    if t1 > end:
        gaps.append((span_at(end), (t1 - end) / 1e6))
    return Trace(window_s=(t1 - t0) / 1e6, busy_s=busy / 1e6, ops=ops, gaps=gaps,
                 spans=[(e["name"], (e["ts"] - t0) / 1e6, (e["ts"] + e["dur"] - t0) / 1e6)
                        for e in named if t0 <= e["ts"] <= t1],
                 missing_launches=missing)


def profile_units(unit, n_units: int, expected: dict | None = None, attempts: int = 5):
    """Trace ``n_units`` units (after one untraced); ``expected`` maps a
    kernel-name fragment to a launch counter (a function of nothing): the
    window must hold as many rows of that kernel as the counter moved. Returns
    the first whole ``Trace``, or ``None`` when no attempt was whole; each
    attempt is reported on standard error."""
    for attempt in range(1, attempts + 1):
        events, want = _record(unit, n_units, expected or {})
        tr = parse(events)
        tr.counts = {k: tr.kernel_rows(k) for k in want}
        whole = tr.missing_launches == 0 and all(tr.counts[k] == v for k, v in want.items())
        print(f"trace attempt {attempt}: window {tr.window_s:.6f} s, busy {tr.busy_s:.6f} s, "
              f"{len(tr.ops)} device ops, launches without a kernel row {tr.missing_launches}, "
              f"kernel rows {tr.counts} against {want}: {'whole' if whole else 'not whole'}",
              file=sys.stderr, flush=True)
        if whole:
            return tr
    return None
