"""The readers of the program's stage marks (``layer_metrics/_spans.py`` and
the four ``*_idle_ms.*`` readers) on hand-built traces.

    python -m pytest gpubench/tests/test_gpubench_spans.py -q
"""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from gpubench import harness
from gpubench.layer_metrics import _spans
from gpubench.trace import Trace

READERS = {"forward_idle_ms.infer": "infer.forward", "decode_idle_ms.infer": "infer.decode",
           "forward_idle_ms.train": "train.forward", "backward_idle_ms.train": "train.backward"}


def _trace(ops, spans, window_s=0.1) -> Trace:
    """A trace of device operations ``(start_s, seconds)`` and host spans
    ``(name, start_s, end_s)``; busy time and gaps are not read here."""
    return Trace(window_s=window_s, busy_s=0.0, ops=[(f"k{i}", d, "other", s) for i, (s, d) in
                                                      enumerate(ops)],
                 gaps=[], spans=spans, missing_launches=0)


def _ctx(tr, units=2):
    return SimpleNamespace(trace=tr, params={"trace_units": units})


def _marks(name, start, end, width=0.001):
    """The entry mark ending at ``start`` and the exit mark beginning at
    ``end``: the stage's host interval is ``[start, end]``."""
    return [("hp:" + name, start - width, start), ("hp:" + name + ":end", end, end + width)]


# busy [0.010, 0.030] (two overlapping operations), [0.050, 0.060], [0.070, 0.075]
OPS = [(0.010, 0.010), (0.015, 0.015), (0.050, 0.010), (0.070, 0.005)]


def test_idle_overlap_with_gaps_across_the_marks():
    """Stage intervals [0.006, 0.055] (its entry inside the idle gap [0,
    0.010], its exit inside a busy stretch) and [0.065, 0.080] (its exit in
    the gap after 0.075): idle 0.004 + 0.020 (+ nothing of [0.050, 0.055])
    and 0.005 + 0.005, over two units."""
    tr = _trace(OPS, _marks("infer.forward", 0.006, 0.055) + _marks("infer.forward", 0.065, 0.080)
                + [("forward", 0.0, 0.09)])
    assert _spans.stage_intervals(tr, "infer.forward") == [(0.006, 0.055), (0.065, 0.080)]
    assert _spans.idle_ms(_ctx(tr), "infer.forward") == pytest.approx((0.024 + 0.010) / 2 * 1e3)


def test_whole_window_stage_reads_the_window_idle():
    """A stage over the whole window reads the window's idle time a unit,
    the most any stage can read."""
    tr = _trace(OPS, _marks("train.backward", 0.0, 0.1))
    busy = 0.020 + 0.010 + 0.005
    assert _spans.idle_ms(_ctx(tr, 3), "train.backward") == pytest.approx((0.1 - busy) / 3 * 1e3)


def test_nested_entries_of_one_stage_count_once():
    tr = _trace(OPS, sorted(_marks("infer.decode", 0.0, 0.04) + _marks("infer.decode", 0.005, 0.02),
                            key=lambda s: s[1]))
    assert _spans.stage_intervals(tr, "infer.decode") == [(0.0, 0.04)]
    assert _spans.idle_ms(_ctx(tr, 1), "infer.decode") == pytest.approx((0.04 - 0.020) * 1e3)


def test_no_trace_or_no_pair_reads_none():
    assert _spans.idle_ms(_ctx(None), "infer.forward") is None
    tr = _trace(OPS, [("forward", 0.0, 0.05)] + _marks("infer.decode", 0.01, 0.02))
    assert _spans.idle_ms(_ctx(tr), "infer.forward") is None


@pytest.mark.parametrize("spans", [
    [("hp:infer.forward", 0.01, 0.011)],
    [("hp:infer.forward:end", 0.01, 0.011)],
    [("hp:infer.forward:end", 0.005, 0.006)] + _marks("infer.forward", 0.01, 0.02),
], ids=["entry_unclosed", "exit_alone", "exit_before_entry"])
def test_unpaired_mark_is_an_error(spans):
    with pytest.raises(ValueError):
        _spans.idle_ms(_ctx(_trace(OPS, spans)), "infer.forward")


def test_idle_in_edges():
    busy = _spans.merge([(0.2, 0.3), (0.0, 0.1), (0.05, 0.15)])
    assert busy == [(0.0, 0.15), (0.2, 0.3)]
    assert _spans.idle_in(busy, 0.15, 0.2) == pytest.approx(0.05)
    assert _spans.idle_in(busy, 0.0, 0.15) == pytest.approx(0.0)
    assert _spans.idle_in(busy, 0.1, 0.4) == pytest.approx(0.05 + 0.1)
    assert _spans.idle_in([], 0.1, 0.4) == pytest.approx(0.3)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_each_reader_reads_its_own_stage(metric):
    """Each reader, found by its name as the harness finds it, reads the
    idle time of its stage and of no other."""
    spans = []
    for i, stage in enumerate(sorted(set(READERS.values()))):
        spans += _marks(stage, 0.02 * i, 0.02 * i + 0.01)
    tr = _trace([(0.0, 0.002), (0.02, 0.004), (0.04, 0.006), (0.06, 0.008)],
                sorted(spans, key=lambda s: s[1]))
    order = sorted(set(READERS.values()))
    i = order.index(READERS[metric])
    want = (0.01 - 0.002 * (i + 1)) / 2 * 1e3
    reader = harness.Layout().reader(metric)
    assert reader.read(_ctx(tr)) == pytest.approx(want)
    assert reader.read(_ctx(None)) is None
    assert reader.read(_ctx(_trace(OPS, []))) is None
