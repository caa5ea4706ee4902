"""The port's profiler spans (``utils/profiling.py::span``) on the CPU.

* With no profiler running a span records nothing: ``record_function`` and
  ``_RecordFunctionFast`` are never called.
* Under ``torch.profiler`` the inference model's ``forward_scale`` and
  ``decode_masked`` on a shallow HigherHRNet, and one keypoints and one
  classification train step on shallow networks, export each stage as an
  entry mark ``hp:<name>`` and an exit mark ``hp:<name>:end``
  (``user_annotation``), balanced, nested and in order, with a ``cpu_op``
  range ``hp:<name>`` between them.
* The marks leave ``gpubench.trace.parse``'s attribution as it is: every
  device operation of a synthetic trace is charged to the caller's span with
  and without them.
* A ``Trainer`` with a profile directory writes a trace that holds the
  ``train.*`` marks.

The networks are the shallow C=8 ones, on one intra-op thread.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from human_pose_tpu_torch.inference import InferenceKeypointsModel
from human_pose_tpu_torch.models import ClassificationHRNet, HigherHRNet
from human_pose_tpu_torch.train import (
    TrainState, classification_train_step, create_optimizer, keypoints_train_step,
)
from human_pose_tpu_torch.utils import profiling
from human_pose_tpu_torch.utils.profiling import span

K, N, P, S = 17, 2, 4, 64
SHALLOW = dict(num_blocks_per_stage=(1, 1, 1, 1), num_units=1)
NET = ("net.stem", "net.stage2", "net.stage3", "net.stage4", "net.head")
DECODE = ("decode.resize", "decode.topk", "decode.group", "decode.adjust", "decode.refine")
INFER = ("infer.to_device", "infer.forward", "infer.merge", "infer.decode") + NET + DECODE
TRAIN = ("train.forward", "train.loss", "train.backward", "train.update") + NET


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _profiled(fn):
    """The CPU profiler that ran ``fn()``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return prof


def _events(prof, tmp_path) -> list:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return json.loads(path.read_text())["traceEvents"]


def stages(events: list) -> dict:
    """Each stage's ``[(start, end)]`` from its marks, checking that the
    marks are balanced, nested and in order, that every ``hp:`` event
    other than a mark is a ``cpu_op`` range, and that each stage has one
    such range between each pair of its marks."""
    marks = sorted((e for e in events if e.get("name", "").startswith("hp:")
                    and e.get("cat") == "user_annotation"), key=lambda e: e["ts"])
    ranges = [e for e in events if e.get("name", "").startswith("hp:") and e.get("cat") != "user_annotation"]
    assert all(e["cat"] == "cpu_op" for e in ranges), {e["cat"] for e in ranges}
    opened, out = [], {}
    for e in marks:
        name = e["name"][3:]
        if name.endswith(":end"):
            assert opened and opened[-1][0] == name[:-4], (opened, name)
            stage, start = opened.pop()
            out.setdefault(stage, []).append((start, e["ts"]))
        else:
            opened.append((name, e["ts"] + e["dur"]))
    assert not opened, opened
    for stage, intervals in out.items():
        inside = [r for r in ranges if r["name"] == "hp:" + stage]
        assert len(inside) == len(intervals), stage
        for (a, b), r in zip(intervals, sorted(inside, key=lambda r: r["ts"])):
            assert a <= r["ts"] and r["ts"] + r["dur"] <= b, stage
    return out


def _within(out: dict, inner: tuple, outer: str) -> None:
    for name in inner:
        for a, b in out[name]:
            assert any(oa <= a and b <= ob for oa, ob in out[outer]), (name, outer)


# -- off ---------------------------------------------------------------------------------

def test_span_off_records_nothing(monkeypatch):
    """No profiler: neither a ``record_function`` nor a
    ``_RecordFunctionFast`` is made, as a context manager or a decorator,
    in a whole forward of the network either."""
    def refuse(*a, **k):
        raise AssertionError("a RecordFunction was made with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    with span("x"):
        pass
    assert span("y")(lambda a: a + 1)(1) == 2
    torch.manual_seed(0)
    net = HigherHRNet(num_kpts=K, C=8, num_deconv_resid_blocks=1, device="cpu", **SHALLOW).eval()
    with torch.no_grad():
        net(torch.zeros(1, 3, S, S))


def test_span_on_forms_and_exceptions(tmp_path):
    """Under the profiler: the marks and the range of a span, as a context
    manager and as a decorator; an exception inside still closes both."""
    @span("deco")
    def f():
        return 3

    def body():
        with span("outer"):
            assert f() == 3
            with pytest.raises(ValueError):
                with span("inner"):
                    raise ValueError

    out = stages(_events(_profiled(body), tmp_path))
    assert set(out) == {"outer", "deco", "inner"}
    _within(out, ("deco", "inner"), "outer")


# -- the program's spans -----------------------------------------------------------------

@pytest.mark.parametrize("flip", [False, True])
def test_inference_spans(tmp_path, flip):
    torch.manual_seed(0)
    net = HigherHRNet(num_kpts=K, C=8, num_deconv_resid_blocks=1, device="cpu", **SHALLOW).eval()
    model = InferenceKeypointsModel(net, use_flip=flip, compact_inputs=True, device="cpu")
    frames = np.random.default_rng(0).integers(0, 256, (N, S, S, 3), dtype=np.uint8)

    def infer():
        avg, tags = model.forward_scale(model.to_device(frames), (S, S))
        model.decode_masked(avg, tags, (S, S), 1.0)

    out = stages(_events(_profiled(infer), tmp_path))
    assert set(out) == set(INFER)
    assert all(len(v) == 1 for v in out.values())
    _within(out, NET + ("infer.merge",), "infer.forward")
    _within(out, DECODE, "infer.decode")
    order = [out[n][0][0] for n in ("infer.to_device",) + NET + ("infer.merge", "infer.decode")]
    assert order == sorted(order)
    assert [out[n][0][0] for n in DECODE] == sorted(out[n][0][0] for n in DECODE)


def _keypoints_batch(rs) -> dict:
    joints = np.zeros((N, P, K, 2), np.int32)
    joints[..., 0] = rs.randint(0, S // 4, (N, P, K))
    joints[..., 1] = rs.randint(0, S // 4, (N, P, K))
    vis = (rs.rand(N, P, K, 1) > 0.3).astype(np.int32)
    return {"images": torch.from_numpy(rs.randint(0, 256, (N, 3, S, S)).astype(np.uint8)),
            "heatmaps": [torch.from_numpy(rs.rand(N, K, S // 4, S // 4).astype(np.float32)),
                         torch.from_numpy(rs.rand(N, K, S // 2, S // 2).astype(np.float32))],
            "masks": [torch.ones(N, S // 4, S // 4), torch.ones(N, S // 2, S // 2)],
            "joints": torch.from_numpy(np.concatenate([joints, vis], -1))}


def _train_step(task: str):
    """A function that makes one train step of ``task`` on a shallow net."""
    torch.manual_seed(0)
    rs = np.random.RandomState(0)
    if task == "keypoints":
        net = HigherHRNet(num_kpts=K, C=8, num_deconv_resid_blocks=1, device="cpu", **SHALLOW)
        state = TrainState.create(net, create_optimizer(net.parameters(), "Adam", 1e-3),
                                  device="cpu")
        batch = _keypoints_batch(rs)
        return lambda: keypoints_train_step(state, batch, 1e-3)
    net = ClassificationHRNet(C=8, num_classes=10, device="cpu", **SHALLOW)
    state = TrainState.create(net, create_optimizer(net.parameters(), "SGD", 0.1, momentum=0.9),
                              device="cpu")
    images = torch.from_numpy(rs.randint(0, 256, (N, 3, S, S)).astype(np.uint8))
    labels = torch.from_numpy(rs.randint(0, 10, (N,)))
    return lambda: classification_train_step(state, images, labels, 0.1)


@pytest.mark.parametrize("task", ["keypoints", "classification"])
def test_train_step_spans(tmp_path, task):
    out = stages(_events(_profiled(_train_step(task)), tmp_path))
    assert set(out) == set(TRAIN)
    assert all(len(v) == 1 for v in out.values())
    _within(out, NET, "train.forward")
    order = [out[n][0][0] for n in ("train.forward", "train.loss", "train.backward", "train.update")]
    assert order == sorted(order)


# -- the benchmark's parser --------------------------------------------------------------

def _ev(cat, name, ts, dur, **a):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "args": a}


def _launch(corr, ts, start, dur=2.0):
    return [_ev("cuda_runtime", "cudaLaunchKernel", ts, 0.5, correlation=corr),
            _ev("kernel", f"k{corr}", start, dur, correlation=corr)]


def _synthetic(with_marks: bool) -> list:
    """A unit with a ``forward`` span, launches right before, between and
    right after program marks, and its kernels; the marks only when asked."""
    events = [_ev("user_annotation", "unit", 0.0, 100.0), _ev("user_annotation", "forward", 1.0, 80.0),
              _ev("user_annotation", "sync", 100.0, 20.0)]
    marks = [("hp:infer.forward", 2.0), ("hp:net.stem", 10.0), ("hp:net.stem:end", 30.0),
             ("hp:infer.merge", 40.0), ("hp:infer.merge:end", 60.0), ("hp:infer.forward:end", 70.0)]
    if with_marks:
        events += [_ev("user_annotation", n, ts, 1.0) for n, ts in marks]
        events += [_ev("cpu_op", "hp:net.stem", 11.001, 18.998),
                   _ev("cpu_op", "hp:infer.merge", 41.001, 18.998)]
    launches = [(1, 3.001, 20.0), (2, 9.999, 25.0), (3, 11.001, 35.0), (4, 29.999, 50.0),
                (5, 31.001, 65.0), (6, 50.0, 75.0), (7, 71.001, 90.0)]
    for corr, ts, start in launches:
        events += _launch(corr, ts, start)
    return events


def test_marks_leave_attribution_unchanged():
    """``gpubench.trace.parse`` charges every operation to ``forward`` with
    the program's marks as without them; window, busy time and operations
    are the same, and the marks are among the spans."""
    from gpubench import trace

    bare, marked = trace.parse(_synthetic(False)), trace.parse(_synthetic(True))
    assert {op[2] for op in bare.ops} == {"forward"}
    assert marked.ops == bare.ops
    assert (marked.window_s, marked.busy_s, marked.missing_launches) == \
        (bare.window_s, bare.busy_s, bare.missing_launches)
    names = [s[0] for s in marked.spans]
    assert names.count("hp:net.stem") == names.count("hp:net.stem:end") == 1
    assert marked.gaps == bare.gaps


# -- the trainer -------------------------------------------------------------------------

class _Loader:
    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def test_trainer_profile_dir_holds_train_marks(tmp_path):
    """A ``Trainer`` whose profiler window is its first step: the trace in
    the profile directory holds every ``train.*`` and ``net.*`` stage of
    that step, balanced and in order."""
    from human_pose_tpu_torch.loggers.loggers import Loggers, TerminalLogger
    from human_pose_tpu_torch.train import ClassificationModule, DataModule, Trainer
    from human_pose_tpu_torch.utils.profiling import StepWindowProfiler

    torch.manual_seed(0)
    rs = np.random.RandomState(0)
    module = ClassificationModule.create(
        ClassificationHRNet(C=8, num_classes=10, device="cpu", **SHALLOW), seed=1)
    batches = [{"images": rs.randint(0, 256, (N, S, S, 3)).astype(np.uint8),
                "labels": rs.randint(0, 10, (N,))} for _ in range(2)]
    run = tmp_path / "run"
    trainer = Trainer(Loggers([TerminalLogger(run)], run), [], max_epochs=1, log_path=run)
    trainer.profiler = StepWindowProfiler(str(tmp_path / "trace"), start=0, steps=1)
    trainer.fit(module, DataModule(_Loader(batches), None))
    traces = list((tmp_path / "trace").glob("*.json"))
    assert len(traces) == 1
    out = stages(json.loads(traces[0].read_text())["traceEvents"])
    assert set(TRAIN) <= set(out) and all(len(out[n]) == 1 for n in TRAIN)


def test_span_reads_the_flag_at_call_time(monkeypatch):
    """The span reads the profiler's flag through its module at each entry,
    so a flag set after import is seen."""
    calls = []
    monkeypatch.setattr(profiling, "_mark", calls.append)
    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled", True)
    with span("late"):
        pass
    assert calls == ["hp:late", "hp:late:end"]
