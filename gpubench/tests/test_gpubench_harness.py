"""The harness on the CPU: discovery by name, the contract's limits on
BENCHMARK.json, imports, the trace reader, and runs of every cell at a tiny
size, sound and with the timed path broken underneath.

    python -m pytest gpubench/tests -q
"""

from __future__ import annotations

import argparse
import ast
import json
import re
from pathlib import Path

import pytest
import torch

from gpubench import harness, run, trace
from gpubench.tests import tiny

ROOT = harness.HERE.parent
BENCH = harness.load_json(ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CPU = torch.device("cpu")


def args(cell: str, trace_: int = 0, seconds: float = 1.0, seed: int = 2**31 + 7):
    return argparse.Namespace(workload=cell, seed=seed, seconds=seconds, trace=trace_)


# -- discovery ---------------------------------------------------------------------------

DUMMY_KIND = '''
class Cell:
    def __init__(self, ctx):
        self.n = 0
        ctx.extra["size"] = ctx.config["size"] * ctx.params["scale"]
    def unit(self, i):
        self.n += 1
        return 0.001
    def drain(self):
        pass
    def end_to_end(self, ctx):
        return {"things_per_s": self.n / ctx.window_s}
    attempted = 1
    failed = 0
    def trace(self, ctx):
        ctx.trace = None
    def release(self):
        pass
    def check(self, ctx):
        return [("exact", 0.0, ctx.limits["exact"])]
'''


def test_new_cell_config_and_metric_are_files_and_entries(tmp_path):
    """A configuration, a traffic kind, a cell and a per-layer metric that
    exist only as new files and new BENCHMARK.json entries are found by
    name; the benchmark's own files are read as they are."""
    for d in ("configs", "workloads", "traffic", "layer_metrics"):
        (tmp_path / d).mkdir()
    (tmp_path / "configs" / "toy.json").write_text(json.dumps({"size": 3}))
    (tmp_path / "workloads" / "toy.cell.json").write_text(json.dumps(
        {"config": "toy", "traffic": "toy_mix", "kind": "toy_kind", "params": {"scale": 2},
         "limits": {"exact": 0}}))
    (tmp_path / "traffic" / "toy_kind.py").write_text(DUMMY_KIND)
    (tmp_path / "layer_metrics" / "size.toy.py").write_text(
        "def read(ctx):\n    return ctx.extra['size']\n")
    (tmp_path / "layer_metrics" / "silent.toy.py").write_text("def read(ctx):\n    return None\n")
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "toy", "source": "https://example.org/toy",
                             "file": "gpubench/configs/toy.json", "reduced": [], "why": "toy"})
    bench["workloads"].append({"name": "toy.cell", "config": "toy", "traffic": "toy_mix",
                               "chips": 1, "why": "toy"})
    bench["end_to_end"].append({"name": "things_per_s", "unit": "1/s", "better": "higher",
                                "bound": 0.05, "source": "host_clock", "workloads": ["toy.cell"]})
    bench["per_layer"] += [
        {"name": "size.toy", "unit": "1", "better": "higher", "source": "program_counter",
         "layer": "toy", "moves": "things_per_s", "workloads": ["toy.cell"]},
        {"name": "silent.toy", "unit": "1", "better": "higher", "source": "program_counter",
         "layer": "toy", "moves": "things_per_s", "workloads": ["toy.cell"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    layout = harness.Layout(roots=(tmp_path, harness.HERE), benchmark=tmp_path / "BENCHMARK.json")

    rec = run.run(args("toy.cell", seconds=0.05), layout=layout, device=CPU)
    assert rec["correct"] and set(rec["metrics"]) == {"things_per_s", "peak_mem_gib", "setup_s"}
    rec = run.run(args("toy.cell", trace_=1, seconds=0.05), layout=layout, device=CPU)
    assert rec["metrics"] == {"size.toy": {"value": 6, "unit": "1"}}  # silent.toy left out
    assert list(rec)[-1] == "checks"
    # the benchmark's own cells are still found through the same layout
    assert layout.cell("pose_w32_infer_bs32")["workload"]["kind"] == "frames"


# -- BENCHMARK.json ----------------------------------------------------------------------

def test_benchmark_names_units_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gpubench"] and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("gpubench/")
        assert harness.load_json(ROOT / c["file"])["reduced"] == c["reduced"] == []
        names.append(c["name"])
    used = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["traffic"]) and len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in used
        used.add((w["config"], w["traffic"]))
        wl = harness.load_json(harness.HERE / "workloads" / f"{w['name']}.json")
        assert (harness.HERE / "traffic" / f"{wl['kind']}.py").is_file()
        names.append(w["name"])
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        names.append(m["name"])
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and (harness.HERE / "layer_metrics" / f"{m['name']}.py").is_file()
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        for cell in m["workloads"]:
            assert "workloads" not in e2e[m["moves"]] or cell in e2e[m["moves"]]["workloads"]
        names.append(m["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    for w in BENCH["workloads"]:  # every cell: setup_s, another end-to-end, a per-layer metric
        cell = harness.Layout().cell(w["name"])
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


# -- imports -----------------------------------------------------------------------------

def _top_level_imports(path: Path) -> set:
    mods = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods.add(node.module.split(".")[0])
    return mods


HARNESS_FILES = sorted(p for p in harness.HERE.rglob("*.py")
                       if "tests" not in p.relative_to(harness.HERE).parts
                       and not p.relative_to(harness.HERE).parts[0].startswith("."))


@pytest.mark.parametrize("path", HARNESS_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_imports(path):
    """Top-level names compared whole: ``human_pose_tpu_torch`` is the
    program, ``human_pose_tpu`` the JAX package."""
    assert not _top_level_imports(path) & {"jax", "jaxlib", "flax", "human_pose_tpu"}


@pytest.mark.parametrize("path", sorted((harness.HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "human_pose_tpu_torch" not in _top_level_imports(path)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "human_pose_tpu_torch_x", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "human_pose_tpu.ops", types.ModuleType("y"))
    assert harness.forbidden_modules() == ["human_pose_tpu"]


def test_no_card_no_result(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit):
        run.run(args("pose_w32_infer_bs32"))


# -- the trace reader --------------------------------------------------------------------

def _ev(cat, name, ts, dur, **a):
    return {"cat": cat, "name": name, "ts": ts, "dur": dur, "args": a}


def test_trace_window_busy_gaps_and_spans():
    events = [
        _ev("user_annotation", "unit", 100, 50), _ev("user_annotation", "forward", 101, 10),
        _ev("user_annotation", "decode", 112, 30), _ev("user_annotation", "sync", 150, 50),
        _ev("cuda_runtime", "cudaLaunchKernel", 102, 1, correlation=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 113, 1, correlation=2),
        _ev("cuda_runtime", "cudaLaunchKernel", 114, 1, correlation=3),
        _ev("kernel", "conv_kernel", 105, 20, correlation=1),
        _ev("kernel", "match_kernel", 130, 10, correlation=2),
        _ev("kernel", "before_window", 50, 10, correlation=9),
    ]
    tr = trace.parse(events)
    assert tr.window_s == pytest.approx(100e-6) and tr.busy_s == pytest.approx(30e-6)
    assert tr.missing_launches == 1  # correlation 3 has no kernel row
    assert tr.kernel_seconds("conv", span="forward") == pytest.approx(20e-6)
    assert tr.kernel_rows("match_kernel") == 1
    assert sorted(s for _, s in tr.gaps) == pytest.approx([5e-6, 5e-6, 60e-6])
    assert tr.breakdown()["device_ops"][0][0] == "conv_kernel"


# -- tiny runs, sound and broken ---------------------------------------------------------

@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    return tiny.write(tmp_path_factory.mktemp("tiny"))


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_tiny_run_is_correct(layout, cell):
    rec = run.run(args(cell), layout=layout, device=CPU)
    assert rec["correct"], rec["checks"]
    assert rec["attempted"] >= 1 and rec["failed"] == 0
    assert set(rec["metrics"]) == {m["name"] for m in layout.cell(cell)["end_to_end"]}


def _unchanged_step(steps):
    def step(state, *a, **k):
        state.model.train()
        return state, {"loss": torch.tensor(1.0)}
    return {"keypoints_train_step": step, "classification_train_step": step}


def _cut(x):
    """The first half of the rows of a tensor or of each in a list, tuple or dict."""
    if isinstance(x, dict):
        return {k: _cut(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_cut(v) for v in x)
    return x[: x.shape[0] // 2]


def _half_batch(steps):
    kp, cls = steps.keypoints_train_step, steps.classification_train_step
    return {"keypoints_train_step": lambda s, b, lr: kp(s, _cut(b), lr),
            "classification_train_step": lambda s, i, y, lr: cls(s, _cut(i), _cut(y), lr)}


def _half_loss(steps):
    """The whole batch forward; the loss over half of its rows."""
    kp, cls = steps._keypoints_losses, steps._classification_metrics
    return {"_keypoints_losses": lambda out, batch: kp(_cut(out), _cut(batch)),
            "_classification_metrics": lambda logits, labels: cls(_cut(logits), _cut(labels))}


def _half_tag_loss(steps):
    """The keypoints loss with its push and pull over half of the rows."""
    from human_pose_tpu_torch.train import losses

    ae = losses.ae_grouping_loss
    return {"ae_grouping_loss": lambda tags, joints: ae(_cut(tags), _cut(joints))}


TRAIN_FAULTS = {"state_unchanged": (_unchanged_step, "steps"),
                "half_batch": (_half_batch, "steps"), "half_loss": (_half_loss, "steps"),
                "half_tag_loss": (_half_tag_loss, "losses")}
TRAIN_CELLS = {"pose_w32_train_bs36": sorted(TRAIN_FAULTS),
               "cls_w32_train_bs80": ["half_batch", "half_loss", "state_unchanged"]}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in TRAIN_CELLS.items() for f in fs])
def test_broken_train_step_is_not_correct(layout, monkeypatch, cell, fault):
    from human_pose_tpu_torch.train import losses, steps

    make, where = TRAIN_FAULTS[fault]
    module = {"steps": steps, "losses": losses}[where]
    for name, fn in make(steps).items():
        monkeypatch.setattr(module, name, fn)
    rec = run.run(args(cell), layout=layout, device=CPU)
    assert not rec["correct"], rec["checks"]
    json.dumps(rec, allow_nan=False)  # the result line stays JSON


def _altered_answer(decode):
    def broken(self, *a, **k):
        joints, scores, valid, avg = decode(self, *a, **k)
        joints = joints.clone()
        joints[..., 0] += 1.0
        return joints, scores, valid, avg
    return broken


def _half_decoded(decode):
    def broken(self, avg, tags, *a, **k):
        n = avg.shape[0] // 2
        joints, scores, valid, out = decode(self, avg[:n], [t[:n] for t in tags], *a, **k)
        pad = avg.shape[0] - n
        return (torch.cat([joints, joints.new_zeros((pad, *joints.shape[1:]))]),
                torch.cat([scores, scores.new_zeros((pad, *scores.shape[1:]))]),
                torch.cat([valid, valid.new_zeros((pad, *valid.shape[1:]))]), out)
    return broken


FRAME_FAULTS = {"altered_answer": _altered_answer, "half_batch": _half_decoded}
HALF_SEED = 3


@pytest.mark.parametrize("fault", sorted(FRAME_FAULTS))
@pytest.mark.parametrize("cell", ["pose_w32_infer_bs32", "pose_w32_flip_bs16"])
def test_broken_decode_is_not_correct(layout, monkeypatch, cell, fault):
    from human_pose_tpu_torch.inference.models import InferenceKeypointsModel

    broken = FRAME_FAULTS[fault](InferenceKeypointsModel.decode_masked)
    monkeypatch.setattr(InferenceKeypointsModel, "decode_masked", broken)
    rec = run.run(args(cell, seed=HALF_SEED), layout=layout, device=CPU)
    assert not rec["correct"], rec["checks"]


def test_half_decoded_frames_are_among_those_held(layout):
    """At ``HALF_SEED`` the frames a tiny run holds include the second half
    of a batch, which the half-batch fault leaves undecoded."""
    from gpubench.traffic import frames

    ctx = harness.Context.make(layout.cell("pose_w32_infer_bs32"), HALF_SEED, 0.1, CPU)
    cell = frames.Cell(ctx)
    for i in range(ctx.params["keep_max"]):
        cell.unit(i)
    assert 1 in {k for _, k, *_ in cell.kept}
