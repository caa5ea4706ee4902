"""The pieces of the port's training engine against the JAX package, on the
CPU: meters and metric storage, the html plots, the logger backends, the
callbacks (the dispatcher, ``SaveModelCheckpoint``'s decisions,
``ModelSummary``), checkpoints (the round trip through
``torch.load(weights_only=True)``, the background writer's snapshot,
``load_params_partial`` from three formats and its refusals), the profiler
window, ``collect_sample`` and ``remat``.

The model is the shallow C=8 HigherHRNet (``SHALLOW``) on one torch
intra-op thread; the trainer against JAX's is in
tests/test_torch_port_trainer.py.
"""

from __future__ import annotations

import json
import math
import pickle
import re
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch

from human_pose_tpu.loggers import loggers as jax_loggers
from human_pose_tpu.loggers.monitoring import collect_sample as jax_collect_sample
from human_pose_tpu.models import HigherHRNet as JaxHigherHRNet
from human_pose_tpu.train import callbacks as jax_callbacks
from human_pose_tpu.train import html_plots as jax_html_plots
from human_pose_tpu.train.meters import Meters as JaxMeters
from human_pose_tpu.train.storage import MetricsStorage as JaxMetricsStorage
from human_pose_tpu.train.storage import SystemMonitoringStorage as JaxSystemMonitoringStorage
from human_pose_tpu.utils.export import export_weights_npz
from human_pose_tpu_torch.loggers import loggers, monitoring
from human_pose_tpu_torch.models import HigherHRNet, hrnet, init_keypoints_weights_
from human_pose_tpu_torch.train import (
    AsyncCheckpointWriter, KeypointsModule, Meters, MetricsStorage, SystemMonitoringStorage,
    callbacks, html_plots, load_checkpoint, load_params_partial, load_train_state, save_checkpoint,
)
from human_pose_tpu_torch.train.visualization import plot_metrics, plot_system_monitoring
from human_pose_tpu_torch.utils import weights
from human_pose_tpu_torch.utils.profiling import StepWindowProfiler
from tests.test_torch_port_models import SHALLOW

K = 17


def make_batch(n: int, size: int, persons: int, seed: int = 0) -> dict:
    """A seeded host batch in the loader's channel-last layout: uint8
    images, heatmaps at 1/4 and 1/2, masks of ones, joints on the 1/4 grid
    about half visible."""
    rs = np.random.RandomState(seed)
    h4, h2 = size // 4, size // 2
    joints = np.stack([rs.randint(0, h4, (n, persons, K)), rs.randint(0, h4, (n, persons, K)),
                       rs.rand(n, persons, K) > 0.5], -1).astype(np.int32)
    return {"images": rs.randint(0, 256, (n, size, size, 3)).astype(np.uint8),
            "heatmaps": [rs.rand(n, h4, h4, K).astype(np.float32),
                         rs.rand(n, h2, h2, K).astype(np.float32)],
            "masks": [np.ones((n, h4, h4), np.float32), np.ones((n, h2, h2), np.float32)],
            "joints": joints}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(seed: int = 0):
    """Seeded step records over 3 epochs, two splits and three metrics."""
    rs = np.random.RandomState(seed)
    out = []
    for step in range(12):
        epoch = step // 4
        for split in ("train", "val") if step % 2 else ("train",):
            out.append(({"loss": float(rs.rand()), "hm_0": float(rs.rand() * 1e-3),
                         "push": float(rs.randn())}, step, epoch, split))
    return out


def _storages(seed: int = 0):
    port, ref = MetricsStorage(), JaxMetricsStorage()
    for metrics, step, epoch, split in _records(seed):
        port.append(metrics, step, epoch, split)
        ref.append(metrics, step, epoch, split)
    return port, ref


# -- meters and storage ----------------------------------------------------------

@pytest.mark.parametrize("key", ["epoch", "step"])
def test_meters_and_storage_equal_jax(key):
    """The same records give the same meters, the same storage and the same
    group-by mean over ``key``, exactly; the state dict round-trips."""
    port, ref = _storages()
    assert port.to_dict() == ref.to_dict()
    assert port.aggregate_over_key(key).to_dict() == ref.aggregate_over_key(key).to_dict()
    assert port.aggregate_over_key(key).name == ref.aggregate_over_key(key).name
    again = MetricsStorage()
    again.load_state_dict(port.state_dict())
    assert again.to_dict() == port.to_dict() and port.state_dict() == ref.state_dict()
    meters, jmeters = Meters(), JaxMeters()
    for metrics, _, _, _ in _records():
        meters.update(metrics, n=2)
        jmeters.update(metrics, n=2)
    assert meters.to_dict() == jmeters.to_dict()
    meters.reset()
    assert meters.to_dict() == {k: 0.0 for k in jmeters.to_dict()}


# -- plots -------------------------------------------------------------------------

def test_html_plots_byte_equal(tmp_path):
    """``plot_metrics_html`` and ``plot_system_monitoring_html`` write the
    same bytes as JAX's for the same storage."""
    port, ref = _storages(1)
    port.append({"loss": 9.9}, 0, 0, "sanity_check")
    ref.append({"loss": 9.9}, 0, 0, "sanity_check")
    html_plots.plot_metrics_html(port.aggregate_over_key("epoch"), tmp_path / "p.html", "epoch")
    jax_html_plots.plot_metrics_html(ref.aggregate_over_key("epoch"), tmp_path / "j.html", "epoch")
    assert (tmp_path / "p.html").read_bytes() == (tmp_path / "j.html").read_bytes()
    mon, jmon = SystemMonitoringStorage(), JaxSystemMonitoringStorage()
    for i in range(5):
        sample = {"timestamp": 100.0 + 3 * i, "cpu_percent": 10.0 * i, "gpu0_mem_gb": 1.5 + i / 7}
        mon.append(sample)
        jmon.append(sample)
    html_plots.plot_system_monitoring_html(mon, tmp_path / "ps.html")
    jax_html_plots.plot_system_monitoring_html(jmon, tmp_path / "js.html")
    assert (tmp_path / "ps.html").read_bytes() == (tmp_path / "js.html").read_bytes()


def test_jpg_plots_drawn_with_cv2(tmp_path):
    """The jpgs (cv2, no matplotlib): one 480x320 panel a metric, three a
    row, a readable image; nothing for an empty storage."""
    port, _ = _storages(2)
    plot_metrics(port.aggregate_over_key("epoch"), tmp_path / "m.jpg", "epoch")
    img = cv2.imread(str(tmp_path / "m.jpg"))
    assert img.shape == (320, 3 * 480, 3) and img.std() > 0
    mon = SystemMonitoringStorage()
    for i in range(3):
        mon.append({"timestamp": float(i), **{f"k{j}": float(i * j) for j in range(4)}})
    plot_system_monitoring(mon, tmp_path / "s.jpg")
    assert cv2.imread(str(tmp_path / "s.jpg")).shape == (2 * 320, 3 * 480, 3)
    plot_metrics(MetricsStorage(), tmp_path / "none.jpg")
    assert not (tmp_path / "none.jpg").exists()


# -- loggers -----------------------------------------------------------------------

def _drive_logger(pkg, kind: str, root: Path):
    """The same calls on a backend of ``pkg`` (the port's or JAX's loggers
    module) in ``root``: metrics of two splits, params, the config, an
    artifact file and directory, a finalize; returns the run id."""
    cls = {"terminal": pkg.TerminalLogger, "file": pkg.FileTrackerLogger,
           "mlflow": pkg.MlflowFileLogger}[kind]
    lg = cls(root / "run", "pose-exp", "run-a") if kind != "terminal" else cls(root / "run")
    fan = pkg.Loggers([lg], root / "run")
    fan.log_metrics({"loss": 0.5, "AP": 0.125}, 0, "train")
    fan.log_metrics({"loss": 0.25}, 1, "val")
    fan.log_params({"setup": {"seed": 42}, "lr": 1e-3})
    fan.log_config({"trainer": {"max_epochs": 2}, "net": {"params": {"C": 8}}})
    (root / "art").mkdir()
    (root / "art" / "a.txt").write_text("artifact")
    fan.log_artifact(root / "art" / "a.txt")
    fan.log_artifact(root / "art", "dir")
    state = fan.state_dict()
    fan.load_state_dict(state)
    fan.finalize(pkg.Status.FINISHED)
    return getattr(lg, "run_id", None)


def _normalized_tree(root: Path, run_id) -> dict:
    """Relative path -> contents with the root, the run id and times taken
    out: 13-digit ms stamps, the jsonl ``ts`` field, mlflow's metric line
    stamps."""
    out = {}
    for p in sorted((root / "run").rglob("*")):
        rel = str(p.relative_to(root))
        if run_id:
            rel = rel.replace(run_id, "RUN")
        if p.is_dir():
            out[rel] = None
            continue
        text = p.read_text()
        text = text.replace(str(root.resolve()), "ROOT").replace(str(root), "ROOT")
        if run_id:
            text = text.replace(run_id, "RUN")
        text = re.sub(r'"ts": [0-9.e+]+, ', "", text)
        text = re.sub(r"\b\d{13}\b", "T", text)
        out[rel] = text
    return out


@pytest.mark.parametrize("kind", ["terminal", "file", "mlflow"])
def test_logger_backends_equal_jax(tmp_path, kind):
    """Each backend writes the same files with the same contents as JAX's
    (the run-dir layout, the tracker's jsonl, params, config, artifacts and
    status; mlflow's FileStore), apart from times, run ids and the root."""
    runs = {}
    for name, pkg in (("port", loggers), ("jax", jax_loggers)):
        root = tmp_path / name
        root.mkdir()
        runs[name] = _normalized_tree(root, _drive_logger(pkg, kind, root))
    assert set(runs["port"]) == set(runs["jax"])
    assert runs["port"] == runs["jax"]
    assert "run/config.yaml" in runs["port"]
    for d in ("checkpoints", "logs", "model", "eval_examples", "data_examples"):
        assert f"run/{d}" in runs["port"]
    if kind == "file":
        assert json.loads(runs["port"]["run/tracker/run.json"])["status"] == "FINISHED"


# -- callbacks ---------------------------------------------------------------------

class _Recorder(callbacks.BaseCallback):
    def __init__(self):
        self.calls = []
        self.n = 0

    def on_epoch_end(self, trainer):
        self.calls.append(("epoch_end", trainer))

    def state_dict(self):
        return {"n": self.n}

    def load_state_dict(self, state):
        self.n = state["n"]


class _StepWatcher(callbacks.BaseCallback):
    main_process_only = False

    def on_step_end(self, trainer):
        pass


def test_callbacks_dispatcher(monkeypatch):
    """Hooks reach every callback in order; ``overrides_step_end`` only with
    a callback that implements it; the state dict is keyed by class name and
    round-trips; on a process other than rank 0 only callbacks with
    ``main_process_only = False`` stay (as JAX's dispatcher keeps)."""
    rec, watcher = _Recorder(), _StepWatcher()
    cbs = callbacks.Callbacks([rec, callbacks.BaseCallback()])
    assert not cbs.overrides_step_end()
    cbs.on_epoch_end("T")
    assert rec.calls == [("epoch_end", "T")]
    with pytest.raises(AttributeError):
        cbs.not_a_hook  # noqa: B018
    rec.n = 7
    state = cbs.state_dict()
    assert state == {"_Recorder": {"n": 7}, "BaseCallback": {}}
    other = _Recorder()
    callbacks.Callbacks([other]).load_state_dict(state)
    assert other.n == 7
    assert callbacks.Callbacks([rec, watcher]).overrides_step_end()
    monkeypatch.setenv("RANK", "1")
    save = callbacks.SaveModelCheckpoint()
    kept = callbacks.Callbacks([rec, watcher, save, callbacks.ModelSummary()]).callbacks
    assert kept == [watcher, save]
    assert [type(cb).__name__ for cb in callbacks.default_callbacks()] == \
        [type(cb).__name__ for cb in jax_callbacks.default_callbacks()]


class _FakeTrainer:
    def __init__(self, root):
        self.ckpt_dir = Path(root) / "checkpoints"
        self.epoch_metrics = {}
        self.saved = []

    def save_checkpoint(self, path):
        self.saved.append(Path(path).name)


@pytest.mark.parametrize("mode", ["min", "max"])
def test_save_model_checkpoint_decisions_equal_jax(tmp_path, mode):
    """best.pt when the monitored value improves (min or max), last.pt every
    epoch, no best.pt without the metric: the same saves as JAX's callback
    on the same sequence, and the same state."""
    values = [3.0, 2.0, 2.5, None, 1.0, 1.0, 4.0]
    got = {}
    for name, mod in (("port", callbacks), ("jax", jax_callbacks)):
        cb, tr = mod.SaveModelCheckpoint(monitor="loss", split="val", mode=mode), _FakeTrainer(tmp_path)
        per_epoch = []
        for v in values:
            tr.epoch_metrics = {"val": {} if v is None else {"loss": v}}
            tr.saved = []
            cb.on_epoch_end(tr)
            per_epoch.append(tuple(tr.saved))
        got[name] = (per_epoch, cb.state_dict())
    assert got["port"] == got["jax"]
    assert got["port"][0][0] == ("best.pt", "last.pt") and got["port"][0][3] == ("last.pt",)


def test_model_summary_total_equals_jax(tmp_path):
    """``ModelSummary`` of W32: TOTAL 28,645,331, the count of JAX's
    parameter tree; the groups sum to it."""
    class T:
        log_path = tmp_path

    class M:
        model = HigherHRNet(num_kpts=K, C=32, device="cpu")

    trainer = T()
    trainer.module = M()
    callbacks.ModelSummary().on_fit_start(trainer)
    lines = (tmp_path / "model" / "model_summary.txt").read_text().splitlines()
    total = int(lines[-1].split()[-1].replace(",", ""))
    template = jax.eval_shape(lambda: JaxHigherHRNet(num_kpts=K, C=32, s2d=False).init(
        jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32), train=False))
    want = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(template["params"]))
    assert total == want == 28_645_331
    assert sum(int(line.split()[-1].replace(",", "")) for line in lines[2:-2]) == total


# -- checkpoints -------------------------------------------------------------------

def _module(seed: int = 0, **net):
    model = HigherHRNet(num_kpts=K, C=8, device="cpu", **{**SHALLOW, **net})
    return KeypointsModule.create(
        model, {"optim": {"name": "Adam", "params": {"lr": 1e-3}}},
        {"optim": {"name": "ReduceLROnPlateau", "interval": "epoch", "params": {"patience": 0}}},
        seed=seed)


def _step(module, seed: int = 0):
    return module.training_step(make_batch(2, 64, 64, seed=seed))


def _host_state():
    storage, _ = _storages(3)
    return dict(datamodule_state={"epoch": 3, "seed": 9}, metrics_state=storage.state_dict(),
                callbacks_state={"SaveModelCheckpoint": {"best": math.inf}},
                logger_state={"run_ids": [{}, {"run_id": "exp-run-1"}]})


def _assert_state_equal(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for k in a:
        if torch.is_tensor(a[k]):
            assert torch.equal(a[k], b[k]), k
        elif isinstance(a[k], dict):
            _assert_state_equal(a[k], b[k])
        else:
            assert a[k] == b[k], k


def test_checkpoint_round_trip_weights_only(tmp_path):
    """A checkpoint after two steps reads back through
    ``torch.load(weights_only=True)`` (plain types only: the loader's,
    storage's, callbacks', logger's and a plateau scheduler's state with its
    infinite best) and restores the model, Adam's state, the step and the
    schedulers into a fresh module, exactly."""
    module = _module()
    _step(module)
    _step(module, 1)
    module.on_epoch_end({"loss": 1.0})
    host = _host_state()
    save_checkpoint(tmp_path / "last.pt", module.state, epoch=4,
                    lr_schedulers=module.schedulers_state_dict(), **host)
    assert not (tmp_path / "last.pt.tmp").exists()
    ckpt = load_checkpoint(tmp_path / "last.pt")
    assert set(ckpt) == {"module", "datamodule", "metrics", "callbacks", "logger", "epoch", "step"}
    assert set(ckpt["module"]) == {"model", "optimizers", "lr_schedulers", "step"}
    assert (ckpt["epoch"], ckpt["step"], ckpt["module"]["step"]) == (4, 2, 2)
    assert ckpt["datamodule"] == host["datamodule_state"] and ckpt["metrics"] == host["metrics_state"]
    assert ckpt["callbacks"] == host["callbacks_state"] and ckpt["logger"] == host["logger_state"]
    fresh = _module(seed=5)
    load_train_state(fresh.state, ckpt)
    fresh.load_schedulers_state_dict(ckpt["module"]["lr_schedulers"])
    assert fresh.state.step == 2
    _assert_state_equal(fresh.model.state_dict(), module.model.state_dict())
    _assert_state_equal(fresh.state.optimizer.state_dict(), module.state.optimizer.state_dict())
    assert fresh.schedulers_state_dict() == module.schedulers_state_dict()
    # the restored module steps on as the saved one does
    a, b = _step(module, 2), _step(fresh, 2)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_async_snapshot_unaffected_by_later_steps(tmp_path):
    """``submit`` snapshots the model, Adam's ``exp_avg``/``exp_avg_sq`` and
    the host state: two steps taken (and the host dicts changed) before the
    write is joined do not reach the file; a later submit writes the later
    state; submits serialize."""
    module = _module()
    _step(module)
    before = {k: v.clone() for k, v in module.model.state_dict().items()}
    opt_before = {i: {k: v.clone() if torch.is_tensor(v) else v for k, v in s.items()}
                  for i, s in module.state.optimizer.state_dict()["state"].items()}
    host = _host_state()
    writer = AsyncCheckpointWriter()
    writer.submit(tmp_path / "last.pt", module.state, epoch=0,
                  lr_schedulers=module.schedulers_state_dict(), **host)
    _step(module, 1)
    _step(module, 2)
    host["metrics_state"]["metrics"]["loss"]["train"].append({"step": 99, "epoch": 9, "value": 9.0})
    host["datamodule_state"]["epoch"] = 99
    writer.wait()
    ckpt = load_checkpoint(tmp_path / "last.pt")
    assert ckpt["module"]["step"] == 1 and ckpt["datamodule"]["epoch"] == 3
    assert len(ckpt["metrics"]["metrics"]["loss"]["train"]) == 12
    _assert_state_equal(ckpt["module"]["model"], before)
    _assert_state_equal(ckpt["module"]["optimizers"]["optim"]["state"], opt_before)
    assert not all(torch.equal(v, module.model.state_dict()[k]) for k, v in before.items())
    for epoch in (1, 2):
        writer.submit(tmp_path / "last.pt", module.state, epoch=epoch)
    writer.wait()
    ckpt = load_checkpoint(tmp_path / "last.pt")
    assert ckpt["epoch"] == 2 and ckpt["module"]["step"] == 3
    _assert_state_equal(ckpt["module"]["model"], module.model.state_dict())


def test_async_error_surfaces_on_wait(tmp_path):
    blocker = tmp_path / "blocker"
    blocker.write_text("x")
    writer = AsyncCheckpointWriter()
    writer.submit(blocker / "sub" / "last.pt", _module().state, epoch=0)
    with pytest.raises(OSError):
        writer.wait()
    writer.wait()  # the error is raised once


def _source_model(seed: int = 11):
    """A model unlike the target: 13 keypoints (the heads' shapes differ)
    and its own seeded weights and statistics."""
    src = HigherHRNet(num_kpts=13, C=8, device="cpu", **SHALLOW)
    init_keypoints_weights_(src, torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for name, t in src.state_dict().items():
            if t.is_floating_point():
                t.add_(torch.rand(t.shape, generator=torch.Generator().manual_seed(len(name))))
    return src


def _write_format(fmt: str, src, path: Path) -> Path:
    sd = src.state_dict()
    if fmt == "port":
        module = KeypointsModule.create(src, seed=0)
        src.load_state_dict(sd)
        save_checkpoint(path, module.state, epoch=0)
    elif fmt == "reference_trainer_pt":
        torch.save({"module": {"model": {f"module.{k}": v for k, v in sd.items()}}, "epoch": 3}, path)
    elif fmt == "reference_pt":
        torch.save(sd, path)
    else:
        template = jax.eval_shape(lambda: JaxHigherHRNet(num_kpts=13, C=8, s2d=False, **SHALLOW).init(
            jax.random.PRNGKey(0), np.zeros((1, 64, 64, 3), np.float32), train=False))
        template = jax.tree_util.tree_map(lambda t: np.zeros(t.shape, t.dtype), dict(template))
        path = path.with_suffix(".npz")
        export_weights_npz(weights.variables_from_torch(
            {k: v.numpy() for k, v in sd.items()}, template), path)
    return path


@pytest.mark.parametrize("fmt", ["port", "reference_trainer_pt", "reference_pt", "flax_npz"])
def test_load_params_partial(tmp_path, fmt):
    """Every parameter whose name and shape the source has is copied (the
    backbone; not the 13-keypoint heads), the rest keep their init, the
    BatchNorm running statistics stay the target's; the same parameters as
    JAX's ``load_params_partial`` takes from a torch file."""
    src = _source_model()
    path = _write_format(fmt, src, tmp_path / "src.pt")
    target = HigherHRNet(num_kpts=K, C=8, device="cpu", **SHALLOW)
    init_keypoints_weights_(target, torch.Generator().manual_seed(0))
    fresh = {k: v.clone() for k, v in target.state_dict().items()}
    n = load_params_partial(target, path)
    src_sd, params = src.state_dict(), dict(target.named_parameters())
    matched = {k for k, p in params.items() if k in src_sd and src_sd[k].shape == p.shape}
    assert n == len(matched) and 0 < n < len(params)
    assert any(k.startswith("init_heatmaps_head") for k in set(params) - matched)
    for k, v in target.state_dict().items():
        want = src_sd[k] if k in matched else fresh[k]
        assert torch.equal(v, want), k


def test_load_params_partial_refuses_jax_formats(tmp_path):
    """A directory that orbax itself wrote (the JAX package's
    ``checkpoint_orbax``: ``host_state.pkl`` without the port's
    ``torch.distributed.checkpoint`` metadata) refuses, naming the npz
    exporter; a native JAX trainer checkpoint (a pickle around flax msgpack)
    whose module holds no params refuses. The port's directories and JAX
    trainer checkpoints with params load
    (tests/test_torch_port_checkpoint_dir.py)."""
    target = HigherHRNet(num_kpts=K, C=8, device="cpu", **SHALLOW)
    orbax = tmp_path / "last.pt"
    orbax.mkdir()
    (orbax / "host_state.pkl").write_bytes(b"")
    with pytest.raises(ValueError, match="orbax.*npz"):
        load_params_partial(target, orbax)
    with open(tmp_path / "jax.ckpt", "wb") as f:
        pickle.dump({"module": b"\x81\xa4step\x00", "epoch": 1}, f)
    with pytest.raises(ValueError, match="no params"):
        load_params_partial(target, tmp_path / "jax.ckpt")


# -- profiler, monitoring ------------------------------------------------------------

def test_profiler_window_traces_steps_1_and_2(tmp_path):
    """``StepWindowProfiler(start=1, steps=2)`` over 5 steps from global
    step 10 (a resumed run): one Chrome trace with the ``train_step_11``
    and ``train_step_12`` ranges, no other step's."""
    prof = StepWindowProfiler(str(tmp_path / "trace"), start=1, steps=2)
    x = torch.randn(64, 64)
    for step in range(10, 15):
        if prof.closing(step):
            assert step == 13
        prof.on_step(step)
        with prof.annotate(step):
            (x @ x).sum()
    prof.stop()
    traces = list((tmp_path / "trace").glob("*.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert {"train_step_11", "train_step_12"} <= names
    assert not {"train_step_10", "train_step_13", "train_step_14"} & names
    assert StepWindowProfiler(None).done


def test_collect_sample_keys():
    """JAX's host keys (without its TPU memory keys), finite; the card's
    memory keys only with a card; the monitor thread samples."""
    got, want = monitoring.collect_sample(), jax_collect_sample()
    host = {k for k in want if not k.startswith("tpu")}
    gpu = {k for k in got if k.startswith("gpu")}
    assert set(got) - gpu == host
    assert bool(gpu) == torch.cuda.is_available()
    assert all(np.isfinite(v) for v in got.values())
    assert 0 <= got["memory_percent"] <= 100 and 0 <= got["disk_percent"] <= 100
    mon = monitoring.SystemMetricsMonitor(interval_s=0.02)
    mon.start()
    import time

    time.sleep(0.2)
    mon.stop()
    assert len(mon.storage.samples) >= 1


# -- remat ---------------------------------------------------------------------------

def _train_once(remat, batch, base):
    net = HigherHRNet(num_kpts=K, C=8, device="cpu", remat=remat, **SHALLOW)
    net.load_state_dict(base)
    module = KeypointsModule.create(net, seed=0)
    net.load_state_dict(base)
    metrics = module.training_step(batch)
    return (metrics, {n: p.grad.clone() for n, p in net.named_parameters()},
            {k: v.clone() for k, v in net.state_dict().items()})


@pytest.fixture(scope="module")
def plain_step():
    base = init_keypoints_weights_(HigherHRNet(num_kpts=K, C=8, device="cpu", **SHALLOW),
                                   torch.Generator().manual_seed(4)).state_dict()
    batch = make_batch(2, 64, 64, seed=3)
    return base, batch, _train_once(False, batch, base)


@pytest.mark.parametrize("remat", [True, (0, 5), (4,), (1, 2, 3)], ids=str)
def test_remat_step_equals_plain_step(plain_step, remat):
    """A step with stages, the stem (5) or the deconv head (4) recomputed
    equals the plain step bit for bit: losses, gradients, BatchNorm running
    statistics and parameters after Adam."""
    base, batch, (m0, g0, sd0) = plain_step
    m, g, sd = _train_once(remat, batch, base)
    assert all(torch.equal(m[k], m0[k]) for k in m0)
    assert all(torch.equal(g[k], g0[k]) for k in g0)
    assert all(torch.equal(sd[k], sd0[k]) for k in sd0)


def test_remat_recompute_would_move_statistics_twice(plain_step, monkeypatch):
    """Without the frozen statistics in the recompute, the running
    statistics of the recomputed stages move twice: the trap the freeze
    closes. Eval mode does not recompute; the config passes ``remat``."""
    from contextlib import nullcontext

    from human_pose_tpu_torch.configs import KeypointsConfig

    base, batch, (_, _, sd0) = plain_step
    monkeypatch.setattr(hrnet, "frozen_running_stats", nullcontext)
    _, _, sd = _train_once((0,), batch, base)
    moved = [k for k in sd0 if k.startswith("backbone.stages.0") and not torch.equal(sd[k], sd0[k])]
    assert moved and all(".running_" in k or "num_batches" in k for k in moved)
    net = KeypointsConfig.from_dict({"trainer": {"accelerator": "cpu"}, "net": {"params": {
        "C": 8, "remat": [1, 5], "s2d": False, **SHALLOW}}}).create_net()
    assert net.backbone.remat == (1, 5) and not net.remat_head
