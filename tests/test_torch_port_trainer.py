"""The port's ``Trainer.fit`` against the JAX package's, on the CPU.

Both packages read one synthesized COCO directory (``make_coco_split``: 8
train images, 8 val images) through their configs' datamodules from one yaml
(128x128, batch 4: two train and two val batches an epoch; Adam lr 1e-3, a
MultiStepLR at epoch 1) and train the shallow C=8 HigherHRNet from the same
seeded weights (``variables_to_torch``) for two epochs with the default
callbacks and a terminal and a file tracker. Then:

* the losses of every step and the epoch means against JAX's, the plot
  batch of each validation, the checkpoint decisions, the run-dir file set;
* the port's ``last.pt`` read by the JAX package's own
  ``load_params_partial`` equals the port's parameters bit for bit;
* one epoch and a resume to two equal the uninterrupted run bit for bit;
* the CLI trains and resumes with ``ckpt_path: auto``;
* a failure mid-epoch leaves FAILED in the tracker and the background
  write joined.

JAX compiles one train and one val step and the decode of its plot batch;
the port runs on one torch intra-op thread.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_pose_tpu.configs import KeypointsConfig as JaxKeypointsConfig
from human_pose_tpu.loggers import loggers as jax_loggers
from human_pose_tpu.models import HigherHRNet as JaxHigherHRNet
from human_pose_tpu.train import TrainState as JaxTrainState
from human_pose_tpu.train import callbacks as jax_callbacks
from human_pose_tpu.train import create_lr_scheduler as jax_create_lr_scheduler
from human_pose_tpu.train import create_optimizer as jax_create_optimizer
from human_pose_tpu.train.checkpoint import load_params_partial as jax_load_params_partial
from human_pose_tpu.train.module import KeypointsModule as JaxKeypointsModule
from human_pose_tpu.train.trainer import Trainer as JaxTrainer
from human_pose_tpu_torch.configs import KeypointsConfig
from human_pose_tpu_torch.inference import InferenceKeypointsModel, load_inference_weights
from human_pose_tpu_torch.loggers import loggers
from human_pose_tpu_torch.models import HigherHRNet
from human_pose_tpu_torch.train import KeypointsModule, Trainer, callbacks, checkpoint
from human_pose_tpu_torch.utils import weights
from tests.test_torch_port_data import make_coco_split
from tests.test_torch_port_models import SHALLOW, _randomize

ROOT = Path(__file__).resolve().parent.parent
K, S, BS, LR, EPOCHS = 17, 128, 4, 1e-3, 2
OPTIMS = {"optim": {"name": "Adam", "params": {"lr": LR}}}
SCHEDULERS = {"optim": {"name": "MultiStepLR", "interval": "epoch",
                        "params": {"milestones": [1], "gamma": 0.5}}}
# later steps and the epoch means: each loss term within 1e-3 of the larger
# of its value and the loss. After the first step the two frameworks'
# parameters differ where Adam's first update lr * g / (|g| + 1e-8) meets
# gradients near 1e-8 or of opposite signs (up to 2 * lr an element), and
# the later losses move with them: on an x86 CPU, 2.1e-4 (hm_0), 1.7e-4 (loss),
# 2.1e-5 (push), 1.0e-5 (hm_1) of their values; pull (~1e-5 of a 0.04 loss)
# 5.2e-3 of its own value, 2e-6 of the loss
LATER_RTOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco_trainer")
    make_coco_split(root, "train2017", 8, 0)
    make_coco_split(root, "val2017", 8, 1)
    return root


def _yaml(path: Path, root: Path, extra: str = "") -> str:
    path.write_text(f"""
setup: {{experiment_name: kp, architecture: HigherHRNet, seed: 9, pretrained_ckpt_path: null}}
trainer: {{accelerator: cpu, use_DDP: true, max_epochs: {EPOCHS}}}
dataloader:
  batch_size: {BS}
  num_workers: 2
  train_ds: {{root: {root}, split: train2017, out_size: {S}, max_num_people: 5}}
  val_ds: {{root: {root}, split: val2017, out_size: {S}, max_num_people: 5}}
transform: {{out_size: {S}}}
module:
  optimizers: {{optim: {{name: Adam, params: {{lr: {LR}}}}}}}
  lr_schedulers: {{optim: {{name: MultiStepLR, interval: epoch, params: {{milestones: [1], gamma: 0.5}}}}}}
net:
  params: {{num_kpts: 17, C: 8, num_blocks_per_stage: [1, 1, 1, 1], num_units: 1,
           num_deconv_resid_blocks: 1, s2d: false}}
{extra}""")
    return str(path)


@pytest.fixture(scope="module")
def setup(coco_root, tmp_path_factory):
    """The yaml, seeded random variables of the shallow net (JAX's
    ``create`` would run flax's init op by op) and a place for runs."""
    base = tmp_path_factory.mktemp("trainer_runs")
    yaml_path = _yaml(base / "train.yaml", coco_root)
    model = JaxHigherHRNet(num_kpts=K, C=8, s2d=False, **SHALLOW)
    template = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), np.zeros((1, S, S, 3), np.float32), train=False))
    template = jax.tree_util.tree_map(lambda t: np.zeros(t.shape, t.dtype), dict(template))
    variables = {col: _randomize(tree, np.random.RandomState(0)) for col, tree in template.items()}
    variables["params"] = jax.tree_util.tree_map(lambda v: (v * 0.3).astype(np.float32),
                                                 variables["params"])
    return base, yaml_path, model, variables


def _quiet_callbacks(module):
    """The default callbacks with the system monitor sampling once an hour
    (a sample is a matter of wall time, so the jpgs it draws would be too)."""
    return [module.SystemMetricsMonitoringCallback(3600.0)
            if type(cb).__name__ == "SystemMetricsMonitoringCallback" else cb
            for cb in module.default_callbacks()]


class _Spy:
    """Records the validation batch index each ``make_results`` call sees and
    each ``save_checkpoint``'s (epoch, file name)."""

    def __init__(self, module, trainer, n_val: int):
        self.plots, self.saves, self.val_calls = [], [], 0
        val_step, make_results, save = module.validation_step, module.make_results, trainer.save_checkpoint

        def validation_step(batch):
            self.val_calls += 1
            return val_step(batch)

        def spy_make_results(batch, outputs):
            self.plots.append((self.val_calls - 1) % n_val)
            return make_results(batch, outputs)

        def spy_save(path):
            self.saves.append((trainer.current_epoch, Path(path).name))
            return save(path)

        module.validation_step, module.make_results = validation_step, spy_make_results
        trainer.save_checkpoint = spy_save


def _port_parts(setup, name: str, max_epochs: int = EPOCHS):
    base, yaml_path, _, variables = setup
    cfg = KeypointsConfig.from_dict(KeypointsConfig.from_yaml_to_dict(yaml_path, []))
    dm = cfg.create_datamodule()
    module = KeypointsModule.create(HigherHRNet(num_kpts=K, C=8, device="cpu", **SHALLOW),
                                    OPTIMS, SCHEDULERS, seed=3)
    module.model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                                  weights.variables_to_torch(variables).items()}, strict=True)
    run = base / name
    logger = loggers.Loggers([loggers.TerminalLogger(run), loggers.FileTrackerLogger(run)], run)
    trainer = Trainer(logger, _quiet_callbacks(callbacks), max_epochs=max_epochs, log_path=run)
    return trainer, module, dm


def _file_set(run: Path) -> set:
    return {str(p.relative_to(run)) for p in run.rglob("*")}


@pytest.fixture(scope="module")
def fitted(setup):
    """JAX's and the port's two-epoch runs."""
    base, yaml_path, model, variables = setup
    jcfg = JaxKeypointsConfig.from_dict(JaxKeypointsConfig.from_yaml_to_dict(yaml_path, []))
    v = jax.tree_util.tree_map(jnp.asarray, variables)
    sched = SCHEDULERS["optim"]
    jmodule = JaxKeypointsModule(
        model, JaxTrainState.create(model.apply, v["params"], v["batch_stats"],
                                    jax_create_optimizer("Adam", lr=LR)),
        {"optim": jax_create_lr_scheduler(LR, sched["name"], sched["interval"], **sched["params"])})
    jrun = base / "jax"
    jtrainer = JaxTrainer(jax_loggers.Loggers([jax_loggers.TerminalLogger(jrun),
                                               jax_loggers.FileTrackerLogger(jrun)], jrun),
                          _quiet_callbacks(jax_callbacks), max_epochs=EPOCHS, log_path=jrun)
    jspy = _Spy(jmodule, jtrainer, 2)
    jtrainer.fit(jmodule, jcfg.create_datamodule())

    trainer, module, dm = _port_parts(setup, "port")
    spy = _Spy(module, trainer, 2)
    t0 = time.perf_counter()
    trainer.fit(module, dm)
    seconds = time.perf_counter() - t0
    return (jtrainer, jmodule, jspy), (trainer, module, dm, spy), seconds


def _values(trainer, split: str, key: str = "loss") -> np.ndarray:
    return np.array([r["value"] for r in trainer.storage.metrics[key][split]])


def test_fit_losses_match_jax(fitted):
    """The first step's loss terms within rel 1e-5 (the tolerance of
    tests/test_torch_port_train.py);
    every later step's and the epoch means (train and val, each term)
    within ``LATER_RTOL`` of the larger of the term and the loss; the same
    steps, epochs and learning rates."""
    (jtrainer, jmodule, _), (trainer, module, _, _), _ = fitted
    assert trainer.current_step == jtrainer.current_step == 2 * EPOCHS
    assert trainer.current_epoch == jtrainer.current_epoch == EPOCHS - 1
    assert module.lr == jmodule.lr == LR * 0.5
    epochs, jepochs = (tr.storage.aggregate_over_key("epoch").metrics for tr in (trainer, jtrainer))
    for key in ("hm_0", "hm_1", "push", "pull", "loss"):
        got, want = _values(trainer, "train", key), _values(jtrainer, "train", key)
        assert got.shape == want.shape == (2 * EPOCHS,)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-12, err_msg=key)
        scale = np.maximum(np.abs(want), _values(jtrainer, "train"))
        assert np.all(np.abs(got - want)[1:] <= LATER_RTOL * scale[1:]), (key, got, want)
        for split in ("train", "val"):
            g, w = epochs[key][split], jepochs[key][split]
            assert [(r["epoch"], r["step"]) for r in g] == [(r["epoch"], r["step"]) for r in w]
            g, w = np.array([r["value"] for r in g]), np.array([r["value"] for r in w])
            scale = np.maximum(np.abs(w), [r["value"] for r in jepochs["loss"][split]])
            assert np.all(np.abs(g - w) <= LATER_RTOL * scale), (split, key, g, w)


def test_fit_decisions_and_files_match_jax(fitted):
    """The same plot batch in each validation (``random.Random(epoch)``),
    the same best.pt and last.pt saves, the same callbacks' state (the best
    val loss within ``LATER_RTOL``) and the same run-dir file set."""
    (jtrainer, _, jspy), (trainer, _, _, spy), _ = fitted
    assert spy.plots == jspy.plots and len(spy.plots) == EPOCHS
    assert spy.saves == jspy.saves
    assert spy.saves[:2] == [(0, "best.pt"), (0, "last.pt")]
    state, jstate = trainer.callbacks.state_dict(), jtrainer.callbacks.state_dict()
    best, jbest = state.pop("SaveModelCheckpoint")["best"], jstate.pop("SaveModelCheckpoint")["best"]
    assert state == jstate and abs(best - jbest) <= LATER_RTOL * jbest
    assert _file_set(trainer.log_path) == _file_set(jtrainer.log_path)
    status = json.loads((trainer.log_path / "tracker" / "run.json").read_text())["status"]
    assert status == "FINISHED"


def test_port_last_pt_loads_into_jax_bit_for_bit(setup, fitted):
    """The JAX package's own ``load_params_partial`` reads the port's
    last.pt (trainer-state layout): its params equal the port's final
    parameters through ``variables_from_torch``, bit for bit; the port's
    best.pt and last.pt load strictly into ``InferenceKeypointsModel``."""
    _, _, _, variables = setup
    (_, jmodule, _), (trainer, module, _, _), _ = fitted
    last = trainer.ckpt_dir / "last.pt"
    got = jax_load_params_partial(jmodule.state.params, last)
    sd = {k: v.numpy() for k, v in module.model.state_dict().items()}
    want = weights.variables_from_torch(sd, variables)["params"]
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_got) == len(flat_want)
    for path, leaf in flat_got:
        np.testing.assert_array_equal(np.asarray(leaf), flat_want[path], err_msg=str(path))
    for name in ("best.pt", "last.pt"):
        net = HigherHRNet(num_kpts=K, C=8, device="cpu", **SHALLOW)
        net.load_state_dict(load_inference_weights(trainer.ckpt_dir / name), strict=True)
        im = InferenceKeypointsModel(net.eval(), device="cpu")
        assert im.model is net
    assert all(torch.equal(a, b) for a, b in zip(net.state_dict().values(),
                                                  module.model.state_dict().values()))


def test_resume_equals_uninterrupted_run(setup, fitted):
    """One epoch, then a new trainer and module resumed from its last.pt to
    two epochs: the parameters, BatchNorm statistics, Adam's state, the
    step, the metric storage, the schedulers and the loader's epoch equal
    the uninterrupted run's, bit for bit; only epoch 1 ran after the
    resume."""
    _, (trainer, module, dm, _), _ = fitted
    first, m1, dm1 = _port_parts(setup, "resume_a", max_epochs=1)
    first.fit(m1, dm1)
    again, m2, dm2 = _port_parts(setup, "resume_b")
    epochs = []
    again.callbacks.callbacks.append(type("E", (callbacks.BaseCallback,), {
        "on_epoch_start": lambda self, tr: epochs.append(tr.current_epoch)})())
    again.fit(m2, dm2, ckpt_path=first.ckpt_dir / "last.pt")
    assert epochs == [1] and again.current_step == trainer.current_step
    for k, v in module.model.state_dict().items():
        assert torch.equal(m2.model.state_dict()[k], v), k
    opt, opt2 = module.state.optimizer.state_dict(), m2.state.optimizer.state_dict()
    for i, st in opt["state"].items():
        for key, value in st.items():
            assert torch.equal(opt2["state"][i][key], value), (i, key)
    assert opt["param_groups"] == opt2["param_groups"]
    assert m2.state.step == module.state.step
    assert again.storage.to_dict() == trainer.storage.to_dict()
    assert m2.schedulers_state_dict() == module.schedulers_state_dict()
    assert dm2.train_dl.state_dict() == dm.train_dl.state_dict() == {"epoch": 1, "seed": 9}
    assert again.callbacks.state_dict()["SaveModelCheckpoint"] == \
        trainer.callbacks.state_dict()["SaveModelCheckpoint"]


def test_cli_trains_and_resumes(setup, tmp_path):
    """``python -m human_pose_tpu_torch.bin.train_keypoints`` with
    ``--trainer.accelerator=cpu``: one epoch to FINISHED with best.pt and
    last.pt and ``logs/device_0.log`` tagged CPU:0; then ``ckpt_path: auto``
    finds that last.pt and runs epoch 1 only, to step 4."""
    _, yaml_path, _, _ = setup
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")

    def run(*argv):
        res = subprocess.run([sys.executable, "-m", "human_pose_tpu_torch.bin.train_keypoints",
                              f"--config={yaml_path}", "--trainer.accelerator=cpu", *argv],
                             cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
        return res.stdout

    run("--trainer.max_epochs=1")
    first = sorted((tmp_path / "results" / "kp").glob("*/*/checkpoints/last.pt"))
    assert len(first) == 1 and (first[0].parent / "best.pt").exists()
    run_dir = first[0].parent.parent
    assert "[CPU:0]" in (run_dir / "logs" / "device_0.log").read_text()
    time.sleep(1.1)  # a new run directory (a timestamp a second)
    out = run("--setup.ckpt_path=auto", "--trainer.max_epochs=2")
    assert "resumed from" in out and "epoch 1:" in out and "epoch 0:" not in out
    lasts = sorted((tmp_path / "results" / "kp").glob("*/*/checkpoints/last.pt"),
                   key=lambda p: p.stat().st_mtime)
    assert len(lasts) == 2 and lasts[0].parent.parent.parent == lasts[1].parent.parent.parent
    ckpt = checkpoint.load_checkpoint(lasts[-1])
    assert (ckpt["epoch"], ckpt["step"]) == (1, 4)
    status = json.loads((lasts[-1].parent.parent / "tracker" / "run.json").read_text())["status"]
    assert status == "FINISHED"


def test_failure_mid_epoch_marks_failed_and_joins_write(setup, monkeypatch):
    """A step that raises in epoch 1, while epoch 0's last.pt is still being
    written (a slowed writer): fit re-raises, the tracker says FAILED, and
    the write is joined: last.pt holds epoch 0."""
    trainer, module, dm = _port_parts(setup, "failure")
    write = checkpoint._write

    def slow_write(*args, **kwargs):
        time.sleep(0.5)
        write(*args, **kwargs)

    monkeypatch.setattr(checkpoint, "_write", slow_write)
    step, calls = module.training_step, []

    def failing_step(batch):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("step failed")
        return step(batch)

    module.training_step = failing_step
    with pytest.raises(RuntimeError, match="step failed"):
        trainer.fit(module, dm)
    assert json.loads((trainer.log_path / "tracker" / "run.json").read_text())["status"] == "FAILED"
    assert trainer._ckpt_writer._future is None
    assert checkpoint.load_checkpoint(trainer.ckpt_dir / "last.pt")["epoch"] == 0


def test_orbax_backend_refuses_before_the_run(setup):
    """``trainer.ckpt_backend: orbax`` is the directory backend now (its
    runs: tests/test_torch_port_checkpoint_dir.py): the ``Trainer`` takes
    it. A backend the JAX package does not have refuses in
    ``create_trainer``, before the run writes anything, and in
    ``Trainer``."""
    _, yaml_path, _, _ = setup
    cfg = KeypointsConfig.from_dict(KeypointsConfig.from_yaml_to_dict(
        yaml_path, ["--trainer.ckpt_backend=npz"]))
    with pytest.raises(ValueError, match="ckpt_backend 'npz'"):
        cfg.create_trainer()
    assert not cfg.log_path.exists()
    with pytest.raises(ValueError, match="ckpt_backend 'npz'"):
        Trainer(None, [], ckpt_backend="npz")
    assert Trainer(None, [], ckpt_backend="orbax").ckpt_backend == "orbax"


def test_cli_refuses_missing_card_and_several_processes(setup, tmp_path, monkeypatch):
    """Without ``--trainer.accelerator=cpu`` the CLI needs a card and raises
    before it makes a run directory (also when torchrun launched it: NCCL
    on a card, never gloo). Several processes no longer refuse: with
    torchrun's environment the CLI joins a process group (gloo on the CPU;
    here a group of one), trains on its mesh to FINISHED and destroys the
    group at the end."""
    import socket

    import torch.distributed as dist

    from human_pose_tpu_torch.bin import train_keypoints

    _, yaml_path, _, _ = setup
    monkeypatch.chdir(tmp_path)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train_keypoints.main([f"--config={yaml_path}", "--trainer.accelerator=gpu"])
        assert not (tmp_path / "results").exists()
    for var, value in (("RANK", "0"), ("LOCAL_RANK", "0"), ("WORLD_SIZE", "1"),
                       ("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(port))):
        monkeypatch.setenv(var, value)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train_keypoints.main([f"--config={yaml_path}", "--trainer.accelerator=gpu"])
        assert not dist.is_initialized()
    meshes = []
    make_mesh = KeypointsConfig.make_mesh
    monkeypatch.setattr(KeypointsConfig, "make_mesh", lambda cfg: meshes.append(make_mesh(cfg)) or meshes[-1])
    tr = train_keypoints.main([f"--config={yaml_path}", "--trainer.max_epochs=1"])
    assert meshes[0].world_size == 1 and tr.module.state.mesh is meshes[0]
    assert json.loads((tr.log_path / "tracker" / "run.json").read_text())["status"] == "FINISHED"
    assert not dist.is_initialized()


def test_fit_profiles_steps_1_and_2(setup):
    """``Trainer.profiler`` with a window of steps [1, 3): one Chrome trace
    in the directory with the ``train_step_1`` and ``train_step_2`` ranges
    and no other step's; the run still ends FINISHED."""
    from human_pose_tpu_torch.utils.profiling import StepWindowProfiler

    trainer, module, dm = _port_parts(setup, "profiled")
    trainer.profiler = StepWindowProfiler(str(trainer.log_path / "trace"), start=1, steps=2)
    trainer.fit(module, dm)
    traces = list((trainer.log_path / "trace").glob("*.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())["traceEvents"]}
    assert {"train_step_1", "train_step_2"} <= names
    assert not {"train_step_0", "train_step_3"} & names
    assert json.loads((trainer.log_path / "tracker" / "run.json").read_text())["status"] == "FINISHED"
