"""The port's directory checkpoint backend (``trainer.ckpt_backend: orbax``,
``train/checkpoint_orbax.py`` on ``torch.distributed.checkpoint``), its
reader of the JAX package's native trainer checkpoints
(``utils/flax_msgpack.py``) and the card-memory monitor, on the CPU:

* a ``Trainer`` with ``ckpt_backend: orbax`` writes ``last.pt/`` and
  ``best.pt/`` as directories in the JAX package's layout; one epoch and a
  resume from ``last.pt/`` to two equal the uninterrupted run bit for bit;
  a direct round trip of a stepped state, synchronous and with
  ``use_async`` (the snapshot is the state at the call, whatever the next
  step does);
* ``read_state_dict`` and ``load_params_partial`` on a port directory;
* a directory written by the JAX package's ``checkpoint_orbax`` (orbax
  here) is refused with its message, naming the npz exporter;
* two gloo processes save into one directory and each loads it back equal
  to the state; one process reads it too;
* the JAX package's ``train/checkpoint.py::save_checkpoint`` output read by
  the port gives the tensors ``load_flax_npz`` gives of the JAX package's
  ``export_weights_npz``; the port's msgpack decoder against msgpack's on
  every type; a pickle naming a ``jax`` class is refused without importing
  it;
* ``GpuInfoMonitor`` refuses without a card.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from human_pose_tpu.models import HigherHRNet as JaxHigherHRNet
from human_pose_tpu.train import TrainState as JaxTrainState
from human_pose_tpu.train import checkpoint as jax_checkpoint
from human_pose_tpu.train import checkpoint_orbax as jax_checkpoint_orbax
from human_pose_tpu.utils.export import export_weights_npz as jax_export_weights_npz
from human_pose_tpu_torch.inference import load_inference_weights
from human_pose_tpu_torch.loggers import GpuInfoMonitor, loggers
from human_pose_tpu_torch.models import HigherHRNet
from human_pose_tpu_torch.train import KeypointsModule, Trainer, callbacks, checkpoint, checkpoint_orbax
from human_pose_tpu_torch.utils import flax_msgpack, weights
from tests.test_torch_port_checkpoint_dir_worker import SHALLOW, fresh_state, stepped_state
from tests.test_torch_port_data import make_coco_split
from tests.test_torch_port_models import _randomize

ROOT = Path(__file__).resolve().parent.parent
K, S, BS, LR = 17, 64, 4, 1e-3
OPTIMS = {"optim": {"name": "Adam", "params": {"lr": LR}}}
SCHEDULERS = {"optim": {"name": "MultiStepLR", "interval": "epoch",
                        "params": {"milestones": [1], "gamma": 0.5}}}
TIMEOUT_S = 120


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _assert_states_equal(a, b):
    for k, v in a.model.state_dict().items():
        assert torch.equal(b.model.state_dict()[k], v), k
    oa, ob = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert oa["param_groups"] == ob["param_groups"] and oa["state"].keys() == ob["state"].keys()
    for i, entries in oa["state"].items():
        for key, value in entries.items():
            assert torch.equal(ob["state"][i][key], value), (i, key)
    assert a.step == b.step


# -- the trainer ------------------------------------------------------------------------

@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco_ckpt_dir")
    make_coco_split(root, "train2017", 8, 0)
    make_coco_split(root, "val2017", 4, 1)
    return root


def _parts(coco_root, run: Path, max_epochs: int, init: dict):
    from human_pose_tpu_torch.configs import KeypointsConfig

    cfg = KeypointsConfig.from_dict({
        "setup": {"seed": 9}, "trainer": {"accelerator": "cpu", "use_DDP": False},
        "dataloader": {"batch_size": BS, "num_workers": 2,
                       "train_ds": {"root": str(coco_root), "split": "train2017", "out_size": S,
                                    "max_num_people": 5},
                       "val_ds": {"root": str(coco_root), "split": "val2017", "out_size": S,
                                  "max_num_people": 5}},
        "transform": {"out_size": S}})
    module = KeypointsModule.create(HigherHRNet(num_kpts=K, C=8, device="cpu", **SHALLOW),
                                    OPTIMS, SCHEDULERS, seed=3)
    module.model.load_state_dict(init)
    quiet = [callbacks.SystemMetricsMonitoringCallback(3600.0)
             if type(cb).__name__ == "SystemMetricsMonitoringCallback" else cb
             for cb in callbacks.default_callbacks()]
    logger = loggers.Loggers([loggers.TerminalLogger(run), loggers.FileTrackerLogger(run)], run)
    trainer = Trainer(logger, quiet, max_epochs=max_epochs, log_path=run, ckpt_backend="orbax")
    return trainer, module, cfg.create_datamodule()


@pytest.fixture(scope="module")
def runs(coco_root, tmp_path_factory):
    """Two epochs in one run; one epoch, then a resume from its last.pt/."""
    base = tmp_path_factory.mktemp("ckpt_dir_runs")
    torch.manual_seed(0)
    init = HigherHRNet(num_kpts=K, C=8, device="cpu", **SHALLOW).state_dict()
    full = _parts(coco_root, base / "full", 2, init)
    full[0].fit(full[1], full[2])
    first = _parts(coco_root, base / "first", 1, init)
    first[0].fit(first[1], first[2])
    again = _parts(coco_root, base / "again", 2, init)
    epochs = []
    again[0].callbacks.callbacks.append(type("E", (callbacks.BaseCallback,), {
        "on_epoch_start": lambda self, tr: epochs.append(tr.current_epoch)})())
    again[0].fit(again[1], again[2], ckpt_path=first[0].ckpt_dir / "last.pt")
    return full, first, again, epochs


def test_trainer_orbax_resume_equals_uninterrupted(runs):
    """The directories, their layout and host state; the resumed run's
    parameters, BatchNorm statistics, Adam state, step, storage,
    schedulers and loader equal the uninterrupted run's bit for bit; only
    epoch 1 ran after the resume."""
    (trainer, module, dm), (first, _, _), (again, m2, dm2), epochs = runs
    for name in ("last.pt", "best.pt"):
        d = first.ckpt_dir / name
        assert checkpoint_orbax.is_port_directory(d), d
        assert sorted(p.name for p in d.iterdir()) == ["host_state.pkl", "state"]
        assert sorted(p.name for p in (d / "state").iterdir()) == [".metadata", "__0_0.distcp"]
    host = checkpoint_orbax.load_checkpoint(first.ckpt_dir / "last.pt")
    assert host["backend"] == "orbax" and host["epoch"] == 0 and host["step"] == 2
    assert epochs == [1] and again.current_step == trainer.current_step == 4
    _assert_states_equal(module.state, m2.state)
    assert again.storage.to_dict() == trainer.storage.to_dict()
    assert m2.schedulers_state_dict() == module.schedulers_state_dict()
    assert dm2.train_dl.state_dict() == dm.train_dl.state_dict() == {"epoch": 1, "seed": 9}


def test_round_trip_sync_and_async(tmp_path):
    """A stepped state through ``save_checkpoint`` and back, synchronous and
    with ``use_async``: the async call returns a future after its snapshot,
    and a step taken before the write is waited for does not reach the
    directory."""
    state = stepped_state()
    checkpoint_orbax.save_checkpoint(tmp_path / "sync", state, epoch=1)
    want = {k: v.clone() for k, v in state.model.state_dict().items()}
    fut = checkpoint_orbax.save_checkpoint(tmp_path / "async", state, epoch=1, use_async=True)
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)  # the next step, while the writer may still run
    fut.result(timeout=60)
    for name in ("sync", "async"):
        loaded = fresh_state()
        checkpoint_orbax.load_train_state(loaded, checkpoint_orbax.load_checkpoint(tmp_path / name))
        for k, v in want.items():
            assert torch.equal(loaded.model.state_dict()[k], v), (name, k)
        assert loaded.step == 2 and loaded.optimizer.state_dict()["state"]


def test_read_state_dict_and_partial_load(tmp_path):
    """``read_state_dict`` of a directory is its model's state dict (and so
    the inference model's weights); ``load_params_partial`` takes the
    parameters of the matching names and shapes from it."""
    state = stepped_state()
    checkpoint_orbax.save_checkpoint(tmp_path / "ckpt", state, epoch=0)
    sd = weights.read_state_dict(tmp_path / "ckpt")
    want = state.model.state_dict()
    assert sd.keys() == want.keys() and all(torch.equal(sd[k], v) for k, v in want.items())
    assert load_inference_weights(tmp_path / "ckpt").keys() == want.keys()
    target = HigherHRNet(num_kpts=12, C=8, device="cpu", **SHALLOW)  # other heads' shapes
    n = checkpoint_orbax.load_params_partial(target, tmp_path / "ckpt")
    params = dict(target.named_parameters())
    matched = [k for k, p in params.items() if k in want and want[k].shape == p.shape]
    assert n == len(matched) == checkpoint.load_params_partial(target, tmp_path / "ckpt")
    assert 0 < n < len(params) and all(torch.equal(params[k], want[k]) for k in matched)


def test_refuses_orbax_written_directory(tmp_path):
    """The JAX package's ``checkpoint_orbax.save_checkpoint`` (orbax and
    tensorstore) writes ``host_state.pkl`` beside OCDBT arrays: the port
    recognizes a checkpoint directory and refuses it, naming the
    exporter."""
    params = {"dense": {"kernel": np.ones((3, 2), np.float32)}}
    tx = optax.adam(1e-3)
    state = JaxTrainState.create(lambda *a, **k: None, params, {}, tx)
    jax_checkpoint_orbax.save_checkpoint(tmp_path / "jax", state, epoch=0)
    assert jax_checkpoint_orbax.is_orbax_checkpoint(tmp_path / "jax")
    assert checkpoint_orbax.is_orbax_checkpoint(tmp_path / "jax")
    assert not checkpoint_orbax.is_port_directory(tmp_path / "jax")
    target = HigherHRNet(num_kpts=K, C=8, device="cpu", **SHALLOW)
    for read in (weights.read_state_dict, checkpoint_orbax.load_checkpoint,
                 lambda p: checkpoint.load_params_partial(target, p)):
        with pytest.raises(ValueError, match="orbax checkpoint directory written by the JAX "
                                             "package.*export_weights_npz"):
            read(tmp_path / "jax")
    (tmp_path / "plain").mkdir()
    with pytest.raises(ValueError, match="not a checkpoint"):
        weights.read_state_dict(tmp_path / "plain")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_gloo_processes_one_directory(tmp_path):
    """Two gloo processes save the same state into one directory (each
    writes its part of the arrays, rank 0 the host state) and each loads
    it back equal to the state; this process reads it alone too."""
    port, ckpt = _free_port(), tmp_path / "shared"
    env = {**os.environ, "OMP_NUM_THREADS": "1", "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
           "MASTER_PORT": str(port)}
    code = "from tests.test_torch_port_checkpoint_dir_worker import worker; worker({!r}, {!r})"
    procs = [subprocess.Popen([sys.executable, "-c", code.format(str(ckpt), str(tmp_path / f"r{r}.pt"))],
                              cwd=ROOT, env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    assert sorted(p.name for p in (ckpt / "state").iterdir()) == [".metadata", "__0_0.distcp",
                                                                   "__1_0.distcp"]
    want = stepped_state()
    for r in range(2):
        got = torch.load(tmp_path / f"r{r}.pt", weights_only=True)
        assert got["epoch"] == 4 and got["metrics"] == {"rank": 0} and got["step"] == 2
        loaded = fresh_state()
        loaded.model.load_state_dict(got["model"])
        loaded.optimizer.load_state_dict(got["optim"])
        loaded.step = got["step"]
        _assert_states_equal(want, loaded)
    alone = fresh_state()
    checkpoint_orbax.load_train_state(alone, checkpoint_orbax.load_checkpoint(ckpt))
    _assert_states_equal(want, alone)


# -- the JAX package's native trainer checkpoint ----------------------------------------

def test_reads_jax_trainer_checkpoint_as_its_npz(tmp_path):
    """The JAX package's ``save_checkpoint`` of a state of the shallow net
    (random parameters and BatchNorm statistics, Adam's state, host states
    with NumPy values): ``read_state_dict`` of it equals ``load_flax_npz``
    of the JAX package's ``export_weights_npz`` of the same variables,
    tensor for tensor; so does the inference model's loader."""
    model = JaxHigherHRNet(num_kpts=K, C=8, s2d=False, **SHALLOW)
    template = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                                                 train=False))
    template = jax.tree_util.tree_map(lambda t: np.zeros(t.shape, t.dtype), dict(template))
    v = {col: _randomize(tree, np.random.RandomState(2)) for col, tree in template.items()}
    state = JaxTrainState.create(model.apply, v["params"], v["batch_stats"], optax.adam(1e-3))
    path = tmp_path / "jax_last.pt"
    jax_checkpoint.save_checkpoint(
        path, state, epoch=3, datamodule_state={"epoch": 3, "seed": np.int64(9)},
        metrics_state={"loss": [np.float32(0.5), 0.25]}, logger_state={"run_id": "abc"})
    jax_export_weights_npz(v, tmp_path / "jax.npz")
    want = weights.load_flax_npz(tmp_path / "jax.npz")
    got = weights.read_state_dict(path)
    assert got.keys() == want.keys()
    for k, value in want.items():
        assert got[k].dtype == torch.float32 and np.array_equal(got[k].numpy(), value), k
    net = HigherHRNet(num_kpts=K, C=8, device="cpu", **SHALLOW)
    net.load_state_dict(load_inference_weights(path), strict=True)
    assert checkpoint.load_params_partial(net, path) == len(list(net.parameters()))


def test_msgpack_decoder_matches_msgpack():
    """Every msgpack type the format has, at the edges of its sizes,
    decodes as msgpack decodes it; flax's ndarray, scalar and complex
    extensions (bfloat16 as float32) and chunked arrays as
    ``flax.serialization.msgpack_restore``; trailing bytes raise."""
    objs = [None, True, False, 0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 64 - 1, -1, -32,
            -33, -128, -129, -2 ** 15 - 1, -2 ** 31 - 1, -2 ** 63, 1.5, -0.0, float("inf"), "",
            "a" * 31, "b" * 32, "c" * 300, "é" * 40000, b"", b"x" * 300, b"y" * 70000, [1] * 15,
            [2] * 16, [3] * 70000, {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
            {"n": {"m": [1, {"k": b"v"}], "f": 2.5}}]
    for o in objs:
        assert flax_msgpack.unpackb(msgpack.packb(o, use_bin_type=True)) == o, str(o)[:40]
    assert flax_msgpack.unpackb(msgpack.packb(np.float32(0.1).item(), use_single_float=True)) == \
        float(np.float32(0.1))
    for code, size in ((7, 1), (7, 2), (7, 4), (7, 8), (7, 16), (7, 3), (7, 300), (7, 70000)):
        packed = msgpack.packb(msgpack.ExtType(code, b"z" * size))
        with pytest.raises(ValueError, match="extension type 7"):
            flax_msgpack.unpackb(packed)
    rs = np.random.RandomState(0)
    tree = {"a": rs.randn(3, 4).astype(np.float32), "b": {
        "c": np.arange(5, dtype=np.int32), "s": np.float32(2.5), "z": 1 + 2j,
        "bf": jnp.asarray(rs.randn(4), jnp.bfloat16), "e": np.zeros((0, 3), np.float64)}}
    blob = serialization.to_bytes(tree)
    got, want = flax_msgpack.msgpack_restore(blob), serialization.msgpack_restore(blob)
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_got] == [p for p, _ in flat_want]
    for (_, g), (_, w) in zip(flat_got, flat_want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape and np.array_equal(g.astype(np.complex128), w.astype(np.complex128))
    assert np.asarray(got["b"]["bf"]).dtype == np.float32
    chunked = {"big": {"__msgpack_chunked_array__": True, "shape": {"0": 2, "1": 3},
                       "chunks": {"0": np.arange(4.0), "1": np.arange(4.0, 6.0)}}}
    restored = flax_msgpack.msgpack_restore(serialization.msgpack_serialize(chunked))
    assert np.array_equal(restored["big"], np.arange(6.0).reshape(2, 3))
    with pytest.raises(ValueError, match="after the object"):
        flax_msgpack.unpackb(msgpack.packb(1) + b"\x00")


def test_pickle_naming_jax_is_refused_unimported(tmp_path):
    """A pickle that names a class of ``jax`` (or ``flax``) is refused with
    the class's name, and the module is never imported (checked in a
    process where importing it fails); other classes are refused too;
    NumPy arrays and builtins pass."""
    bad = tmp_path / "jax.ckpt"
    with open(bad, "wb") as f:
        pickle.dump({"module": jnp.float32}, f)  # names jax.numpy.float32
    code = ("import sys; sys.modules['jax'] = None; sys.modules['flax'] = None\n"
            "from human_pose_tpu_torch.utils.weights import read_state_dict\n"
            "try:\n"
            f"    read_state_dict({str(bad)!r})\n"
            "except ValueError as e:\n"
            "    print('refused:', e)\n"
            "print('jax imported' if sys.modules.get('jax') is not None else 'jax not imported')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "refused:" in res.stdout and "a class of jax" in res.stdout, res.stdout
    assert "jax not imported" in res.stdout
    other = tmp_path / "os.ckpt"
    with open(other, "wb") as f:
        pickle.dump({"module": os.getcwd}, f)
    with pytest.raises(ValueError, match="posix.getcwd, which this reader does not admit"):
        weights.read_state_dict(other)
    plain = tmp_path / "plain.pkl"
    value = {"a": [np.arange(3), np.float32(2), (1, "x")], "r": np.random.RandomState(0).get_state()}
    with open(plain, "wb") as f:
        pickle.dump(value, f)
    got = flax_msgpack.load_pickle(plain)
    assert np.array_equal(got["a"][0], np.arange(3)) and got["a"][1:] == value["a"][1:]
    with pytest.raises(ValueError, match="not a JAX trainer checkpoint"):
        weights.read_state_dict(plain)


def test_gpu_monitor_refuses_without_card(tmp_path):
    """The card-memory monitor raises at construction where there is no
    card; it writes nothing."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs a CUDA-less host")
    with pytest.raises(RuntimeError, match="is_available"):
        GpuInfoMonitor(str(tmp_path / "gpu.log"), interval_s=0.01)
    assert not (tmp_path / "gpu.log").exists()
