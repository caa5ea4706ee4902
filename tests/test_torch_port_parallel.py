"""The port's data-parallel training against the JAX package's, on the CPU.

* ``LocalBatchNorm`` (``num_groups`` 1, 2 and 4) against JAX's: forward,
  the gradients of input, scale and bias, and the running statistics;
* ``convert_batch_norm``'s scopes, ``make_mesh``, ``bn_groups``, and
  ``setup_distributed`` without torchrun's environment;
* two gloo processes launched with torchrun's environment
  (``setup_distributed``, the config's ``make_mesh`` and ``create_module``)
  train the shallow C=8 HigherHRNet at 64x64 for two SGD steps, each on
  its half of a global batch of 4: with per-process BatchNorm against one
  process with ``LocalBatchNorm(num_groups=2)`` over the whole batch, and
  under ``sync_batchnorm`` against one process's plain BatchNorm over it.
  The first step's losses within rel 1e-5, the parameters after the two
  steps within 1e-5 a tensor, and both ranks' parameters and running
  statistics bit for bit equal; both ranks against the JAX package's
  ``KeypointsModule`` (``bn_groups`` 2, or 1 under ``sync_batchnorm``) and
  ``ClassificationModule`` (``bn_groups`` 2) on the global batch from the
  same initial weights, compiled while the processes train;
  ``AverageMeter.all_reduce`` over the two ranks; one process at world size
  1 through the same code bit for bit equal to the run without a process
  group;
* the config's loaders at ``process_count`` 2: each rank's stream equals
  the JAX package's loader's for that rank, and the two put together in
  rank order are the one-process stream of the global batch.

The processes get a free port from the OS and a hard timeout.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_pose_tpu.configs.keypoints import KeypointsConfig as JaxKeypointsConfig
from human_pose_tpu.models import ClassificationHRNet as JaxClassificationHRNet
from human_pose_tpu.models import HigherHRNet as JaxHigherHRNet
from human_pose_tpu.parallel.sync_bn import LocalBatchNorm as JaxLocalBatchNorm
from human_pose_tpu.train import TrainState as JaxTrainState
from human_pose_tpu.train import create_lr_scheduler as jax_create_lr_scheduler
from human_pose_tpu.train import create_optimizer as jax_create_optimizer
from human_pose_tpu.train.module import ClassificationModule as JaxClassificationModule
from human_pose_tpu.train.module import KeypointsModule as JaxKeypointsModule
from human_pose_tpu_torch.configs import ClassificationConfig, KeypointsConfig
from human_pose_tpu_torch.configs import base as config_base
from human_pose_tpu_torch.models import HigherHRNet
from human_pose_tpu_torch.models.norm import (
    BatchNorm2d, SyncBatchNorm2d, batch_norm, convert_batch_norm,
)
from human_pose_tpu_torch.parallel import (
    LocalBatchNorm, Mesh, local_batch_to_global, make_mesh, setup_distributed,
)
from human_pose_tpu_torch.train import ClassificationModule, KeypointsModule
from human_pose_tpu_torch.utils import weights
from tests.jax_reference import light_jax_reference  # noqa: F401  (module fixture)
from tests.test_torch_port_data import _assert_same, coco_root  # noqa: F401  (fixture)
from tests.test_torch_port_parallel_worker import (
    CLS_STEPS, CLS_TINY, STEPS, TINY as TINY_CFG, _train, classification_batch, dp_config,
    global_batch,
)

ROOT = Path(__file__).resolve().parent.parent
K = 17
TINY = {"C": 8, "num_blocks_per_stage": (1, 1, 1, 1), "num_units": 1, "num_deconv_resid_blocks": 1}
TIMEOUT_S = 150


# -- LocalBatchNorm against JAX's ---------------------------------------------------

@pytest.mark.parametrize("groups", [1, 2, 4])
def test_local_batch_norm_matches_jax(groups):
    """A batch of 8 (NCHW here, NHWC in JAX) through ``LocalBatchNorm`` in
    train mode from the same scale, bias and running statistics: the
    output, the gradients of ``sum(y * r)`` with respect to the input, the
    scale and the bias, and the running mean and variance after it, each
    within 1e-6 of its tensor's largest value: the two-pass moments through
    ``BatchNorm2d``'s kernels, more than one group side by side as
    channels."""
    rs = np.random.RandomState(groups)
    x = (rs.randn(8, 6, 5, 4) * 3 + 1).astype(np.float32)  # NHWC
    r = rs.randn(*x.shape).astype(np.float32)
    variables = {"params": {"scale": (1 + 0.2 * rs.randn(4)).astype(np.float32),
                            "bias": (0.1 * rs.randn(4)).astype(np.float32)},
                 "batch_stats": {"mean": (0.1 * rs.randn(4)).astype(np.float32),
                                 "var": (1 + rs.rand(4)).astype(np.float32)}}
    jbn = JaxLocalBatchNorm(num_groups=groups)

    def loss(params, x):
        y, upd = jbn.apply({**variables, "params": params}, x, True, mutable=["batch_stats"])
        return (y * r).sum(), (y, upd["batch_stats"])

    (_, (jy, jstats)), (jg_params, jg_x) = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(variables["params"], x)

    bn = LocalBatchNorm(4, num_groups=groups, eps=1e-5, momentum=0.1).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(variables["params"]["scale"]))
        bn.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        bn.running_mean.copy_(torch.from_numpy(variables["batch_stats"]["mean"]))
        bn.running_var.copy_(torch.from_numpy(variables["batch_stats"]["var"]))
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    y = bn(xt)
    (y * torch.from_numpy(r.transpose(0, 3, 1, 2).copy())).sum().backward()

    def close(got, want):
        want = np.asarray(want)
        assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()

    close(y.detach().numpy().transpose(0, 2, 3, 1), jy)
    close(xt.grad.numpy().transpose(0, 2, 3, 1), jg_x)
    close(bn.weight.grad.numpy(), jg_params["scale"])
    close(bn.bias.grad.numpy(), jg_params["bias"])
    close(bn.running_mean.numpy(), jstats["mean"])
    close(bn.running_var.numpy(), jstats["var"])
    assert y.dtype == torch.float32 and int(bn.num_batches_tracked) == 1


def test_local_batch_norm_bf16_and_eval():
    """A bfloat16 input gives a bfloat16 output computed in float32 and
    float32 parameter gradients; eval mode is ``nn.BatchNorm2d``'s; a batch
    that does not split into the groups raises."""
    bn = LocalBatchNorm(3, num_groups=2).train()
    x = torch.randn(4, 3, 5, 5, generator=torch.Generator().manual_seed(0))
    y = bn(x.to(torch.bfloat16))
    y.float().sum().backward()
    assert y.dtype == torch.bfloat16 and bn.weight.grad.dtype == torch.float32
    bn.eval()
    assert torch.equal(bn(x), torch.nn.functional.batch_norm(
        x, bn.running_mean, bn.running_var, bn.weight, bn.bias, False, 0.1, bn.eps))
    with pytest.raises(ValueError, match="not divisible"):
        bn.train()(x[:3])


# -- scopes, mesh, config ------------------------------------------------------------

def _tiny_net(bn_groups=1, world_size=1):
    return convert_batch_norm(HigherHRNet(num_kpts=K, **TINY, device="cpu"), bn_groups, world_size)


def test_convert_batch_norm_scopes(monkeypatch):
    """One process: 1 group keeps ``BatchNorm2d``, g groups give
    ``LocalBatchNorm(g)``; a mesh of W processes: 1 group gives
    ``SyncBatchNorm2d``, W groups ``LocalBatchNorm(1)`` (a process's own
    shard), 2W ``LocalBatchNorm(2)``, and a count that does not split
    raises. The state dict keeps its keys and values, and the parameters
    stay the same objects. The scope comes from the mesh alone: in a
    process group of 2 (torchrun's) with ``trainer.use_DDP: false`` the
    config has no mesh, one group and ``BatchNorm2d`` over each process's
    batch, as JAX's flax BatchNorm in each of two separate runs."""
    from human_pose_tpu_torch.utils import utils

    def kinds(net):
        return {type(m) for m in net.modules() if isinstance(m, BatchNorm2d)}

    assert type(batch_norm(8)) is BatchNorm2d
    net = _tiny_net()
    before = {k: v.clone() for k, v in net.state_dict().items()}
    weight = net.backbone.bn1.weight
    assert kinds(net) == {BatchNorm2d}
    assert kinds(_tiny_net(4)) == {LocalBatchNorm} and _tiny_net(4).backbone.bn1.num_groups == 4
    convert_batch_norm(net, 1, 2)
    assert kinds(net) == {SyncBatchNorm2d} and net.backbone.bn1.weight is weight
    assert all(torch.equal(v, before[k]) for k, v in net.state_dict().items())
    assert kinds(_tiny_net(2, 2)) == {LocalBatchNorm} and _tiny_net(2, 2).backbone.bn1.num_groups == 1
    assert kinds(_tiny_net(4, 2)) == {LocalBatchNorm} and _tiny_net(4, 2).backbone.bn1.num_groups == 2
    with pytest.raises(ValueError, match="does not split"):
        _tiny_net(3, 2)
    monkeypatch.setattr(utils, "process_count", lambda: 2)
    monkeypatch.setattr(config_base, "process_group_initialized", lambda: True)
    assert kinds(_tiny_net()) == {BatchNorm2d}
    alone = KeypointsConfig.from_dict({"trainer": {"accelerator": "cpu", "use_DDP": False},
                                       "net": {"params": TINY_CFG}})
    assert alone.make_mesh() is None and alone.bn_groups() == 1
    module = alone.create_module()
    assert kinds(module.model) == {BatchNorm2d} and module.state.mesh is None


def test_mesh_and_config_without_a_process_group(monkeypatch):
    """Without torchrun's environment ``setup_distributed`` does nothing and
    returns rank 0; ``make_mesh`` needs a process group; the config's
    ``make_mesh`` is None and ``bn_groups`` gives JAX's values: 1 with
    ``sync_batchnorm``, else a mesh's world size, else 1 (one process, or
    without ``use_DDP``). A process's batch stays its own, on
    the mesh's device."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert setup_distributed("cpu") == 0 and not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh()
    cfg = KeypointsConfig.from_dict({"trainer": {"accelerator": "cpu"}})
    assert cfg.make_mesh() is None and cfg.bn_groups() == 1
    mesh = Mesh(rank=1, world_size=4, device=torch.device("cpu"))
    assert cfg.bn_groups(mesh) == 4 and mesh.shape == {"data": 4}
    for trainer in ({"sync_batchnorm": True}, {"use_DDP": False}):
        both = {"trainer": {"accelerator": "cpu", **trainer}}
        assert KeypointsConfig.from_dict(both).bn_groups() == 1
        assert JaxKeypointsConfig.from_dict(both).bn_groups() == 1
    sync = {"trainer": {"accelerator": "cpu", "sync_batchnorm": True}}
    assert KeypointsConfig.from_dict(sync).bn_groups(mesh) == 1
    batch = {"images": torch.zeros(2, 3), "heatmaps": [torch.ones(2)], "n": 3}
    moved = local_batch_to_global(mesh, batch)
    assert moved["n"] == 3 and torch.equal(moved["heatmaps"][0], batch["heatmaps"][0])


def test_module_refuses_a_mesh_on_another_device():
    net = _tiny_net()
    with pytest.raises(ValueError, match="mesh's device"):
        KeypointsModule.create(net, mesh=Mesh(0, 1, torch.device("cuda", 0)))


# -- gloo processes ------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(world: int, tmp: Path) -> list:
    """``world`` processes of ``test_torch_port_parallel_worker.worker``
    (torch and the port only) with torchrun's variables."""
    port = _free_port()
    procs = []
    for rank in range(world):
        env = {**os.environ, "RANK": str(rank), "LOCAL_RANK": str(rank), "WORLD_SIZE": str(world),
               "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)}
        code = ("from tests.test_torch_port_parallel_worker import worker; "
                f"worker({str(tmp / f'w{world}_r{rank}.pt')!r})")
        procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """The two-process launch and the one-process (world size 1) launch,
    started together; whatever still runs after the module is killed."""
    tmp = tmp_path_factory.mktemp("dp")
    launches = {world: _launch(world, tmp) for world in (2, 1)}
    yield tmp, launches
    for procs in launches.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def dp_runs(launched):
    """The launches' results, {world: [rank 0's results, ...]}."""
    tmp, launches = launched
    out = {}
    for world, procs in launches.items():
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
        for p, log in zip(procs, logs):
            assert p.returncode == 0, log[-4000:]
        out[world] = [torch.load(tmp / f"w{world}_r{r}.pt", weights_only=False) for r in range(world)]
    return out


# -- against the JAX package's module on the global batch ---------------------------

def _nhwc(batch: dict) -> dict:
    """A global batch of the steps' NCHW layout as the JAX package's host
    batch: channel-last images and heatmaps, numpy."""
    def arr(key, t):
        t = t.numpy()
        return t.transpose(0, 2, 3, 1).copy() if key in ("images", "heatmaps") else t
    return {k: [arr(k, t) for t in v] if isinstance(v, list) else arr(k, v) for k, v in batch.items()}


def _jax_train(module_cls, model, init: dict, batch: dict, steps: int) -> dict:
    """JAX's ``module_cls`` on ``model`` from the port's initial state dict
    ``init`` (carried across by ``utils/weights.py``) with the run's SGD
    at a constant lr: ``steps`` training steps on the global batch; the
    metrics of each and the state after them in the port's names."""
    variables = jax.tree_util.tree_map(jnp.asarray, weights.variables_from_state_dict(init))
    opt = dict(dp_config(False)["module"]["optimizers"]["optim"]["params"])
    lr = opt.pop("lr")
    state = JaxTrainState.create(model.apply, variables["params"], variables["batch_stats"],
                                 jax_create_optimizer("SGD", lr=lr, **opt))
    module = module_cls(model, state, {"optim": jax_create_lr_scheduler(lr, "ConstantLR")})
    metrics = [{k: float(v) for k, v in module.training_step(batch).items()} for _ in range(steps)]
    after = jax.tree_util.tree_map(np.asarray, {"params": module.state.params,
                                                "batch_stats": module.state.batch_stats})
    return {"init": {k: v.numpy() for k, v in init.items()}, "metrics": metrics,
            "state": weights.variables_to_torch(after)}


@pytest.fixture(scope="module")
def jax_runs(launched):
    """The JAX package's modules on the global batch, compiled while the
    launched processes train: the keypoints module on the shallow C=8
    HigherHRNet with ``bn_groups`` 2 (per-device statistics, the
    processes' default) and 1 (``sync_batchnorm``), the classification
    module with ``bn_groups`` 2; each from the port's seeded init."""
    init = KeypointsConfig.from_dict(dp_config(False)).create_module().model.state_dict()
    batch = _nhwc(global_batch())
    out = {case: _jax_train(JaxKeypointsModule,
                            JaxHigherHRNet(num_kpts=K, s2d=False, bn_groups=groups, **TINY),
                            init, batch, STEPS)
           for case, groups in (("per_process_bn", 2), ("sync_bn", 1))}
    cls_init = ClassificationConfig.from_dict(dp_config(False, CLS_TINY)).create_module().model.state_dict()
    net = {k: tuple(v) if isinstance(v, list) else v for k, v in CLS_TINY.items()}
    out["classification"] = _jax_train(JaxClassificationModule, JaxClassificationHRNet(bn_groups=2, **net),
                                       cls_init, _nhwc(classification_batch()), CLS_STEPS)
    return out


# each parameter's update after the steps within this of JAX's (measured
# 1.6e-5, 1.6e-5 and 3.3e-3 on the worst tensor, a BatchNorm's bias or
# scale); the classifier's 4x4 head maps normalize 32 values a channel in
# a group of two images
UPDATE_RTOL = {"per_process_bn": 1e-4, "sync_bn": 1e-4, "classification": 1e-2}


@pytest.mark.parametrize("case", list(UPDATE_RTOL))
def test_two_processes_match_jax(jax_runs, dp_runs, case):
    """Both gloo ranks against the JAX package's module on the whole global
    batch from the same initial weights: per-process BatchNorm against
    ``bn_groups`` 2, ``sync_batchnorm`` against ``bn_groups`` 1, the
    classifier (one step) against ``bn_groups`` 2. Every metric of the
    first step within rel 1e-5 (measured 5.8e-6); each parameter's update
    within ``UPDATE_RTOL`` of JAX's, where a bias right before a train-mode
    BatchNorm (zero gradient in exact arithmetic) moves less than 1e-6 of
    the whole update on both sides; the running statistics within 1e-4 of
    each tensor's largest value (measured 1.4e-6; ``num_batches_tracked``
    counts the steps)."""
    ref = jax_runs[case]
    steps = CLS_STEPS if case == "classification" else STEPS
    updates = {k: v - ref["init"][k] for k, v in ref["state"].items() if ".running_" not in k}
    total = np.sqrt(sum(float(np.sum(u.astype(np.float64) ** 2)) for u in updates.values()))
    for run in dp_runs[2]:
        run = run["classification"] if case == "classification" else run[case == "sync_bn"]
        assert set(run["metrics"][0]) == set(ref["metrics"][0])
        for key, value in ref["metrics"][0].items():
            np.testing.assert_allclose(run["metrics"][0][key], value, rtol=1e-5, err_msg=key)
        assert set(run["state"]) == set(ref["state"]) | {k for k in run["state"]
                                                          if k.endswith("num_batches_tracked")}
        for key, got in run["state"].items():
            got = got.numpy()
            if key.endswith("num_batches_tracked"):
                assert int(got) == steps, key
            elif ".running_" in key:
                want = ref["state"][key]
                assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), key
            else:
                want, got = updates[key], got - ref["init"][key]
                scale = np.linalg.norm(want)
                if scale < 1e-6 * total:
                    assert np.linalg.norm(got) < 1e-6 * total, key
                else:
                    assert np.linalg.norm(got - want) <= UPDATE_RTOL[case] * scale, key


def _reference(bn_groups: int) -> dict:
    """One process, no process group: the same config's net with
    ``bn_groups`` over the whole global batch."""
    cfg = KeypointsConfig.from_dict(dp_config(False))
    module = KeypointsModule.create(cfg.create_net(bn_groups=bn_groups),
                                    optimizers_cfg=cfg.module.optimizers, seed=cfg.setup.seed)
    return _train(module, global_batch())


def _assert_matches_one_process(dp, ref, steps: int = STEPS):
    """Every metric of the first step within rel 1e-5 (both ranks report
    the global means), each parameter after ``steps`` steps within ||dp -
    one|| <= 1e-5 ||one|| + 1e-9 (a conv bias right before a train-mode
    BatchNorm has a zero gradient in exact arithmetic: the classifier's
    head moves its biases by ~1e-10 of rounding), the running statistics
    within 1e-5 of each tensor's largest value; the two ranks' state dicts
    bit for bit equal."""
    r0, r1 = dp
    assert r0["metrics"] == r1["metrics"]
    for key, value in ref["metrics"][0].items():
        np.testing.assert_allclose(r0["metrics"][0][key], value, rtol=1e-5, err_msg=key)
    assert set(r0["state"]) == set(ref["state"])
    for key, want in ref["state"].items():
        got = r0["state"][key]
        assert torch.equal(got, r1["state"][key]), key
        if key.endswith("num_batches_tracked"):
            assert int(got) == int(want) == steps
        elif ".running_" in key:
            assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max()), key
        else:
            assert float((got - want).norm()) <= 1e-5 * float(want.norm()) + 1e-9, key


@pytest.mark.parametrize("sync", [False, True], ids=["per_process_bn", "sync_bn"])
def test_two_processes_match_one_process(dp_runs, sync):
    """Per-process BatchNorm against ``LocalBatchNorm(num_groups=2)`` over
    the global batch in one process; ``sync_batchnorm`` against plain
    BatchNorm over it. Every metric of the first step within rel 1e-5 (both
    ranks report the global means), each parameter after two steps within
    ||dp - one|| / ||one|| <= 1e-5, the running statistics within 1e-5 of
    each tensor's largest value; the two ranks' state dicts bit for bit
    equal (``_assert_matches_one_process``)."""
    dp = [run[sync] for run in dp_runs[2]]
    assert dp_runs[2][0]["backend"] == "gloo"
    assert dp[0]["bn"] == (["SyncBatchNorm2d"] if sync else ["LocalBatchNorm"])
    ref = _reference(1 if sync else 2)
    assert ref["bn"] == (["BatchNorm2d"] if sync else ["LocalBatchNorm"])
    _assert_matches_one_process(dp, ref)


def test_two_processes_classification_match_one_process(dp_runs):
    """The classification module through the same mesh (the tiny C=8
    ClassificationHRNet at 128x128, per-process BatchNorm, one SGD step on
    each half of a global batch of 4) against one process with
    ``LocalBatchNorm(num_groups=2)`` over the global batch, as above. Both
    sides take JAX's two-pass variance: with flax's E[x^2] - E[x]^2 on the
    processes' side the stem's gradients parted by ~3e-4 at the head's 4x4
    maps (2e-6 with the two-pass one on both)."""
    cfg = ClassificationConfig.from_dict(dp_config(False, CLS_TINY))
    module = ClassificationModule.create(cfg.create_net(bn_groups=2),
                                         optimizers_cfg=cfg.module.optimizers, seed=cfg.setup.seed)
    ref = _train(module, classification_batch(), CLS_STEPS)
    assert set(ref["metrics"][0]) == {"loss", "top-1_error", "top-5_error"}
    _assert_matches_one_process([run["classification"] for run in dp_runs[2]], ref, CLS_STEPS)


def test_average_meter_all_reduce(dp_runs):
    """Rank 0 adds 1 over 1 sample, rank 1 adds 2 over 2: both hold sum 5,
    count 3, average 5/3."""
    assert [r["meter"] for r in dp_runs[2]] == [(5.0, 3, 5.0 / 3.0)] * 2


def test_world_size_one_equals_no_process_group(dp_runs):
    """One process launched with torchrun's environment (a gloo group of
    one, the mesh, every collective of the steps) trains bit for bit as the
    same config without a process group: the metrics and the state dict."""
    run = dp_runs[1][0]
    assert run["world"] == 1
    cfg = KeypointsConfig.from_dict(dp_config(False))
    assert cfg.make_mesh() is None
    ref = _train(cfg.create_module(), global_batch())
    assert run[False]["metrics"] == ref["metrics"]
    assert all(torch.equal(run[False]["state"][k], v) for k, v in ref["state"].items())


# -- the loaders at process_count 2 ------------------------------------------------

def _loader_config(root) -> dict:
    ds = {"root": str(root), "split": "train2017", "out_size": 128, "max_num_people": 5}
    return {"setup": {"seed": 4}, "trainer": {"accelerator": "cpu"},
            "dataloader": {"batch_size": 2, "num_workers": 2, "train_ds": ds, "val_ds": ds},
            "transform": {"out_size": 128}}


def _epoch(dl, epoch=1) -> list:
    dl.set_epoch(epoch)
    return list(dl)


def test_config_loaders_shard_as_jax(coco_root, monkeypatch):  # noqa: F811
    """``create_datamodule`` of the port's config and of JAX's at
    ``process_count`` 2, rank by rank: the train loader's epoch equals
    JAX's bit for bit, and the two ranks' batches put together in rank
    order are the one-process loader's batches of 4."""
    from human_pose_tpu.configs import keypoints as jax_keypoints
    from human_pose_tpu_torch.configs import keypoints as port_keypoints
    from human_pose_tpu_torch.utils import utils

    cfg = _loader_config(coco_root)
    streams = []
    for rank in (0, 1):
        monkeypatch.setattr(utils, "get_rank", lambda r=rank: r)
        monkeypatch.setattr(port_keypoints, "process_count", lambda: 2)
        monkeypatch.setattr(jax_keypoints, "get_rank", lambda r=rank: r)
        monkeypatch.setattr(jax, "process_count", lambda: 2)
        got = _epoch(KeypointsConfig.from_dict(cfg).create_datamodule().train_dl)
        want = _epoch(JaxKeypointsConfig.from_dict(cfg).create_datamodule().train_dl)
        assert len(got) == len(want) > 0
        _assert_same(got, want, f"rank {rank}")
        streams.append(got)
    monkeypatch.undo()
    one = KeypointsConfig.from_dict({**cfg, "dataloader": {**cfg["dataloader"], "batch_size": 4}})
    whole = _epoch(one.create_datamodule().train_dl)
    assert len(whole) == len(streams[0])
    for i, batch in enumerate(whole):
        for key in ("images", "joints"):
            np.testing.assert_array_equal(
                np.concatenate([streams[0][i][key], streams[1][i][key]]), batch[key])


# -- the training CLI under torch.distributed.run -------------------------------------

def test_training_cli_under_torchrun_two_gloo_processes(coco_root, tmp_path):  # noqa: F811
    """``python -m torch.distributed.run --nproc_per_node=2 -m
    human_pose_tpu_torch.bin.train_keypoints`` with ``trainer.accelerator:
    cpu``: two gloo processes train the shallow C=8 net for one epoch on
    their shards (batch 2 each), rank 0 writes the run (FINISHED, last.pt
    and best.pt after a barrier), and both exit 0. last.pt's step count is
    the global batches' (8 images in batches of 2 x 2: 2 steps), and its
    validation metrics are the global means the two ranks agreed on."""
    cfg = tmp_path / "train.yaml"
    cfg.write_text(f"""
setup: {{experiment_name: dp, architecture: HigherHRNet, seed: 9, pretrained_ckpt_path: null}}
trainer: {{accelerator: cpu, use_DDP: true, max_epochs: 1}}
dataloader:
  batch_size: 2
  num_workers: 1
  train_ds: {{root: {coco_root}, split: train2017, out_size: 64, max_num_people: 5}}
  val_ds: {{root: {coco_root}, split: val2017, out_size: 64, max_num_people: 5}}
transform: {{out_size: 64}}
net:
  params: {{num_kpts: 17, C: 8, num_blocks_per_stage: [1, 1, 1, 1], num_units: 1,
           num_deconv_resid_blocks: 1}}
""")
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(filter(None, [str(ROOT), os.environ.get("PYTHONPATH")]))}
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node=2", "--nnodes=1",
         "--master_addr=127.0.0.1", f"--master_port={_free_port()}",
         "-m", "human_pose_tpu_torch.bin.train_keypoints", f"--config={cfg}"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-4000:]
    assert "initialized torch.distributed (gloo): process 1 / 2" in proc.stdout + proc.stderr
    runs = list(tmp_path.glob("results/dp/*/*/checkpoints/last.pt"))
    assert len(runs) == 1
    run = runs[0].parent.parent
    assert (run / "checkpoints" / "best.pt").is_file()
    assert '"FINISHED"' in (run / "tracker" / "run.json").read_text()
    last = torch.load(runs[0], weights_only=True)
    assert last["step"] == 2 and last["epoch"] == 0
    val = last["metrics"]["metrics"]["loss"]["val"]
    assert len(val) == 1 and np.isfinite(val[0]["value"])
