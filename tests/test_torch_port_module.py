"""The port's ``KeypointsModule`` and the keypoints config's training
factories against the JAX package, on the CPU.

* ``KeypointsModule.create`` from yaml-shaped dicts against JAX's: the
  optimizer, the schedulers, ``lr`` over steps and epochs (step and epoch
  intervals), the init;
* ``training_step`` and ``validation_step`` of the shallow C=8 HigherHRNet
  (tests/test_torch_port_models.py's ``SHALLOW``) at 64x64 on one loader
  batch of a synthesized COCO directory, against JAX's module with the same
  parameters carried across (``variables_to_torch``), with the
  tolerances of tests/test_torch_port_train.py; ``make_results`` against JAX's at the level of decisions;
* ``create_datamodule`` / ``create_module`` from a yaml over the directory
  with ``trainer.accelerator: cpu``; ``bn_groups``; the refusals.

JAX compiles one train step and one val step (a module fixture); the port
runs on one torch intra-op thread.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_pose_tpu.configs import KeypointsConfig as JaxKeypointsConfig
from human_pose_tpu.models import HigherHRNet as JaxHigherHRNet
from human_pose_tpu.train import TrainState as JaxTrainState
from human_pose_tpu.train import create_lr_scheduler as jax_create_lr_scheduler
from human_pose_tpu.train import create_optimizer as jax_create_optimizer
from human_pose_tpu.train.module import KeypointsModule as JaxKeypointsModule
from human_pose_tpu_torch.configs import KeypointsConfig
from human_pose_tpu_torch.data import DataLoader, collate
from human_pose_tpu_torch.models import HigherHRNet
from human_pose_tpu_torch.train import (
    ClassificationModule, DataModule, DeviceBatch, KeypointsModule, Trainer, host_batch_to_device,
    metrics_to_host,
)
from human_pose_tpu_torch.utils import weights
from tests.test_torch_port_data import _assert_same, _datasets, make_coco_split
from tests.test_torch_port_models import SHALLOW, _randomize

K, S, BS, LR = 17, 64, 2, 1e-3
OPTIMS = {"optim": {"name": "Adam", "params": {"lr": LR, "betas": [0.9, 0.99]}}}
SCHEDULERS = {
    "step": {"optim": {"name": "MultiStepLR", "interval": "step",
                       "params": {"milestones": [2, 3], "gamma": 0.5}}},
    "epoch": {"optim": {"name": "ExponentialLR", "interval": "epoch", "params": {"gamma": 0.9}}},
    "none": {},
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's many small CPU ops while this
    module runs: the suite runs several workers on a few cores, where
    torch's default thread pool spins against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco_module")
    make_coco_split(root, "train2017", 4, 0)
    make_coco_split(root, "val2017", 2, 1)
    return root


@pytest.fixture(scope="module")
def setup(coco_root):
    """JAX's shallow net and module with seeded random parameters and BN
    statistics (its ``create`` would run flax's init op by op, ~40 s here),
    the yaml's Adam and step scheduler; the port's module from ``create``
    with the same weights loaded; one host batch of each split at 64x64."""
    model = JaxHigherHRNet(num_kpts=K, C=8, s2d=False, **SHALLOW)
    template = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), np.zeros((1, S, S, 3), np.float32), train=False))
    template = jax.tree_util.tree_map(lambda t: np.zeros(t.shape, t.dtype), dict(template))
    rs = np.random.RandomState(0)
    variables = {col: _randomize(tree, rs) for col, tree in template.items()}
    v = jax.tree_util.tree_map(jnp.asarray, variables)
    sched = SCHEDULERS["step"]["optim"]
    jax_module = JaxKeypointsModule(
        model, JaxTrainState.create(model.apply, v["params"], v["batch_stats"],
                                    jax_create_optimizer("Adam", lr=LR, betas=(0.9, 0.99))),
        {"optim": jax_create_lr_scheduler(LR, sched["name"], sched["interval"], **sched["params"])})
    module = KeypointsModule.create(HigherHRNet(num_kpts=K, C=8, device="cpu", **SHALLOW),
                                    OPTIMS, SCHEDULERS["step"], seed=3)
    module.model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                                  weights.variables_to_torch(variables).items()}, strict=True)
    batches = {}
    for split in ("train2017", "val2017"):
        ds, _ = _datasets(coco_root, split, train=split == "train2017", out_size=S)
        batches[split] = next(iter(DataLoader(ds, batch_size=BS, collate_fn=collate, shuffle=False)))
    return jax_module, module, variables, batches


@pytest.fixture(scope="module")
def stepped(setup):
    """One training step, then one val step, in both packages (JAX's
    compiled once each), each from its own copy of the host batches."""
    jax_module, module, _, batches = setup
    jax_metrics = jax_module.training_step(batches["train2017"])
    jax_val, jax_out = jax_module.validation_step(batches["val2017"])
    metrics = module.training_step(batches["train2017"])
    trained = {k: v.clone() for k, v in module.model.state_dict().items()}
    # the val step from JAX's weights and statistics after its step: the two
    # steps' weights differ by Adam's sign-ambiguous elements (up to 2 * lr)
    module.model.load_state_dict({
        k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in weights.variables_to_torch(
            jax.tree_util.tree_map(np.asarray, jax_module.state.variables())).items()}, strict=False)
    val, out = module.validation_step(batches["val2017"])
    return (metrics_to_host(metrics), trained, metrics_to_host(val), out,
            {k: float(v) for k, v in jax_metrics.items()}, {k: float(v) for k, v in jax_val.items()},
            jax.tree_util.tree_map(np.asarray, jax_out))


# -- create ----------------------------------------------------------------------

@pytest.mark.parametrize("case", list(SCHEDULERS))
def test_create_matches_jax_schedulers(case):
    """``create`` from the yaml's dicts: Adam with the yaml's betas (a list
    in yaml, a tuple here), the first scheduler's ``lr`` stepping with
    ``on_step_end`` for "step" intervals and ``on_epoch_end`` for "epoch"
    ones, ConstantLR without a scheduler: the lr sequence of JAX's
    schedulers over 4 steps and 2 epochs; the keypoints init draws conv
    weights from N(0, 0.001) with zero biases, the same for one seed."""
    net = HigherHRNet(num_kpts=K, C=8, device="cpu", **SHALLOW)
    module = KeypointsModule.create(net, OPTIMS, SCHEDULERS[case], seed=5)
    opt = module.state.optimizer
    assert isinstance(opt, torch.optim.Adam) and opt.param_groups[0]["betas"] == (0.9, 0.99)
    assert module.state.dtype == torch.float32 and module.state.device == torch.device("cpu")
    cfg = SCHEDULERS[case].get("optim", {"name": "ConstantLR"})
    ref = jax_create_lr_scheduler(LR, cfg["name"], cfg.get("interval", "epoch"), **cfg.get("params", {}))
    seen, want = [], []
    for _ in range(2):
        for _ in range(4):
            seen.append(module.lr)
            want.append(ref.lr)
            module.on_step_end()
            if ref.interval == "step":
                ref.step()
        module.on_epoch_end({"loss": 1.0})
        if ref.interval == "epoch":
            ref.step(1.0)
    assert seen == want and len(set(seen)) == {"none": 1, "epoch": 2, "step": 3}[case]
    assert module.schedulers_state_dict() == {"optim": ref.state_dict()}
    again = KeypointsModule.create(HigherHRNet(num_kpts=K, C=8, device="cpu", **SHALLOW), seed=5)
    assert all(torch.equal(a, b) for a, b in zip(again.model.parameters(), net.parameters()))
    w = torch.cat([m.weight.detach().flatten() for m in net.modules() if isinstance(m, torch.nn.Conv2d)])
    assert abs(float(w.std()) - 1e-3) < 5e-5
    assert all(float(m.bias.detach().abs().max()) == 0 for m in net.modules()
               if isinstance(m, torch.nn.Conv2d) and m.bias is not None)


def test_module_refusals():
    """A mesh whose device is not the model's raises (data parallelism is
    tests/test_torch_port_parallel.py's); an unknown checkpoint backend
    refuses (the directory backend "orbax" is ported,
    tests/test_torch_port_checkpoint_dir.py)."""
    from human_pose_tpu_torch.parallel import Mesh

    net = HigherHRNet(num_kpts=K, C=8, device="cpu", **SHALLOW)
    mesh = Mesh(rank=0, world_size=1, device=torch.device("cuda", 0))
    with pytest.raises(ValueError, match="mesh's device"):
        KeypointsModule.create(net, mesh=mesh)
    with pytest.raises(ValueError, match="mesh's device"):
        ClassificationModule.create(net, mesh=mesh)
    with pytest.raises(ValueError, match="ckpt_backend 'npz'"):
        Trainer(None, [], ckpt_backend="npz")
    assert Trainer(None, [], ckpt_backend="orbax").ckpt_backend == "orbax"


# -- the steps against JAX's module ------------------------------------------------

def test_training_step_matches_jax(setup, stepped):
    """The loss terms of one step on a loader batch within rel 1e-5; the BN
    running statistics after it within 1e-4 of each tensor's largest value;
    the parameters after Adam within 1e-6 where JAX moved them by (almost)
    lr, and within 2 * lr elsewhere (tests/test_torch_port_train.py)."""
    jax_module, module, variables, _ = setup
    metrics, trained, _, _, jax_metrics, _, _ = stepped
    assert set(metrics) == set(jax_metrics) == {"hm_0", "hm_1", "push", "pull", "loss"}
    for key, value in jax_metrics.items():
        np.testing.assert_allclose(metrics[key], value, rtol=1e-5, err_msg=key)
    assert module.state.step == 1 and module.lr == LR  # milestones 2, 3: not yet
    sd = {k: v.numpy() for k, v in trained.items()}
    after = weights.variables_to_torch(jax.tree_util.tree_map(np.asarray, {
        "params": jax_module.state.params, "batch_stats": jax_module.state.batch_stats}))
    before = weights.variables_to_torch(variables)
    for key, want in after.items():
        if ".running_" in key:
            assert np.abs(sd[key] - want).max() <= 1e-4 * np.abs(want).max(), key
        else:
            diff = np.abs(sd[key] - want)
            sure = np.abs(want - before[key]) >= 0.999 * LR
            assert diff[sure].max(initial=0.0) <= 1e-6, key
            assert diff.max() <= 2 * LR + 1e-6, key


def test_validation_step_matches_jax(stepped):
    """The val step from JAX's weights and BN statistics after its train
    step (eval BatchNorm with the moved statistics) on a val loader batch:
    metrics within rel 1e-5 of JAX's; outputs NCHW float32, JAX's
    channel-last ones within 1e-4 of their scale."""
    _, _, val, out, _, jax_val, jax_out = stepped
    for key, value in jax_val.items():
        np.testing.assert_allclose(val[key], value, rtol=1e-5, err_msg=key)
    (hm_q, hm_h), tags = out
    (jq, jh), jt = jax_out
    assert hm_q.shape == (BS, K, S // 4, S // 4) and hm_h.shape == (BS, K, S // 2, S // 2)
    assert tags.shape == (BS, K, S // 4, S // 4) and tags.dtype == torch.float32
    for got, want in ((hm_q, jq), (hm_h, jh), (tags, jt)):
        want = want.transpose(0, 3, 1, 2)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()


def _person_outputs(batch: dict):
    """Outputs that decode into the batch's persons: the batch's target
    heatmaps as both stages plus seeded noise below 0.01 (the Gaussian
    targets alone tie neighbouring pixels exactly, and a resize's ulps then
    break the ties either way), and a tag map of 3 * (person + 1) on a 3x3
    patch around each visible joint (channel-last, JAX's layout)."""
    rs = np.random.RandomState(2)
    heatmaps = [(h + 0.01 * rs.rand(*h.shape)).astype(np.float32) for h in batch["heatmaps"]]
    tags = np.zeros_like(heatmaps[0])
    n, h, w, _ = tags.shape
    for b in range(n):
        for p, person in enumerate(batch["joints"][b]):
            for k, (x, y, vis) in enumerate(person):
                if vis:
                    tags[b, max(0, y - 1): y + 2, max(0, x - 1): x + 2, k] = 3.0 * (p + 1)
    return heatmaps, tags


def test_make_results_matches_jax(setup):
    """``make_results`` of the port and of JAX on the same outputs (the val
    batch's own targets as heatmaps, a tag a person): the same number of
    results and of persons in each, the same joints (x, y within 1e-3,
    scores within 1e-4; a bilinear resize on each side), heatmaps and tags
    at input size within 1e-5, the input images equal. From a
    ``DeviceBatch`` the port gives the same results."""
    jax_module, module, _, batches = setup
    batch = batches["val2017"]
    heatmaps, tags = _person_outputs(batch)
    want = jax_module.make_results(batch, ([jnp.asarray(h) for h in heatmaps], jnp.asarray(tags)))
    port_out = ([torch.from_numpy(h.transpose(0, 3, 1, 2).copy()) for h in heatmaps],
                torch.from_numpy(tags.transpose(0, 3, 1, 2).copy()))
    got = module.make_results(batch, port_out)
    again = module.make_results(DeviceBatch(host_batch_to_device(batch, torch.device("cpu"))),
                                port_out)
    assert len(got) == len(want) == len(again) == BS
    persons = 0
    for g, a, w in zip(got, again, want):
        np.testing.assert_array_equal(g.model_input_image, np.asarray(w.model_input_image))
        np.testing.assert_array_equal(a.model_input_image, g.model_input_image)
        for field in ("kpts_heatmaps", "tags_heatmaps"):
            np.testing.assert_allclose(getattr(g, field), np.asarray(getattr(w, field)), atol=1e-5)
        assert g.kpts_coords.shape == np.asarray(w.kpts_coords).shape
        np.testing.assert_allclose(g.kpts_coords, np.asarray(w.kpts_coords), atol=1e-3)
        np.testing.assert_allclose(g.kpts_scores, np.asarray(w.kpts_scores), atol=1e-4)
        np.testing.assert_allclose(g.obj_scores, np.asarray(w.obj_scores), atol=1e-4)
        np.testing.assert_array_equal(a.kpts_coords, g.kpts_coords)
        assert g.det_thr == w.det_thr == 0.1
        persons += len(g.obj_scores)
    assert persons >= 2


# -- the config's factories ---------------------------------------------------------

def _yaml(tmp_path, root, extra: str = "") -> str:
    path = tmp_path / "train.yaml"
    path.write_text(f"""
setup: {{experiment_name: kp, architecture: HigherHRNet, seed: 9}}
trainer: {{accelerator: cpu, use_DDP: true, max_epochs: 1}}
dataloader:
  batch_size: 2
  num_workers: 2
  train_ds: {{root: {root}, split: train2017, out_size: {S}, max_num_people: 5}}
  val_ds: {{root: {root}, split: val2017, out_size: {S}, max_num_people: 5}}
transform: {{out_size: {S}}}
module:
  optimizers: {{optim: {{name: Adam, params: {{lr: 0.002}}}}}}
  lr_schedulers: {{optim: {{name: MultiStepLR, interval: epoch, params: {{milestones: [1], gamma: 0.1}}}}}}
net:
  params: {{num_kpts: 17, C: 8, num_blocks_per_stage: [1, 1, 1, 1], num_units: 1,
           num_deconv_resid_blocks: 1, s2d: false}}
{extra}""")
    return str(path)


@pytest.mark.parametrize("compact", [False, True])
def test_config_datamodule_matches_jax(tmp_path, coco_root, compact):
    """``create_datamodule`` from a yaml: the train loader shuffled, the val
    loader ordered without dropping, both batch streams equal to those of
    JAX's config from the same yaml, bit for bit."""
    path = _yaml(tmp_path, coco_root)
    argv = ["--dataloader.compact_batches=true"] if compact else []
    dm = KeypointsConfig.from_dict(KeypointsConfig.from_yaml_to_dict(path, argv)).create_datamodule()
    ref = JaxKeypointsConfig.from_dict(JaxKeypointsConfig.from_yaml_to_dict(path, argv)).create_datamodule()
    assert isinstance(dm, DataModule) and dm.train_ds is dm.train_dl.dataset
    assert dm.train_dl.shuffle and not dm.val_dl.shuffle and not dm.val_dl.drop_last
    assert (len(dm.train_dl), len(dm.val_dl)) == (len(ref.train_dl), len(ref.val_dl)) == (2, 1)
    for dl, rdl in ((dm.train_dl, ref.train_dl), (dm.val_dl, ref.val_dl)):
        _assert_same(list(dl), list(rdl))
    assert dm.state_dict() == ref.state_dict() == {"epoch": 0, "seed": 9}


def test_config_module_trains_on_the_cpu(tmp_path, coco_root):
    """``create_module`` from the yaml with ``accelerator: cpu``: float32
    on the CPU, the yaml's optimizer and scheduler, the keypoints init from
    ``setup.seed``; one training step on a datamodule batch gives finite
    losses; ``seed()`` seeds numpy per rank."""
    cfg = KeypointsConfig.from_dict(KeypointsConfig.from_yaml_to_dict(_yaml(tmp_path, coco_root), []))
    module = cfg.create_module()
    assert module.device == torch.device("cpu") and module.state.dtype == torch.float32
    assert module.lr == 0.002 and module.schedulers["optim"].interval == "epoch"
    assert module.pin_memory and module.accumulate_grad_batches == 1
    again = cfg.create_module()
    assert all(torch.equal(a, b) for a, b in zip(module.model.parameters(), again.model.parameters()))
    batch = next(iter(cfg.create_datamodule().train_dl))
    metrics = metrics_to_host(module.training_step(batch))
    assert all(np.isfinite(v) for v in metrics.values()) and module.state.step == 1
    module.on_epoch_end({"loss": metrics["loss"]})
    assert module.lr == pytest.approx(0.0002)
    cfg.seed()
    a = np.random.rand()
    cfg.seed()
    assert np.random.rand() == a


@pytest.mark.parametrize("trainer,cards,want", [
    ({"sync_batchnorm": True}, 4, 1),
    ({"use_DDP": False}, 4, 1),
    ({"use_DDP": True, "accelerator": "cpu"}, 4, 1),
    ({"use_DDP": True, "accelerator": "gpu"}, 1, 1),
    ({"use_DDP": True, "accelerator": "gpu"}, 0, 1),
    ({"use_DDP": True, "accelerator": "gpu"}, 4, 1),
])
def test_bn_groups(monkeypatch, trainer, cards, want):
    """One group wherever the JAX package's gives one on one device (with
    ``sync_batchnorm``, without data parallelism, or on one device). A
    process of the port trains on one card whatever the host has, so one
    process is one group with 4 cards too; more processes are
    tests/test_torch_port_parallel.py's."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    cfg = KeypointsConfig.from_dict({"trainer": trainer})
    assert cfg.bn_groups() == want
    if trainer.get("sync_batchnorm") or not trainer.get("use_DDP", True):
        assert JaxKeypointsConfig.from_dict({"trainer": trainer}).bn_groups() == want


def test_compact_config_refuses_custom_mean(tmp_path, coco_root):
    cfg = KeypointsConfig.from_dict(KeypointsConfig.from_yaml_to_dict(
        _yaml(tmp_path, coco_root), ["--dataloader.compact_batches=true", "--transform.mean=[0.5,0.5,0.5]"]))
    with pytest.raises(ValueError, match="compact_batches"):
        cfg.create_datamodule()
