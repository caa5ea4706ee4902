"""The AE hourglass's training against the JAX package's, on the CPU.

A one-stage ``AEHourglassNet`` at full width (K=17, 128x128 inputs, batch
2, uint8 images, crowd masks, joints off the map and a sample with one
person) gets seeded flax variables (kernels at std 1/sqrt(fan_in), BN
statistics near (0, 1)), carried to the port by the weights bridge. At
64x64 the hourglass's 1x1 bottom normalizes two values a channel, where
flax's E[x^2] - E[x]^2 cancels and the two frameworks' train forwards part
by 46%; at 128x128 they agree within 6e-5. JAX's
gradients (``steps._keypoints_grads``), its Adam update from them
(``steps._update``) and one ``accumulated_keypoints_train_step(2)`` are each
compiled once; the port's ``keypoints_train_step`` and
``accumulated_keypoints_train_step(2)`` are held against them: every loss
term, the BatchNorm running statistics and the parameters after the update,
under the rules of the HigherHRNet step (``tests/test_torch_port_train.py``);
the gradients of both against a float64 evaluation of the same net. The bf16 step, the config's module
(``architecture: Hourglass``, ``hm_resolutions [0.25, 0.25]``) through a
step, a validation and ``make_results``; the single-output nets through
the top-down step, and the refusal of targets that do not match the
stages.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_pose_tpu.models import AEHourglassNet as JaxAEHourglassNet
from human_pose_tpu.train import TrainState as JaxTrainState
from human_pose_tpu.train import accumulated_keypoints_train_step as jax_accumulated_step
from human_pose_tpu.train import create_optimizer as jax_create_optimizer
from human_pose_tpu.train import steps as jax_steps
from human_pose_tpu_torch.configs import KeypointsConfig
from human_pose_tpu_torch.models import AEHourglassNet, HourglassNet, HRNetSPPE, SimpleBaseline
from human_pose_tpu_torch.models.norm import BatchNorm2d
from human_pose_tpu_torch.ops import prep_images
from human_pose_tpu_torch.train import (
    DeviceBatch, KeypointsModule, TrainState, accumulated_keypoints_train_step, ae_keypoints_loss,
    create_optimizer, keypoints_train_step,
)
from human_pose_tpu_torch.utils import weights
from tests.jax_reference import FLAG, light_jax_reference  # noqa: F401  (module fixture)

N, S, K, P = 2, 128, 17, 5
LR = 1e-3
METRICS = {"hm_0", "push", "pull", "loss"}


def _randomize(tree: dict, rs: np.random.RandomState) -> dict:
    """Kernels at std 1/sqrt(fan_in), biases and BN offsets and means near
    0, BN scales near 1, variances in [0.5, 1.5)."""
    def leaf(name, shape):
        if name == "kernel":
            return rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        if name in ("scale", "var"):
            return 1.0 + (0.2 * rs.randn(*shape) if name == "scale" else rs.rand(*shape) - 0.5)
        return 0.1 * rs.randn(*shape)

    return {k: _randomize(v, rs) if isinstance(v, dict) else leaf(k, v.shape).astype(np.float32)
            for k, v in tree.items()}


def _joints(rs, n, p, h):
    """``[n, p, K, 3]`` int32: about half visible, coordinates from 3 below
    to 3 past the map's edges; the last sample keeps one person."""
    j = np.stack([rs.randint(-3, h + 3, (n, p, K)), rs.randint(-3, h + 3, (n, p, K)),
                  rs.rand(n, p, K) > 0.5], -1).astype(np.int32)
    j[-1, 1:, :, 2] = 0
    return j


@pytest.fixture(scope="module")
def setup():
    """JAX's one-stage AE hourglass, seeded variables in its tree (named and
    shaped through the bridge from the port's state dict), one seeded NHWC
    batch with one heatmap target at 1/4."""
    template = weights.variables_from_state_dict(AEHourglassNet(K, 1, device="cpu").state_dict())
    rs = np.random.RandomState(0)
    variables = {col: _randomize(tree, rs) for col, tree in template.items()}
    rs = np.random.RandomState(1)
    batch = {"images": rs.randint(0, 256, (N, S, S, 3)).astype(np.uint8),
             "heatmaps": [rs.rand(N, S // 4, S // 4, K).astype(np.float32)],
             "masks": [(rs.rand(N, S // 4, S // 4) > 0.2).astype(np.float32)],
             "joints": _joints(rs, N, P, S // 4)}
    return JaxAEHourglassNet(K, 1), variables, batch


def _jax_state(setup):
    model, variables, _ = setup
    v = jax.tree_util.tree_map(jnp.asarray, variables)
    return JaxTrainState.create(model.apply, v["params"], v["batch_stats"],
                                jax_create_optimizer("Adam", lr=LR))


def _jax_batch(batch):
    """Fresh device arrays: JAX's steps donate their batch."""
    return jax.tree_util.tree_map(jnp.asarray, batch)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree: dict, col: str = "params") -> dict:
    return weights.variables_to_torch({"params": {}, **{col: _np_tree(tree)}})


def _torch_batch(batch):
    return {"images": torch.from_numpy(batch["images"].transpose(0, 3, 1, 2).copy()),
            "heatmaps": [torch.from_numpy(h.transpose(0, 3, 1, 2).copy()) for h in batch["heatmaps"]],
            "masks": [torch.from_numpy(m) for m in batch["masks"]],
            "joints": torch.from_numpy(batch["joints"])}


def _torch_state(setup, dtype=torch.float32):
    _, variables, _ = setup
    net = AEHourglassNet(K, 1, device="cpu")
    net.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in weights.variables_to_torch(variables).items()}, strict=False)
    return TrainState.create(net, create_optimizer(net.parameters(), "Adam", LR), dtype=dtype,
                             device="cpu")


@pytest.fixture(scope="module")
def jax_run(setup):
    """JAX's gradients, BN statistics and metrics of the batch
    (``_keypoints_grads``), the Adam update from those gradients
    (``_update``), and one ``accumulated_keypoints_train_step(2)``."""
    _, _, batch = setup
    grads, stats, metrics = jax.jit(jax_steps._keypoints_grads)(_jax_state(setup), _jax_batch(batch))
    params, _ = jax.jit(jax_steps._update)(_jax_state(setup), grads, LR)
    # compiled with XLA's optimizations: its microbatch loop ran 2.6x
    # slower (26 s against 10 s) without them
    jax.config.update(FLAG, False)
    try:
        acc_state, acc_metrics = jax_accumulated_step(2)(_jax_state(setup), _jax_batch(batch), LR)
    finally:
        jax.config.update(FLAG, True)
    return {"grads": _flat(grads), "stats": _flat(stats, "batch_stats"), "params": _flat(params),
            "metrics": _np_tree(metrics), "acc_params": _flat(acc_state.params),
            "acc_stats": _flat(acc_state.batch_stats, "batch_stats"),
            "acc_metrics": _np_tree(acc_metrics)}


@pytest.fixture(scope="module")
def torch_run(setup):
    _, _, batch = setup
    return keypoints_train_step(_torch_state(setup), _torch_batch(batch), LR)


@pytest.fixture(scope="module")
def float64_run(setup):
    """The loss and the gradients of the port's net evaluated in float64
    (its BatchNorm moments too) on the same batch and weights: the
    reference both frameworks' float32 gradients are held against."""
    _, _, batch = setup
    b = _torch_batch(batch)
    net = _torch_state(setup).model.double().train()
    hms, tags = net(prep_images(b["images"]).double())
    loss = ae_keypoints_loss(hms, tags, [h.double() for h in b["heatmaps"]],
                             [m.double() for m in b["masks"]], b["joints"])[0]
    loss.backward()
    return float(loss), {name: p.grad.numpy() for name, p in net.named_parameters()
                         if p.grad is not None}


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _assert_metrics(got: dict, want: dict, rtol: float):
    assert set(got) == set(want) == METRICS
    for key, value in want.items():
        np.testing.assert_allclose(float(got[key]), float(value), rtol=rtol, atol=0, err_msg=key)


def _assert_stats(model, want: dict, before: dict, n_batches: int):
    """Each running statistic within 1e-3 of its tensor's largest value
    (measured 1.6e-4 on a variance), moved from ``before``;
    ``num_batches_tracked`` counts the batches."""
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    assert want
    for key, value in want.items():
        assert np.abs(sd[key] - value).max() <= 1e-3 * np.abs(value).max(), key
        assert not np.array_equal(sd[key], before[key]), key
    assert all(int(v) == n_batches for k, v in sd.items() if k.endswith("num_batches_tracked"))


def _assert_adam_parameters(got: dict, want: dict, sure: dict):
    """Parameters after an Adam step: within 1e-6 where ``sure``, within
    2 * lr elsewhere."""
    for name, value in want.items():
        diff = np.abs(got[name] - value)
        assert diff[sure[name]].max(initial=0.0) <= 1e-6, name
        assert diff.max() <= 2 * LR + 1e-6, name


def test_ae_hourglass_step_losses_match_jax(jax_run, torch_run, float64_run):
    """hm_0, push, pull and loss within rel 1e-5 of JAX's (measured 6.6e-6);
    the port's loss within 1e-6 of its float64 evaluation (measured 1.1e-7)."""
    _, metrics = torch_run
    _assert_metrics(metrics, jax_run["metrics"], 1e-5)
    np.testing.assert_allclose(float(metrics["loss"]), float64_run[0], rtol=1e-6)


def test_ae_hourglass_step_gradients_match_jax(jax_run, torch_run, float64_run):
    """The hourglass is deep (55 BatchNorms; its bottom normalizes 8 values
    a channel at 128^2, batch 2), so float32 gradients carry rounding that
    float64 does not: both frameworks are held against the port's float64
    gradients of the same weights and batch. The port's within 1e-2 a
    tensor and 2e-3 over all (measured 4.4e-3, 9.6e-4), JAX's within 3e-2
    and 2e-2 (measured 1.25e-2, 8.2e-3), and the two within 3e-2 a tensor
    of each other. The last stage's remap convs feed nothing the loss
    reads: JAX's gradient is zero there and the port's is None."""
    state, _ = torch_run
    want, ref = jax_run["grads"], float64_run[1]
    names = [name for name, _ in state.model.named_parameters()]
    assert sorted(names) == sorted(want)
    got, unused = {}, 0
    for name, p in state.model.named_parameters():
        if p.grad is None:
            assert ".remap_" in name and not np.any(want[name]) and name not in ref, name
            unused += 1
        else:
            got[name] = p.grad.numpy()
            assert _rel(got[name], ref[name]) <= 1e-2, name
            assert _rel(want[name], ref[name]) <= 3e-2, name
            assert _rel(got[name], want[name]) <= 3e-2, name
    assert unused == 4

    def flat(g):
        return np.concatenate([g[name].ravel() for name in ref])
    assert _rel(flat(got), flat(ref)) <= 2e-3
    assert _rel(flat(want), flat(ref)) <= 2e-2


def test_ae_hourglass_step_batch_norm_statistics_match_jax(setup, jax_run, torch_run):
    """Every BatchNorm's running mean and variance after the step (flax's
    biased variance) against JAX's."""
    state, _ = torch_run
    assert sum(isinstance(m, BatchNorm2d) for m in state.model.modules()) == 55
    _assert_stats(state.model, jax_run["stats"], weights.variables_to_torch(setup[1]), 1)


def test_ae_hourglass_step_adam_parameters_match_jax(jax_run, torch_run):
    """The parameters after one Adam step against JAX's. Its first update
    is lr * g / (|g| + 1e-8): where both gradients reach 1e-5 with one sign
    the two updates differ by at most lr * 1e-8 / 1e-5 = 1e-6 whatever
    the gradients' own gap (up to ~1e-2 here, the test above); elsewhere
    by at most 2 * lr."""
    state, _ = torch_run
    got = {name: p.detach().numpy() for name, p in state.model.named_parameters()}
    sure = {}
    for name, p in state.model.named_parameters():
        g, w = (np.zeros_like(got[name]) if p.grad is None else p.grad.numpy()), jax_run["grads"][name]
        sure[name] = (np.abs(g) >= 1e-5) & (np.abs(w) >= 1e-5) & (np.sign(g) == np.sign(w))
    _assert_adam_parameters(got, {k: jax_run["params"][k] for k in got}, sure)


def test_ae_hourglass_accumulated_step_matches_jax(setup, jax_run):
    """Two microbatches of one sample: the metrics (the microbatches' mean)
    within rel 1e-5, the statistics carried through both microbatches, and
    the averaged gradients' Adam step against JAX's accumulated step
    (``sure`` where both moved an element by ~lr the same way)."""
    _, variables, batch = setup
    state, metrics = accumulated_keypoints_train_step(2)(_torch_state(setup), _torch_batch(batch), LR)
    assert state.step == 1
    _assert_metrics(metrics, jax_run["acc_metrics"], 1e-5)
    before = weights.variables_to_torch(variables)
    _assert_stats(state.model, jax_run["acc_stats"], before, 2)
    got = {name: p.detach().numpy() for name, p in state.model.named_parameters()}
    want = {k: jax_run["acc_params"][k] for k in got}
    sure = {k: (np.abs(got[k] - before[k]) >= 0.999 * LR) & (np.abs(want[k] - before[k]) >= 0.999 * LR)
            & (np.sign(got[k] - before[k]) == np.sign(want[k] - before[k])) for k in got}
    _assert_adam_parameters(got, want, sure)


def test_ae_hourglass_bf16_step(setup, torch_run):
    """Under bfloat16 autocast: the same metrics, float32, hm_0 and the
    loss within 1e-2 of the float32 step's (measured 2.3e-4), float32
    parameters and finite float32 gradients on the same parameters. This
    random-weight net amplifies rounding ~1e5 into its gradients (float32
    misses float64 by up to 1e-2, above), so bfloat16's are not held to
    the float32 ones (their cosine read 0.58)."""
    _, _, batch = setup
    state, metrics = keypoints_train_step(_torch_state(setup, torch.bfloat16), _torch_batch(batch), LR)
    ref_state, ref = torch_run
    assert set(metrics) == METRICS and all(v.dtype == torch.float32 for v in metrics.values())
    for key in ("hm_0", "loss"):
        np.testing.assert_allclose(float(metrics[key]), float(ref[key]), rtol=1e-2, err_msg=key)
    for (name, p), q in zip(state.model.named_parameters(), ref_state.model.parameters()):
        assert p.dtype == torch.float32 and (p.grad is None) == (q.grad is None), name
        if p.grad is not None:
            assert p.grad.dtype == torch.float32 and bool(torch.isfinite(p.grad).all()), name


def _config(arch="Hourglass", hm=(0.25, 0.25), **net):
    return KeypointsConfig.from_dict({
        "setup": {"architecture": arch}, "trainer": {"accelerator": "cpu"},
        "net": {"params": net},
        "dataloader": {"train_ds": {"hm_resolutions": list(hm)}, "val_ds": {"hm_resolutions": list(hm)}},
        "transform": {"hm_resolutions": list(hm)}})


def test_config_trains_the_ae_hourglass():
    """``architecture: Hourglass`` with ``hm_resolutions [0.25, 0.25]``:
    ``create_module`` gives a ``KeypointsModule`` on the AE hourglass
    (two stages, the keypoints init), whose step reports hm_0, hm_1, push,
    pull and loss; its validation decodes two 1/4 stages with the tags in
    ``make_results`` (det 0.1, tag 1.0), every result at the input's
    resolution."""
    module = _config(num_stages=2).create_module()
    assert isinstance(module.model, AEHourglassNet) and module.device == torch.device("cpu")
    g = torch.Generator().manual_seed(0)
    batch = DeviceBatch({
        "images": torch.randint(0, 256, (N, 3, S, S), dtype=torch.uint8, generator=g),
        "heatmaps": [torch.rand(N, K, S // 4, S // 4, generator=g) for _ in range(2)],
        "masks": [torch.ones(N, S // 4, S // 4) for _ in range(2)],
        "joints": torch.randint(0, S // 4, (N, P, K, 3), generator=g).int()})
    metrics = module.training_step(batch)
    assert set(metrics) == METRICS | {"hm_1"} and all(bool(torch.isfinite(v)) for v in metrics.values())
    val_metrics, (stages, tags) = module.validation_step(batch)
    assert set(val_metrics) == set(metrics)
    assert [tuple(h.shape) for h in stages] == [(N, K, S // 4, S // 4)] * 2
    results = module.make_results(batch, (stages, tags))
    assert len(results) == N
    for r in results:
        assert r.kpts_heatmaps.shape == (S, S, K) and r.tags_heatmaps.shape == (S, S, K)
        assert r.kpts_coords.shape[1:] == (K, 2) and r.det_thr == 0.1


def _crops(k: int, s: int = 64) -> DeviceBatch:
    """A top-down batch of two uint8 crops of ``s``x``s``, targets at 1/4
    and the joints' weights (one joint unlabelled)."""
    g = torch.Generator().manual_seed(0)
    weight = torch.ones(N, k)
    weight[0, 0] = 0.0
    return DeviceBatch({
        "images": torch.randint(0, 256, (N, 3, s, s), dtype=torch.uint8, generator=g),
        "heatmaps": torch.rand(N, k, s // 4, s // 4, generator=g), "target_weight": weight})


def _trains_one_step(module, k: int) -> None:
    """``module`` takes one top-down step (the joints MSE of each stage, the
    parameters move) and validates the batch."""
    batch = _crops(k)
    before = [p.detach().clone() for p in module.model.parameters()]
    metrics = module.training_step(batch)
    assert module.top_down and "loss" in metrics and "hm_0" in metrics
    assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert any(not torch.equal(p, b) for p, b in zip(module.model.parameters(), before))
    val_metrics, stages = module.validation_step(batch)
    assert set(val_metrics) == set(metrics) and stages[0].shape == (N, k, 16, 16)


@pytest.mark.parametrize("make,k", [
    (lambda: SimpleBaseline(K, "resnet18", device="cpu"), K),
    (lambda: HRNetSPPE(K, C=8, num_blocks_per_stage=(1, 1, 1, 1), num_units=1,
                       heatmap_softmax=False, device="cpu"), K),
    (lambda: HourglassNet(16, 1, device="cpu"), 16),
], ids=["SimpleBaseline", "HRNetSPPE", "HourglassNet"])
def test_single_output_nets_refuse_to_train(make, k):
    """The SPPE nets return a list of heatmap stages and no tags: the JAX
    package's ``KeypointsModule`` cannot train them (its step unpacks
    ``(stages, tags)``, human_pose_tpu/train/steps.py:109); the port's
    trains them through the top-down step (``steps.sppe_train_step``, the
    target-weighted joints MSE) on batches of crops."""
    _trains_one_step(KeypointsModule.create(make()), k)


@pytest.mark.parametrize("arch", ["SimpleBaseline", "HRNet"])
def test_config_refuses_single_output_architectures(arch):
    """The config's ``create_module`` builds them (tiny nets on the CPU)
    as top-down modules, their one stage at 1/4, and they train a step."""
    tiny = ({"backbone": "resnet18"} if arch == "SimpleBaseline"
            else {"C": 8, "num_blocks_per_stage": [1, 1, 1, 1], "num_units": 1})
    cfg = _config(arch, hm=(0.25,), **tiny)
    cfg.check_trainable()
    assert cfg.stage_resolutions() == (0.25,)
    _trains_one_step(cfg.create_module(), K)


@pytest.mark.parametrize("hm", [(0.25, 0.5), (0.5, 0.25)])
def test_config_refuses_targets_off_the_hourglass_stages(hm):
    """The AE hourglass's stages are all at 1/4: ``[0.25, 0.5]`` (the W32
    yaml's) raises a ValueError that names the stages, before the module
    is built (JAX fails later, broadcasting (2,16,16,17) against
    (2,32,32,17) in the loss), and so does a transform whose masks are
    off the stages; HigherHRNet keeps its [0.25, 0.5]."""
    with pytest.raises(ValueError, match=r"stages are at \[0.25, 0.25\]"):
        _config(hm=hm).create_module()
    _config("HigherHRNet", hm=(0.25, 0.5)).check_trainable()
    with pytest.raises(ValueError, match=r"\[0.25, 0.5\]"):
        _config("HigherHRNet", hm=(0.25, 0.25)).check_trainable()
    masks_off = _config()
    masks_off.transform.hm_resolutions = list(hm)  # the masks' sizes
    with pytest.raises(ValueError, match="^transform.hm_resolutions"):
        masks_off.check_trainable()
