"""The port's keypoints training slice against the JAX package, on the CPU.

* the train step on the shallow C=8 HigherHRNet of tests/test_train_steps.py
  (one deconv residual block, 64x64, batch 2, uint8 images, crowd masks,
  joints off the map and a sample with one person), JAX's ``HigherHRNet``
  with ``s2d=False`` (the port's layout) and the same random weights
  through ``variables_to_torch``: every loss term, every parameter's
  gradient, the BatchNorm running statistics after the step, the
  parameters after one Adam step (carried back through
  ``variables_from_torch``), the val step's metrics, the accumulated step
  at ``n_micro`` 2 against JAX's, and ``n_micro`` 1 against the plain step;
* the losses alone on their edge cases, flax's train-mode BatchNorm, the
  keypoints init;
* the seven optimizers against optax over three steps with a changing
  learning rate, with and without their weight-decay or momentum argument,
  and the global-norm clip; the eight schedulers against the JAX package's.

JAX compiles each step once (module fixtures, jitted); the port runs on one
torch intra-op thread.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from human_pose_tpu.models import HigherHRNet as JaxHigherHRNet
from human_pose_tpu.train import TrainState as JaxTrainState
from human_pose_tpu.train import accumulated_keypoints_train_step as jax_accumulated_step
from human_pose_tpu.train import ae_grouping_loss as jax_ae_grouping_loss
from human_pose_tpu.train import ae_keypoints_loss as jax_ae_keypoints_loss
from human_pose_tpu.train import create_lr_scheduler as jax_create_lr_scheduler
from human_pose_tpu.train import create_optimizer as jax_create_optimizer
from human_pose_tpu.train import keypoints_train_step as jax_train_step
from human_pose_tpu.train import keypoints_val_step as jax_val_step
from human_pose_tpu.train import set_learning_rate as jax_set_learning_rate
from human_pose_tpu.train import steps as jax_steps
from human_pose_tpu_torch.models import HigherHRNet, init_keypoints_weights_
from human_pose_tpu_torch.models.norm import BatchNorm2d, batch_norm
from human_pose_tpu_torch.train import (
    TAG_LOSS_WEIGHT, TrainState, accumulated_keypoints_train_step, ae_grouping_loss,
    ae_keypoints_loss, create_lr_scheduler, create_optimizer, keypoints_train_step,
    keypoints_val_step,
)
from human_pose_tpu_torch.train.optim import clip_by_global_norm_
from human_pose_tpu_torch.utils import weights
from tests.test_torch_port_models import SHALLOW, _randomize

N, S, K, P = 2, 64, 17, 5
LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's many small CPU ops while this
    module runs: the suite runs several workers on a few cores, where
    torch's default thread pool spins against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- the step on the shallow net ---------------------------------------------------

def _joints(rs, n, p, h):
    """``[n, p, K, 3]`` int32: about half visible, coordinates from 3 below
    to 3 past the map's edges; the last sample keeps one person."""
    j = np.stack([rs.randint(-3, h + 3, (n, p, K)), rs.randint(-3, h + 3, (n, p, K)),
                  rs.rand(n, p, K) > 0.5], -1).astype(np.int32)
    j[-1, 1:, :, 2] = 0
    return j


@pytest.fixture(scope="module")
def setup():
    """JAX's shallow net with random weights and BN statistics, one seeded
    batch (NHWC numpy; the port gets it transposed)."""
    model = JaxHigherHRNet(num_kpts=K, C=8, s2d=False, **SHALLOW)
    template = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), np.zeros((1, S, S, 3), np.float32), train=False))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), dict(template))
    rs = np.random.RandomState(0)
    variables = {col: _randomize(tree, rs) for col, tree in template.items()}
    rs = np.random.RandomState(1)
    batch = {
        "images": rs.randint(0, 256, (N, S, S, 3)).astype(np.uint8),
        "heatmaps": [rs.rand(N, S // 4, S // 4, K).astype(np.float32),
                     rs.rand(N, S // 2, S // 2, K).astype(np.float32)],
        "masks": [(rs.rand(N, S // 4, S // 4) > 0.2).astype(np.float32),
                  (rs.rand(N, S // 2, S // 2) > 0.2).astype(np.float32)],
        "joints": _joints(rs, N, P, S // 4),
    }
    return model, variables, batch


def _jax_batch(batch):
    """Fresh device arrays: the JAX steps donate their batch."""
    return jax.tree_util.tree_map(jnp.asarray, batch)


def _jax_state(setup):
    model, variables, _ = setup
    v = jax.tree_util.tree_map(jnp.asarray, variables)
    return JaxTrainState.create(model.apply, v["params"], v["batch_stats"],
                                jax_create_optimizer("Adam", lr=LR))


def _torch_batch(batch):
    return {"images": torch.from_numpy(batch["images"].transpose(0, 3, 1, 2).copy()),
            "heatmaps": [torch.from_numpy(h.transpose(0, 3, 1, 2).copy()) for h in batch["heatmaps"]],
            "masks": [torch.from_numpy(m) for m in batch["masks"]],
            "joints": torch.from_numpy(batch["joints"])}


def _torch_state(setup, name="Adam", **params):
    _, variables, _ = setup
    net = HigherHRNet(num_kpts=K, C=8, device="cpu", **SHALLOW)
    net.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                         for k, v in weights.variables_to_torch(variables).items()}, strict=True)
    return TrainState.create(net, create_optimizer(net.parameters(), name, LR, **params), device="cpu")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_run(setup):
    """JAX's gradients (``_keypoints_grads``), one ``keypoints_train_step``,
    the val step after it, and one ``accumulated_keypoints_train_step(2)``,
    each compiled once."""
    _, _, batch = setup
    grads, _, _ = jax.jit(jax_steps._keypoints_grads)(_jax_state(setup), _jax_batch(batch))
    state, metrics = jax_train_step(_jax_state(setup), _jax_batch(batch), LR)
    val_metrics, _ = jax_val_step(state, _jax_batch(batch))
    acc_state, acc_metrics = jax_accumulated_step(2)(_jax_state(setup), _jax_batch(batch), LR)
    return {"grads": weights.variables_to_torch({"params": _np_tree(grads)}),
            "state": state, "metrics": _np_tree(metrics), "val_metrics": _np_tree(val_metrics),
            "acc_state": acc_state, "acc_metrics": _np_tree(acc_metrics)}


@pytest.fixture(scope="module")
def torch_run(setup):
    """The port's train step, then its val step, from the same weights."""
    _, _, batch = setup
    state, metrics = keypoints_train_step(_torch_state(setup), _torch_batch(batch), LR)
    val_metrics, out = keypoints_val_step(state, _torch_batch(batch))
    return state, metrics, val_metrics, out


def _assert_metrics(got: dict, want: dict, rtol: float):
    assert set(got) == set(want) == {"hm_0", "hm_1", "push", "pull", "loss"}
    for key, value in want.items():
        np.testing.assert_allclose(float(got[key]), float(value), rtol=rtol, atol=0, err_msg=key)


def test_train_step_losses_match_jax(jax_run, torch_run):
    """Every loss term within rel 1e-5 (measured 1.2e-6: the two frameworks
    sum the convolutions in other orders)."""
    _, metrics, _, _ = torch_run
    assert all(v.shape == () and not v.requires_grad for v in metrics.values())
    _assert_metrics(metrics, jax_run["metrics"], 1e-5)


def test_train_step_gradients_match_jax(jax_run, torch_run):
    """Every parameter's gradient within ||port - jax|| / ||jax|| <= 5e-4
    (measured 5.3e-5, a deconv-head BN bias)."""
    state, _, _, _ = torch_run
    want = jax_run["grads"]
    names = [name for name, _ in state.model.named_parameters()]
    assert sorted(names) == sorted(want)
    for name, p in state.model.named_parameters():
        g = p.grad.numpy()
        rel = np.linalg.norm(g - want[name]) / np.linalg.norm(want[name])
        assert rel <= 5e-4, (name, rel)


def test_train_step_batch_norm_statistics_match_jax(setup, jax_run, torch_run):
    """The running mean and variance after the step: flax moves the variance
    towards the biased batch variance E[x^2] - E[x]^2 (torch's BatchNorm2d,
    towards the unbiased one). Within 1e-4 of each tensor's largest value
    (measured 1.1e-4 relative on the smallest variances, 4.5e-6 absolute)."""
    state, _, _, _ = torch_run
    want = weights.variables_to_torch({"params": {}, "batch_stats": _np_tree(jax_run["state"].batch_stats)})
    before = weights.variables_to_torch(setup[1])
    sd = state.model.state_dict()
    for key, value in want.items():
        got = sd[key].numpy()
        assert np.abs(got - value).max() <= 1e-4 * np.abs(value).max(), key
        assert not np.array_equal(got, before[key]), key
    n_batches = [v for k, v in sd.items() if k.endswith("num_batches_tracked")]
    assert n_batches and all(int(v) == 1 for v in n_batches)


def test_train_step_adam_parameters_match_jax(setup, jax_run, torch_run):
    """The parameters after one Adam step, carried back through
    ``variables_from_torch``. Adam's first update is lr * g / (|g| + 1e-8):
    where |g| >= 1e-6 (100x eps) it is within 1e-6 of JAX's (measured
    1.2e-7); below, the two gradients' rounding (~1e-7) can flip its sign,
    so those elements are held within 2 * lr. The same Adam step from the
    port's own gradients through JAX's update (``steps._update``) is held
    within two float32 ulps or 2e-5 of the step size everywhere."""
    _, variables, _ = setup
    state, _, _, _ = torch_run
    sd = {k: v.numpy() for k, v in state.model.state_dict().items()}
    got = weights.variables_from_torch(sd, variables)["params"]
    want = _np_tree(jax_run["state"].params)
    grads = {name: p.grad.numpy() for name, p in state.model.named_parameters()}
    flat_got = weights.variables_to_torch({"params": got})
    flat_want = weights.variables_to_torch({"params": want})
    for key, g in jax_run["grads"].items():
        diff = np.abs(flat_got[key] - flat_want[key])
        sure = np.abs(g) >= 1e-6
        assert diff[sure].max(initial=0.0) <= 1e-6, key
        assert diff.max() <= 2 * LR + 1e-6, key

    # JAX's update from the port's gradients
    port_grads = weights.variables_from_torch(grads, {"params": variables["params"]})["params"]
    params, _ = jax.jit(jax_steps._update)(_jax_state(setup), jax.tree_util.tree_map(
        jnp.asarray, port_grads), LR)
    flat_jax = weights.variables_to_torch({"params": _np_tree(params)})
    for key, value in flat_jax.items():
        np.testing.assert_allclose(flat_got[key], value, rtol=2.4e-7, atol=2e-8, err_msg=key)


def test_val_step_matches_jax(setup, jax_run, torch_run):
    """The val step from JAX's weights and statistics after its train step
    (eval BatchNorm with the moved running statistics): metrics within rel
    1e-5, outputs NCHW float32. The port's val step after its own train
    step runs too (its weights differ by Adam's sign-ambiguous elements)."""
    _, _, batch = setup
    _, _, own_metrics, _ = torch_run
    after = jax_run["state"]
    state = _torch_state(setup)
    state.model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                                 weights.variables_to_torch(_np_tree(after.variables())).items()},
                                strict=False)
    val_metrics, out = keypoints_val_step(state, _torch_batch(batch))
    _assert_metrics(val_metrics, jax_run["val_metrics"], 1e-5)
    assert all(bool(torch.isfinite(v)) for v in own_metrics.values())
    (hm_q, hm_h), tags = out
    assert tuple(hm_q.shape) == (N, K, S // 4, S // 4) and tuple(hm_h.shape) == (N, K, S // 2, S // 2)
    assert tuple(tags.shape) == (N, K, S // 4, S // 4) and tags.dtype == torch.float32


def test_accumulated_step_matches_jax(setup, jax_run):
    """``n_micro`` 2: the averaged gradients' Adam step and the BN statistics
    carried through the two microbatches in order, against JAX's; metrics
    are the microbatches' mean. The tolerances of the plain step."""
    _, variables, batch = setup
    state, metrics = accumulated_keypoints_train_step(2)(_torch_state(setup), _torch_batch(batch), LR)
    assert state.step == 1
    _assert_metrics(metrics, jax_run["acc_metrics"], 1e-5)
    sd = {k: v.numpy() for k, v in state.model.state_dict().items()}
    want_stats = weights.variables_to_torch(
        {"params": {}, "batch_stats": _np_tree(jax_run["acc_state"].batch_stats)})
    for key, value in want_stats.items():
        assert np.abs(sd[key] - value).max() <= 1e-4 * np.abs(value).max(), key
    assert all(int(v) == 2 for k, v in sd.items() if k.endswith("num_batches_tracked"))
    flat_want = weights.variables_to_torch({"params": _np_tree(jax_run["acc_state"].params)})
    before = weights.variables_to_torch(variables)
    for name, p in state.model.named_parameters():
        diff = np.abs(sd[name] - flat_want[name])
        step = np.abs(flat_want[name] - before[name])
        # elements JAX moved by (almost) lr had |g| far above Adam's eps
        sure = step >= 0.999 * LR
        assert diff[sure].max(initial=0.0) <= 1e-6, name
        assert diff.max() <= 2 * LR + 1e-6, name


def test_accumulated_step_one_micro_equals_plain_step(setup, torch_run):
    """``n_micro`` 1 is the plain step bit for bit: gradients, statistics,
    parameters and metrics."""
    _, _, batch = setup
    plain, plain_metrics, _, _ = torch_run
    state, metrics = accumulated_keypoints_train_step(1)(_torch_state(setup), _torch_batch(batch), LR)
    for key in plain_metrics:
        assert torch.equal(metrics[key], plain_metrics[key]), key
    # the plain state ran a val step since (eval mode changes no state)
    want = plain.model.state_dict()
    for key, value in state.model.state_dict().items():
        assert torch.equal(value, want[key]), key
    for (name, p), q in zip(state.model.named_parameters(), plain.model.parameters()):
        assert torch.equal(p.grad, q.grad), name


def test_accumulated_step_refuses_ragged_batch(setup):
    _, _, batch = setup
    with pytest.raises(ValueError, match="not divisible"):
        accumulated_keypoints_train_step(3)(_torch_state(setup), _torch_batch(batch), LR)


def test_bf16_step_runs_under_autocast(setup):
    """The bfloat16 compute dtype: the step runs the forward under
    ``torch.autocast``; outputs, losses, parameters and optimizer state stay
    float32 and finite, and the loss is near the float32 step's (bf16
    activations: within 5%)."""
    _, _, batch = setup
    f32 = _torch_state(setup)
    bf16 = _torch_state(setup)
    bf16.dtype = torch.bfloat16
    _, m32 = keypoints_train_step(f32, _torch_batch(batch), LR)
    _, m16 = keypoints_train_step(bf16, _torch_batch(batch), LR)
    assert all(v.dtype == torch.float32 and bool(torch.isfinite(v)) for v in m16.values())
    assert abs(float(m16["loss"]) - float(m32["loss"])) <= 0.05 * float(m32["loss"])
    assert all(p.dtype == torch.float32 and bool(torch.isfinite(p).all()) for p in bf16.model.parameters())
    assert all(s.dtype == torch.float32 for st in bf16.optimizer.state.values()
               for s in st.values() if torch.is_tensor(s) and s.is_floating_point())


def test_train_state_refusals():
    """Only float32 and bfloat16 compute; the card by default (refused
    without one); the model's parameters must be on the state's device."""
    net = HigherHRNet(num_kpts=K, C=8, device="cpu", **SHALLOW)
    opt = create_optimizer(net.parameters(), "Adam", LR)
    with pytest.raises(ValueError, match="dtype"):
        TrainState.create(net, opt, dtype=torch.float16, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            TrainState.create(net, opt)
    with pytest.raises(ValueError, match="device"):
        TrainState.create(net, opt, device="meta")
    state = TrainState.create(net, opt, device="cpu")
    assert state.step == 0 and state.dtype == torch.float32 and state.device == torch.device("cpu")


# -- losses on their edge cases ----------------------------------------------------

def _loss_case(name, rs, n=3, p=4, h=8, w=10):
    tags = (rs.randn(n, h, w, K) * 2).astype(np.float32)
    j = np.stack([rs.randint(0, w, (n, p, K)), rs.randint(0, h, (n, p, K)),
                  rs.rand(n, p, K) > 0.4], -1).astype(np.int32)
    if name == "all_invisible":
        j[:, :, :, 2] = 0
    elif name == "one_sample_empty":
        j[1, :, :, 2] = 0
    elif name == "one_person":
        j[:, 1:, :, 2] = 0
        j[:, 0, :3, 2] = 1
    elif name == "off_map":
        j[..., 0] = rs.randint(-2 * w, 3 * w, (n, p, K))
        j[..., 1] = rs.randint(-2 * h, 3 * h, (n, p, K))
    elif name == "one_joint_persons":
        j[..., 2] = 0
        j[:, :, 5, 2] = 1
    return tags, j


LOSS_CASES = ["random", "all_invisible", "one_sample_empty", "one_person", "off_map",
              "one_joint_persons"]


@pytest.mark.parametrize("case", LOSS_CASES)
def test_ae_grouping_loss_matches_jax(case):
    """Push and pull, and their gradients with respect to the tag maps,
    within rel 1e-6 / abs 1e-9 of JAX's (all-invisible samples count in the
    batch mean; coordinates are clipped into the map before the gather)."""
    tags, j = _loss_case(case, np.random.RandomState(10 + LOSS_CASES.index(case)))
    (w_push, w_pull), (g_push, g_pull) = [
        [np.asarray(v) for v in r] for r in (
            jax_ae_grouping_loss(jnp.asarray(tags), jnp.asarray(j)),
            (jax.grad(lambda t: jax_ae_grouping_loss(t, jnp.asarray(j))[0])(jnp.asarray(tags)),
             jax.grad(lambda t: jax_ae_grouping_loss(t, jnp.asarray(j))[1])(jnp.asarray(tags))))]
    t = torch.from_numpy(tags.transpose(0, 3, 1, 2).copy()).requires_grad_()
    push, pull = ae_grouping_loss(t, torch.from_numpy(j))
    np.testing.assert_allclose(push.item(), w_push, rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(pull.item(), w_pull, rtol=1e-6, atol=1e-9)
    for loss, want in ((push, g_push), (pull, g_pull)):
        (g,) = torch.autograd.grad(loss, t, retain_graph=True)
        np.testing.assert_allclose(g.numpy().transpose(0, 2, 3, 1), want, rtol=1e-5, atol=1e-9)
    if case == "all_invisible":
        assert push.item() == pull.item() == 0.0


def test_ae_keypoints_loss_matches_jax():
    """Both stages' masked MSE plus the weighted push and pull, NCHW against
    JAX's NHWC, within rel 1e-5 (the means sum in other orders)."""
    rs = np.random.RandomState(3)
    preds = [rs.rand(2, 8, 8, K).astype(np.float32), rs.rand(2, 16, 16, K).astype(np.float32)]
    targets = [rs.rand(2, 8, 8, K).astype(np.float32), rs.rand(2, 16, 16, K).astype(np.float32)]
    masks = [(rs.rand(2, 8, 8) > 0.3).astype(np.float32), (rs.rand(2, 16, 16) > 0.3).astype(np.float32)]
    tags, j = _loss_case("random", rs, n=2, h=8, w=8)
    want_total, want = jax_ae_keypoints_loss(*[[jnp.asarray(a) for a in x] if isinstance(x, list)
                                               else jnp.asarray(x) for x in (preds, tags, targets, masks, j)])
    nchw = lambda a: torch.from_numpy(a.transpose(0, 3, 1, 2).copy())  # noqa: E731
    total, got = ae_keypoints_loss([nchw(a) for a in preds], nchw(tags), [nchw(a) for a in targets],
                                   [torch.from_numpy(m) for m in masks], torch.from_numpy(j))
    assert TAG_LOSS_WEIGHT == 1e-3 and got["loss"] is total
    _assert_metrics(got, want, 1e-5)


# -- flax's train-mode BatchNorm, the keypoints init ---------------------------------

def test_batch_norm_train_mode_matches_flax():
    """One train-mode call on channels of means and spreads between 0.1 and
    3: outputs, running statistics and the gradients of x, weight and bias
    against flax's ``nn.BatchNorm`` (momentum 0.9, eps 1e-5). Outputs and
    gradients within 1e-5 of their scale, statistics within rel 1e-6;
    torch's own BatchNorm2d moves the variance n / (n - 1) further. (Where
    a channel's mean is many times its spread, E[x^2] - E[x]^2 keeps few
    digits and its value depends on the summation order: there the two
    frameworks agree only as far as that.)"""
    rs = np.random.RandomState(4)
    x = (rs.randn(4, 6, 5, 7) * (0.1 + 2.9 * rs.rand(1, 6, 1, 1))
         + rs.uniform(-3, 3, (1, 6, 1, 1))).astype(np.float32)
    scale, bias = (1 + 0.3 * rs.randn(6)).astype(np.float32), (0.3 * rs.randn(6)).astype(np.float32)
    mean0, var0 = (0.1 * rs.randn(6)).astype(np.float32), (0.5 + rs.rand(6)).astype(np.float32)
    gy = rs.randn(*x.shape).astype(np.float32)

    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": scale, "bias": bias}, "batch_stats": {"mean": mean0, "var": var0}}
    x_nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))

    def f(params, xx):
        y, upd = bn.apply({**variables, "params": params}, xx, mutable=["batch_stats"])
        return (y * jnp.asarray(gy.transpose(0, 2, 3, 1))).sum(), (y, upd["batch_stats"])

    (_, (y_want, stats)), (g_params, g_x) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        variables["params"], x_nhwc)

    m = batch_norm(6)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(scale))
        m.bias.copy_(torch.from_numpy(bias))
        m.running_mean.copy_(torch.from_numpy(mean0))
        m.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(x).requires_grad_()
    y = m.train()(xt)
    y.backward(torch.from_numpy(gy))

    def close(got, want, what):
        want = np.asarray(want)
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), what

    close(y.detach().numpy().transpose(0, 2, 3, 1), y_want, "y")
    close(xt.grad.numpy().transpose(0, 2, 3, 1), g_x, "grad x")
    close(m.weight.grad.numpy(), g_params["scale"], "grad weight")
    close(m.bias.grad.numpy(), g_params["bias"], "grad bias")
    np.testing.assert_allclose(m.running_mean.numpy(), stats["mean"], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(m.running_var.numpy(), stats["var"], rtol=1e-6, atol=1e-7)
    ref = torch.nn.BatchNorm2d(6, momentum=0.1).train()
    with torch.no_grad():
        ref.running_var.copy_(torch.from_numpy(var0))
        ref(torch.from_numpy(x))
    assert not np.allclose(ref.running_var.numpy(), stats["var"], rtol=1e-4)


def test_batch_norm_eval_mode_is_batchnorm2d():
    """Eval mode is ``nn.BatchNorm2d``'s bit for bit, with the same
    state-dict keys; bfloat16 input keeps its dtype in train mode and the
    statistics stay float32."""
    rs = np.random.RandomState(5)
    x = torch.from_numpy(rs.randn(3, 4, 6, 6).astype(np.float32))
    m, ref = batch_norm(4), torch.nn.BatchNorm2d(4, eps=1e-5, momentum=0.1)
    assert isinstance(m, BatchNorm2d) and isinstance(m, torch.nn.BatchNorm2d)
    with torch.no_grad():
        for t in (m, ref):
            t.weight.copy_(torch.linspace(0.5, 2.0, 4))
            t.bias.copy_(torch.linspace(-1.0, 1.0, 4))
            t.running_mean.copy_(torch.linspace(-0.3, 0.3, 4))
            t.running_var.copy_(torch.linspace(0.5, 1.5, 4))
    assert list(m.state_dict()) == list(ref.state_dict())
    assert torch.equal(m.eval()(x), ref.eval()(x))
    y = m.train()(x.to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and m.running_var.dtype == torch.float32
    assert bool(torch.isfinite(y.float()).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float64])
def test_batch_norm_parameter_gradients_in_at_least_float32(dtype):
    """The weight's and the bias's gradients of a train-mode BatchNorm on a
    reduced-precision x (bf16, fp16) are float32 sums, as in JAX's bf16
    step: within 1e-5 of their scale against a float64 evaluation of the
    same formulas on the same values (one low-precision rounding would be
    ~2**-9); grad_x keeps x's dtype. A float64 x keeps float64 moments and
    gradients (within 1e-12), so a float64 copy of a model is a reference."""
    gen = torch.Generator().manual_seed(6)
    x = (torch.randn((4, 8, 9, 7), generator=gen) * (0.2 + 2 * torch.rand((1, 8, 1, 1), generator=gen))
         + torch.randn((1, 8, 1, 1), generator=gen)).to(dtype)
    gy = torch.randn(x.shape, generator=gen).to(dtype)
    m = batch_norm(8).to(torch.float64 if dtype == torch.float64 else torch.float32).train()
    with torch.no_grad():
        m.weight.copy_(torch.linspace(0.5, 1.5, 8))
        m.bias.copy_(torch.linspace(-0.2, 0.2, 8))
    xx = x.detach().requires_grad_()
    m(xx).backward(gy)
    assert xx.grad.dtype == dtype and m.weight.grad.dtype == m.weight.dtype
    x64, gy64, c = x.double(), gy.double(), (None, slice(None), None, None)
    var = x64.var((0, 2, 3), unbiased=False)
    xhat = (x64 - x64.mean((0, 2, 3))[c]) / (var + 1e-5).sqrt()[c]
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    for got, want in ((m.weight.grad, (gy64 * xhat).sum((0, 2, 3))), (m.bias.grad, gy64.sum((0, 2, 3)))):
        assert float((got.double() - want).abs().max()) <= tol * float(want.abs().max())
    if dtype == torch.float64:
        assert m.running_var.dtype == torch.float64
        assert float((m.running_var - (0.9 + 0.1 * var)).abs().max()) <= 1e-12


def test_init_keypoints_weights():
    """Every conv and transposed-conv kernel drawn from N(0, 0.001) (each
    tensor's std within 10% for 500+ draws, mean within 5 standard errors),
    every conv bias zero, BN untouched; one seed, one set of weights."""
    net = HigherHRNet(num_kpts=K, C=8, device="cpu", **SHALLOW)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.Conv2d) and m.bias is not None:
                m.bias.fill_(0.5)
    bn_before = {k: v.clone() for k, v in net.state_dict().items() if ".running_" in k or "bn" in k}
    init_keypoints_weights_(net, torch.Generator().manual_seed(0))
    convs = [m for m in net.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.ConvTranspose2d))]
    assert any(isinstance(m, torch.nn.ConvTranspose2d) for m in convs)
    for m in convs:
        w = m.weight.detach()
        if w.numel() >= 500:
            assert abs(float(w.std()) - 1e-3) <= 1e-4, m
            assert abs(float(w.mean())) <= 5e-3 / w.numel() ** 0.5, m
        assert float(w.abs().max()) <= 1e-2
        if m.bias is not None:
            assert not bool(m.bias.any())
    sd = net.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in bn_before.items())
    other = init_keypoints_weights_(HigherHRNet(num_kpts=K, C=8, device="cpu", **SHALLOW),
                                    torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(other.parameters(), net.parameters()))


# -- optimizers and schedulers ---------------------------------------------------

OPTIMIZER_CASES = [
    ("SGD", {}), ("SGD", {"momentum": 0.9}),
    ("SGD", {"momentum": 0.9, "nesterov": True, "weight_decay": 1e-2}),
    ("SGD", {"momentum": 0.9, "dampening": 0.5}),
    ("Adam", {}), ("Adam", {"weight_decay": 1e-1}),
    ("AdamW", {}), ("AdamW", {"weight_decay": 0.1, "betas": (0.8, 0.99)}),
    ("Adamax", {}), ("Adamax", {"eps": 0.1, "betas": (0.8, 0.9)}),
    ("Adadelta", {}), ("Adadelta", {"weight_decay": 1e-2, "rho": 0.5, "eps": 1e-2}),
    ("Adagrad", {}), ("Adagrad", {"eps": 0.1}),
    ("RMSprop", {}), ("RMSprop", {"momentum": 0.9}), ("RMSprop", {"momentum": 0.5, "eps": 0.1}),
]
LRS = (1e-2, 5e-3, 2e-3)


def _tree(rs):
    return {"w": rs.randn(3, 4).astype(np.float32), "b": rs.randn(4).astype(np.float32)}


def _run_both(name, params, clip_norm=None, grad_scale=1.0):
    """Three updates from the same parameters and gradients with the
    learning rates ``LRS``: (port parameters, optax parameters)."""
    rs = np.random.RandomState(6)
    p0 = _tree(rs)
    grads = [jax.tree_util.tree_map(lambda a: a * grad_scale, _tree(rs)) for _ in LRS]

    tx = jax_create_optimizer(name, LRS[0], clip_norm=clip_norm, **params)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    opt_state = tx.init(jp)
    for lr, g in zip(LRS, grads):
        opt_state = jax_set_learning_rate(opt_state, lr)
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, updates)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = create_optimizer(tp.values(), name, LRS[0], clip_norm=clip_norm, **params)
    for lr, g in zip(LRS, grads):
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
    return {k: p.detach().numpy() for k, p in tp.items()}, _np_tree(jp), p0


@pytest.mark.parametrize("name,params", OPTIMIZER_CASES,
                         ids=[f"{n}-{'-'.join(map(str, p)) or 'default'}" for n, p in OPTIMIZER_CASES])
def test_optimizer_matches_optax(name, params):
    """Three updates with a changing learning rate: the parameters' change
    within rel 1e-5 or two float32 ulps of the parameters (below 4) of optax's (the
    same formulas rounded in other orders)."""
    got, want, p0 = _run_both(name, params)
    for k in want:
        np.testing.assert_allclose(got[k] - p0[k], want[k] - p0[k], rtol=1e-5, atol=4.8e-7, err_msg=k)
        assert not np.array_equal(got[k], p0[k])


@pytest.mark.parametrize("grad_scale", [0.1, 100.0])
def test_clip_norm_matches_optax(grad_scale):
    """SGD with momentum behind a global-norm clip at 1.5, with gradients of
    global norm ~0.4 (left alone) and ~400 (clipped), as optax's
    ``clip_by_global_norm`` in the JAX chain; and the clip alone."""
    got, want, p0 = _run_both("SGD", {"momentum": 0.9}, clip_norm=1.5, grad_scale=grad_scale)
    unclipped, _, _ = _run_both("SGD", {"momentum": 0.9}, grad_scale=grad_scale)
    for k in want:
        np.testing.assert_allclose(got[k] - p0[k], want[k] - p0[k], rtol=1e-5, atol=4.8e-7, err_msg=k)
        assert np.array_equal(got[k], unclipped[k]) == (grad_scale < 1), k
    rs = np.random.RandomState(7)
    g = _tree(rs)
    want_clip = _np_tree(optax.clip_by_global_norm(1.5).update(
        jax.tree_util.tree_map(jnp.asarray, g), None)[0])
    tg = {k: torch.from_numpy(v.copy()) for k, v in g.items()}
    clip_by_global_norm_(list(tg.values()), 1.5)
    for k in g:
        np.testing.assert_allclose(tg[k].numpy(), want_clip[k], rtol=1e-6, atol=0)


SCHEDULER_CASES = [
    ("ConstantLR", {}),
    ("MultiStepLR", {"milestones": [3, 6], "gamma": 0.1}),
    ("ExponentialLR", {"gamma": 0.8}),
    ("CosineAnnealingLR", {"T_max": 7, "eta_min": 1e-5}),
    ("CosineAnnealingWarmRestarts", {"T_0": 3, "T_mult": 2, "eta_min": 1e-5}),
    ("PolynomialLR", {"total_iters": 6, "power": 2.0}),
    ("OneCycleLR", {"total_steps": 9, "max_lr": 1e-2, "pct_start": 0.3}),
    ("ReduceLROnPlateau", {"mode": "min", "factor": 0.5, "patience": 1, "threshold": 0.01}),
]


@pytest.mark.parametrize("name,params", SCHEDULER_CASES, ids=[n for n, _ in SCHEDULER_CASES])
def test_scheduler_matches_jax(name, params):
    """Twelve ``step()`` calls (ReduceLROnPlateau on a metric sequence that
    improves, stalls and improves): the same learning rate each step, and
    a ``state_dict`` round trip that carries on the same."""
    metrics = [1.0, 0.9, 0.95, 0.95, 0.94, 0.5, 0.5, 0.5, 0.5, 0.4, 0.41, 0.42]
    want = jax_create_lr_scheduler(1e-3, name, **params)
    got = create_lr_scheduler(1e-3, name, **params)
    assert got.interval == want.interval and got.lr == want.lr
    lrs_got, lrs_want = [], []
    for i, m in enumerate(metrics):
        lrs_got.append(got.step(m))
        lrs_want.append(want.step(m))
        if i == 5:
            resumed = create_lr_scheduler(1e-3, name, **params)
            resumed.load_state_dict(got.state_dict())
            got = resumed
    assert lrs_got == lrs_want
    assert len(set(lrs_got)) > 1 or name == "ConstantLR"
