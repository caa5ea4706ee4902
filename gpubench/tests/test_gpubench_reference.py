"""The plain reference held to the program on the CPU at small sizes: the
parameter names and shapes of both W32 networks, the seeded weights, the
forward (eval and train BatchNorm), the inference front end with and
without flip, the decode (exact), and training steps with Adam and SGD.
The tests import the program; the reference does not."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gpubench.reference import decode as ref_decode
from gpubench.reference import nets, pose, train
from gpubench.traffic.classification_train import classification_batch
from gpubench.traffic.keypoints_train import keypoints_batch
from gpubench.weights import TRUNCATED_STD, make_weights

CPU = torch.device("cpu")
POSE = {"model": "HigherHRNet", "C": 32, "num_kpts": 17}
CLS = {"model": "ClassificationHRNet", "C": 32, "num_classes": 1000}
SMALL = {"num_blocks_per_stage": (1, 1, 1, 1), "num_units": 1}
POSE_S = {**POSE, **SMALL, "C": 8, "num_deconv_resid_blocks": 1}
CLS_S = {**CLS, **SMALL, "C": 8, "num_classes": 10}


def port_model(arch: dict):
    from human_pose_tpu_torch.models import ClassificationHRNet, HigherHRNet

    kw = {k: arch[k] for k in ("num_blocks_per_stage", "num_units") if k in arch}
    if arch["model"] == "HigherHRNet":
        return HigherHRNet(num_kpts=arch["num_kpts"], C=arch["C"], device=CPU,
                           num_deconv_resid_blocks=arch.get("num_deconv_resid_blocks", 4), **kw)
    return ClassificationHRNet(C=arch["C"], num_classes=arch["num_classes"], device=CPU, **kw)


@pytest.mark.parametrize("arch,count", [(POSE, 28_645_331), (CLS, 41_232_680)],
                         ids=["higher_hrnet_w32", "cls_hrnet_w32"])
def test_spec_is_the_programs_state_dict(arch, count):
    sd = port_model(arch).state_dict()
    sp = nets.spec(arch, (64, 64))
    assert sorted(n for n, _, _ in sp) == sorted(sd) and len(sp) == len(sd)
    assert all(tuple(sd[n].shape) == s for n, s, _ in sp)
    kernels = ("bn_mean", "bn_var", "bn_count")
    assert sum(int(np.prod(s)) for _, s, k in sp if k not in kernels) == count


def test_weights_are_seeded_and_load_strictly():
    sp = nets.spec(POSE, (64, 64))
    a, b = make_weights(sp, 2**31 + 11, CPU), make_weights(sp, 2**31 + 11, CPU)
    assert all(torch.equal(a[n], b[n]) for n in a)
    other = make_weights(sp, 12, CPU)
    assert not torch.equal(a["backbone.conv1.weight"], other["backbone.conv1.weight"])
    port_model(POSE).load_state_dict(a, strict=True)
    w = a["backbone.stages.2.blocks.0.scales_blocks.0.0.conv1.weight"]  # 32 x 32 x 3 x 3
    assert w.abs().max() <= 2 / TRUNCATED_STD / (32 * 9) ** 0.5 + 1e-6
    assert float(w.std()) == pytest.approx((32 * 9) ** -0.5, rel=0.05)
    deconv = a["deconv_layers.0.deconv.0.weight"]  # 66 in, 32 out, 4 x 4
    assert float(deconv.std()) == pytest.approx((66 * 16) ** -0.5, rel=0.05)


def _loaded(arch, seed=5):
    w = make_weights(nets.spec(arch, (64, 64)), seed, CPU)
    m = port_model(arch)
    m.load_state_dict(w, strict=True)
    return m, w


@pytest.mark.parametrize("arch", [POSE_S, CLS_S], ids=["pose", "cls"])
@pytest.mark.parametrize("train_mode", [False, True], ids=["eval", "train"])
def test_forward_matches_the_program(arch, train_mode):
    m, w = _loaded(arch)
    m.train(train_mode)
    x = torch.randn(2, 3, 64, 96, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got = m(x)
        net = nets.Net(arch, w, train=train_mode)
        want = net(x)
    if arch["model"] == "HigherHRNet":
        pairs = list(zip(got[0], want[0])) + [(got[1], want[1])]
    else:
        pairs = [(got, want)]
    for g, r in pairs:
        torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-4 * float(r.abs().max()))
    if train_mode:
        sd = m.state_dict()
        for name, value in net.new_stats.items():
            torch.testing.assert_close(sd[name], value, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("flip", [False, True], ids=["plain", "flip"])
def test_front_end_matches_forward_scale(flip):
    from human_pose_tpu_torch.inference.models import InferenceKeypointsModel

    m, w = _loaded(POSE_S)
    m.eval()
    infer = InferenceKeypointsModel(m, use_flip=flip, compact_inputs=True, device=CPU)
    x = torch.randint(0, 256, (2, 3, 64, 128), dtype=torch.uint8,
                      generator=torch.Generator().manual_seed(1))
    avg, tags = infer.forward_scale(x, (64, 128))
    r_avg, r_tags = pose.maps(nets.Net(POSE_S, w), x, flip, (64, 128))
    torch.testing.assert_close(avg, r_avg, rtol=1e-4, atol=1e-4 * float(r_avg.abs().max()))
    assert len(tags) == len(r_tags) == (2 if flip else 1)
    for t, r in zip(tags, r_tags):
        torch.testing.assert_close(t, r, rtol=1e-4, atol=1e-4 * float(r.abs().max()))


@pytest.mark.parametrize("e", [1, 2])
@pytest.mark.parametrize("scale", [1.0, 1000.0], ids=["unit", "thousands"])
def test_decode_equals_the_programs(e, scale):
    from human_pose_tpu_torch.ops.decode import decode_batch

    g = torch.Generator().manual_seed(e)
    hm = torch.randn(2, 17, 48, 64, generator=g) * scale
    tags = [torch.randn(2, 17, 48, 64, generator=g) * scale for _ in range(e)]
    j, s, v = decode_batch([hm], tags, (48, 64), 30, 0.05, 0.5)
    for i in range(2):
        rj, rs, rv = ref_decode.decode(hm[i], torch.stack([t[i] for t in tags], 1), 30, 0.05, 0.5)
        np.testing.assert_array_equal(j[i].numpy(), rj)
        np.testing.assert_array_equal(v[i].numpy(), rv)
        np.testing.assert_allclose(s[i].numpy(), rs, rtol=1e-5)


def test_decode_falls_back_to_one_person():
    from human_pose_tpu_torch.ops.decode import decode_batch

    hm = -torch.rand(1, 17, 32, 32)  # nothing above det_thr
    tags = [torch.randn(1, 17, 32, 32)]
    j, s, v = decode_batch([hm], tags, (32, 32), 30, 0.05, 0.5)
    rj, rs, rv = ref_decode.decode(hm[0], tags[0][0][:, None], 30, 0.05, 0.5)
    np.testing.assert_array_equal(j[0].numpy(), rj)
    np.testing.assert_array_equal(v[0].numpy(), rv)


def test_hungarian_is_optimal_on_small_problems():
    from scipy.optimize import linear_sum_assignment

    rng = np.random.default_rng(0)
    for _ in range(20):
        c = rng.integers(-5, 5, (6, 6)).astype(np.float32)
        col = ref_decode.hungarian(c, 6)
        r, cc = linear_sum_assignment(c)
        assert c[np.arange(6), col].sum() == c[r, cc].sum()


def _port_steps(arch, weights, batches, opt):
    from human_pose_tpu_torch.train import steps
    from human_pose_tpu_torch.train.optim import create_optimizer
    from human_pose_tpu_torch.train.state import TrainState

    m = port_model(arch)
    m.load_state_dict(weights, strict=True)
    kw = dict(opt)
    lr, name = kw.pop("lr"), kw.pop("name")
    state = TrainState.create(m, create_optimizer(m.parameters(), name, lr, **kw), device=CPU)
    losses = []
    for b in batches:
        if arch["model"] == "HigherHRNet":
            losses.append(float(steps.keypoints_train_step(state, b, lr)[1]["loss"]))
        else:
            losses.append(float(steps.classification_train_step(
                state, b["images"], b["labels"], lr)[1]["loss"]))
    return losses, state


def _median_norm(leaves: dict) -> float:
    """The median leaf's norm: the floor a leaf's error is held against,
    since a leaf whose gradient is nought (a biased conv before BatchNorm)
    reads rounding alone."""
    return float(torch.tensor([float(v.norm()) for v in leaves.values()]).median())


def _batches(arch, n):
    g = torch.Generator().manual_seed(3)
    params = {"max_people": 30, "sigma": 2.0, "visible": 0.8, "crowd": 0.5}
    return [keypoints_batch(g, CPU, 2, 64, 17, params) if arch["model"] == "HigherHRNet"
            else classification_batch(g, CPU, 2, 64, 10) for _ in range(n)]


def test_adam_step_matches_the_programs():
    """One keypoints step: the loss, the gradient Adam took in (its first
    moment over 1 - beta1) and the BatchNorm running statistics. Later
    steps are not compared here: Adam moves a leaf whose gradient is nought
    to rounding by a full step of either sign."""
    opt = {"name": "Adam", "lr": 1e-3}
    batches = _batches(POSE_S, 1)
    w = make_weights(nets.spec(POSE_S, (64, 64)), 9, CPU)
    losses, st = _port_steps(POSE_S, {k: v.clone() for k, v in w.items()}, batches, opt)
    state = dict(w)
    ref = train.train_steps(POSE_S, state, batches, train.make_optimizer(opt))
    np.testing.assert_allclose(losses, ref["loss"], rtol=1e-5)
    med = _median_norm(ref["first_gradient"])
    for name, p in st.model.named_parameters():
        g = st.optimizer.state[p]["exp_avg"] / 0.1
        r = ref["first_gradient"][name]
        assert float((g - r).norm()) <= 1e-4 * max(float(r.norm()), med), name
    sd = st.model.state_dict()
    for name, value in state.items():
        if name.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(sd[name], value, rtol=1e-5, atol=1e-6, msg=name)


def test_sgd_steps_match_the_programs():
    """A classification step with Nesterov momentum and weight decay: the
    loss, the gradient SGD took in (its momentum buffer) and every
    parameter and statistic after it. (A second step is not compared: at
    batch 2 the last stage's BatchNorm normalizes 8 values a channel and
    carries the first update's rounding far into the next loss.)"""
    opt = {"name": "SGD", "lr": 0.01, "momentum": 0.9, "weight_decay": 1e-4, "nesterov": True}
    batches = _batches(CLS_S, 1)
    w = make_weights(nets.spec(CLS_S, (64, 64)), 9, CPU)
    losses, st = _port_steps(CLS_S, {k: v.clone() for k, v in w.items()}, batches, opt)
    state = dict(w)
    ref = train.train_steps(CLS_S, state, batches, train.make_optimizer(opt))
    np.testing.assert_allclose(losses, ref["loss"], rtol=1e-5)
    med = _median_norm(ref["first_gradient"])
    for name, p in st.model.named_parameters():
        g, r = st.optimizer.state[p]["momentum_buffer"], ref["first_gradient"][name]
        assert float((g - r).norm()) <= 1e-4 * max(float(r.norm()), med), name
    sd = st.model.state_dict()
    for name, value in state.items():
        if value.is_floating_point():
            torch.testing.assert_close(sd[name], value, rtol=1e-4, atol=1e-6, msg=name)


def test_keypoints_batch_is_seeded_and_well_formed():
    params = {"max_people": 30, "sigma": 2.0, "visible": 0.8, "crowd": 1.0}
    a = keypoints_batch(torch.Generator().manual_seed(4), CPU, 3, 64, 17, params)
    b = keypoints_batch(torch.Generator().manual_seed(4), CPU, 3, 64, 17, params)
    assert all(torch.equal(a[k], b[k]) for k in ("images", "joints"))
    assert a["joints"].shape == (3, 30, 17, 3) and a["joints"].dtype == torch.int32
    assert [h.shape[-1] for h in a["heatmaps"]] == [16, 32]
    assert float(a["heatmaps"][0].max()) == pytest.approx(1.0)
    assert all(float(m.min()) == 0.0 for m in a["masks"])  # a crowd region in each image
