"""Top-down training of the single-person nets on the CPU, against the
benchmark's plain float32 reference (``gpubench/reference/sppe.py``); no
JAX (the JAX package cannot train these nets).

``HRNetSPPE`` with the published head (``heatmap_softmax=False``) at C=8,
one unit a stage, crops of 64x32 (a multiple of 32 in both dims, as the
backbone's four halvings need; 48 columns would not fuse), batch 4, gets the
reference's seeded weights (``gpubench/weights.py``); one
``sppe_train_step`` and one reference step on the same batch are held
against each other: the forward's heatmaps, the loss, each leaf's gradient,
the first BatchNorm's batch moments, the running statistics and one Adam
step. The same step in bf16 must miss the tolerances. Then the joints MSE
by hand, the person-crop dataset on a synthesized two-image COCO corpus,
one training step of ``bin/train_keypoints`` from the W48 yaml (tiny net),
the config's module and datamodule, the benchmark's top-down kind at a
tiny size, sound and with its step broken, and the BatchNorm backward
roofline's reader.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import cv2
import numpy as np
import pytest
import torch

from gpubench import harness, run
from gpubench.reference import sppe as ref_sppe
from gpubench.reference.train import Adam
from gpubench.tests import tiny
from gpubench.traffic.topdown_train import topdown_batch
from gpubench.weights import make_weights
from human_pose_tpu_torch.configs import KeypointsConfig
from human_pose_tpu_torch.data import coco_topdown
from human_pose_tpu_torch.data.coco_topdown import (
    CocoTopDownDataset, box_to_center_scale, collate_topdown,
)
from human_pose_tpu_torch.data.transforms import COCO_FLIP_INDEX
from human_pose_tpu_torch.models import HRNetSPPE
from human_pose_tpu_torch.train import (
    TrainState, accumulated_sppe_train_step, create_optimizer, joints_mse_loss, sppe_train_step,
)

ROOT = Path(__file__).resolve().parent.parent
ARCH = {"model": "HRNetSPPE", "C": 8, "num_kpts": 17, "num_blocks_per_stage": [1, 1, 1, 1],
        "num_units": 1}
HW, N, K, LR, SEED = (64, 32), 4, 17, 1e-3, 3
TINY_NET = dict(C=8, num_blocks_per_stage=(1, 1, 1, 1), num_units=1)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while this module runs: the suite's workers
    share the cores, where torch's default thread pool spins against
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def _port_step(spec, batch, dtype):
    """One ``sppe_train_step`` of the tiny net from the reference's weights:
    its output, the first BatchNorm's input, metrics, Adam's gradients (the
    first moment over 1 - beta1) and the state dict after the step."""
    net = HRNetSPPE(K, heatmap_softmax=False, device="cpu", **TINY_NET)
    net.load_state_dict(make_weights(spec, SEED, "cpu"), strict=True)
    state = TrainState.create(net, create_optimizer(net.parameters(), "Adam", LR), dtype=dtype,
                              device="cpu")
    seen = {}
    hooks = [net.register_forward_hook(lambda m, i, o: seen.update(out=o[0].detach().clone())),
             net.backbone.bn1.register_forward_hook(
                 lambda m, i, o: seen.update(bn1_x=i[0].detach().float().clone()))]
    _, metrics = sppe_train_step(state, batch, LR)
    for h in hooks:
        h.remove()
    opt = state.optimizer
    grads = {n: opt.state[p]["exp_avg"] / (1 - opt.param_groups[0]["betas"][0])
             for n, p in net.named_parameters()}
    return {**seen, "metrics": metrics, "grads": grads, "state": net.state_dict()}


@pytest.fixture(scope="module")
def steps():
    spec = ref_sppe.spec(ARCH, HW)
    batch = topdown_batch(torch.Generator().manual_seed(SEED), "cpu", N, HW, K,
                          {"sigma": 3.0, "visible": 0.8})
    ref_state = make_weights(spec, SEED, "cpu")
    ref = ref_sppe.train_steps(ARCH, ref_state, [batch], Adam(LR))
    return {"ref": ref, "ref_state": ref_state, "batch": batch,
            "f32": _port_step(spec, batch, torch.float32),
            "bf16": _port_step(spec, batch, torch.bfloat16)}


# Tolerances of the float32 step. The port and the reference compute the
# same float32 arithmetic in another order (the port's BatchNorm moments as
# E[x^2] - E[x]^2, its fused ReLUs, the loss's reductions), so they part
# by rounding: observed 1.5e-6 on the heatmaps, 7.5e-8 on the loss, 6.6e-6
# on the worst leaf's gradient, 0 on the first moments. A bf16 forward
# parts by 3e-2, 2.7e-3, 0.72 and 1.7e-3 there.
OUT_TOL = 1e-4  # relative L2 of the heatmaps: rounding through 20 conv/BN layers
LOSS_TOL = 1e-5  # relative: a mean of squares of those heatmaps
GRAD_TOL = 1e-3  # relative L2 a leaf: small leaves (BN shifts) amplify rounding
MOMENT_TOL = 1e-5  # relative L2: one conv's output, two reductions
RUNNING_TOL = 1e-5  # absolute: 0.1 of the batch moments moved in
# Adam's first step is lr * g / (|g| + 1e-8): the same sign of g gives the
# same step to lr * 1e-8 / |g| times g's relative error; where |g| < 1e-6 or
# the two gradients' signs differ (rounding can flip a near-zero gradient),
# the steps may differ by up to 2 lr
ADAM_TOL = 2e-5


def _errors(port, ref):
    x = port["bn1_x"]
    mean = x.mean((0, 2, 3))
    var = (x - mean[:, None, None]).square().mean((0, 2, 3))
    ref_mean, ref_var = ref["stats"]["backbone.bn1"]
    return {"out": _rel(port["out"], ref["out"][0]),
            "loss": abs(float(port["metrics"]["loss"]) - ref["loss"][0]) / ref["loss"][0],
            "grad": max(_rel(g, ref["first_gradient"][n]) for n, g in port["grads"].items()),
            "moments": max(_rel(mean, ref_mean), _rel(var, ref_var))}


def test_published_head_at_w48_and_its_default():
    """The published head at W48 has pose_hrnet's 63,595,745 parameters and
    the same state dict keys as the softmax head; the default (softmax
    over the joints, the JAX package's) is unchanged, and the flag off
    returns the 1x1 conv's output itself."""
    w48 = HRNetSPPE(K, C=48, heatmap_softmax=False, device="meta")
    assert sum(p.numel() for p in w48.parameters()) == 63_595_745
    assert w48.state_dict().keys() == HRNetSPPE(K, C=48, device="meta").state_dict().keys()
    torch.manual_seed(0)
    soft = HRNetSPPE(K, device="cpu", **TINY_NET).eval()
    raw = HRNetSPPE(K, heatmap_softmax=False, device="cpu", **TINY_NET).eval()
    raw.load_state_dict(soft.state_dict())
    x = torch.randn(2, 3, *HW)
    with torch.no_grad():
        (s,), (r,) = soft(x), raw(x)
        feats = raw.backbone(x)[0]
        assert torch.equal(r, raw.final_conv(feats))
    assert torch.allclose(s, torch.softmax(r, dim=1)) and torch.allclose(s.sum(1), torch.ones(1))
    assert r.shape == (2, K, HW[0] // 4, HW[1] // 4) and float(r.min()) < 0


def test_forward_and_loss_match_the_reference(steps):
    err = _errors(steps["f32"], steps["ref"])
    assert err["out"] <= OUT_TOL and err["loss"] <= LOSS_TOL, err
    assert set(steps["f32"]["metrics"]) == {"hm_0", "loss"}
    assert steps["ref"]["terms"]["hm_0"] == pytest.approx(steps["ref"]["loss"][0])


def test_gradients_match_the_reference_leaf_by_leaf(steps):
    port, ref = steps["f32"]["grads"], steps["ref"]["first_gradient"]
    assert port.keys() == ref.keys()
    worst = {n: _rel(g, ref[n]) for n, g in port.items()}
    assert max(worst.values()) <= GRAD_TOL, sorted(worst.items(), key=lambda kv: -kv[1])[:3]


def test_batch_moments_and_running_statistics_match_the_reference(steps):
    assert _errors(steps["f32"], steps["ref"])["moments"] <= MOMENT_TOL
    sd, ref = steps["f32"]["state"], steps["ref_state"]
    stats = [n for n in ref if n.endswith(("running_mean", "running_var"))]
    assert len(stats) == 2 * sum(1 for n in ref if n.endswith("running_mean")) > 0
    assert max(float((sd[n] - ref[n]).abs().max()) for n in stats) <= RUNNING_TOL


def test_one_adam_step_matches_the_reference(steps):
    sd, ref = steps["f32"]["state"], steps["ref_state"]
    port_g, ref_g = steps["f32"]["grads"], steps["ref"]["first_gradient"]
    held = total = 0
    for n, g in ref_g.items():
        same = (g.abs() >= 1e-6) & (port_g[n].abs() >= 1e-6) & (g.sign() == port_g[n].sign())
        gap = (sd[n] - ref[n]).abs()
        assert float(gap.max()) <= 2 * LR, n
        assert not same.any() or float(gap[same].max()) <= ADAM_TOL, n
        held, total = held + int(same.sum()), total + int((g.abs() >= 1e-6).sum())
    assert held > 0.99 * total


def test_a_bf16_step_misses_the_tolerances(steps):
    """The tolerances are tight enough that the step's bf16 forward (and
    backward) fails them."""
    err = _errors(steps["bf16"], steps["ref"])
    assert err["out"] > OUT_TOL and err["loss"] > LOSS_TOL and err["grad"] > GRAD_TOL
    assert err["moments"] > MOMENT_TOL


def test_accumulated_step_of_one_microbatch_is_the_step(steps):
    """``accumulated_sppe_train_step(1)`` is ``sppe_train_step``, bit for
    bit (the module's ``accumulate_grad_batches`` path)."""
    spec = ref_sppe.spec(ARCH, HW)
    got = []
    for step in (sppe_train_step, accumulated_sppe_train_step(1)):
        net = HRNetSPPE(K, heatmap_softmax=False, device="cpu", **TINY_NET)
        net.load_state_dict(make_weights(spec, SEED, "cpu"), strict=True)
        state = TrainState.create(net, create_optimizer(net.parameters(), "Adam", LR),
                                  device="cpu")
        _, metrics = step(state, steps["batch"], LR)
        got.append((metrics, net.state_dict()))
    (m1, sd1), (m2, sd2) = got
    assert set(m1) == set(m2) and all(torch.equal(m1[k], m2[k]) for k in m1)
    assert all(torch.equal(sd1[k], sd2[k]) for k in sd1)


def test_reference_recompute_is_the_same_step(steps):
    """The reference's recomputed stages (how the benchmark fits bs96 in
    float32) give the step it gives without them."""
    spec = ref_sppe.spec(ARCH, HW)
    state = make_weights(spec, SEED, "cpu")
    again = ref_sppe.train_steps(ARCH, state, [steps["batch"]], Adam(LR), recompute=True)
    ref = steps["ref"]
    assert again["loss"] == ref["loss"] and torch.equal(again["out"][0], ref["out"][0])
    assert all(torch.allclose(g, ref["first_gradient"][n], rtol=1e-5, atol=1e-9)
               for n, g in again["first_gradient"].items())
    assert all(torch.equal(state[n], steps["ref_state"][n]) for n in state
               if n.endswith("running_mean"))


def test_joints_mse_loss_by_hand():
    """0.5 * mean((w p - w t)^2) over N, K and the pixels: joint 1 has
    weight 0 and contributes nothing, whatever its prediction; a second
    stage adds its own term."""
    pred = torch.tensor([[[[1.0, 2.0]], [[3.0, 4.0]]]], requires_grad=True)  # [1, 2, 1, 2]
    target = torch.tensor([[[[0.0, 1.0]], [[5.0, 5.0]]]])
    weight = torch.tensor([[1.0, 0.0]])
    total, metrics = joints_mse_loss([pred], target, weight)
    assert float(total.detach()) == 0.5 * (1.0 + 1.0) / 4 == float(metrics["loss"].detach())
    assert float(metrics["hm_0"].detach()) == 0.25
    total.backward()
    assert torch.equal(pred.grad[0, 1], torch.zeros(1, 2))
    assert torch.allclose(pred.grad[0, 0], torch.tensor([[0.25, 0.25]]))
    other = pred.detach().clone()
    other[0, 1] += 100.0
    total2, m2 = joints_mse_loss([other, target.clone()], target, weight)
    assert float(m2["hm_0"]) == 0.25 and float(m2["hm_1"]) == 0.0 and float(total2) == 0.25


# -- the person-crop dataset ---------------------------------------------------------------

IMAGES = [(120, 100), (90, 140)]  # (h, w)


def _person(box, kpts, **kw):
    flat = [v for x, y, vis in kpts for v in (x, y, vis)]
    return {"category_id": 1, "iscrowd": 0, "area": float(box[2] * box[3]), "bbox": list(box),
            "keypoints": flat, "num_keypoints": sum(1 for *_, v in kpts if v > 0), **kw}


def make_corpus(root: Path) -> dict:
    """Two images, both splits: image 0 one person with every joint
    labelled inside its box, a crowd and a person without a labelled joint
    (both skipped); image 1 a person with joints 3-5 unlabelled and joint 16
    labelled far below its box (outside the crop)."""
    rng = np.random.RandomState(0)
    box0 = (30.0, 20.0, 40.0, 80.0)
    k0 = [(32 + 2 * k, 22 + 4 * k, 2) for k in range(K)]
    box1 = (50.0, 10.0, 60.0, 45.0)
    k1 = [(55 + 3 * k, 15 + 2 * k, 0 if k in (3, 4, 5) else 1) for k in range(K)]
    k1[16] = (60, 85, 2)
    anns = [_person(box0, k0), _person(box0, k0, iscrowd=1),
            _person(box0, [(0, 0, 0)] * K), _person(box1, k1)]
    for i, (a, img) in enumerate(zip(anns, [0, 0, 0, 1])):
        a.update(id=i + 1, image_id=img)
    images = [{"id": i, "file_name": f"{i:012d}.jpg", "height": h, "width": w}
              for i, (h, w) in enumerate(IMAGES)]
    (root / "annotations").mkdir(parents=True)
    for split in ("train2017", "val2017"):
        (root / "images" / split).mkdir(parents=True)
        for im, (h, w) in zip(images, IMAGES):
            cv2.imwrite(str(root / "images" / split / im["file_name"]),
                        (rng.rand(h, w, 3) * 255).astype(np.uint8))
        with open(root / "annotations" / f"person_keypoints_{split}.json", "w") as f:
            json.dump({"images": images, "annotations": anns}, f)
    return {"boxes": [box0, box1], "joints": [k0, k1]}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("coco")
    return root, make_corpus(root)


def test_box_to_center_scale_by_hand():
    """A 30x80 box at aspect 3:4 is widened to 60x80, in 200-px units, x1.25."""
    center, scale = box_to_center_scale((10, 20, 30, 80), 0.75)
    assert np.allclose(center, [25, 60]) and np.allclose(scale, [0.375, 0.5])
    _, scale = box_to_center_scale((10, 20, 90, 80), 0.75)
    assert np.allclose(scale, [90 / 200 * 1.25, 120 / 200 * 1.25])


def test_crops_of_the_gt_boxes(corpus):
    """One sample a person with a labelled joint; its box cleaned as the
    source's (x2 = x + w - 1 within the image); without augmentation the
    box's centre maps to the crop's and its padded height to the crop's
    height; heatmap peaks (1) at the labelled joints' rounded positions,
    target weight 0 for the unlabelled joints and the one off the map."""
    root, c = corpus
    ds = CocoTopDownDataset(str(root), "val2017", out_size=128, augment=False)
    assert len(ds) == 2 and ds.input_hw == (128, 96) and ds.hm_hw == (32, 24)
    for i, (box, kpts) in enumerate(zip(c["boxes"], c["joints"])):
        x, y, w, h = box
        assert ds.persons[i]["box"] == (x, y, w - 1, h - 1)
        img, trans, joints, vis = ds.crop(i)
        center, scale = box_to_center_scale(ds.persons[i]["box"], 0.75)
        assert np.allclose(trans @ [*center, 1.0], [48, 64], atol=1e-3)
        assert trans[1, 1] == pytest.approx(128 / (scale[1] * 200), rel=1e-5)
        crop, heatmaps, weight = ds[i]
        assert crop.shape == (128, 96, 3) and crop.dtype == np.uint8
        assert heatmaps.shape == (32, 24, K) and weight.shape == (K,)
        mapped = np.asarray(kpts, np.float64)[:, :2] @ trans[:, :2].T + trans[:, 2]
        for k in range(K):
            mu = (mapped[k] / 4 + 0.5).astype(int)
            on_map = kpts[k][2] > 0 and 0 <= mu[0] < 24 and 0 <= mu[1] < 32
            assert weight[k] == float(on_map), (i, k)
            if on_map:
                assert heatmaps[mu[1], mu[0], k] == 1.0 == heatmaps[..., k].max()
            else:
                assert not heatmaps[..., k].any()
    assert weight[[3, 4, 5, 16]].sum() == 0 and weight.sum() == K - 4


def test_flip_mirrors_the_crop_and_swaps_left_and_right(corpus, monkeypatch):
    """With the flip alone drawn (no scale, rotation or half body), a
    flipped sample's joint k sits at the mirror (w - x) of the unflipped
    sample's joint ``COCO_FLIP_INDEX[k]``, with its label."""
    root, _ = corpus
    for name in ("SCALE_FACTOR", "ROTATION_FACTOR", "PROB_HALF_BODY"):
        monkeypatch.setattr(coco_topdown, name, 0.0)
    plain = CocoTopDownDataset(str(root), "train2017", out_size=128, augment=False)
    aug = CocoTopDownDataset(str(root), "train2017", out_size=128, augment=True)
    _, t0, j0, v0 = plain.crop(1)
    base = j0 @ t0[:, :2].T + t0[:, 2]
    flipped = 0
    for seed in range(12):
        _, t, j, v = aug.crop(1, np.random.default_rng(seed))
        m = j @ t[:, :2].T + t[:, 2]
        if np.allclose(m, base, atol=1e-3):
            continue
        flipped += 1
        assert np.array_equal(v, v0[COCO_FLIP_INDEX])
        assert np.allclose(m[:, 0], 96 - base[COCO_FLIP_INDEX, 0], atol=1e-3)
        assert np.allclose(m[:, 1], base[COCO_FLIP_INDEX, 1], atol=1e-3)
    assert 0 < flipped < 12


def test_augmented_samples_follow_their_seed(corpus):
    root, _ = corpus
    ds = CocoTopDownDataset(str(root), "train2017", out_size=128)
    a = ds.__getitem__(0, np.random.default_rng(5))
    b = ds.__getitem__(0, np.random.default_rng(5))
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    batch = collate_topdown([a, b])
    assert batch["images"].shape == (2, 128, 96, 3) and batch["heatmaps"].shape == (2, 32, 24, K)
    assert batch["target_weight"].dtype == np.float32


# -- config, module and the CLI ------------------------------------------------------------

YAML = ROOT / "experiments" / "keypoints" / "hrnet_w48_384x288.yaml"
TINY_ARGV = ["--trainer.accelerator=cpu", "--net.params.C=8",
             "--net.params.num_blocks_per_stage=[1,1,1,1]", "--net.params.num_units=1",
             "--dataloader.train_ds.out_size=128", "--dataloader.val_ds.out_size=128",
             "--dataloader.batch_size=2", "--dataloader.num_workers=1"]


def _yaml_config(root, argv=()):
    ds = [f"--dataloader.{s}.root={root}" for s in ("train_ds", "val_ds")]
    return KeypointsConfig.from_dict(
        KeypointsConfig.from_yaml_to_dict(str(YAML), [*TINY_ARGV, *ds, *argv]))


def test_w48_yaml_builds_the_published_net():
    cfg = KeypointsConfig.from_dict(KeypointsConfig.from_yaml_to_dict(str(YAML), []))
    net = cfg.create_net(device="meta")
    assert isinstance(net, HRNetSPPE) and not net.heatmap_softmax
    assert sum(p.numel() for p in net.parameters()) == 63_595_745
    assert cfg.stage_resolutions() == (0.25,) and cfg.compute_dtype() == torch.bfloat16
    assert cfg.dataloader.batch_size == 24 and cfg.dataloader.train_ds.sigma == 3.0


def test_config_trains_the_yaml_through_the_top_down_step(corpus, monkeypatch):
    """The W48 yaml (tiny net, CPU): the top-down datamodule's batch through
    ``KeypointsModule``'s step (``sppe_train_step``: the parameters move,
    hm_0 and loss reported), its validation and ``make_results``."""
    from human_pose_tpu_torch.train import steps

    root, _ = corpus
    cfg = _yaml_config(root)
    dm = cfg.create_datamodule()
    assert len(dm.train_ds) == 2 and isinstance(dm.train_ds, CocoTopDownDataset)
    module = cfg.create_module()
    assert module.top_down and module.state.dtype == torch.float32
    called = []
    monkeypatch.setattr(steps, "_sppe_backward",
                        lambda s, b, f=steps._sppe_backward: called.append(1) or f(s, b))
    batch = next(iter(dm.train_dl))
    before = {n: p.detach().clone() for n, p in module.model.named_parameters()}
    metrics = module.training_step(batch)
    assert called and set(metrics) == {"hm_0", "loss"} and torch.isfinite(metrics["loss"])
    assert any(not torch.equal(p, before[n]) for n, p in module.model.named_parameters())
    val_metrics, out = module.validation_step(next(iter(dm.val_dl)))
    assert set(val_metrics) == {"hm_0", "loss"} and out[0].shape == (2, K, 32, 24)
    results = module.make_results(next(iter(dm.val_dl)), out)
    assert len(results) == 2 and results[0].kpts_coords.shape == (1, K, 2)
    assert results[0].kpts_heatmaps.shape == (128, 96, K)


def test_train_cli_takes_a_step_from_the_w48_yaml(corpus, tmp_path, monkeypatch):
    """``bin/train_keypoints`` from the W48 yaml (tiny net, one batch, one
    epoch, CPU): the step runs and the checkpoint is written."""
    from human_pose_tpu_torch.bin import train_keypoints

    root, _ = corpus
    monkeypatch.chdir(tmp_path)
    trainer = train_keypoints.main([
        f"--config={YAML}", *TINY_ARGV, f"--dataloader.train_ds.root={root}",
        f"--dataloader.val_ds.root={root}", "--trainer.max_epochs=1",
        "--trainer.limit_batches=1", "--trainer.async_ckpt=false"])
    assert trainer.module.state.step == 1
    assert list(Path(tmp_path, "results").glob("**/checkpoints/last.pt"))


# -- the benchmark's kind at a tiny size ---------------------------------------------------

CELL = "sppe_w48_train_bs96"


@pytest.fixture(scope="module")
def layout(tmp_path_factory):
    """``gpubench/tests/tiny.py``'s copy, with the top-down cell at 64x32,
    bs4."""
    root = tmp_path_factory.mktemp("tiny")
    lay = tiny.write(root)
    w = harness.load_json(harness.HERE / "workloads" / f"{CELL}.json")
    w["params"].update(batch=4, height=64, width=32, pool=4, trace_units=2)
    (root / "workloads" / f"{CELL}.json").write_text(json.dumps(w))
    return lay


def _args(seed=2**31 + 7):
    return argparse.Namespace(workload=CELL, seed=seed, seconds=0.3, trace=0)


def test_tiny_top_down_cell_is_correct(layout):
    rec = run.run(_args(), layout=layout, device=torch.device("cpu"))
    assert rec["correct"], rec["checks"]
    assert rec["attempted"] >= 1 and rec["failed"] == 0
    assert set(rec["metrics"]) == {"train_img_per_s", "peak_mem_gib", "setup_s"}


def _cut(x):
    if isinstance(x, dict):
        return {k: _cut(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_cut(v) for v in x)
    return x[: x.shape[0] // 2]


def _unchanged(state, batch, lr):
    state.model.train()
    return state, {"loss": torch.tensor(1.0)}


FAULTS = {
    "state_unchanged": ("sppe_train_step", lambda steps: _unchanged),
    "half_batch": ("sppe_train_step",
                   lambda steps: lambda s, b, lr, f=steps.sppe_train_step: f(s, _cut(b), lr)),
    "half_loss": ("_sppe_losses",
                  lambda steps: lambda out, b, f=steps._sppe_losses: f(_cut(out), _cut(b))),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_broken_top_down_step_is_not_correct(layout, monkeypatch, fault):
    from human_pose_tpu_torch.train import steps

    name, make = FAULTS[fault]
    monkeypatch.setattr(steps, name, make(steps))
    rec = run.run(_args(), layout=layout, device=torch.device("cpu"))
    assert not rec["correct"], rec["checks"]
    json.dumps(rec, allow_nan=False)


def test_bn_backward_roofline_reads_the_pair_against_its_bound(layout):
    """The reader: the bound of the step's BatchNorm layers at the cell's
    shapes (pose W32 bs36 at 512^2: 301 layers, 10.14 ms on the H100's
    50 MB L2, as PERF.md's row 7) over the traced time of the pair's
    kernels a step; nothing without a trace or without those kernels."""
    from gpubench import bn_bound
    from gpubench.trace import Trace

    pose = harness.Layout().cell("pose_w32_train_bs36")
    sizes = bn_bound.bn_elements(harness.arch_of(pose["config"]), (512, 512), 36)
    assert len(sizes) == 301
    assert bn_bound.step_bound_s(harness.arch_of(pose["config"]), (512, 512), 36) * 1e3 == \
        pytest.approx(10.143, abs=1e-3)
    ctx = harness.Context.make(pose, 1, 1.0, torch.device("cpu"))
    reader = layout.reader("bn_backward_roofline.train")
    assert reader.read(ctx) is None
    ops = [("void hp_batch_norm_backward_reduce<bf16>", 0.0101432, "other", 0.0),
           ("void hp_batch_norm_backward_apply<bf16>", 0.0101432, "other", 0.0),
           ("void cudnn_conv", 1.0, "other", 0.0)]
    ctx.trace = Trace(3.0, 1.0, ops, [], [], 0)
    assert reader.read(ctx) == pytest.approx(100 * 3 / 2, rel=1e-3)  # 3 traced units
    ctx.trace = Trace(3.0, 1.0, ops[2:], [], [], 0)
    assert reader.read(ctx) is None
