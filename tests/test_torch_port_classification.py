"""The port's ImageNet classification slice against the JAX package, on the CPU.

* the reduced ClassificationHRNet of tests/test_train_steps.py (C=8, one
  unit a stage, 13 classes) with the same random weights on both sides
  (``variables_to_torch``): the eval forward; the full W32's state-dict
  names and shapes against the bridge of JAX's ``eval_shape`` (41,232,680
  parameters, a strict load); the weights round trip;
* the loss and ``topk_error`` (tied logits included); one SGD step
  (nesterov, weight decay) with its losses, errors, gradients, BatchNorm
  statistics and parameters, the val step after it, the accumulated step at
  two microbatches, each against JAX's step as its step functions compose
  it; ``ClassificationModule`` on a collated host batch; ``chip_smoke``'s
  reduced-step check with the CPU in the card's place (float32 against
  float64 on float32's ReLU decisions, batch 8 and 4 at 64^2);
* the crops, flips and center crops bit for bit over seeds and raw sizes,
  the fallback branch included; the ImageFolder dataset and its collate;
* ``InferenceClassificationModel``'s probabilities; the eval CLI serial and
  batched against JAX's ``evaluate_split``; the inference CLI's plots;
* the train CLI on the CPU to FINISHED, its ``last.pt`` as a reduced
  HigherHRNet's pretrained weights; the inits and the config.

JAX compiles its gradients, its optimizer update, the val step and the
inference forward once each (module fixtures); the port runs on one torch
intra-op thread.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from human_pose_tpu.bin.eval_classification import evaluate_split as jax_evaluate_split
from human_pose_tpu.configs import base as jax_config_base
from human_pose_tpu.configs.classification import ClassificationConfig as JaxClassificationConfig
from human_pose_tpu.data import imagenet as jax_imagenet
from human_pose_tpu.data import transforms as jax_transforms
from human_pose_tpu.inference.models import InferenceClassificationModel as JaxInferenceModel
from human_pose_tpu.models import ClassificationHRNet as JaxClassificationHRNet
from human_pose_tpu.models import init_classification_weights as jax_init_classification_weights
from human_pose_tpu.train import TrainState as JaxTrainState
from human_pose_tpu.train import classification_loss as jax_classification_loss
from human_pose_tpu.train import classification_val_step as jax_val_step
from human_pose_tpu.train import create_optimizer as jax_create_optimizer
from human_pose_tpu.train import steps as jax_steps
from human_pose_tpu.train.module import ClassificationModule as JaxClassificationModule
from human_pose_tpu_torch.bin import eval_classification, inference_classification, train_classification
from human_pose_tpu_torch.configs import ClassificationConfig
from human_pose_tpu_torch.configs import base as config_base
from human_pose_tpu_torch.data import (
    ClassificationTransform, DataLoader, ImagenetClassificationDataset, center_crop,
    collate_classification, random_resized_crop, resize_short,
)
from human_pose_tpu_torch.inference import InferenceClassificationModel
from human_pose_tpu_torch.loggers.pylogger import log as port_log
from human_pose_tpu_torch.models import (
    ClassificationHRNet, HigherHRNet, init_classification_weights_, init_flax_default_,
)
from human_pose_tpu_torch.ops import prep_images
from human_pose_tpu_torch.train import (
    ClassificationModule, TrainState, accumulated_classification_train_step, checkpoint,
    classification_loss, classification_train_step, classification_val_step, create_optimizer,
    topk_error,
)
from human_pose_tpu_torch.utils import weights
from tests.test_data import make_imagenet_fixture
from tests.test_torch_port_models import SHALLOW, _randomize

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(num_blocks_per_stage=(1, 1, 1, 1), num_units=1)
N, S, NUM_CLASSES = 4, 32, 13
LR, MOMENTUM, WEIGHT_DECAY = 0.1, 0.9, 1e-4
W32_PARAMS = 41_232_680
# HigherHRNet's backbone parameters at C=8 with one unit a stage: every one
# is in a classification checkpoint under the same name and shape
SHALLOW_BACKBONE_TENSORS = 120


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's many small CPU ops while this
    module runs (the suite runs several workers on a few cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tensors(sd: dict) -> dict:
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _net(variables=None, num_classes: int = NUM_CLASSES) -> ClassificationHRNet:
    net = ClassificationHRNet(C=8, num_classes=num_classes, device="cpu", **TINY)
    if variables is not None:
        net.load_state_dict(_tensors(weights.variables_to_torch(variables)), strict=True)
    return net


@pytest.fixture(scope="module")
def setup():
    """JAX's reduced net with random weights and BN statistics (the
    classifier's kernel scaled to keep the logits within a few units), one
    seeded batch of uint8 NHWC images and labels."""
    model = JaxClassificationHRNet(C=8, num_classes=NUM_CLASSES, **TINY)
    template = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), np.zeros((1, S, S, 3), np.float32), train=False))
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), dict(template))
    rs = np.random.RandomState(0)
    variables = {col: _randomize(tree, rs) for col, tree in template.items()}
    variables["params"]["head"]["classifier"]["kernel"] *= np.float32(0.02)
    rs = np.random.RandomState(1)
    images = rs.randint(0, 256, (N, S, S, 3)).astype(np.uint8)
    labels = np.array([0, 5, 12, 5], np.int32)
    return model, variables, images, labels


def _jax_state(setup):
    model, variables, _, _ = setup
    v = jax.tree_util.tree_map(jnp.asarray, variables)
    tx = jax_create_optimizer("SGD", lr=LR, momentum=MOMENTUM, weight_decay=WEIGHT_DECAY,
                              nesterov=True)
    return JaxTrainState.create(model.apply, v["params"], v["batch_stats"], tx)


def _torch_state(setup):
    net = _net(setup[1])
    opt = create_optimizer(net.parameters(), "SGD", LR, momentum=MOMENTUM,
                           weight_decay=WEIGHT_DECAY, nesterov=True)
    return TrainState.create(net, opt, device="cpu")


def _torch_images(images: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(images.transpose(0, 3, 1, 2).copy())


@pytest.fixture(scope="module")
def jax_run(setup):
    """JAX's step on the batch, composed as ``classification_train_step_body``
    composes it (``_classification_grads``, then ``_update``), the val step
    after it, and the accumulated step on the batch twice over (eight
    images, two microbatches of four) composed as ``_accumulated_step``
    composes it (the BN statistics threaded through the microbatches, the
    gradients summed and divided by 2, one ``_update``, the metrics' mean):
    one compile each of the gradients, the update and the val step."""
    _, _, images, labels = setup
    grads_fn, update_fn = jax.jit(jax_steps._classification_grads), jax.jit(jax_steps._update)
    state = _jax_state(setup)
    grads, stats, metrics = grads_fn(state, jnp.asarray(images), jnp.asarray(labels))
    params, _ = update_fn(state, grads, LR)
    after = state.replace(params=params, batch_stats=stats, step=state.step + 1)
    val_metrics, logits = jax_val_step(after, jnp.asarray(images), jnp.asarray(labels))
    acc_stats, acc_grads, acc_metrics = state.batch_stats, None, []
    for mb in range(2):
        g, acc_stats, m = grads_fn(state.replace(batch_stats=acc_stats), jnp.asarray(images),
                                   jnp.asarray(np.roll(labels, mb)))
        acc_grads = g if acc_grads is None else jax.tree_util.tree_map(jnp.add, acc_grads, g)
        acc_metrics.append(_np_tree(m))
    acc_params, _ = update_fn(state, jax.tree_util.tree_map(lambda g: g / 2, acc_grads), LR)
    return {"grads": weights.variables_to_torch({"params": _np_tree(grads)}),
            "params": _np_tree(params), "batch_stats": _np_tree(stats),
            "metrics": _np_tree(metrics), "val_metrics": _np_tree(val_metrics),
            "val_logits": np.asarray(logits), "update": update_fn,
            "acc_params": _np_tree(acc_params), "acc_stats": _np_tree(acc_stats),
            "acc_metrics": {k: np.mean([m[k] for m in acc_metrics]) for k in acc_metrics[0]}}


def _accumulated_batch(setup):
    """The accumulated step's batch: the images twice, the labels rolled by
    one in the second half."""
    _, _, images, labels = setup
    return (_torch_images(np.concatenate([images, images])),
            torch.from_numpy(np.concatenate([labels, np.roll(labels, 1)])))


@pytest.fixture(scope="module")
def torch_run(setup):
    _, _, images, labels = setup
    state, metrics = classification_train_step(
        _torch_state(setup), _torch_images(images), torch.from_numpy(labels), LR)
    return state, metrics


def _assert_metrics(got: dict, want: dict, rtol: float = 1e-5):
    assert set(got) == set(want) == {"loss", "top-1_error", "top-5_error"}
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=rtol, atol=0)
    for key in ("top-1_error", "top-5_error"):
        assert float(got[key]) == pytest.approx(float(want[key]), abs=1e-7), key


# -- the model and its weights --------------------------------------------------------------

def test_forward_matches_jax(setup):
    """Eval-mode logits ``[N, 13]`` float32 of the uint8 batch (normalized
    on the device by ``prep_images``) within 1e-4 of the largest of JAX's
    (the frameworks sum the convolutions in other orders): JAX's val step
    on the unchanged weights, the same compile as ``jax_run``'s."""
    _, variables, images, labels = setup
    _, want = jax_val_step(_jax_state(setup), jnp.asarray(images), jnp.asarray(labels))
    want = np.asarray(want)
    with torch.no_grad():
        got = _net(variables).eval()(prep_images(_torch_images(images)))
    assert got.dtype == torch.float32 and tuple(got.shape) == (N, NUM_CLASSES)
    assert float(np.abs(got.numpy() - want).max()) <= 1e-4 * float(np.abs(want).max())


def test_w32_state_dict_matches_bridge():
    """Full W32 with 1000 classes: the port's state-dict names and shapes
    equal ``variables_to_torch`` of JAX's ``eval_shape`` (no forward), a
    strict load takes them, and both count 41,232,680 parameters."""
    shapes = jax.eval_shape(lambda: JaxClassificationHRNet().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
    template = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), dict(shapes))
    bridged = weights.variables_to_torch(template)
    net = ClassificationHRNet(device="cpu")
    sd = {k: tuple(v.shape) for k, v in net.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    assert sd == {k: tuple(v.shape) for k, v in bridged.items()}
    result = net.load_state_dict({k: torch.zeros(v.shape) for k, v in bridged.items()}, strict=False)
    assert not result.unexpected_keys
    assert all(k.endswith("num_batches_tracked") for k in result.missing_keys)
    assert sum(p.numel() for p in net.parameters()) == W32_PARAMS
    assert sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(shapes["params"])) == W32_PARAMS
    assert net.classification_head.classifier.weight.shape == (1000, 2048)


def test_weights_round_trip(setup):
    """flax tree -> torch state dict -> flax tree, bit for bit, the dense
    classifier's transpose and the head's biased convs included; through
    the port's module too."""
    _, variables, _, _ = setup
    sd = weights.variables_to_torch(variables)
    back = weights.variables_from_torch(sd, variables)
    via_net = weights.variables_from_torch(
        {k: v.numpy() for k, v in _net(variables).state_dict().items()}, variables)
    for tree in (back, via_net):
        for col in variables:
            flat_got = weights.variables_to_torch({"params": {}, col: tree[col]}) if col != "params" \
                else weights.variables_to_torch({"params": tree[col]})
            flat_want = weights.variables_to_torch({"params": {}, col: variables[col]}) \
                if col != "params" else weights.variables_to_torch({"params": variables[col]})
            assert flat_got.keys() == flat_want.keys()
            for key, value in flat_want.items():
                assert np.array_equal(flat_got[key], value), key
    kernel = variables["params"]["head"]["classifier"]["kernel"]
    assert np.array_equal(sd["classification_head.classifier.weight"], kernel.T)
    assert weights.torch_key_for(("head", "down2_conv")) == (
        "classification_head.downsample_blocks.2.0", "conv")


# -- loss, errors and steps -------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "ties", "few_classes"])
def test_loss_and_topk_error_match_jax(case):
    """``classification_loss`` within rel 1e-6; ``topk_error`` at k 1, 5
    (and k past the class count) equal JAX's ``lax.top_k`` rule: ties go to
    the lowest index."""
    rs = np.random.RandomState({"random": 0, "ties": 1, "few_classes": 2}[case])
    c = 3 if case == "few_classes" else 11
    logits = rs.randn(16, c).astype(np.float32) * 3
    if case == "ties":
        logits = np.round(logits / 3).astype(np.float32)  # a few distinct values a row
    labels = rs.randint(0, c, 16).astype(np.int32)
    got_loss = float(classification_loss(torch.from_numpy(logits), torch.from_numpy(labels)))
    want_loss = float(jax_classification_loss(jnp.asarray(logits), jnp.asarray(labels)))
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-6)
    for k in (1, 5, 20):
        got = float(topk_error(torch.from_numpy(logits), torch.from_numpy(labels), k))
        want = float(jax_steps.topk_error(jnp.asarray(logits), jnp.asarray(labels), k))
        assert got == want, (case, k)
    if case == "ties":
        tied = torch.tensor([[1.0, 2.0, 2.0, 2.0]])
        assert float(topk_error(tied, torch.tensor([1]), 1)) == 0.0
        assert float(topk_error(tied, torch.tensor([3]), 2)) == 1.0


def _grads_close(got: dict, want: dict, rtol: float = 5e-4) -> None:
    """Every gradient within ||got - want|| / ||want|| ``rtol``; a bias
    right before a train-mode BatchNorm has a zero gradient in exact
    arithmetic (the batch mean takes it out), so where ||want|| is below
    1e-6 of the whole gradient's norm both must be below that."""
    total = np.sqrt(sum(float(np.sum(w.astype(np.float64) ** 2)) for w in want.values()))
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        scale = np.linalg.norm(want[name])
        if scale < 1e-6 * total:
            assert np.linalg.norm(g) < 1e-6 * total, name
        else:
            assert np.linalg.norm(g - want[name]) <= rtol * scale, name


def _steps_close(sd: dict, before: dict, after: dict, rtol: float = 5e-4) -> None:
    """Each parameter's update (after - before) within ``rtol`` of JAX's."""
    for key, value in after.items():
        step_want, step_got = value - before[key], sd[key] - before[key]
        assert np.linalg.norm(step_got - step_want) <= rtol * np.linalg.norm(step_want), key


def test_train_step_matches_jax(setup, jax_run, torch_run):
    """One SGD step (momentum 0.9, nesterov, weight decay 1e-4, lr 0.1) of
    the reduced net at 32^2, batch 4: the loss within rel 1e-5 and the
    errors equal; every gradient within ||port - jax|| / ||jax|| 5e-4
    (``_grads_close``; measured 1.5e-4, as far as the port's float32 is
    from its float64); the BN running statistics within 1e-4 of each
    tensor's largest value; each parameter's update within 5e-4 of JAX's,
    and JAX's update from the port's own gradients within two float32 ulps
    of the port's parameters (``torch.optim.SGD`` is optax's chain)."""
    _, variables, _, _ = setup
    state, metrics = torch_run
    assert state.step == 1 and all(v.shape == () for v in metrics.values())
    _assert_metrics(metrics, jax_run["metrics"])
    grads = {name: p.grad.numpy() for name, p in state.model.named_parameters()}
    _grads_close(grads, jax_run["grads"])
    sd = {k: v.numpy() for k, v in state.model.state_dict().items()}
    stats = weights.variables_to_torch({"params": {}, "batch_stats": jax_run["batch_stats"]})
    for key, value in stats.items():
        assert np.abs(sd[key] - value).max() <= 1e-4 * np.abs(value).max(), key
    _steps_close(sd, weights.variables_to_torch(variables),
                 weights.variables_to_torch({"params": jax_run["params"]}))
    port_grads = weights.variables_from_torch(grads, {"params": variables["params"]})["params"]
    params, _ = jax_run["update"](_jax_state(setup), jax.tree_util.tree_map(jnp.asarray, port_grads), LR)
    for key, value in weights.variables_to_torch({"params": _np_tree(params)}).items():
        np.testing.assert_allclose(sd[key], value, rtol=2.4e-7, atol=2e-8, err_msg=key)


def test_val_step_matches_jax(setup, jax_run):
    """The val step from JAX's weights and statistics after its train step:
    metrics within rel 1e-5, logits within 1e-4 of their largest."""
    _, _, images, labels = setup
    state = _torch_state(setup)
    after = {"params": jax_run["params"], "batch_stats": jax_run["batch_stats"]}
    state.model.load_state_dict(_tensors(weights.variables_to_torch(after)), strict=False)
    metrics, logits = classification_val_step(state, _torch_images(images), torch.from_numpy(labels))
    _assert_metrics(metrics, jax_run["val_metrics"])
    want = jax_run["val_logits"]
    assert logits.dtype == torch.float32
    assert float(np.abs(logits.numpy() - want).max()) <= 1e-4 * float(np.abs(want).max())


def test_accumulated_step_matches_jax(setup, jax_run):
    """``accumulated_classification_train_step(2)`` on eight images: the
    averaged gradients' SGD update and the BN statistics carried through
    both microbatches in order, against JAX's (``jax_run``); metrics the
    microbatches' mean. The plain step's tolerances."""
    _, variables, _, _ = setup
    images, labels = _accumulated_batch(setup)
    state, metrics = accumulated_classification_train_step(2)(_torch_state(setup), images, labels, LR)
    assert state.step == 1
    _assert_metrics(metrics, jax_run["acc_metrics"])
    sd = {k: v.numpy() for k, v in state.model.state_dict().items()}
    for key, value in weights.variables_to_torch(
            {"params": {}, "batch_stats": jax_run["acc_stats"]}).items():
        assert np.abs(sd[key] - value).max() <= 1e-4 * np.abs(value).max(), key
    assert all(int(v) == 2 for k, v in sd.items() if k.endswith("num_batches_tracked"))
    _steps_close(sd, weights.variables_to_torch(variables),
                 weights.variables_to_torch({"params": jax_run["acc_params"]}))
    with pytest.raises(ValueError, match="not divisible"):
        accumulated_classification_train_step(3)(_torch_state(setup), images, labels, LR)


@pytest.mark.parametrize("batch_size", chip_smoke.CLS_REDUCED_BATCHES)
def test_reduced_step_check_on_relu_decisions(batch_size):
    """``chip_smoke.classification_step_card_vs_cpu`` with the CPU in the
    card's place (the yaml's SGD step of the reduced net at 64^2, 1000
    classes): the float32 gradients within 1e-3 a tensor of float64
    evaluated with float32's ReLU decisions, every decision that differs
    from float64's at an input within 1e-4 of its ReLU input's largest;
    two CPU steps that each record their ReLU inputs decide alike and
    equal."""
    out = chip_smoke.classification_step_card_vs_cpu(torch.device("cpu"), batch_size)
    assert out["batch"] == batch_size and out["relu"]["calls"] > 0
    assert out["grad_rel_max"] <= 1e-3 and out["cpu_grad_rel_max"] <= 1e-3
    assert out["relu"]["card_vs_cpu_differ"] == 0 and out["grad_rel_vs_cpu_max"] == 0.0
    for who in ("cpu", "card"):
        assert out["relu"][who]["differ_input_rel_max"] <= 1e-4


def test_module_steps_and_results(setup, torch_run):
    """``ClassificationModule`` on a collated channel-last host batch of
    uint8 images: its training step equals the bare step bit for bit (the
    module puts the batch on its device in NCHW); its validation step gives
    the logits; ``make_results`` keeps at most 8, softmaxes on the host as
    JAX's module does, and each result plots its top 5."""
    _, variables, images, labels = setup
    state, metrics = torch_run
    module = ClassificationModule.create(_net(), seed=3)
    assert isinstance(module.state.optimizer, torch.optim.SGD) and module.lr == 0.1
    module.state = _torch_state(setup)
    module.model = module.state.model
    batch = collate_classification(list(zip(images, labels)))
    got = module.training_step(batch)
    for key in metrics:
        assert torch.equal(got[key], metrics[key]), key
    for (name, p), q in zip(module.model.named_parameters(), state.model.parameters()):
        assert torch.equal(p, q), name
    val_metrics, logits = module.validation_step(batch)
    assert tuple(logits.shape) == (N, NUM_CLASSES) and set(val_metrics) == set(metrics)
    results = module.make_results(batch, logits, max_results=3)
    want = JaxClassificationModule.make_results(None, batch, np.asarray(logits), max_results=3)
    assert len(results) == 3
    for r, w in zip(results, want):
        np.testing.assert_allclose(r.probs, w.probs, rtol=1e-6, atol=1e-9)
        assert r.target == w.target and r.labels == w.labels
        assert np.array_equal(r.image, w.image)
        assert r.plot()["top_probs"].shape == (S, S, 3)
    assert len(module.make_results(batch, logits)) == N


# -- data ---------------------------------------------------------------------------------------

RAW_SIZES = [(375, 500), (500, 375), (333, 500), (500, 500), (4, 400), (61, 45)]


@pytest.mark.parametrize("hw", RAW_SIZES, ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_transforms_equal_jax(hw):
    """``train`` (random resized crop, flip; normalized and compact) and
    ``inference`` (short-side resize to size / 0.875, center crop) equal
    JAX's bit for bit over 12 seeds, with the generators left in the same
    state (the same draws). 4x400 never fits a crop: every call takes the
    center-crop fallback."""
    rs = np.random.RandomState(hw[0] * 1000 + hw[1])
    image = rs.randint(0, 256, (*hw, 3)).astype(np.uint8)
    for normalize in (True, False):
        got_t = ClassificationTransform(out_size=64, normalize=normalize)
        want_t = jax_transforms.ClassificationTransform(out_size=64, normalize=normalize)
        for seed in range(12):
            r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
            got, want = got_t.train(image, r1), want_t.train(image, r2)
            assert got.dtype == want.dtype and np.array_equal(got, want), (normalize, seed)
            assert r1.bit_generator.state == r2.bit_generator.state
        assert np.array_equal(got_t.inference(image), want_t.inference(image))
    if hw == (4, 400):
        crop = random_resized_crop(image, 32, np.random.default_rng(0))
        assert np.array_equal(crop, center_crop(resize_short(image, 32), 32))
    assert np.array_equal(resize_short(image, 37), jax_transforms.resize_short(image, 37))


def test_compact_transform_refuses_float():
    with pytest.raises(ValueError, match="uint8"):
        ClassificationTransform(out_size=32, normalize=False).inference(np.zeros((40, 40, 3), np.float32))


@pytest.fixture(scope="module")
def imagenet_root(tmp_path_factory):
    """A synthesized ImageFolder: ``train`` and ``val`` splits of 3 classes
    by 2 jpgs (80x80)."""
    root = tmp_path_factory.mktemp("imagenet")
    make_imagenet_fixture(root, n_classes=3, n_per=2, size=80, split="val")
    make_imagenet_fixture(root, n_classes=3, n_per=2, size=80, split="train")
    return root


@pytest.mark.parametrize("labels_yaml", [False, True])
def test_dataset_and_collate_equal_jax(imagenet_root, tmp_path, labels_yaml):
    """The ImageFolder dataset (samples, class order, wordnet labels with and
    without ``wordnet_labels.yaml``), its train samples under per-sample
    generators and a loader's collated batches equal JAX's bit for bit."""
    root = imagenet_root
    if labels_yaml:
        root = tmp_path / "imagenet"
        root.mkdir()
        (root / "val").symlink_to(imagenet_root / "val")
        (root / "wordnet_labels.yaml").write_text(yaml.safe_dump({"n00000001": "one"}))
    t = ClassificationTransform(out_size=48)
    jt = jax_transforms.ClassificationTransform(out_size=48)
    got = ImagenetClassificationDataset(str(root), "val", t.train)
    want = jax_imagenet.ImagenetClassificationDataset(str(root), "val", jt.train)
    assert got.samples == want.samples and got.idx_to_label == want.idx_to_label
    assert got.wnid_to_idx == want.wnid_to_idx and len(got) == 6
    for idx in range(len(got)):
        (gi, gl), (wi, wl) = got.__getitem__(idx, np.random.default_rng(idx)), \
            want.__getitem__(idx, np.random.default_rng(idx))
        assert gl == wl and gi.dtype == wi.dtype == np.float32 and np.array_equal(gi, wi)
    loader = DataLoader(got, 4, collate_classification, shuffle=True, drop_last=False,
                        num_workers=2, seed=5)
    batches = list(loader)
    assert [len(b["labels"]) for b in batches] == [4, 2]
    for b in batches:
        want_b = jax_imagenet.collate_classification([(img, int(lab)) for img, lab in zip(
            b["images"], b["labels"])])
        assert b["labels"].dtype == want_b["labels"].dtype == np.int32
        assert np.array_equal(b["images"], want_b["images"])
    if labels_yaml:
        assert got.idx_to_label[1] == "one"


# -- inference and the CLIs ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_inference(setup):
    """JAX's inference model on the shared weights at input size 64."""
    model, variables, _, _ = setup
    return JaxInferenceModel(model, jax.tree_util.tree_map(jnp.asarray, variables), input_size=64)


@pytest.mark.parametrize("compact", [False, True])
def test_inference_model_matches_jax(setup, jax_inference, compact):
    """``InferenceClassificationModel`` on two raw images: the model input
    equal to JAX's, the probabilities within 1e-5 of JAX's (normalized and
    compact uint8 inputs); a batch through ``probs`` equals the calls one by
    one within 1e-6."""
    _, variables, _, _ = setup
    model = InferenceClassificationModel(_net(variables).eval(), input_size=64,
                                         compact_inputs=compact, device="cpu")
    rs = np.random.RandomState(3)
    raws = [rs.randint(0, 256, hw + (3,)).astype(np.uint8) for hw in ((90, 120), (140, 80))]
    for raw in raws:
        got, want = model(raw, target=2), jax_inference(raw)
        want_image = want.image if not compact else jax_transforms.ClassificationTransform(
            out_size=64, normalize=False).inference(raw)
        assert np.array_equal(got.image, want_image)
        assert got.probs.dtype == np.float32 and got.probs.shape == (NUM_CLASSES,)
        assert float(np.abs(got.probs - np.asarray(want.probs)).max()) <= 1e-5
        assert got.target == 2 and got.plot()["top_probs"].shape == (64, 64, 3)
    xs = np.stack([model.transform.inference(r) for r in raws])
    batched = model.probs(model.to_device(xs)).numpy()
    assert np.abs(batched - np.stack([model(r).probs for r in raws])).max() <= 1e-6
    with pytest.raises(ValueError, match="dtype"):
        InferenceClassificationModel(_net(), dtype=torch.float16, device="cpu")


def _cfg_yaml(path: Path, root: Path, ckpt: str = "null", extra: str = "") -> str:
    path.write_text(f"""
setup: {{experiment_name: cls, architecture: ClassificationHRNet, seed: 4, pretrained_ckpt_path: null}}
trainer: {{accelerator: cpu, use_DDP: false, max_epochs: 1}}
dataloader:
  batch_size: 2
  num_workers: 1
  train_ds: {{root: {root}, split: train}}
  val_ds: {{root: {root}, split: val}}
transform: {{out_size: 64}}
net:
  params: {{C: 8, num_classes: {NUM_CLASSES}, num_blocks_per_stage: [1, 1, 1, 1], num_units: 1}}
inference: {{input_size: 64, ckpt_path: {ckpt}}}
{extra}""")
    return str(path)


def test_eval_cli_matches_jax(setup, jax_inference, imagenet_root, tmp_path, capsys):
    """``bin.eval_classification`` on 6 images with the shared weights (a
    ``.pt`` state dict): serial errors equal JAX's ``evaluate_split``, and
    ``--batch_size=4`` (one full batch and a padded tail) agrees with serial
    as tests/test_cli.py requires (at most one near-tied flip of 6)."""
    _, variables, _, _ = setup
    pt = tmp_path / "w.pt"
    torch.save(_tensors(weights.variables_to_torch(variables)), pt)
    cfg = _cfg_yaml(tmp_path / "cfg.yaml", imagenet_root, ckpt=str(pt))

    def run(extra):
        stats = eval_classification.main([f"--config={cfg}", *extra])
        assert eval(capsys.readouterr().out.strip().splitlines()[-1]) == stats
        return stats

    serial, batched = run([]), run(["--batch_size=4"])
    ds = jax_imagenet.ImagenetClassificationDataset(str(imagenet_root), "val")
    want = jax_evaluate_split(jax_inference, ds, len(ds))
    assert serial == want
    assert serial["n"] == batched["n"] == 6
    assert abs(serial["top1_error"] - batched["top1_error"]) <= 1 / 6 + 1e-9
    assert abs(serial["top5_error"] - batched["top5_error"]) <= 1 / 6 + 1e-9
    limited = eval_classification.main([f"--config={cfg}", "--limit=3", "--batch_size=2"])
    assert limited["n"] == 3


def test_inference_cli_writes_overlays(imagenet_root, tmp_path, monkeypatch):
    """``bin.inference_classification`` in both modes on the CPU (random
    weights, a warning): one top-5 overlay an image, named after it."""
    monkeypatch.chdir(tmp_path)
    cfg = _cfg_yaml(tmp_path / "cfg.yaml", imagenet_root)
    written = inference_classification.main([f"--config={cfg}", "--mode=val"])
    # the val split's first 8 (here 6) images; their names repeat across classes
    assert len(written) == 6 and {p.name for p in written} == {"img_0_top_probs.jpg", "img_1_top_probs.jpg"}
    assert all((tmp_path / p).is_file() for p in written)
    custom = inference_classification.main([f"--config={cfg}", "--mode=custom",
                                            f"--dirpath={imagenet_root / 'val' / 'n00000000'}"])
    assert [p.name for p in custom] == ["img_0_top_probs.jpg", "img_1_top_probs.jpg"]
    with pytest.raises(ValueError, match="dirpath"):
        inference_classification.main([f"--config={cfg}", "--mode=custom"])


def test_train_cli_and_pretrained_handoff(imagenet_root, tmp_path, monkeypatch):
    """``bin.train_classification`` on the CPU: one epoch (3 steps of 2) to
    FINISHED with best.pt and last.pt; that last.pt as a reduced
    HigherHRNet's pretrained weights (``load_params_partial``, what
    ``Trainer.fit`` calls for ``pretrained_ckpt_path``) loads every backbone
    parameter, 120 tensors, equal to the classifier's, and nothing else."""
    monkeypatch.chdir(tmp_path)
    cfg = _cfg_yaml(tmp_path / "cfg.yaml", imagenet_root)
    handlers = list(port_log.handlers)
    try:
        trainer = train_classification.main([f"--config={cfg}"])
    finally:
        for h in [h for h in port_log.handlers if h not in handlers]:
            port_log.removeHandler(h)
            h.close()
    run_dir = tmp_path / trainer.log_path
    assert json.loads((run_dir / "tracker" / "run.json").read_text())["status"] == "FINISHED"
    assert (run_dir / "checkpoints" / "best.pt").is_file() and trainer.current_step == 3
    assert isinstance(trainer.module, ClassificationModule)
    last = run_dir / "checkpoints" / "last.pt"
    saved = checkpoint.load_checkpoint(last)["module"]["model"]
    net = HigherHRNet(num_kpts=17, C=8, device="cpu", **SHALLOW)
    fresh = {k: v.clone() for k, v in net.state_dict().items()}
    assert checkpoint.load_params_partial(net, last) == SHALLOW_BACKBONE_TENSORS
    backbone = [n for n, _ in net.named_parameters() if n.startswith("backbone.")]
    assert len(backbone) == SHALLOW_BACKBONE_TENSORS
    for name, p in net.named_parameters():
        want = saved[name] if name.startswith("backbone.") else fresh[name]
        assert torch.equal(p.detach(), want), name


# -- inits and the config ----------------------------------------------------------------------

def test_linear_init_matches_flax_dense_default():
    """``init_flax_default_`` draws a Linear like flax's ``Dense`` default
    (truncated LeCun normal over ``in_features``, bias 0): the std of
    2048 x 1000 draws within 1% of JAX's and of 1/sqrt(2048), no value past
    the truncation; ``init_classification_weights_`` draws the classifier
    the same way."""
    from flax import linen as fnn

    kernel = np.asarray(fnn.Dense(1000).init(jax.random.PRNGKey(0), jnp.zeros((1, 2048)))
                        ["params"]["kernel"])
    want = 1 / np.sqrt(2048)
    limit = 2 * want / 0.87962566103423978
    assert abs(kernel.std() / want - 1) <= 0.01 and np.abs(kernel).max() <= limit * (1 + 1e-6)
    for init in (init_flax_default_, init_classification_weights_):
        lin = torch.nn.Linear(2048, 1000)
        init(lin, torch.Generator().manual_seed(1))
        w = lin.weight.detach().numpy()
        assert abs(w.std() / kernel.std() - 1) <= 0.01 and abs(w.std() / want - 1) <= 0.01
        assert np.abs(w).max() <= limit * (1 + 1e-6) and not lin.bias.any()


def test_classification_init_matches_jax_distribution(setup):
    """``init_classification_weights_``: every conv kernel of at least 4096
    values with std sqrt(2 / (kH kW out)) (fan_out) within 3% (the sampling
    noise of 4096 draws is 1.1%), and the head's three largest within 3% of
    the std JAX's ``init_classification_weights`` draws for them; conv
    biases 0, BN (1, 0)."""
    _, variables, _, _ = setup
    head = variables["params"]["head"]
    sub = {"head": {k: head[k] for k in ("final_conv", "down2_conv", "down1_conv")}}
    want = weights.variables_to_torch({"params": _np_tree(jax_init_classification_weights(
        jax.tree_util.tree_map(jnp.asarray, sub), jax.random.PRNGKey(0)))})
    want = {k: v for k, v in want.items() if k.endswith(".weight")}
    net = init_classification_weights_(_net(), torch.Generator().manual_seed(0))
    checked = 0
    for name, m in net.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            w = m.weight.detach().numpy()
            out, _, kh, kw = w.shape
            if w.size >= 4096:
                assert abs(w.std() / np.sqrt(2.0 / (kh * kw * out)) - 1) <= 0.03, name
                checked += 1
            if f"{name}.weight" in want:
                assert abs(w.std() / want[f"{name}.weight"].std() - 1) <= 0.03, name
            assert m.bias is None or not m.bias.any()
        elif isinstance(m, torch.nn.BatchNorm2d):
            assert bool((m.weight == 1).all()) and not m.bias.any()
    assert checked >= 10 and len(want) == 3


@pytest.mark.parametrize("overrides", [[], ["--trainer.accelerator=cpu", "--net.params.C=8",
                                             "--dataloader.batch_size=4", "--setup.seed=7"]])
def test_config_matches_jax(monkeypatch, tmp_path, overrides):
    """The yaml (and overrides) structure into the same ``to_dict()`` in
    both packages; ``compute_dtype`` bf16 for ``accelerator: tpu`` and the
    card as the target; a missing dataset gives a datamodule without loaders
    and a warning, as JAX's."""
    monkeypatch.setattr(config_base, "NOW", "2026-01-01_00-00-00")
    monkeypatch.setattr(jax_config_base, "NOW", "2026-01-01_00-00-00")
    path = str(ROOT / "experiments" / "classification" / "hrnet_32.yaml")
    got_dict = ClassificationConfig.from_yaml_to_dict(path, list(overrides))
    assert got_dict == JaxClassificationConfig.from_yaml_to_dict(path, list(overrides))
    got = ClassificationConfig.from_dict(got_dict)
    assert got.to_dict() == JaxClassificationConfig.from_dict(got_dict).to_dict()
    cpu = bool(overrides)
    assert got.compute_dtype() == (torch.float32 if cpu else torch.bfloat16)
    assert got.target_device() == ("cpu" if cpu else "cuda")
    monkeypatch.chdir(tmp_path)
    dm = got.create_datamodule()
    assert dm.train_dl is None and dm.val_dl is None


def test_config_factories(imagenet_root, tmp_path):
    """``create_datamodule`` (compact batches stay uint8), ``create_module``
    (the yaml's SGD with nesterov and weight decay, the classification
    init), ``create_inference_model`` with random weights (flax's default
    init, seed 0) and from the module's state dict."""
    cfg_path = _cfg_yaml(tmp_path / "cfg.yaml", imagenet_root, extra="""
module:
  optimizers: {optim: {name: SGD, params: {lr: 0.05, momentum: 0.9, weight_decay: 0.0001, nesterov: true}}}
""")
    cfg = ClassificationConfig.from_dict(ClassificationConfig.from_yaml_to_dict(
        cfg_path, ["--dataloader.compact_batches=true"]))
    dm = cfg.create_datamodule()
    batch = next(iter(dm.train_dl))
    assert batch["images"].dtype == np.uint8 and batch["images"].shape == (2, 64, 64, 3)
    assert len(dm.val_ds) == 6 and dm.val_dl.drop_last is False
    module = cfg.create_module()
    group = module.state.optimizer.param_groups[0]
    assert (group["lr"], group["momentum"], group["nesterov"], group["weight_decay"]) == \
        (0.05, 0.9, True, 1e-4)
    assert module.device == torch.device("cpu") and module.state.dtype == torch.float32
    model = cfg.create_inference_model()
    head = model.model.classification_head
    assert not model.model.training and not head.classifier.bias.any()
    assert abs(float(head.classifier.weight.detach().std()) * np.sqrt(2048) - 1) <= 0.05
    pt = tmp_path / "m.pt"
    torch.save(module.model.state_dict(), pt)
    loaded = cfg.create_inference_model(ckpt_path=str(pt))
    for key, value in module.model.state_dict().items():
        assert torch.equal(loaded.model.state_dict()[key], value), key
