"""The port's model zoo vs the JAX package's.

Small nets (HRNetSPPE at C=8 with one block and unit a stage,
SimpleBaseline and ResNet at resnet18, the hourglasses with one stage) get
numpy-seeded flax variables (kernels at std 1/sqrt(fan_in), so activations
stay near unit scale), carried to the port by the weights bridge; inputs are
seeded too. Each forward matches JAX's ``apply`` in float32 within 1e-4 of
the output's scale (the frameworks sum convolutions in other orders);
``sppe_parse`` is exact, ties included; the SPPE inference model's joints
are equal and its heatmaps within 1e-4, on plain and compact inputs; the AE
hourglass through ``InferenceKeypointsModel`` matches at the level of
decisions (``assert_decisions_match``). Full-size parameter counts against
JAX's ``eval_shape``; the bridge both ways and the flat npz bit for bit; a
torchvision-layout state dict (``chip_smoke.torchvision_resnet_state_dict``,
named and shaped from torchvision's scheme); configs, refusals, MPII and
PCKh.
"""

from __future__ import annotations

import functools
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from human_pose_tpu.configs.keypoints import KeypointsConfig as JaxKeypointsConfig
from human_pose_tpu.data.mpii import MpiiKeypointsDataset as JaxMpii
from human_pose_tpu.inference import InferenceKeypointsModel as JaxInferenceKeypointsModel
from human_pose_tpu.inference.models import InferenceSPPEModel as JaxInferenceSPPEModel
from human_pose_tpu.metrics.pckh import pckh as jax_pckh
from human_pose_tpu.models import hrnet as jax_hrnet
from human_pose_tpu.models import AEHourglassNet as JaxAEHourglassNet
from human_pose_tpu.models import HigherHRNet as JaxHigherHRNet
from human_pose_tpu.models import HourglassNet as JaxHourglassNet
from human_pose_tpu.models import HRNetSPPE as JaxHRNetSPPE
from human_pose_tpu.models import ResNet as JaxResNet
from human_pose_tpu.models import SimpleBaseline as JaxSimpleBaseline
from human_pose_tpu.ops.sppe import sppe_parse as jax_sppe_parse
from human_pose_tpu.utils.export import export_weights_npz as jax_export_weights_npz
from human_pose_tpu.utils.torch_interop import (
    resnet_variables_from_torchvision as jax_resnet_variables_from_torchvision,
)
from human_pose_tpu_torch.configs import KeypointsConfig
from human_pose_tpu_torch.data import MpiiKeypointsDataset
from human_pose_tpu_torch.inference import (
    BatchedKeypointsEvaluator, BatchedKeypointsPredictor, InferenceKeypointsModel,
    InferenceSPPEModel,
)
from human_pose_tpu_torch.metrics import pckh
from human_pose_tpu_torch.models import (
    AEHourglassNet, HourglassNet, HRNetSPPE, ResNet, SEBlock, SimpleBaseline,
    init_flax_default_, init_keypoints_weights_,
)
from human_pose_tpu_torch.ops import sppe_parse
from human_pose_tpu_torch.utils import (
    export_weights_npz, load_flax_npz, load_torchvision_backbone,
    resnet_variables_from_torchvision, variables_from_state_dict, variables_from_torch,
    variables_to_torch,
)
from chip_smoke import torchvision_resnet_state_dict
from tests.jax_reference import light_jax_reference  # noqa: F401  (module fixture)
from tests.test_torch_port_inference import assert_decisions_match

TINY_HRNET = dict(C=8, num_blocks_per_stage=(1, 1, 1, 1), num_units=1)
# name -> (JAX model, port model on a device)
ZOO = {
    "hrnet_sppe": (lambda: JaxHRNetSPPE(num_keypoints=17, **TINY_HRNET),
                   lambda d: HRNetSPPE(17, **TINY_HRNET, device=d)),
    "simple_baseline": (lambda: JaxSimpleBaseline(17, "resnet18"),
                        lambda d: SimpleBaseline(17, "resnet18", device=d)),
    "ae_hourglass": (lambda: JaxAEHourglassNet(17, 1), lambda d: AEHourglassNet(17, 1, device=d)),
    "hourglass": (lambda: JaxHourglassNet(16, 1), lambda d: HourglassNet(16, 1, device=d)),
}
FORWARD_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def plain_jax_hrnet_sppe():
    """JAX's ``HRNetSPPE`` builds its backbone in the space-to-depth layout
    (``s2d``, a TPU lane packing of the same parameters and forward), which
    traces and compiles several times slower on the CPU; in this module it
    builds the plain layout, as the other port tests build JAX's
    HigherHRNet (``s2d=False``)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_hrnet, "HRNetBackbone", functools.partial(jax_hrnet.HRNetBackbone, s2d=False))
        yield


def _meta(make):
    """The port's net from ``make(device)`` on the meta device, its modules
    created there (no default init on the CPU)."""
    with torch.device("meta"):
        return make("meta")


def _cpu(make):
    """The port's net from ``make(device)``, built on the meta device and
    given uninitialized CPU storage: every test here loads its weights."""
    return _meta(make).to_empty(device="cpu")


def _randomize(tree: dict, rs: np.random.RandomState) -> dict:
    """Seeded values for every leaf: kernels at std 1/sqrt(fan_in), biases,
    BN scales, offsets and means near (1, 0), variances in [0.5, 1.5)."""
    def leaf(name, shape):
        if name == "kernel":
            return rs.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        if name in ("scale", "var"):
            return 1.0 + (0.2 * rs.randn(*shape) if name == "scale" else rs.rand(*shape) - 0.5)
        return 0.1 * rs.randn(*shape)

    return {k: _randomize(v, rs) if isinstance(v, dict) else leaf(k, v.shape).astype(np.float32)
            for k, v in tree.items()}


def _tensors(sd: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.fixture(scope="module")
def zoo():
    """name -> (JAX model, seeded flax variables, the port's net with them).
    The flax tree's names and shapes come from the port's state dict
    through the bridge (``variables_from_state_dict``); flax's ``apply``
    refuses a tree that misses a variable or has a wrong shape, and
    ``test_full_size_trees_match_jax`` holds the full-size trees against
    JAX's ``eval_shape`` leaf for leaf."""
    cache = {}

    def get(name):
        if name not in cache:
            make_jax, make_port = ZOO[name]
            net = _cpu(make_port).eval()
            template = variables_from_state_dict(net.state_dict())
            rs = np.random.RandomState(sorted(ZOO).index(name))
            variables = {col: _randomize(tree, rs) for col, tree in template.items()}
            net.load_state_dict(_tensors(variables_to_torch(variables)), strict=False)
            cache[name] = make_jax(), variables, net
        return cache[name]
    return get


def _flat(out) -> list:
    if isinstance(out, (list, tuple)):
        return [a for o in out for a in _flat(o)]
    return [out]


@pytest.mark.parametrize("name", list(ZOO))
def test_forward_matches_jax(zoo, name):
    """float32 forward on the CPU vs flax's ``apply``: every output (each
    stage, the tags) within 1e-4 of its scale (ResNet with its logits:
    ``test_torchvision_state_dict_loads_strictly``)."""
    model, variables, net = zoo(name)
    _assert_forward_matches(model, variables, net)


def _assert_forward_matches(model, variables, net):
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    want = _flat(jax.jit(functools.partial(model.apply, train=False))(variables, x))
    with torch.no_grad():
        got = _flat(net(_nchw(x)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        w = w.transpose(0, 3, 1, 2) if w.ndim == 4 else w
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        err = np.abs(g.numpy() - w).max() / max(np.abs(w).max(), 1.0)
        assert err < FORWARD_TOL, (type(net).__name__, err)


FULL_SIZE = {
    "AEHourglassNet": (lambda: JaxAEHourglassNet(17, 2),
                       lambda d: AEHourglassNet(17, 2, device=d), 6_795_396),
    "HourglassNet": (lambda: JaxHourglassNet(16, 2), lambda d: HourglassNet(16, 2, device=d),
                     6_785_632),
    "SimpleBaseline-R50": (lambda: JaxSimpleBaseline(17, "resnet50"),
                           lambda d: SimpleBaseline(17, "resnet50", device=d), 33_999_697),
    "HRNetSPPE-W32": (lambda: JaxHRNetSPPE(17, 32), lambda d: HRNetSPPE(17, 32, device=d),
                      28_536_113),
    "ResNet50-fc": (lambda: JaxResNet("resnet50", num_classes=1000),
                    lambda d: ResNet("resnet50", 1000, device=d), 25_557_032),
}


def _leaf_shapes(tree: dict, path=()) -> dict:
    out = {}
    for k, v in tree.items():
        out.update(_leaf_shapes(v, path + (k,)) if isinstance(v, dict)
                   else {"/".join(path + (k,)): tuple(v.shape)})
    return out


@pytest.mark.parametrize("name", list(FULL_SIZE))
def test_full_size_trees_match_jax(name):
    """At full size, the port's state dict read as a flax tree through the
    bridge has JAX's ``eval_shape`` tree exactly (every path and shape,
    parameters and BN statistics), so the parameter counts of the issue's
    table agree too."""
    make_jax, make_port, count = FULL_SIZE[name]
    model = make_jax()
    want = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                             np.zeros((1, 64, 64, 3), np.float32), train=False))
    net = _meta(make_port)
    # zero-strided host arrays of the state dict's shapes for the bridge
    got = variables_from_state_dict({k: np.broadcast_to(np.float32(0), v.shape)
                                     for k, v in net.state_dict().items()})
    assert _leaf_shapes(got) == _leaf_shapes(dict(want))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(want["params"]))
    assert sum(p.numel() for p in net.parameters()) == n_jax == count


def _assert_trees_equal(got: dict, want: dict, path=()):
    assert got.keys() == want.keys(), path
    for key, value in want.items():
        if isinstance(value, dict):
            _assert_trees_equal(got[key], value, path + (key,))
        else:
            value = np.asarray(value)
            assert got[key].dtype == value.dtype and got[key].shape == value.shape, path + (key,)
            np.testing.assert_array_equal(got[key], value, err_msg="/".join(path + (key,)))


@pytest.mark.parametrize("name", list(ZOO))
def test_bridge_round_trip_and_npz(zoo, name, tmp_path):
    """flax tree -> state dict -> flax tree, with and without the template,
    gives back every leaf; the flat npz JAX writes loads into the port's net
    strictly and the port writes the same file back, bit for bit."""
    _, variables, net = zoo(name)
    sd = {f"module.{k}": v for k, v in net.state_dict().items()}
    _assert_trees_equal(variables_from_torch(sd, variables), variables)
    _assert_trees_equal(variables_from_state_dict(sd), variables)
    jax_export_weights_npz(variables, tmp_path / "jax.npz")
    fresh = _cpu(ZOO[name][1])
    result = fresh.load_state_dict(_tensors(load_flax_npz(tmp_path / "jax.npz")), strict=False)
    assert not result.unexpected_keys
    assert all(k.endswith("num_batches_tracked") for k in result.missing_keys)
    export_weights_npz(fresh, tmp_path / "port.npz")
    with np.load(tmp_path / "jax.npz") as want, np.load(tmp_path / "port.npz") as got:
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_sppe_parse_matches_jax_with_ties():
    rs = np.random.RandomState(3)
    maps = rs.randn(2, 5, 7, 9).astype(np.float32)  # NHWC, K = 9
    maps[0, :, :, 0] = 0.0  # every pixel ties: the first, (0, 0)
    maps[0, 4, 1, 1] = maps[0, 1, 5, 1] = 9.0  # row-major first: (x 5, y 1)
    maps[1, 2, :, 2] = 9.0  # a tied row: x 0
    maps[1, :, 6, 3] = 9.0  # a tied column: y 0
    want = np.asarray(jax_sppe_parse(maps))
    got = sppe_parse(_nchw(maps)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 1, 9, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 0, 0], [0, 0, 0])
    np.testing.assert_array_equal(got[0, 0, 1], [5, 1, 9])
    np.testing.assert_array_equal(got[1, 0, 2, :2], [0, 2])
    np.testing.assert_array_equal(got[1, 0, 3, :2], [6, 0])


def _raw(h, w, seed):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


@pytest.mark.parametrize("compact", [False, True], ids=["plain", "compact"])
def test_sppe_inference_matches_jax(zoo, compact):
    """The single-person model on one raw image: the same joints (argmax
    decisions), heatmaps within 1e-4, the zero tag column, valid one person;
    plain float inputs and compact uint8 ones."""
    model, variables, net = zoo("simple_baseline")
    raw = _raw(90, 70, 4)
    want = JaxInferenceSPPEModel(model, variables, input_size=64, compact_inputs=compact)(raw)
    im = InferenceSPPEModel(net, input_size=64, compact_inputs=compact, device="cpu")
    got = im(raw)
    assert im.model_input_shape == tuple(want.model_input_image.shape[:2])
    assert got.kpts_coords.shape == want.kpts_coords.shape == (1, 17, 2)
    np.testing.assert_array_equal(got.kpts_coords, want.kpts_coords)
    np.testing.assert_allclose(got.kpts_scores, want.kpts_scores, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.obj_scores, want.obj_scores, rtol=1e-4, atol=1e-4)
    assert got.kpts_heatmaps.shape == want.kpts_heatmaps.shape
    assert np.abs(got.kpts_heatmaps - want.kpts_heatmaps).max() < 1e-4
    assert got.tags_heatmaps.shape == want.tags_heatmaps.shape and not got.tags_heatmaps.any()
    assert got.kpts_tags.shape == want.kpts_tags.shape and not got.kpts_tags.any()
    np.testing.assert_array_equal(got.model_input_image, want.model_input_image)


def test_ae_hourglass_inference_decisions_match_jax(zoo):
    """``InferenceKeypointsModel`` on the AE hourglass with flip: the AE
    decode of the port (the kernels' plain versions on the CPU) against
    JAX's, at the level of decisions."""
    model, variables, net = zoo("ae_hourglass")
    kw = dict(det_thr=0.1, tag_thr=1.0, use_flip=True, input_size=64, max_num_people=5)
    jax_im = JaxInferenceKeypointsModel(model, variables, **kw)
    port_im = InferenceKeypointsModel(net, **kw, device="cpu")
    raws = [_raw(80, 96, 5), _raw(80, 96, 6)]  # one shape: one JAX compile
    assert_decisions_match("flip", [(jax_im(r), port_im(r)) for r in raws], jax_im, port_im)


@pytest.mark.parametrize("variant", ["resnet18", "resnet50"])
def test_torchvision_state_dict_loads_strictly(variant):
    """A torchvision-layout state dict: the same flax tree as JAX's
    ``resnet_variables_from_torchvision``, a strict load into ``ResNet``
    (fc kept) and, for resnet18, its forward with its float32 logits vs
    JAX's ResNet on JAX's tree and a load into ``SimpleBaseline``'s
    backbone (fc dropped); refusals of a missing key and a wrong shape."""
    sd = torchvision_resnet_state_dict(variant, np.random.default_rng(8), num_classes=10)
    want = jax_resnet_variables_from_torchvision(sd)
    _assert_trees_equal(resnet_variables_from_torchvision(sd), want)

    net = load_torchvision_backbone(_cpu(lambda d: ResNet(variant, 10, device=d)), sd, module=None)
    loaded = net.state_dict()
    assert loaded.keys() == sd.keys()
    for key, value in sd.items():
        if not key.endswith("num_batches_tracked"):
            assert torch.equal(loaded[key], value), key
    if variant == "resnet18":
        _assert_forward_matches(JaxResNet(variant, num_classes=10), want, net.eval())
        pose = load_torchvision_backbone(_cpu(lambda d: SimpleBaseline(17, variant, device=d)), sd)
        back = variables_from_state_dict(pose.state_dict())
        want["params"].pop("fc")
        _assert_trees_equal({col: back[col]["backbone"] for col in want}, want)

    with pytest.raises(KeyError, match="missing"):
        load_torchvision_backbone(_meta(lambda d: ResNet(variant, device=d)), {
            k: v for k, v in sd.items() if k != "layer1.0.conv1.weight"}, module=None)
    bad = dict(sd, **{"conv1.weight": np.zeros((64, 3, 3, 3), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        load_torchvision_backbone(_meta(lambda d: ResNet(variant, device=d)), bad, module=None)


def test_se_block_and_inits_cover_every_leaf():
    """``SEBlock`` (mean, fc1, ReLU, fc2, sigmoid) vs flax's, and both
    seeded inits draw every new leaf: conv and deconv kernels, SEBlock's
    Linears as flax's Dense default (the JAX keypoints init leaves 2-D
    kernels), biases zero."""
    from human_pose_tpu.models import SEBlock as JaxSEBlock

    x = np.random.RandomState(2).randn(2, 4, 4, 32).astype(np.float32)
    jax_se = JaxSEBlock()
    variables = {"params": _randomize(
        jax.eval_shape(lambda: jax_se.init(jax.random.PRNGKey(0), x))["params"],
        np.random.RandomState(0))}
    se = SEBlock(32)
    with torch.no_grad():
        for name in ("fc1", "fc2"):
            getattr(se, name).weight.copy_(torch.from_numpy(variables["params"][name]["kernel"].T))
            getattr(se, name).bias.copy_(torch.from_numpy(variables["params"][name]["bias"]))
        got = se(_nchw(x)).numpy()
    want = np.asarray(jax_se.apply(variables, x)).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    for init in (init_flax_default_, init_keypoints_weights_):
        fresh = SEBlock(64)
        default_w = fresh.fc1.weight.clone()
        init(fresh, torch.Generator().manual_seed(0))
        w = fresh.fc1.weight.detach()
        assert not torch.equal(w, default_w) and not fresh.fc1.bias.any()
        assert abs(float(w.std()) * np.sqrt(64) - 1.0) < 0.3  # flax Dense: 1/sqrt(fan_in)
        assert float(w.abs().max()) <= 2.0 / np.sqrt(64) / 0.8796256610342398 + 1e-6
    net = SimpleBaseline(4, "resnet18", device="cpu")
    init_keypoints_weights_(net, torch.Generator().manual_seed(0))
    assert abs(float(net.deconv1.weight.detach().std()) - 1e-3) < 1e-4 and not net.final.bias.any()


# arch -> (JAX's net for the config's default net.params, its parameters
# (test_full_size_trees_match_jax), tiny net.params for the inference model)
CONFIG_NETS = {
    "HigherHRNet": (lambda: JaxHigherHRNet(), 28_645_331,
                    {"C": 8, "num_blocks_per_stage": [1, 1, 1, 1], "num_units": 1,
                     "num_deconv_resid_blocks": 1}),
    "Hourglass": (FULL_SIZE["AEHourglassNet"][0], FULL_SIZE["AEHourglassNet"][2],
                  {"num_stages": 1}),
    "SimpleBaseline": (FULL_SIZE["SimpleBaseline-R50"][0], FULL_SIZE["SimpleBaseline-R50"][2],
                       {"backbone": "resnet18"}),
    "HRNet": (FULL_SIZE["HRNetSPPE-W32"][0], FULL_SIZE["HRNetSPPE-W32"][2],
              {"C": 8, "num_blocks_per_stage": [1, 1, 1, 1], "num_units": 1}),
}


@pytest.mark.parametrize("arch", list(CONFIG_NETS))
def test_configs_build_every_architecture(arch):
    """``create_net`` builds what JAX's builds: for the default
    ``net.params`` JAX's config gives the module of the full-size tree test
    and the port's the same parameter count; ``create_inference_model``
    gives the SPPE model to HRNet and SimpleBaseline and the AE model
    otherwise (a tiny net, float32 on the CPU), which runs an image; the
    SPPE nets' module takes a top-down step on a host batch of crops."""
    make_jax, count, tiny = CONFIG_NETS[arch]
    cfg = {"setup": {"architecture": arch}, "trainer": {"accelerator": "cpu"},
           "inference": {"input_size": 64}}
    assert JaxKeypointsConfig.from_dict(cfg).create_net() == make_jax()
    net = _meta(lambda d: KeypointsConfig.from_dict(cfg).create_net(device=d))
    assert type(net).__name__ == type(make_jax()).__name__
    assert sum(p.numel() for p in net.parameters()) == count
    im = KeypointsConfig.from_dict({**cfg, "net": {"params": tiny}}).create_inference_model()
    sppe = arch in ("HRNet", "SimpleBaseline")
    assert isinstance(im, InferenceSPPEModel if sppe else InferenceKeypointsModel)
    assert im.device == torch.device("cpu") and im.dtype == torch.float32
    assert not im.model.training
    assert im(_raw(70, 90, 9)).kpts_coords.shape[1:] == (17, 2)
    train_cfg = KeypointsConfig.from_dict({**cfg, "net": {"params": tiny}})
    if sppe:  # a single output, which JAX's KeypointsModule cannot train: the top-down step
        module = train_cfg.create_module()
        g = torch.Generator().manual_seed(0)
        metrics = module.training_step({
            "images": torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8, generator=g),
            "heatmaps": torch.rand(2, 16, 16, 17, generator=g),
            "target_weight": torch.ones(2, 17)})
        assert module.top_down and module.state.step == 1 and bool(torch.isfinite(metrics["loss"]))
    elif arch == "Hourglass":  # two stages at 1/4: the default [0.25, 0.5] targets refuse
        with pytest.raises(ValueError, match="hm_resolutions"):
            KeypointsConfig.from_dict(cfg).check_trainable()


def test_serving_and_batched_eval_refuse_sppe_models(zoo):
    """The serving predictor and the batched evaluator take the bottom-up
    model only: an SPPE model is refused when they are built."""
    _, _, net = zoo("simple_baseline")
    im = InferenceSPPEModel(net, input_size=64, device="cpu")
    with pytest.raises(TypeError, match="InferenceKeypointsModel"):
        BatchedKeypointsPredictor(im)
    with pytest.raises(TypeError, match="batch_size=1"):
        BatchedKeypointsEvaluator(im, batch_size=2)
    with pytest.raises(ValueError, match="dtype"):
        InferenceSPPEModel(net, dtype=torch.float16, device="cpu")
    with pytest.raises(ValueError, match="uint8"):
        InferenceSPPEModel(net, input_size=64, compact_inputs=True, device="cpu")(
            _raw(64, 64, 0).astype(np.float32))


def test_mpii_reader_and_pckh_match_jax(tmp_path):
    """A synthesized ``annot/*.json`` with its images: the same samples as
    JAX's reader; PCKh on seeded predictions (a zero head length skipped,
    no visible joint at all gives -1) equal to JAX's."""
    import cv2

    rs = np.random.RandomState(11)
    (tmp_path / "images").mkdir()
    (tmp_path / "annot").mkdir()
    annots = []
    for i in range(3):
        name = f"{i:03d}.png"
        cv2.imwrite(str(tmp_path / "images" / name), (rs.rand(20, 30, 3) * 255).astype(np.uint8))
        annots.append({"image": name, "joints": (rs.rand(16, 2) * 30).tolist(),
                       "joints_vis": rs.randint(0, 2, 16).tolist(), "center": [15.0, 10.0],
                       "scale": 1.2})
    (tmp_path / "annot" / "valid.json").write_text(json.dumps(annots))
    want, got = JaxMpii(str(tmp_path), "valid"), MpiiKeypointsDataset(str(tmp_path), "valid")
    assert len(got) == len(want) == 3 and got.labels == want.labels and got.limbs == want.limbs
    assert len(MpiiKeypointsDataset(str(tmp_path), "train")) == 0
    for i in range(3):
        for g, w in zip(got[i], want[i]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)

    target = rs.rand(4, 16, 2).astype(np.float32) * 50
    target[2, 9] = target[2, 8]  # zero head length: skipped
    pred = target + rs.randn(4, 16, 2).astype(np.float32) * 4
    vis = rs.randint(0, 2, (4, 16))
    for thr in (0.1, 0.5, 1.0):
        assert pckh(pred, target, vis, thr=thr) == jax_pckh(pred, target, vis, thr=thr)
    assert pckh(pred, target, np.zeros_like(vis)) == jax_pckh(pred, target, np.zeros_like(vis)) == -1


def test_inference_cli_runs_an_sppe_config(tmp_path, monkeypatch):
    """``bin.inference_keypoints`` on the keypoints yaml with
    ``--setup.architecture=SimpleBaseline`` (resnet18, the CPU, seeded
    weights): the SPPE model's plots of a custom image, as JAX's CLI writes
    them."""
    import cv2

    from human_pose_tpu_torch.bin import inference_keypoints

    cv2.imwrite(str(tmp_path / "a.png"), _raw(90, 70, 10))
    monkeypatch.chdir(tmp_path)
    inference_keypoints.main([
        f"--config={Path(__file__).resolve().parent.parent}/experiments/keypoints/higher_hrnet_32.yaml",
        "--setup.architecture=SimpleBaseline", "--net.params.backbone=resnet18",
        "--trainer.accelerator=cpu", "--inference.ckpt_path=null", "--inference.input_size=64",
        "--mode=custom", f"--path={tmp_path / 'a.png'}"])
    written = sorted(p.name for p in (tmp_path / "inference_results" / "custom").iterdir())
    assert written and all(name.startswith("a_") for name in written), written
