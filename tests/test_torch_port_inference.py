"""The port's keypoints inference model vs the JAX package's.

Decisions: the trained C=8 fixture HigherHRNet (tests/data/ap_fixture_weights.npz)
in both packages, on the AP corpus's 96x96 raw images at input_size 64, in
four configurations: single scale, flip, scales (0.5, 1) with flip, and
compact uint8 inputs with ``pad_multiple=128`` (flip, with the AP check,
in tests/test_torch_port_ap.py, so that the two files' JAX compiles run on
two workers). The frameworks' convs and resizes sum in other orders, so the
check is at the level of decisions, with the statistics of
tests/test_torch_port_e2e.py: the same person counts, a median
joint-coordinate difference under 0.5 px and sorted person scores within
0.05.

Behaviour and refusals (port only, a tiny random-weight model), the
weights loader, and the import rules of the new subpackages.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from human_pose_tpu.inference import InferenceKeypointsModel as JaxInferenceKeypointsModel
from human_pose_tpu.models import HigherHRNet as JaxHigherHRNet
from human_pose_tpu_torch.constants import PAD_PIXEL_U8
from human_pose_tpu_torch.inference import InferenceKeypointsModel, load_inference_weights
from human_pose_tpu_torch.models import HigherHRNet, init_flax_default_
from human_pose_tpu_torch.utils import load_flax_npz
from tests.ap_fixture import (
    IN_SIZE, K, P_CAP, WEIGHTS_PATH, build_corpus, load_trained_variables, train_batch_and_views,
)
from tests.jax_reference import light_jax_reference  # noqa: F401  (module fixture)

ROOT = Path(__file__).resolve().parent.parent
# the AP check's eval point (tests/test_ap_parity.py); every configuration
# uses it, so the flip configuration's results serve both tests
EVAL = dict(det_thr=0.25, tag_thr=0.4, input_size=IN_SIZE, max_num_people=P_CAP)
CONFIGS = {
    "single": {},
    "flip": {"use_flip": True},
    "multiscale_flip": {"use_flip": True, "scales": (0.5, 1.0)},
    "compact_pad128": {"compact_inputs": True, "pad_multiple": 128},
}
N_DECISION_IMAGES = 3
TINY = dict(num_blocks_per_stage=(1, 1, 1, 1), num_units=1, num_deconv_resid_blocks=1)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("ap_corpus") / "coco"
    gt = build_corpus(root)
    raws, _ = train_batch_and_views(root, gt)
    return gt, raws


@pytest.fixture(scope="module")
def fixture_models():
    jax_model = JaxHigherHRNet(num_kpts=K, C=8, s2d=False)
    net = HigherHRNet(num_kpts=K, C=8, device="cpu").eval()
    net.load_state_dict(load_inference_weights(WEIGHTS_PATH))
    return jax_model, load_trained_variables(), net


@pytest.fixture(scope="module")
def pipeline_results(corpus, fixture_models):
    """Per configuration, the (JAX, port) results, run once each: the flip
    configuration over the whole corpus (the AP check), the others over its
    first images. One JAX model object per configuration, so each compiles
    its program once."""
    _, raws = corpus
    jax_model, variables, net = fixture_models
    cache = {}

    def run(name):
        if name not in cache:
            kw = CONFIGS[name]
            jax_im = JaxInferenceKeypointsModel(jax_model, variables, **EVAL, **kw)
            port_im = InferenceKeypointsModel(net, **EVAL, **kw, device="cpu")
            images = raws if name == "flip" else raws[:N_DECISION_IMAGES]
            cache[name] = [(jax_im(raw), port_im(raw)) for raw in images], (jax_im, port_im)
        return cache[name]
    return run


def assert_decisions_match(name, pairs, jax_im, port_im):
    assert port_im.model_input_shape == jax_im.model_input_shape
    e = 2 if CONFIGS[name].get("use_flip") else 1
    for want, got in pairs:
        # same person counts, the same joints almost everywhere
        assert len(got.kpts_coords) == len(want.kpts_coords) >= 2
        assert np.median(np.abs(got.kpts_coords - want.kpts_coords)) < 0.5
        score_diff = np.abs(np.sort(got.obj_scores) - np.sort(want.obj_scores))
        assert score_diff.max() < 0.05, score_diff
        # the host boundary: channel-last maps cropped to the valid region
        assert got.kpts_heatmaps.shape == want.kpts_heatmaps.shape
        assert got.tags_heatmaps.shape == want.tags_heatmaps.shape
        assert got.kpts_tags.shape[-1] == want.kpts_tags.shape[-1] == e
        assert np.abs(got.kpts_heatmaps - want.kpts_heatmaps).max() < 1e-4
        np.testing.assert_array_equal(got.model_input_image, want.model_input_image)


# the flip configuration and the AP check: tests/test_torch_port_ap.py
@pytest.mark.parametrize("name", ["single", "multiscale_flip", "compact_pad128"])
def test_inference_decisions_match_jax(pipeline_results, name):
    pairs, (jax_im, port_im) = pipeline_results(name)
    assert_decisions_match(name, pairs, jax_im, port_im)


# -- behaviour and refusals (port only) ----------------------------------------

@pytest.fixture(scope="module")
def tiny_net():
    net = HigherHRNet(num_kpts=17, C=8, device="cpu", **TINY).eval()
    return init_flax_default_(net, torch.Generator().manual_seed(0))


def _raw(h, w, seed):
    return (np.random.RandomState(seed).rand(h, w, 3) * 255).astype(np.uint8)


def test_single_scale_shapes_detections_and_plot(tiny_net):
    im = InferenceKeypointsModel(tiny_net, input_size=128, max_num_people=5, device="cpu")
    result = im(_raw(200, 300, 0))
    assert im.model_input_shape[0] % 64 == 0 and im.model_input_shape[1] % 64 == 0
    assert result.kpts_coords.shape[1:] == (17, 2)
    assert result.kpts_heatmaps.shape == (*im.model_input_shape, 17)
    assert result.tags_heatmaps.shape == (*im.model_input_shape, 17)
    dets = result.to_coco_detections(image_id=42)
    assert len(dets) == len(result.kpts_coords)
    for d in dets:
        assert d["image_id"] == 42 and len(d["keypoints"]) == 51
    assert set(result.plot()) == {"heatmaps", "connections", "associative_embedding"}


def test_flip_and_multiscale_tags_and_scale_one(tiny_net):
    im = InferenceKeypointsModel(tiny_net, input_size=128, max_num_people=5, use_flip=True,
                                 device="cpu")
    raw = _raw(160, 160, 1)
    result = im(raw, scales=(0.5, 1.0))
    assert result.kpts_tags.shape[-1] == 2  # flip TTA stacks a second embedding
    with pytest.raises(ValueError, match="must include 1.0"):
        im(raw, scales=(0.5, 2.0))
    default = InferenceKeypointsModel(tiny_net, input_size=128, max_num_people=5,
                                      scales=(0.5, 1.0), device="cpu")
    assert default.scales == (0.5, 1.0)
    assert default(raw).kpts_coords.shape[1:] == (17, 2)


def test_compact_inputs_match_float_path_and_refuse_floats(tiny_net):
    raw = np.random.RandomState(11).randint(0, 256, (140, 170, 3), np.uint8)
    kw = dict(input_size=128, max_num_people=5, device="cpu")
    plain = InferenceKeypointsModel(tiny_net, **kw)(raw)
    comp_im = InferenceKeypointsModel(tiny_net, compact_inputs=True, **kw)
    comp = comp_im(raw)
    np.testing.assert_allclose(comp.kpts_heatmaps, plain.kpts_heatmaps, atol=2e-5)
    np.testing.assert_array_equal(comp.kpts_coords, plain.kpts_coords)
    assert comp.model_input_image.dtype == np.uint8
    with pytest.raises(ValueError, match="uint8"):
        comp_im(np.random.RandomState(1).rand(100, 120, 3).astype(np.float32))


def test_bucket_padding_masks_the_pad_region(tiny_net):
    raw = _raw(150, 260, 5)
    im = InferenceKeypointsModel(tiny_net, input_size=128, max_num_people=5, pad_multiple=256,
                                 compact_inputs=True, device="cpu")
    x, _, _ = im.prepare_input(raw)
    assert x.dtype == np.uint8 and x.shape[1] % 256 == 0 and x.shape[2] % 256 == 0
    np.testing.assert_array_equal(x[0, -1, -1], np.asarray(PAD_PIXEL_U8, np.uint8))
    result = im(raw)
    assert im.model_input_shape[0] % 256 == 0 and im.model_input_shape[1] % 256 == 0
    vh, vw = result.model_input_image.shape[:2]
    assert (vh, vw) != im.model_input_shape and vh % 64 == 0 and vw % 64 == 0
    # the decode on the device: no valid joint in the pad region
    hw = im.model_input_shape
    avg, tags = im.forward_scale(im.to_device(x), hw)
    joints, _, valid, masked, _ = im._decode_aggregated(avg, tags, hw, 1.0, (vh, vw))
    assert (masked[..., vh:, :] == -1e4).all() and (masked[..., vw:] == -1e4).all()
    j = joints[valid]
    scored = j[..., 2] > 0
    assert bool(((j[..., 0] < vw) & (j[..., 1] < vh))[scored].all())


def test_refusals(tiny_net):
    # the pipeline-parallel model is built (tests/test_torch_port_pipeline.py);
    # it refuses a segment count outside partition_for's table
    assert len(InferenceKeypointsModel(tiny_net, pipeline_devices=2, device="cpu")._pipe.segments) == 2
    with pytest.raises(ValueError, match="1-6 segments"):
        InferenceKeypointsModel(tiny_net, pipeline_devices=7, device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        InferenceKeypointsModel(tiny_net, dtype=torch.float16, device="cpu")


def test_default_device_refuses_missing_card(tiny_net):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal path needs a CUDA-less host")
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceKeypointsModel(tiny_net)


def test_load_inference_weights(tmp_path):
    want = load_flax_npz(WEIGHTS_PATH)
    from_npz = load_inference_weights(WEIGHTS_PATH)
    assert set(from_npz) == set(want)
    assert all(torch.equal(from_npz[k], torch.from_numpy(want[k])) for k in want)
    # a reference trainer-state .pt, DDP prefixes and num_batches_tracked
    ref = HigherHRNet(num_kpts=17, C=8, device="cpu", **TINY)
    init_flax_default_(ref, torch.Generator().manual_seed(3))
    sd = {f"module.{k}": v for k, v in ref.state_dict().items()}
    torch.save({"module": {"model": sd, "optimizer": {"lr": 0.1}}, "epoch": 3}, tmp_path / "ref.pt")
    got = load_inference_weights(tmp_path / "ref.pt")
    net = HigherHRNet(num_kpts=17, C=8, device="cpu", **TINY)
    net.load_state_dict(got, strict=True)
    assert all(torch.equal(a, b) for a, b in zip(net.state_dict().values(),
                                                  ref.state_dict().values()))
    torch.save(ref.state_dict(), tmp_path / "bare.pt")
    assert set(load_inference_weights(tmp_path / "bare.pt")) == set(ref.state_dict())
    # a native JAX trainer checkpoint (a pickle around flax msgpack bytes)
    # whose module holds no params refuses; one with params loads
    # (tests/test_torch_port_checkpoint_dir.py)
    with open(tmp_path / "last.ckpt", "wb") as f:
        pickle.dump({"module": b"\x81\xa4step\x00", "epoch": 1}, f)
    with pytest.raises(ValueError, match="no params"):
        load_inference_weights(tmp_path / "last.ckpt")


def test_new_subpackages_import_without_cv2():
    """The inference path's host modules import cv2 only where they use it:
    the subpackages import with cv2 (and JAX) unimportable."""
    code = (
        "import sys\n"
        "for m in ('cv2', 'jax', 'flax', 'human_pose_tpu'): sys.modules[m] = None\n"
        "import human_pose_tpu_torch.inference, human_pose_tpu_torch.data\n"
        "import human_pose_tpu_torch.metrics, human_pose_tpu_torch.loggers\n"
        "import human_pose_tpu_torch.utils.image, human_pose_tpu_torch.ops.flip\n"
        "from human_pose_tpu_torch.data import get_multi_scale_size\n"
        "import numpy as np\n"
        "print(get_multi_scale_size(np.zeros((480, 640, 3)), 512, 1.0, 1.0)[0])\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "(704, 512)", res.stderr
