"""The port's COCO evaluation slice on the CPU, part 1 (part 2, the trained
fixture against JAX: tests/test_torch_port_eval_jax.py).

* host copies against the JAX package: ``utils/files``, ``data/rle``,
  ``prebake_annotations``, the dataset's ``load_image`` / ``load_annot``,
  ``image_id_from_path``, ``utils/utils``;
* configs against the JAX package: both keypoints yamls of ``experiments/``
  with and without ``--a.b.c=v`` overrides give equal ``to_dict()``;
  ``parse_cli_value``; ``resolved_pad_multiple``; the refusals;
* the batched evaluator against the port's serial one, the recipes of
  tests/test_batched_eval.py with its tolerances (a tiny random-weight net);
* ``bin.inference_keypoints``: the plot files JAX's CLI writes.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from human_pose_tpu.configs import KeypointsConfig as JaxKeypointsConfig
from human_pose_tpu.configs import base as jax_config_base
from human_pose_tpu.configs import parse_cli_value as jax_parse_cli_value
from human_pose_tpu.data import CocoKeypointsDataset as JaxCocoKeypointsDataset
from human_pose_tpu.data import prebake_annotations as jax_prebake_annotations
from human_pose_tpu.data import rle as jax_rle
from human_pose_tpu.inference.batched_eval import image_id_from_path as jax_image_id_from_path
from human_pose_tpu.utils import files as jax_files
from human_pose_tpu_torch.bin.eval_keypoints import evaluate_dataset
from human_pose_tpu_torch.configs import KeypointsConfig, parse_cli_value
from human_pose_tpu_torch.configs import base as config_base
from human_pose_tpu_torch.data import CocoKeypointsDataset, collate, prebake_annotations
from human_pose_tpu_torch.data import rle
from human_pose_tpu_torch.inference import (
    BatchedKeypointsEvaluator, InferenceKeypointsModel, evaluate_dataset_batched,
    image_id_from_path,
)
from human_pose_tpu_torch.models import HigherHRNet, init_flax_default_
from human_pose_tpu_torch.utils import (
    elapsed_timer, get_rank, is_main_process, load_json, load_yaml, save_json, save_yaml,
    seed_everything,
)
from tests.test_batched_eval import assert_detections_match
from tests.test_data import make_coco_fixture

ROOT = Path(__file__).resolve().parent.parent
YAMLS = [ROOT / "experiments" / "keypoints" / f"higher_hrnet_{c}.yaml" for c in (32, 48)]
TINY = dict(num_blocks_per_stage=(1, 1, 1, 1), num_units=1, num_deconv_resid_blocks=1)
TINY_NET = ("--net.params.C=8 --net.params.num_blocks_per_stage=[1,1,1,1] "
            "--net.params.num_units=1 --net.params.num_deconv_resid_blocks=1").split()


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the port's many small CPU ops while this
    module runs: the suite runs several workers on a few cores, where
    torch's default thread pool spins against them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- host copies ----------------------------------------------------------------

def test_files_round_trip(tmp_path):
    obj = {"a": [1, 2.5, None], "b": {"c": "x", "d": True}, "e": [[1, 2], [3]]}
    save_yaml(obj, tmp_path / "sub" / "o.yaml")
    save_json(obj, tmp_path / "sub" / "o.json")
    assert load_yaml(tmp_path / "sub" / "o.yaml") == obj == load_json(tmp_path / "sub" / "o.json")
    jax_files.save_yaml(obj, tmp_path / "j.yaml")
    jax_files.save_json(obj, tmp_path / "j.json")
    assert (tmp_path / "j.yaml").read_text() == (tmp_path / "sub" / "o.yaml").read_text()
    assert (tmp_path / "j.json").read_text() == (tmp_path / "sub" / "o.json").read_text()


def _encode_rle(counts):
    """The pycocotools compressed-string scheme (tests/test_data.py's encoder)."""
    out = []
    for i, x in enumerate(counts):
        if i > 2:
            x -= counts[i - 2]
        more = True
        while more:
            c = x & 0x1F
            x >>= 5
            more = not (x == 0 and not (c & 0x10)) and not (x == -1 and (c & 0x10))
            if more:
                c |= 0x20
            out.append(chr(c + 48))
    return "".join(out)


def _mask_counts(mask):
    """Column-major run lengths of a 0/1 mask, starting with zeros."""
    flat = mask.T.ravel()
    change = np.flatnonzero(np.diff(flat)) + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(bounds).tolist()
    return counts if flat[0] == 0 else [0] + counts


def _seeded_annots(rng, h, w, n):
    annots = []
    for i in range(n):
        if i % 3 == 0:  # crowd, RLE (compressed string or counts list)
            m = (rng.random((h, w)) < 0.1).astype(np.uint8)
            m[rng.integers(0, h // 2):, rng.integers(0, w // 2):] = 1
            counts = _mask_counts(m)
            segm = {"counts": _encode_rle(counts) if i % 2 else counts, "size": [h, w]}
            annots.append({"iscrowd": 1, "num_keypoints": 0, "segmentation": segm})
        else:  # polygons, with or without keypoints
            polys = [rng.uniform(0, [w, h] * 4).round(1).tolist() for _ in range(1 + i % 2)]
            annots.append({"iscrowd": 0, "num_keypoints": int(i % 2) * 5, "segmentation": polys})
    return annots


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rle_matches_jax(seed):
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(20, 60)), int(rng.integers(20, 60))
    annots = _seeded_annots(rng, h, w, 6)
    for a in annots:
        segm = a["segmentation"]
        if isinstance(segm, dict) and isinstance(segm["counts"], str):
            assert rle.decode_rle_counts_string(segm["counts"]) == \
                jax_rle.decode_rle_counts_string(segm["counts"])
            assert rle.decode_rle_counts_string(segm["counts"].encode()) == \
                jax_rle.decode_rle_counts_string(segm["counts"])
        if isinstance(segm, dict):
            counts = segm["counts"] if isinstance(segm["counts"], list) else \
                rle.decode_rle_counts_string(segm["counts"])
            np.testing.assert_array_equal(rle.rle_to_mask(counts, h, w),
                                          jax_rle.rle_to_mask(counts, h, w))
        else:
            np.testing.assert_array_equal(rle.polygons_to_mask(segm, h, w),
                                          jax_rle.polygons_to_mask(segm, h, w))
        np.testing.assert_array_equal(rle.segmentation_to_mask(segm, h, w),
                                      jax_rle.segmentation_to_mask(segm, h, w))
        for got, want in zip(rle.segmentation_masks(segm, h, w),
                             jax_rle.segmentation_masks(segm, h, w), strict=True):
            np.testing.assert_array_equal(got, want)
    got = rle.get_crowd_mask(annots, h, w)
    assert got.dtype == bool and not got.all() and got.any()
    np.testing.assert_array_equal(got, jax_rle.get_crowd_mask(annots, h, w))


def _coco_root(root: Path) -> Path:
    """tests/test_data.py's fixture (mixed sizes) plus a crowd RLE and a
    zero-keypoint polygon annotation, so the crowd masks are not all True."""
    gt = make_coco_fixture(root, n_images=4, sizes=[96, (96, 128), (80, 96), 96])
    gt["annotations"] += [
        {"id": 100, "image_id": 1, "category_id": 1, "iscrowd": 1, "num_keypoints": 0,
         "keypoints": [0] * 51, "area": 100.0, "bbox": [0, 0, 10, 10],
         "segmentation": {"counts": _encode_rle([200, 300, 1000, 40]), "size": [96, 128]}},
        {"id": 101, "image_id": 2, "category_id": 1, "iscrowd": 0, "num_keypoints": 0,
         "keypoints": [0] * 51, "area": 100.0, "bbox": [0, 0, 10, 10],
         "segmentation": [[5, 5, 40, 8, 30, 50, 6, 30]]},
    ]
    (root / "annotations" / "person_keypoints_val2017.json").write_text(json.dumps(gt))
    return root


@pytest.fixture(scope="module")
def coco_roots(tmp_path_factory):
    """The same corpus pre-baked by each package."""
    port_root = _coco_root(tmp_path_factory.mktemp("port") / "coco")
    jax_root = tmp_path_factory.mktemp("jax") / "coco"
    shutil.copytree(port_root, jax_root)
    prebake_annotations(str(port_root), "val2017")
    jax_prebake_annotations(str(jax_root), "val2017")
    return port_root, jax_root


def test_prebake_matches_jax(coco_roots):
    port_root, jax_root = coco_roots
    files = lambda r: sorted(str(p.relative_to(r)) for p in r.rglob("*") if p.is_file())  # noqa: E731
    assert files(port_root) == files(jax_root)
    yamls = sorted((port_root / "annotations" / "person_keypoints_val2017").glob("*.yaml"))
    assert len(yamls) == 4
    for p in yamls:
        q = jax_root / p.relative_to(port_root)
        assert p.read_text() == q.read_text()
    masks = sorted((port_root / "masks").rglob("*.npy"))
    assert len(masks) == 4 and not all(np.load(p).all() for p in masks)
    for p in masks:
        got, want = np.load(p), np.load(jax_root / p.relative_to(port_root))
        assert got.dtype == want.dtype == bool
        np.testing.assert_array_equal(got, want)
    # a second pre-bake finds the files and writes nothing
    before = {p: p.stat().st_mtime_ns for p in yamls}
    prebake_annotations(str(port_root), "val2017")
    assert {p: p.stat().st_mtime_ns for p in yamls} == before


def test_dataset_matches_jax(coco_roots):
    port_root, jax_root = coco_roots
    ds = CocoKeypointsDataset(str(port_root), "val2017")
    ref = JaxCocoKeypointsDataset(str(jax_root), "val2017", transform=None)
    assert len(ds) == len(ref) == 4
    assert [Path(p).name for p in ds.images_filepaths] == [Path(p).name for p in ref.images_filepaths]
    for i in range(len(ds)):
        np.testing.assert_array_equal(ds.load_image(i), ref.load_image(i))
        assert ds.load_annot(i) == ref.load_annot(i)
        (img, annot, mask), (rimg, rannot, rmask) = ds.get_raw_data(i), ref.get_raw_data(i)
        np.testing.assert_array_equal(img, rimg)
        np.testing.assert_array_equal(mask, rmask)
        assert annot == rannot
    assert ds.images_dir == f"{port_root}/images/val2017" and ds.hm_sizes == [128, 256]


def test_dataset_training_side_refuses(coco_roots):
    """The training side (ported since; tests/test_torch_port_data.py holds
    it against JAX) refuses what JAX's refuses: a compact dataset whose
    transform gives a float image, and an empty batch."""
    from human_pose_tpu_torch.data import KeypointsTransform

    port_root, _ = coco_roots
    ds = CocoKeypointsDataset(str(port_root), "val2017", KeypointsTransform(64).inference,
                              out_size=64, compact=True)
    with pytest.raises(ValueError, match="uint8"):
        ds.__getitem__(0, np.random.default_rng(0))
    with pytest.raises(IndexError):
        collate([])


@pytest.mark.parametrize("path,fallback", [
    ("images/val2017/000000397133.jpg", 5), ("a/b/img_0042.png", 1), ("x/no_digits.jpg", 7),
    ("12.jpeg", 0), (Path("d/000000000001.jpg"), 3),
])
def test_image_id_from_path(path, fallback):
    assert image_id_from_path(path, fallback) == jax_image_id_from_path(path, fallback)


def test_rank_seed_and_timer(monkeypatch):
    monkeypatch.delenv("RANK", raising=False)
    assert get_rank() == 0 and is_main_process()
    monkeypatch.setenv("RANK", "3")
    assert get_rank() == 3 and not is_main_process()
    seed_everything(5)
    a = (np.random.rand(), torch.rand(2))
    seed_everything(5)
    b = (np.random.rand(), torch.rand(2))
    assert a[0] == b[0] and torch.equal(a[1], b[1])
    with elapsed_timer() as elapsed:
        first = elapsed()
    frozen = elapsed()
    assert 0 <= first <= frozen == elapsed()


# -- configs ------------------------------------------------------------------------

OVERRIDES = {
    "none": [],
    "scalars": ["--setup.seed=7", "--trainer.accelerator=cpu", "--inference.det_thr=0.1",
                "--inference.use_flip=True", "--net.params.C=8", "--setup.run_name=r1"],
    "lists_null": ["--inference.scales=[0.5,1,2]", "--net.params.num_blocks_per_stage=[1,1,1,1]",
                   "--inference.ckpt_path=null", "--setup.pretrained_ckpt_path=none",
                   "--dataloader.val_ds.hm_resolutions=[0.25]", "--unknown.key=3",
                   "--inference.pad_multiple=auto", "not-a-flag", "--cudnn.benchmark=false"],
}


@pytest.fixture
def same_now(monkeypatch):
    """One timestamp for both packages' default run names."""
    monkeypatch.setattr(config_base, "NOW", "2026-01-01_00-00-00")
    monkeypatch.setattr(jax_config_base, "NOW", "2026-01-01_00-00-00")


@pytest.mark.parametrize("overrides", list(OVERRIDES))
@pytest.mark.parametrize("path", YAMLS, ids=lambda p: p.stem)
def test_config_to_dict_matches_jax(same_now, path, overrides):
    argv = OVERRIDES[overrides]
    got_dict = KeypointsConfig.from_yaml_to_dict(str(path), list(argv))
    want_dict = JaxKeypointsConfig.from_yaml_to_dict(str(path), list(argv))
    assert got_dict == want_dict
    got = KeypointsConfig.from_dict(got_dict)
    want = JaxKeypointsConfig.from_dict(want_dict)
    assert got.to_dict() == want.to_dict()
    assert str(got.log_path) == str(want.log_path) and got.is_debug == want.is_debug
    assert got.resolved_pad_multiple() == want.resolved_pad_multiple()
    # the yaml written by the eval CLI reads back into the same config
    assert KeypointsConfig.from_dict(yaml.safe_load(yaml.safe_dump(got.to_dict()))).to_dict() \
        == got.to_dict()


@pytest.mark.parametrize("value", ["none", "NULL", "True", "false", "3", "-2", "0.5", "1e-3",
                                   "hello", "[1, 2]", "[0.25,0.5]", "[]", "[a, 1, null]", "auto"])
def test_parse_cli_value_matches_jax(value):
    got, want = parse_cli_value(value), jax_parse_cli_value(value)
    assert got == want and type(got) is type(want)


def test_resolved_pad_multiple_and_debug_mode(same_now):
    cfg = KeypointsConfig.from_dict({"inference": {"pad_multiple": "auto"}})
    assert cfg.resolved_pad_multiple() == 128
    assert KeypointsConfig.from_dict({}).resolved_pad_multiple() == 64
    with pytest.raises(ValueError, match="pad_multiple"):
        KeypointsConfig.from_dict({"inference": {"pad_multiple": "big"}}).resolved_pad_multiple()
    debug = KeypointsConfig.from_dict({"trainer": {"limit_batches": 2}})
    assert debug.is_debug and debug.setup.experiment_name == "debug"


def test_auto_ckpt_path(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = {"setup": {"experiment_name": "kp", "ckpt_path": "auto"}}
    assert KeypointsConfig.from_dict(json.loads(json.dumps(cfg))).setup.ckpt_path is None
    ckpt = tmp_path / "results" / "kp" / "run7" / "2026" / "checkpoints" / "last.pt"
    ckpt.parent.mkdir(parents=True)
    ckpt.write_bytes(b"x")
    got = KeypointsConfig.from_dict(json.loads(json.dumps(cfg)))
    assert got.setup.ckpt_path == str(Path("results/kp/run7/2026/checkpoints/last.pt"))
    assert got.setup.run_name == "run7"


def test_deterministic_and_cudnn_section():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
             torch.backends.cudnn.enabled)
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        cfg = KeypointsConfig.from_dict({"setup": {"deterministic": True,
                                                   "compilation_cache_dir": "/nowhere"},
                                         "cudnn": {"benchmark": False}})
        assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
        cfg.apply_cudnn()
        assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark
        KeypointsConfig.from_dict({"cudnn": {"benchmark": True}}).apply_cudnn()
        assert torch.backends.cudnn.benchmark and not torch.backends.cudnn.deterministic
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.enabled) = saved


def test_config_refusals():
    cfg = KeypointsConfig.from_dict({"trainer": {"accelerator": "cpu"}})
    for call, module in ((cfg.create_callbacks, "10d"), (cfg.create_trainer, "10d"),
                         (cfg.create_logger, 16), (cfg.make_mesh, 14),
                         (lambda: cfg.bn_groups(mesh=object()), 14),
                         (lambda: cfg.create_net(bn_groups=2), 14)):
        with pytest.raises(NotImplementedError, match=f"module {module}"):
            call()
    for arch in ("Hourglass", "SimpleBaseline", "HRNet"):
        other = KeypointsConfig.from_dict({"setup": {"architecture": arch}})
        with pytest.raises(NotImplementedError, match="module 15"):
            other.create_inference_model()
    with pytest.raises(ValueError, match="unknown"):
        KeypointsConfig.from_dict({"setup": {"architecture": "ViT"}}).create_net()
    pipe = KeypointsConfig.from_dict({"trainer": {"accelerator": "cpu"},
                                      "inference": {"pipeline_devices": 2},
                                      "net": {"params": dict(C=8, **TINY)}})
    with pytest.raises(NotImplementedError, match="module 14"):
        pipe.create_inference_model()


def test_create_inference_model_device_and_dtype():
    net_params = {"C": 8, "s2d": False, "remat": [1, 4], "num_blocks_per_stage": [1, 1, 1, 1],
                  "num_units": 1, "num_deconv_resid_blocks": 1}
    cpu = KeypointsConfig.from_dict({"trainer": {"accelerator": "cpu"},
                                     "net": {"params": net_params},
                                     "inference": {"use_flip": True, "scales": [0.5, 1]}})
    im = cpu.create_inference_model()
    assert im.device == torch.device("cpu") and im.dtype == torch.float32
    assert im.use_flip and im.scales == (0.5, 1.0) and not im.model.training
    again = cpu.create_inference_model()  # seeded: the same random weights
    assert all(torch.equal(a, b) for a, b in zip(im.model.state_dict().values(),
                                                  again.model.state_dict().values()))
    tpu = KeypointsConfig.from_dict({"net": {"params": net_params}})
    assert tpu.compute_dtype() == torch.bfloat16 and tpu.target_device() == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tpu.create_inference_model()


# -- batched eval, port vs port ----------------------------------------------------

@pytest.fixture(scope="module")
def tiny_net():
    net = HigherHRNet(num_kpts=17, C=8, device="cpu", **TINY).eval()
    return init_flax_default_(net, torch.Generator().manual_seed(0))


@pytest.fixture(scope="module")
def mixed_ds(tmp_path_factory):
    """5 images in 2 shape buckets (square and 1:2): partial batches in both
    buckets at batch size 2 (tests/test_batched_eval.py's set)."""
    root = tmp_path_factory.mktemp("coco_mixed")
    make_coco_fixture(root, n_images=5, sizes=[96, 96, (96, 192), (96, 192), 96])
    prebake_annotations(str(root), "val2017")
    return CocoKeypointsDataset(str(root), "val2017")


def _model(net, **kw):
    return InferenceKeypointsModel(net, input_size=64, max_num_people=5, device="cpu", **kw)


def test_batched_matches_serial_mixed_shapes(tiny_net, mixed_ds):
    im = _model(tiny_net, use_flip=True)
    serial = evaluate_dataset(im, mixed_ds)
    ev = BatchedKeypointsEvaluator(im, batch_size=2)
    for i in range(len(mixed_ds)):
        ev.add(mixed_ds.load_image(i), i, mixed_ds.load_annot(i))
    batched, oks = ev.finish()
    assert len(ev.buckets) == 2 and ev.n_batches == 3 and ev._n_images == 5
    assert len(oks) == 5 and all(0 <= v <= 1 for v in oks)
    assert_detections_match(serial, batched)
    assert_detections_match(serial, evaluate_dataset_batched(im, mixed_ds, 2, progress=False))


def test_batched_pad_multiple_dynamic_mask(tiny_net, mixed_ds):
    """pad_multiple 128 puts both shapes in one bucket; each image's own
    mask reproduces the serial path's."""
    im = _model(tiny_net, pad_multiple=128)
    serial = evaluate_dataset(im, mixed_ds)
    batched = evaluate_dataset_batched(im, mixed_ds, batch_size=4, progress=False)
    assert_detections_match(serial, batched)
    ev = BatchedKeypointsEvaluator(im, batch_size=4)
    keys = {ev._bucket_key(mixed_ds.load_image(i).shape[:2]) for i in range(4)}
    assert len(keys) == 1


def test_batched_multiscale(tiny_net, mixed_ds):
    im = _model(tiny_net, scales=(0.5, 1.0))
    serial = evaluate_dataset(im, mixed_ds, limit=3)
    batched = evaluate_dataset_batched(im, mixed_ds, batch_size=2, limit=3, progress=False)
    assert_detections_match(serial, batched)


def test_max_pending_flushes_fullest_bucket(tiny_net, mixed_ds):
    im = _model(tiny_net)
    ev = BatchedKeypointsEvaluator(im, batch_size=4, max_pending=2)
    for i in range(3):
        ev.add(mixed_ds.load_image(i), image_id=i, annot=None)
        assert sum(len(v) for v in ev._buckets.values()) <= 2
    dets, oks = ev.finish()
    assert {d["image_id"] for d in dets} <= {0, 1, 2} and oks == []
    assert ev._n_images == 3 and ev.n_batches == 2


def test_decode_masked_per_image_equals_single(tiny_net):
    """The ``[B, 2]`` mask: each image of a batch decodes as it does alone."""
    im = _model(tiny_net, use_flip=True)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((3, 3, 128, 192),
                                                                  dtype=np.float32))
    avg, tags = im.forward_scale(x, (128, 192))
    sizes = torch.tensor([[128, 192], [64, 192], [128, 64]], dtype=torch.int32)
    joints, scores, valid, masked = im.decode_masked(avg, tags, (128, 192), 1.0, sizes)
    for i, (vh, vw) in enumerate(sizes.tolist()):
        one = im.decode_masked(avg[i:i + 1], [t[i:i + 1] for t in tags], (128, 192), 1.0,
                               (vh, vw))
        for got, want in zip((joints, scores, valid, masked), one):
            assert torch.equal(got[i:i + 1], want)
        assert (masked[i, :, vh:] == -1e4).all() and (masked[i, :, :, vw:] == -1e4).all()


def test_batched_refusals(tiny_net):
    with pytest.raises(ValueError, match="must include 1.0"):
        BatchedKeypointsEvaluator(_model(tiny_net, scales=(0.5, 2.0)), batch_size=2)
    with pytest.raises(NotImplementedError, match="module 14"):
        BatchedKeypointsEvaluator(_model(tiny_net), batch_size=2, mesh=object())
    im = _model(tiny_net)
    im.pipeline_devices = 2
    with pytest.raises(ValueError, match="pipeline_devices"):
        BatchedKeypointsEvaluator(im, batch_size=2)


# -- CLIs ------------------------------------------------------------------------

def _cli_config(tmp: Path, root: Path) -> Path:
    """tests/test_cli.py's config: a CPU run on the fixture at input 64."""
    cfg = tmp / "cfg.yaml"
    cfg.write_text(f"""
setup: {{experiment_name: kp, architecture: HigherHRNet}}
trainer: {{accelerator: cpu, use_DDP: false}}
dataloader:
  val_ds: {{root: {root}, split: val2017, out_size: 64, max_num_people: 5}}
net:
  params: {{num_kpts: 17, s2d: false}}
inference: {{input_size: 64, ckpt_path: null}}
""")
    return cfg


def test_eval_cli_refuses_sharded(tmp_path):
    from human_pose_tpu_torch.bin.eval_keypoints import main

    with pytest.raises(NotImplementedError, match="module 14"):
        main(["--config=unused.yaml", "--batch_size=8", "--sharded=true"])


def test_inference_cli_writes_jax_plot_names(tmp_path, monkeypatch):
    """``--mode custom --path <dir>`` (and ``--mode val``) write the plot
    files JAX's CLI writes, on a tiny random-weight net."""
    from human_pose_tpu.bin.inference_keypoints import main as jax_main
    from human_pose_tpu_torch.bin.inference_keypoints import main

    root = tmp_path / "coco"
    make_coco_fixture(root, n_images=2, sizes=[96, (96, 128)])
    prebake_annotations(str(root), "val2017")
    cfg = _cli_config(tmp_path, root)
    names = {}
    for who, run in (("port", main), ("jax", lambda argv: (
            monkeypatch.setattr(sys, "argv", ["inf"] + argv), jax_main()))):
        work = tmp_path / who
        work.mkdir()
        monkeypatch.chdir(work)
        run([f"--config={cfg}", "--mode=custom", f"--path={root}/images/val2017"] + TINY_NET)
        names[who] = sorted(str(p.relative_to(work)) for p in work.rglob("*.jpg"))
    assert names["port"] == names["jax"]
    assert len(names["port"]) == 6 and all(n.startswith("inference_results/custom/")
                                           for n in names["port"])
    monkeypatch.chdir(tmp_path / "port")
    main([f"--config={cfg}", "--mode=val"] + TINY_NET)
    assert len(list((tmp_path / "port" / "inference_results" / "val").glob("*.jpg"))) == 6
