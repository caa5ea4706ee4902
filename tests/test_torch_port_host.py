"""The port's host-side copies vs the JAX package's: affine math, image
normalization, OKS, the NumPy COCO eval, image grids and drawing, the
result objects, the logger; the NCHW flip ops; the repaired downsampling
resize. Each function gets the same seeded inputs in both packages; the
copies are the same NumPy/cv2 code, so they must agree exactly (the resize
and the flip ops within the stated tolerance)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from human_pose_tpu.data import affine as j_affine
from human_pose_tpu.data import transforms as j_transforms
from human_pose_tpu.data.coco import COCO_LABELS as J_LABELS, COCO_LIMBS as J_LIMBS
from human_pose_tpu.inference import results as j_results
from human_pose_tpu.inference import visualization as j_vis
from human_pose_tpu.metrics import cocoeval as j_cocoeval
from human_pose_tpu.metrics import oks as j_oks
from human_pose_tpu.ops import flip as j_flip
from human_pose_tpu.ops.heatmaps import resize_bilinear as j_resize
from human_pose_tpu.utils import image as j_image
from human_pose_tpu_torch.data import affine, transforms
from human_pose_tpu_torch.data.coco import COCO_LABELS, COCO_LIMBS
from human_pose_tpu_torch.inference import results, visualization
from human_pose_tpu_torch.loggers import pylogger
from human_pose_tpu_torch.metrics import cocoeval, oks
from human_pose_tpu_torch.ops import flip
from human_pose_tpu_torch.ops.heatmaps import resize_bilinear
from human_pose_tpu_torch.utils import image

RAW_SHAPES = {"portrait": (480, 320), "landscape": (480, 640), "square": (300, 300),
              "odd": (137, 211)}


def _raw(shape, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (*shape, 3), np.uint8)


# -- data/affine.py ----------------------------------------------------------

@pytest.mark.parametrize("scales", [(1.0,), (0.5, 1.0), (0.5, 1.0, 2.0), (1.0, 2.0)])
@pytest.mark.parametrize("shape", list(RAW_SHAPES), ids=list(RAW_SHAPES))
def test_get_multi_scale_size_matches_jax(shape, scales):
    img = np.zeros((*RAW_SHAPES[shape], 3), np.uint8)
    for s in scales:
        for input_size in (64, 512):
            want = j_affine.get_multi_scale_size(img, input_size, s, min(scales))
            got = affine.get_multi_scale_size(img, input_size, s, min(scales))
            assert got == want
            if min(scales) == 1.0:
                assert got[0][0] % 64 == 0 and got[0][1] % 64 == 0


@pytest.mark.parametrize("current_scale,min_scale", [(1.0, 1.0), (0.5, 0.5), (2.0, 0.5)])
@pytest.mark.parametrize("shape", list(RAW_SHAPES), ids=list(RAW_SHAPES))
def test_resize_align_multi_scale_bit_equal(shape, current_scale, min_scale):
    raw = _raw(RAW_SHAPES[shape])
    want, wc, ws = j_affine.resize_align_multi_scale(raw, 64, current_scale, min_scale)
    got, gc, gs = affine.resize_align_multi_scale(raw, 64, current_scale, min_scale)
    assert got.dtype == np.uint8 and (gc, gs) == (wc, ws)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("inverse", [False, True])
def test_affine_transform_and_inverse_coords_match_jax(inverse):
    rng = np.random.RandomState(1)
    center, scale, out = (160, 240), (320.0, 480.0), (512, 768)
    want = j_affine.get_affine_transform(center, scale, 0, out, inverse=inverse)
    got = affine.get_affine_transform(center, scale, 0, out, inverse=inverse)
    np.testing.assert_array_equal(got, want)
    pt = rng.rand(2) * 500
    np.testing.assert_array_equal(affine.affine_transform_point(pt, got),
                                  j_affine.affine_transform_point(pt, want))
    kpts = (rng.rand(3, 17, 2) * 512).astype(np.float32)
    np.testing.assert_array_equal(affine.transform_coords_inverse(kpts, center, scale, out),
                                  j_affine.transform_coords_inverse(kpts, center, scale, out))


# -- data/transforms.py, data/coco.py ------------------------------------------

def test_normalize_and_inverse_match_jax():
    raw = _raw((33, 47, ), seed=2)
    want = j_transforms.normalize(raw)
    got = transforms.normalize(raw)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(transforms.inverse_normalize(got),
                                  j_transforms.inverse_normalize(want))
    assert transforms.inverse_normalize(raw) is raw  # uint8 passes through
    assert transforms.COCO_FLIP_INDEX == list(j_transforms.COCO_FLIP_INDEX)
    assert COCO_LABELS == J_LABELS and COCO_LIMBS == J_LIMBS


# -- metrics -------------------------------------------------------------------

def _persons(rng, n, jitter=0.0, base=None):
    if base is None:
        base = rng.rand(n, 17, 2) * 200
    return base + rng.randn(*base.shape) * jitter


def test_oks_functions_match_jax():
    rng = np.random.RandomState(3)
    target = _persons(rng, 3)
    vis = (rng.rand(3, 17) > 0.2).astype(np.float64) * 2
    vis[2] = 0  # a target without visible joints
    preds = _persons(rng, 4, jitter=4.0, base=np.concatenate([target, target[:1]]))
    scores = rng.rand(4)
    polys = [[[0, 0, 60, 0, 60, 90, 0, 90]], [[10, 10, 50, 10, 30, 70]], []]
    for p in polys:
        assert oks.polygons_area(p) == j_oks.polygons_area(p)
    for j in range(3):
        assert oks.object_OKS(preds[j], target[j], vis[j], polys[j]) == \
            j_oks.object_OKS(preds[j], target[j], vis[j], polys[j])
    assert oks.image_OKS(preds[:3], target, vis, polys) == j_oks.image_OKS(preds[:3], target, vis, polys)
    assert oks.match_preds_to_targets(preds, scores, target, vis) == \
        j_oks.match_preds_to_targets(preds, scores, target, vis)
    np.testing.assert_array_equal(oks.VARIANCES, j_oks.VARIANCES)


def _coco_set(seed):
    """Small synthetic COCO GT (visible, partly labelled, crowd, no-keypoint
    persons over 4 images of several areas) and detections near it."""
    rng = np.random.RandomState(seed)
    images = [{"id": i} for i in range(4)]
    anns, dets = [], []
    for i in range(4):
        for p in range(3):
            kp = np.zeros((17, 3))
            kp[:, :2] = rng.rand(17, 2) * 300
            kp[:, 2] = (rng.rand(17) > 0.3) * 2
            n_kp = int((kp[:, 2] > 0).sum()) if p < 2 else 0
            if p == 2:
                kp[:, 2] = 0
            area = float(rng.choice([500.0, 4000.0, 20000.0]))
            anns.append({"id": len(anns) + 1, "image_id": i, "category_id": 1,
                         "keypoints": kp.reshape(-1).tolist(), "num_keypoints": n_kp,
                         "iscrowd": int(i == 3 and p == 1), "area": area,
                         "bbox": [float(kp[:, 0].min()), float(kp[:, 1].min()), 80.0, 120.0]})
            for _ in range(rng.randint(1, 3)):
                d = kp.copy()
                d[:, :2] += rng.randn(17, 2) * rng.choice([1.0, 5.0, 20.0])
                d[:, 2] = 1
                dets.append({"image_id": i, "category_id": 1, "keypoints": d.reshape(-1).tolist(),
                             "score": float(rng.rand())})
    dets.append({"image_id": 5, "category_id": 1, "keypoints": [1.0] * 51, "score": 0.9})
    return {"images": images, "annotations": anns}, dets


@pytest.mark.parametrize("as_dict", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_coco_eval_stats_match_jax(seed, as_dict):
    gt, dets = _coco_set(seed)
    gt_in = gt if as_dict else gt["annotations"]
    want = j_cocoeval.COCOKeypointsEval(gt_in, dets)
    got = cocoeval.COCOKeypointsEval(gt_in, dets)
    stats = got.evaluate()
    np.testing.assert_array_equal(stats, want.evaluate())
    assert (stats > 0).any()
    assert got.summarize() == want.summarize()
    np.testing.assert_array_equal(cocoeval.compute_oks_matrix(dets[:5], gt["annotations"][:4]),
                                  j_cocoeval.compute_oks_matrix(dets[:5], gt["annotations"][:4]))


# -- utils/image.py, inference/visualization.py ------------------------------------

def _tiles(seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 256, (h, w, 3), np.uint8) for h, w in ((20, 30), (25, 18), (12, 40))] + \
        [rng.randint(0, 256, (16, 16), np.uint8)]


@pytest.mark.parametrize("nrows,pad,match_size", [(1, 2, False), (2, 5, False), (2, 0, True)])
def test_make_grid_matches_jax(nrows, pad, match_size):
    tiles = _tiles(4)
    if match_size:
        tiles = tiles[:3]
    np.testing.assert_array_equal(image.make_grid(tiles, nrows, pad, match_size),
                                  j_image.make_grid(tiles, nrows, pad, match_size))


def test_stack_match_size_and_text_match_jax():
    tiles = _tiles(5)
    np.testing.assert_array_equal(image.stack_horizontally(tiles, 3), j_image.stack_horizontally(tiles, 3))
    for mode in ("height", "width"):
        for a, b in zip(image.match_size_to_src(tiles[0], tiles[1:3], mode),
                        j_image.match_size_to_src(tiles[0], tiles[1:3], mode)):
            np.testing.assert_array_equal(a, b)
    a, b = tiles[0].copy(), tiles[0].copy()
    image.put_txt(a, ["OKS: 0.50", "x"], alpha=0.7)
    j_image.put_txt(b, ["OKS: 0.50", "x"], alpha=0.7)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(image.get_color(19), j_image.get_color(19))


def test_plots_match_jax():
    rng = np.random.RandomState(6)
    img = rng.randint(0, 256, (48, 64, 3), np.uint8)
    kpts = rng.rand(3, 17, 2) * [64, 48]
    scores = rng.rand(3, 17)
    np.testing.assert_array_equal(
        visualization.plot_connections(img, kpts, scores, COCO_LIMBS, thr=0.3),
        j_vis.plot_connections(img, kpts, scores, J_LIMBS, thr=0.3))
    hms = rng.rand(48, 64, 17).astype(np.float32)
    for kw in ({"clip_0_1": True}, {"minmax": True}):
        for hm in (hms, np.moveaxis(hms, -1, 0), hms[::2, ::2]):
            for a, b in zip(visualization.plot_heatmaps(img, hm, **kw), j_vis.plot_heatmaps(img, hm, **kw)):
                np.testing.assert_array_equal(a, b)
    probs = rng.rand(10)
    np.testing.assert_array_equal(visualization.plot_top_probs(img, probs, [f"c{i}" for i in range(10)]),
                                  j_vis.plot_top_probs(img, probs, [f"c{i}" for i in range(10)]))


# -- inference/results.py ------------------------------------------------------

def _decoded(seed, n_persons=4, e=2):
    """Decoded arrays as the inference model hands them to ``from_decoded``,
    and annotations near the valid persons."""
    rng = np.random.RandomState(seed)
    h, w = 64, 96
    joints = np.concatenate([rng.rand(n_persons, 17, 2) * [w, h], rng.rand(n_persons, 17, 1),
                             rng.randn(n_persons, 17, e)], axis=-1).astype(np.float32)
    valid = np.arange(n_persons) < n_persons - 1
    center, scale = (60, 40), (120.0, 80.0)
    kw = dict(raw_image=rng.randint(0, 256, (80, 120, 3), np.uint8),
              model_input_image=rng.randint(0, 256, (h, w, 3), np.uint8),
              avg_heatmaps=rng.rand(h, w, 17).astype(np.float32),
              tags_heatmaps=rng.randn(h, w, 17, e).astype(np.float32),
              joints=joints, obj_scores=rng.rand(n_persons).astype(np.float32), valid=valid,
              center=center, scale=scale, det_thr=0.1, tag_thr=0.5)
    mapped = j_affine.transform_coords_inverse(joints[valid][..., :2], center, scale, (w, h))
    annot = []
    for p in (1, 0):
        kp = np.concatenate([mapped[p] + rng.randn(17, 2), np.full((17, 1), 2.0)], axis=1)
        annot.append({"keypoints": kp.reshape(-1).tolist(),
                      "segmentation": [[0, 0, 120, 0, 120, 80, 0, 80]]})
    return kw, annot


@pytest.mark.parametrize("e", [1, 2])
def test_inference_result_matches_jax(e):
    kw, annot = _decoded(7, e=e)
    want = j_results.InferenceKeypointsResult.from_decoded(annot=annot, limbs=J_LIMBS, **kw)
    got = results.InferenceKeypointsResult.from_decoded(annot=annot, limbs=COCO_LIMBS, **kw)
    for field in ("kpts_coords", "kpts_scores", "kpts_tags", "obj_scores", "tags_heatmaps"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
    assert got.to_coco_detections(3) == want.to_coco_detections(3)
    assert got.calculate_OKS() == want.calculate_OKS()
    np.testing.assert_array_equal(got.kpts_coords, want.kpts_coords)  # reordered alike
    plots, want_plots = got.plot(), want.plot()
    assert set(plots) == {"heatmaps", "connections", "associative_embedding"}
    for key in plots:
        np.testing.assert_array_equal(plots[key], want_plots[key])


def test_keypoints_result_plot_matches_jax():
    rng = np.random.RandomState(8)
    kw = dict(model_input_image=transforms.normalize(rng.randint(0, 256, (64, 64, 3), np.uint8)),
              kpts_heatmaps=rng.rand(64, 64, 17).astype(np.float32),
              tags_heatmaps=rng.randn(64, 64, 17).astype(np.float32),
              kpts_coords=rng.rand(2, 17, 2) * 64, kpts_scores=rng.rand(2, 17),
              kpts_tags=rng.randn(2, 17, 1), obj_scores=rng.rand(2))
    got = results.KeypointsResult(**kw).plot()
    want = j_results.KeypointsResult(**kw).plot()
    assert set(got) == {"connections", "heatmaps"}
    for key in got:
        np.testing.assert_array_equal(got[key], want[key])


# -- loggers/pylogger.py ---------------------------------------------------------

def test_logger_rank_gate_and_file_handler(tmp_path):
    """Without a process group the banner logs (rank 0); the file handler
    writes the device tag."""
    import logging

    lg = pylogger.get_pylogger("human_pose_tpu_torch.test_host")
    fh = pylogger.add_file_handler(lg, tmp_path / "run.log", device="cuda:1")
    try:
        pylogger.log_breaking_point("phase", logger=lg)
        lg.info("hello")
    finally:
        fh.close()
        lg.removeHandler(fh)
    text = (tmp_path / "run.log").read_text()
    assert "[cuda:1]" in text and "phase" in text and "hello" in text
    assert isinstance(pylogger.log, logging.Logger)


# -- ops/flip.py (NCHW) ------------------------------------------------------------

def _maps(seed, n=2, k=17, h=6, w=9):
    return np.random.RandomState(seed).randn(n, h, w, k).astype(np.float32)


def test_flip_ops_match_jax():
    """NHWC JAX vs NCHW port after the transpose: all three exact."""
    a, b = _maps(9), _maps(10)
    t = lambda x: torch.from_numpy(x.transpose(0, 3, 1, 2).copy())  # noqa: E731
    assert flip.COCO_FLIP_INDEX == j_flip.COCO_FLIP_INDEX
    np.testing.assert_array_equal(flip.flip_back(t(a)).numpy(),
                                  np.asarray(j_flip.flip_back(jnp.asarray(a))).transpose(0, 3, 1, 2))
    np.testing.assert_array_equal(
        flip.merge_flip_heatmaps(t(a), t(b)).numpy(),
        np.asarray(j_flip.merge_flip_heatmaps(jnp.asarray(a), jnp.asarray(b))).transpose(0, 3, 1, 2))
    got = flip.stack_flip_tags(t(a), t(b)).numpy()  # [N, K, 2, H, W]
    want = np.asarray(j_flip.stack_flip_tags(jnp.asarray(a), jnp.asarray(b)))  # [N, H, W, K, 2]
    np.testing.assert_array_equal(got, want.transpose(0, 3, 4, 1, 2))


# -- ops/heatmaps.py: the downsampling repair ----------------------------------------

RESIZE_TARGETS = {"down_both": (32, 44), "down_w_up_h": (128, 44), "down_w": (64, 44),
                  "down_4x": (16, 22), "up_4x": (256, 352), "up_2x": (128, 176),
                  "identity": (64, 88)}


@pytest.mark.parametrize("target", list(RESIZE_TARGETS), ids=list(RESIZE_TARGETS))
def test_resize_bilinear_matches_jax(target):
    """From 64x88: downsamples filter like ``jax.image.resize`` (antialias),
    upsamples are the plain interpolate; both within 1e-6, identity exact."""
    h, w = RESIZE_TARGETS[target]
    x = np.random.RandomState(11).randn(2, 17, 64, 88).astype(np.float32)
    want = np.asarray(j_resize(jnp.asarray(x), h, w, channel_major=True))
    got = resize_bilinear(torch.from_numpy(x), h, w).numpy()
    assert got.shape == (2, 17, h, w)
    if target == "identity":
        np.testing.assert_array_equal(got, x)
        np.testing.assert_array_equal(want, x)
    else:
        assert np.abs(got - want).max() <= 1e-6


def test_resize_bilinear_upsample_is_the_plain_call():
    """Upsamples (the main path's resizes) stay the plain interpolate, bit
    for bit."""
    x = torch.from_numpy(np.random.RandomState(12).randn(1, 3, 16, 24).astype(np.float32))
    for h, w in ((32, 48), (64, 96), (16, 48)):
        plain = torch.nn.functional.interpolate(x, size=(h, w), mode="bilinear", align_corners=False)
        assert torch.equal(resize_bilinear(x, h, w), plain)
