"""COCO person crops for the top-down (single-person) nets: one sample an
annotated person with at least one labelled joint, the crop's target
heatmaps and the joints' target weights (NumPy; cv2 imported where it is
used).

Follows pose_hrnet's ``COCODataset`` and ``JointsDataset`` (Sun et al.,
CVPR 2019; ``leoxiaobin/deep-high-resolution-net.pytorch``, lib/dataset/)
with the augmentation of its COCO yamls:

* the crop: the GT box's centre, the box widened or heightened to the
  crop's aspect (width : height of the input, 3 : 4 at 384x288), in units
  of 200 px, times 1.25;
* training: with probability ``PROB_HALF_BODY`` (0.3), when more than
  ``NUM_JOINTS_HALF_BODY`` (8) joints are labelled, the box of the upper or
  the lower body's labelled joints (the upper when ``randn() < 0.5`` and it
  has more than 2, as the source draws it) times 1.5; the scale times
  ``clip(1 + sf * randn, 1 - sf, 1 + sf)`` with ``SCALE_FACTOR`` sf 0.35;
  with probability 0.6 a rotation of ``clip(rf * randn, -2 rf, 2 rf)``
  degrees with ``ROTATION_FACTOR`` rf 45; with probability 0.5 a
  horizontal flip with the COCO left/right swap
  (``transforms.COCO_FLIP_INDEX``);
* the crop warped by ``affine.get_affine_transform`` (bilinear) to
  ``out_size`` rows and three quarters of that in columns, the labelled
  joints mapped by the same matrix;
* targets: a Gaussian of ``sigma`` at each labelled joint at the heatmap
  resolution (``hm_resolution`` of the input), peak 1 on a zero background
  (``targets.HeatmapGenerator`` on the square of the map's longer side,
  cropped); ``target_weight`` 1 for a labelled joint whose rounded heatmap
  position lies inside the map, else 0.

Departures from the source:

* a joint whose centre lies outside the heatmap has weight 0 and no
  Gaussian; the source keeps weight 1 and draws the part of its Gaussian
  that falls inside the map while the 3-sigma window touches it;
* the Gaussian is ``HeatmapGenerator``'s: a window of 6 sigma + 3 pixels
  (21 at sigma 3) where the source's has 6 sigma + 1 (19), so the window's
  edge (values under 0.004) reaches one pixel further;
* the validation crops are the GT boxes' (the source's COCO yamls validate
  on a person detector's boxes and score them with OKS);
* every random draw comes from the loader's per-sample ``rng``, in the
  order above (the source mixes ``np.random`` and ``random``);
* the crop stays uint8 (normalized on the device by
  ``ops.images.prep_images``, ImageNet mean and std as the source's).

``collate_topdown`` stacks the samples channel-last, as ``coco.collate``
does: ``images`` ``[N, H, W, 3]`` uint8, ``heatmaps`` ``[N, h, w, K]``
float32, ``target_weight`` ``[N, K]`` float32.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from .affine import get_affine_transform
from .targets import HeatmapGenerator
from .transforms import COCO_FLIP_INDEX

PIXEL_STD = 200.0  # the source's box unit
BOX_PADDING = 1.25
HALF_BODY_PADDING = 1.5
# the augmentation of the source's COCO yamls
SCALE_FACTOR = 0.35
ROTATION_FACTOR = 45.0
ROTATION_PROBABILITY = 0.6
FLIP_PROBABILITY = 0.5
PROB_HALF_BODY = 0.3
NUM_JOINTS_HALF_BODY = 8
UPPER_BODY = tuple(range(11))  # nose .. wrists; hips .. ankles below


def box_to_center_scale(box, aspect: float, padding: float = BOX_PADDING):
    """``(x, y, w, h)`` -> ``(center [2], scale [2])``: the box widened or
    heightened to ``aspect`` (width over height), in 200-px units, times
    ``padding`` (the source's ``_box2cs``)."""
    x, y, w, h = (float(v) for v in box)
    center = np.array([x + w * 0.5, y + h * 0.5], np.float32)
    if w > aspect * h:
        h = w / aspect
    elif w < aspect * h:
        w = h * aspect
    return center, np.array([w, h], np.float32) / PIXEL_STD * padding


def half_body_center_scale(joints: np.ndarray, vis: np.ndarray, aspect: float,
                           rng: np.random.Generator):
    """The box of the upper or the lower body's labelled joints (the
    source's ``half_body_transform``), or ``(None, None)`` when the chosen
    half has fewer than 2."""
    upper = [joints[k] for k in range(len(joints)) if vis[k] > 0 and k in UPPER_BODY]
    lower = [joints[k] for k in range(len(joints)) if vis[k] > 0 and k not in UPPER_BODY]
    if rng.standard_normal() < 0.5 and len(upper) > 2:
        chosen = upper
    else:
        chosen = lower if len(lower) > 2 else upper
    if len(chosen) < 2:
        return None, None
    pts = np.asarray(chosen, np.float32)
    lo, hi = pts.min(0), pts.max(0)
    box = (lo[0], lo[1], hi[0] - lo[0], hi[1] - lo[1])
    _, scale = box_to_center_scale(box, aspect, HALF_BODY_PADDING)
    return pts.mean(0), scale


def load_person_annotations(json_path) -> tuple:
    """The COCO keypoints json -> ``(images {id: info}, persons)``: one
    person a non-crowd annotation with at least one labelled joint and a
    non-empty box inside its image, ``{"image_id", "box" (x, y, w, h),
    "joints" [K, 2], "vis" [K]}``."""
    with open(json_path) as f:
        coco = json.load(f)
    images = {im["id"]: im for im in coco["images"]}
    persons = []
    for ann in coco["annotations"]:
        kpts = np.asarray(ann.get("keypoints", []), np.float32).reshape(-1, 3)
        info = images.get(ann["image_id"])
        if info is None or ann.get("iscrowd", 0) or not len(kpts) or kpts[:, 2].max() <= 0:
            continue
        x, y, w, h = ann["bbox"]
        x1, y1 = max(0.0, x), max(0.0, y)
        x2 = min(info["width"] - 1.0, x1 + max(0.0, w - 1))
        y2 = min(info["height"] - 1.0, y1 + max(0.0, h - 1))
        if ann.get("area", 1) <= 0 or x2 < x1 or y2 < y1:
            continue
        persons.append({"image_id": ann["image_id"], "box": (x1, y1, x2 - x1, y2 - y1),
                        "joints": kpts[:, :2].copy(), "vis": (kpts[:, 2] > 0).astype(np.float32)})
    return images, persons


class CocoTopDownDataset:
    """Person crops of ``<root>/annotations/person_keypoints_<split>.json``
    with images under ``<root>/images/<split>``; ``augment`` draws the
    training augmentation (else the crop of the GT box alone)."""

    name = "COCO"

    def __init__(self, root: str, split: str, out_size: int = 384, hm_resolution: float = 0.25,
                 num_kpts: int = 17, sigma: float = 3.0, augment: bool = True):
        self.root, self.split = root, split
        self.input_hw = (out_size, out_size * 3 // 4)
        self.hm_hw = (round(out_size * hm_resolution), round(out_size * 3 // 4 * hm_resolution))
        self.aspect = self.input_hw[1] / self.input_hw[0]
        self.num_kpts = num_kpts
        self.augment = augment
        self.images_dir = Path(root) / "images" / split
        json_path = Path(root) / "annotations" / f"person_keypoints_{split}.json"
        self.images, self.persons = load_person_annotations(json_path)
        self.hm_generator = HeatmapGenerator(num_kpts, max(self.hm_hw), sigma)

    def __len__(self) -> int:
        return len(self.persons)

    def load_image(self, image_id) -> np.ndarray:
        import cv2

        img = cv2.imread(str(self.images_dir / self.images[image_id]["file_name"]))
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def crop(self, idx: int, rng: np.random.Generator | None = None):
        """The sample's image, its affine (2x3, image to crop) and its
        joints ``[K, 2]`` and labels ``[K]`` in the image after any flip."""
        p = self.persons[idx]
        img = self.load_image(p["image_id"])
        joints, vis = p["joints"].copy(), p["vis"].copy()
        center, scale = box_to_center_scale(p["box"], self.aspect)
        rot = 0.0
        if self.augment:
            if rng is None:
                rng = np.random.default_rng()
            if vis.sum() > NUM_JOINTS_HALF_BODY and rng.random() < PROB_HALF_BODY:
                c, s = half_body_center_scale(joints, vis, self.aspect, rng)
                if c is not None:
                    center, scale = c, s
            sf, rf = SCALE_FACTOR, ROTATION_FACTOR
            scale = scale * np.clip(rng.standard_normal() * sf + 1, 1 - sf, 1 + sf)
            if rng.random() <= ROTATION_PROBABILITY:
                rot = float(np.clip(rng.standard_normal() * rf, -2 * rf, 2 * rf))
            if rng.random() <= FLIP_PROBABILITY:
                width = img.shape[1]
                img = img[:, ::-1]
                joints[:, 0] = width - joints[:, 0] - 1
                joints, vis = joints[COCO_FLIP_INDEX], vis[COCO_FLIP_INDEX]
                center = np.array([width - center[0] - 1, center[1]], np.float32)
        h, w = self.input_hw
        trans = get_affine_transform(center, scale * PIXEL_STD, rot, (w, h))
        return np.ascontiguousarray(img), trans, joints, vis

    def targets(self, joints: np.ndarray, vis: np.ndarray):
        """Crop joints ``[K, 2]`` and labels ``[K]`` -> (heatmaps ``[h, w,
        K]`` float32, target_weight ``[K]`` float32)."""
        h, w = self.hm_hw
        stride = self.input_hw[0] / h
        mu = (joints / stride + 0.5).astype(np.int32)  # int(), as the source
        inside = (vis > 0) & (mu[:, 0] >= 0) & (mu[:, 0] < w) & (mu[:, 1] >= 0) & (mu[:, 1] < h)
        pts = np.concatenate([mu, inside[:, None].astype(np.int32)], 1)[None]
        heatmaps = self.hm_generator(pts)[:h, :w]
        return np.ascontiguousarray(heatmaps), inside.astype(np.float32)

    def __getitem__(self, idx: int, rng: np.random.Generator | None = None):
        """``(image [H, W, 3] uint8, heatmaps [h, w, K] float32,
        target_weight [K] float32)``."""
        import cv2

        img, trans, joints, vis = self.crop(idx, rng)
        h, w = self.input_hw
        crop = cv2.warpAffine(img, trans, (w, h), flags=cv2.INTER_LINEAR)
        mapped = joints @ trans[:, :2].T + trans[:, 2]
        heatmaps, weight = self.targets(mapped, vis)
        return crop, heatmaps, weight


def collate_topdown(samples: list) -> dict:
    """Channel-last batch: ``images`` ``[N, H, W, 3]``, ``heatmaps`` ``[N,
    h, w, K]``, ``target_weight`` ``[N, K]``."""
    return {"images": np.stack([s[0] for s in samples]),
            "heatmaps": np.stack([s[1] for s in samples]),
            "target_weight": np.stack([s[2] for s in samples]).astype(np.float32)}
