"""The COCO person-keypoints dataset (port of human_pose_tpu/data/coco.py;
NumPy, cv2 imported where it is used).

* annotation pre-bake (rank 0 only): parses ``person_keypoints_{split}.json``
  with plain json, drops images without annotations, writes per-sample
  ``.yaml`` annots and ``.npy`` crowd masks in the reference's layout
  (reference coco.py:244-289)
* ``CocoKeypointsDataset``: the paths, ``load_image``, ``load_annot`` and
  ``get_raw_data`` that evaluation reads; ``__getitem__`` with the optional
  2x2 mosaic, the crowd filter, the per-scale transform and the Gaussian
  heatmap and padded joints targets (reference coco.py:451-475), plain or
  compact (uint8 image, fp16 heatmaps, bool masks)
* ``collate``: the JAX package's fixed-shape channel-last batch, the same
  arrays and dtypes; the device side puts it in the steps' NCHW layout
  (``train/module.py::BaseModule.batch_to_device``)
"""

from __future__ import annotations

import glob
import json
from pathlib import Path

import numpy as np

from ..loggers.pylogger import log
from ..utils.files import load_yaml, save_yaml
from ..utils.utils import get_rank
from .rle import get_crowd_mask
from .targets import HeatmapGenerator, JointsGenerator

COCO_LABELS = [
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip",
    "left_knee", "right_knee", "left_ankle", "right_ankle",
]

COCO_LIMBS = [
    (9, 7), (7, 5), (5, 3), (3, 1), (1, 0), (0, 2), (1, 2), (2, 4), (4, 6),
    (6, 8), (8, 10), (5, 6), (5, 11), (6, 12), (11, 12), (11, 13), (13, 15),
    (12, 14), (14, 16),
]


def get_coco_joints(annots: list[dict]) -> np.ndarray:
    joints = np.zeros((len(annots), 17, 3))
    for i, obj in enumerate(annots):
        joints[i] = np.asarray(obj["keypoints"], np.float64).reshape(-1, 3)
    return joints


def prebake_annotations(root: str, split: str) -> None:
    """Write per-image annot yaml + crowd-mask npy files (rank 0 only),
    same directory layout as the reference (coco.py:244-289)."""
    if get_rank() != 0:
        log.warning(f"rank {get_rank()} != 0 -> skipping annotation pre-bake")
        return
    kpts_dir = f"person_keypoints_{split}"
    annots_dir = Path(root) / "annotations" / kpts_dir
    masks_dir = Path(root) / "masks" / kpts_dir
    json_path = Path(root) / "annotations" / f"person_keypoints_{split}.json"

    with open(json_path) as f:
        coco = json.load(f)
    img_info = {im["id"]: im for im in coco["images"]}
    by_image: dict[int, list[dict]] = {}
    for ann in coco["annotations"]:
        by_image.setdefault(ann["image_id"], []).append(ann)

    ids = [i for i in img_info if by_image.get(i)]
    existing = len(glob.glob(str(annots_dir / "*")))
    if annots_dir.exists() and existing == len(ids):
        log.info(f"{split} annotations already pre-baked ({existing} files)")
        return
    log.info(f"pre-baking {len(ids)} {split} annotations (yaml + crowd-mask npy)")
    annots_dir.mkdir(parents=True, exist_ok=True)
    masks_dir.mkdir(parents=True, exist_ok=True)
    for img_id in ids:
        info = img_info[img_id]
        stem = Path(info["file_name"]).stem
        annot = by_image[img_id]
        mask = get_crowd_mask(annot, info["height"], info["width"])
        np.save(masks_dir / f"{stem}.npy", mask)
        save_yaml([dict(a) for a in annot], annots_dir / f"{stem}.yaml")


class CocoKeypointsDataset:
    limbs = COCO_LIMBS
    labels = COCO_LABELS
    name = "COCO"

    def __init__(
        self,
        root: str,
        split: str,
        transform=None,
        out_size: int = 512,
        hm_resolutions: list[float] = (0.25, 0.5),
        num_kpts: int = 17,
        max_num_people: int = 30,
        sigma: float = 2.0,
        mosaic_probability: float = 0.0,
        compact: bool = False,
    ):
        """The JAX dataset's signature. ``transform`` is a
        ``ComposeKeypointsTransform`` (training samples) or None (raw images
        for evaluation, untransformed samples)."""
        self.root = root
        self.split = split
        self.transform = transform
        self.compact = compact
        self.out_size = out_size
        self.num_scales = len(hm_resolutions)
        self.num_kpts = num_kpts
        self.max_num_people = max_num_people
        self.sigma = sigma
        self.mosaic_probability = mosaic_probability
        self.is_train = "train" in split
        kpts_dir = f"person_keypoints_{split}"
        self.images_dir = f"{root}/images/{split}"
        self.annots_dir = f"{root}/annotations/{kpts_dir}"
        self.masks_dir = f"{root}/masks/{kpts_dir}"
        self._set_paths()
        self.hm_sizes = [int(r * out_size) for r in hm_resolutions]
        self.hm_generators = [HeatmapGenerator(num_kpts, s, sigma) for s in self.hm_sizes]
        self.joints_generators = [JointsGenerator(s, max_num_people) for s in self.hm_sizes]

    def _set_paths(self) -> None:
        annots = sorted(glob.glob(f"{self.annots_dir}/*.yaml"))
        self.annots_filepaths = annots
        self.images_filepaths = [f"{self.images_dir}/{Path(p).stem}.jpg" for p in annots]
        self.masks_filepaths = [f"{self.masks_dir}/{Path(p).stem}.npy" for p in annots]
        if not annots:
            log.warning(
                f"no pre-baked annotations under {self.annots_dir} — run "
                f"prebake_annotations('{self.root}', '{self.split}') first"
            )

    def __len__(self) -> int:
        return len(self.annots_filepaths)

    def load_image(self, idx: int) -> np.ndarray:
        import cv2

        img = cv2.imread(self.images_filepaths[idx])
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def load_annot(self, idx: int):
        return load_yaml(self.annots_filepaths[idx])

    def get_raw_data(self, idx: int):
        image = self.load_image(idx)
        annot = self.load_annot(idx)
        mask = np.load(self.masks_filepaths[idx])
        return image, annot, mask

    def get_raw_mosaiced_data(self, idx: int, rng: np.random.Generator):
        """2x2 mosaic (reference coco.py:300-370, without the segmentation
        rescale, which the training targets do not read)."""
        import cv2

        out_size = self.out_size * 2
        img_size = out_size // 2
        idxs = [idx] + [int(rng.integers(0, len(self))) for _ in range(3)]
        mosaic_annot: list[dict] = []
        mosaic_img = np.zeros([out_size, out_size, 3], np.uint8)
        mosaic_mask = np.empty([out_size, out_size], bool)
        for i, cur in enumerate(idxs):
            img, annot, mask = self.get_raw_data(cur)
            img_h, img_w = img.shape[:2]
            s_y = 0 if i < 2 else img_size
            s_x = 0 if i % 2 == 0 else img_size
            new_img = cv2.resize(img, (img_size, img_size))
            # the reference resizes the baked mask too, and its `> 0.5` on
            # uint8 masks a pixel that any nonzero value reaches
            new_mask = cv2.resize((mask * 255).astype(np.uint8), (img_size, img_size)) > 0
            sy, sx = img_size / img_h, img_size / img_w
            for obj in annot:
                kpts = np.asarray(obj["keypoints"], np.float64).reshape(-1, 3)
                invisible = kpts[:, 2] <= 0
                kpts[:, 0] = kpts[:, 0] * sx + s_x
                kpts[:, 1] = kpts[:, 1] * sy + s_y
                kpts[invisible] = 0
                mosaic_annot.append({
                    "keypoints": kpts.ravel().tolist(),
                    "iscrowd": obj.get("iscrowd", 0),
                    "num_keypoints": obj.get("num_keypoints", 0),
                })
            mosaic_img[s_y : s_y + img_size, s_x : s_x + img_size] = new_img
            mosaic_mask[s_y : s_y + img_size, s_x : s_x + img_size] = new_mask
        return mosaic_img, mosaic_annot, mosaic_mask

    def __getitem__(self, idx: int, rng: np.random.Generator | None = None):
        """Returns (image ``[H, W, 3]`` float32, heatmaps list of ``[h, w, K]``
        float32, masks list of ``[h, w]`` float32, joints ``[P, K, 3]`` int32
        at 1/4 scale); compact: uint8 image, float16 heatmaps, bool masks.

        Every random draw comes from ``rng`` (the loader derives it from
        (seed, epoch, idx)), in the JAX package's order."""
        if rng is None:
            rng = np.random.default_rng()
        if rng.random() < self.mosaic_probability:
            img, annot, mask = self.get_raw_mosaiced_data(idx, rng)
        else:
            img, annot, mask = self.get_raw_data(idx)

        annots = [o for o in annot if o.get("iscrowd", 0) == 0 or o.get("num_keypoints", 0) > 0]
        joints = get_coco_joints(annots)
        mask_list = [mask.astype(np.float32).copy() for _ in range(self.num_scales)]
        joints_list = [joints.copy() for _ in range(self.num_scales)]
        if self.transform is not None:
            img, mask_list, joints_list = self.transform(img, mask_list, joints_list, rng)
        heatmaps = []
        padded_joints = []
        for i in range(self.num_scales):
            pj = self.joints_generators[i](joints_list[i])
            padded_joints.append(pj)
            heatmaps.append(self.hm_generators[i](pj[pj.sum(axis=(1, 2)) > 0]))
        # the AE loss samples tags at the 1/4-resolution scale (reference loss.py:90)
        if self.compact:
            # compact host batches: uint8 image (normalized on the device),
            # fp16 Gaussian targets in [0, 1] (the loss upcasts), bool masks
            # (exact: the warp binarizes them)
            if img.dtype != np.uint8:
                # a float image would reach the step un-normalized (the
                # device prep normalizes integer images only)
                raise ValueError(
                    f"compact dataset requires a uint8 image from the transform, got {img.dtype} "
                    "— build the transform with normalize=False"
                )
            return (
                img,
                [h.astype(np.float16) for h in heatmaps],
                [m.astype(bool) for m in mask_list],
                padded_joints[0],
            )
        return img.astype(np.float32), heatmaps, mask_list, padded_joints[0]


def collate(samples: list) -> dict:
    """The fixed-shape channel-last batch of the JAX package: ``images``
    ``[N, H, W, 3]``, ``heatmaps`` and ``masks`` lists of ``[N, h, w, K]``
    and ``[N, h, w]`` a scale, ``joints`` ``[N, P, K, 3]`` int32."""
    num_scales = len(samples[0][1])
    return {
        "images": np.stack([s[0] for s in samples]),
        "heatmaps": [np.stack([s[1][i] for s in samples]) for i in range(num_scales)],
        "masks": [np.stack([s[2][i] for s in samples]) for i in range(num_scales)],
        "joints": np.stack([s[3] for s in samples]).astype(np.int32),
    }
