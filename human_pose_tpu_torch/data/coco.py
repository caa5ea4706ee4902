"""The COCO person-keypoints dataset, eval side (port of
human_pose_tpu/data/coco.py; NumPy, cv2 imported where it is used).

* annotation pre-bake (rank 0 only): parses ``person_keypoints_{split}.json``
  with plain json, drops images without annotations, writes per-sample
  ``.yaml`` annots and ``.npy`` crowd masks in the reference's layout
  (reference coco.py:244-289)
* ``CocoKeypointsDataset``: the paths, ``load_image``, ``load_annot`` and
  ``get_raw_data`` that evaluation reads. The training side (``__getitem__``
  with the mosaic and the heatmap/joints targets, ``collate``) comes with
  the port's training, ROADMAP module 10, and raises until then.
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

TRAINING_SIDE = ("the keypoints dataset's training side (targets, mosaic, collate) comes with "
                 "the port's training, ROADMAP module 10")


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
        """The JAX dataset's signature. ``transform`` must be None (raw
        images for evaluation); a training transform raises."""
        if transform is not None:
            raise NotImplementedError(f"transform={transform!r}: {TRAINING_SIDE}")
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
        raise NotImplementedError(TRAINING_SIDE)

    def __getitem__(self, idx: int, rng: np.random.Generator | None = None):
        raise NotImplementedError(TRAINING_SIDE)


def collate(samples: list) -> dict:
    raise NotImplementedError(TRAINING_SIDE)
