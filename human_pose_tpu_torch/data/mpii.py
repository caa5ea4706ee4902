"""MPII single-person dataset scaffolding (port of
human_pose_tpu/data/mpii.py; counterpart of reference
src/keypoints/datasets/mpii.py): the joint layout and a minimal reader of
json annotations (MPII ships a .mat file commonly converted to json). The
PCKh metric is ``metrics/pckh.py``. Host-side NumPy; cv2 imported where it
is used."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

MPII_LABELS = [
    "r_ankle", "r_knee", "r_hip", "l_hip", "l_knee", "l_ankle", "pelvis",
    "thorax", "upper_neck", "head_top", "r_wrist", "r_elbow", "r_shoulder",
    "l_shoulder", "l_elbow", "l_wrist",
]

MPII_LIMBS = [
    (0, 1), (1, 2), (2, 6), (3, 6), (3, 4), (4, 5), (6, 7), (7, 8), (8, 9),
    (10, 11), (11, 12), (12, 7), (13, 7), (13, 14), (14, 15),
]

MPII_FLIP_INDEX = [5, 4, 3, 2, 1, 0, 6, 7, 8, 9, 15, 14, 13, 12, 11, 10]


class MpiiKeypointsDataset:
    """Minimal MPII reader of ``<root>/annot/<split>.json``: a list of
    {image, joints [16, 2], joints_vis [16], center, scale}; images under
    ``<root>/images``. A missing annotation file gives an empty dataset."""

    labels = MPII_LABELS
    limbs = MPII_LIMBS
    name = "MPII"

    def __init__(self, root: str, split: str = "train", transform=None):
        self.root = root
        self.split = split
        self.transform = transform
        annot_path = Path(root) / "annot" / f"{split}.json"
        self.annotations: list[dict] = []
        if annot_path.exists():
            with open(annot_path) as f:
                self.annotations = json.load(f)

    def __len__(self) -> int:
        return len(self.annotations)

    def load_image(self, idx: int) -> np.ndarray:
        import cv2

        a = self.annotations[idx]
        img = cv2.imread(str(Path(self.root) / "images" / a["image"]))
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def __getitem__(self, idx: int):
        """(image RGB ``[H, W, 3]``, joints ``[16, 2]`` and visibility
        ``[16]`` float32), the image through ``transform`` when given."""
        a = self.annotations[idx]
        img = self.load_image(idx)
        joints = np.asarray(a["joints"], np.float32)
        vis = np.asarray(a["joints_vis"], np.float32)
        if self.transform is not None:
            img = self.transform(img)
        return img, joints, vis
