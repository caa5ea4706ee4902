"""ImageNet classification dataset in the ImageFolder layout (port of
human_pose_tpu/data/imagenet.py; counterpart of reference
src/classification/datasets/imagenet.py:15-41).

``root/<split>/<wordnet_id>/*`` with class indices in sorted directory
order and the wordnet id -> label map of ``root/wordnet_labels.yaml`` when
it exists (else the ids themselves).
"""

from __future__ import annotations

import glob
from pathlib import Path
from typing import Callable

import numpy as np

from ..utils.files import load_yaml


class ImagenetClassificationDataset:
    name = "ImageNet"

    def __init__(self, root: str, split: str, transform: Callable | None = None):
        self.root = root
        self.split = split
        self.transform = transform
        split_dir = Path(root) / split
        class_dirs = sorted(d.name for d in split_dir.iterdir() if d.is_dir())
        self.wnid_to_idx = {wnid: i for i, wnid in enumerate(class_dirs)}
        labels_path = Path(root) / "wordnet_labels.yaml"
        if labels_path.exists():
            self.wnid_to_label = load_yaml(labels_path)
        else:
            self.wnid_to_label = {w: w for w in class_dirs}
        self.idx_to_label = {i: self.wnid_to_label.get(w, w) for w, i in self.wnid_to_idx.items()}
        self.samples: list[tuple[str, int]] = []
        for wnid in class_dirs:
            for p in sorted(glob.glob(str(split_dir / wnid / "*"))):
                self.samples.append((p, self.wnid_to_idx[wnid]))

    def __len__(self) -> int:
        return len(self.samples)

    def load_image(self, idx: int) -> np.ndarray:
        """The sample's image, RGB uint8 HWC."""
        import cv2

        path, _ = self.samples[idx]
        return cv2.cvtColor(cv2.imread(path), cv2.COLOR_BGR2RGB)

    def __getitem__(self, idx: int, rng: np.random.Generator | None = None):
        """``(image, label)``: the transformed image (uint8 from a compact
        transform, normalized float32 otherwise) and the class index."""
        img = self.load_image(idx)
        label = self.samples[idx][1]
        if self.transform is not None:
            img = self.transform(img, rng=rng)
        if img.dtype == np.uint8:
            return img, label
        return img.astype(np.float32), label


def collate_classification(samples: list) -> dict:
    """``images`` ``[N, H, W, 3]`` (channel-last, as the JAX package's) and
    ``labels`` ``[N]`` int32."""
    return {
        "images": np.stack([s[0] for s in samples]),
        "labels": np.asarray([s[1] for s in samples], np.int32),
    }
