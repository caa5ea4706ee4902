"""Base image datasets (port of human_pose_tpu/data/base.py; counterpart of
reference src/base/datasets/base.py):
``BaseImageDataset`` (root/split/transform image loading), ``DirectoryDataset``
(natural-sorted glob of jpgs), ``ExplorerDataset`` (interactive browsing) and
``InferenceDataset.perform_inference`` (interactive loop with keybinds + plot
saving; display gated off when headless). cv2 is imported where it is used."""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Callable

import numpy as np

from ..loggers.pylogger import log


def natural_sort_key(s: str):
    return [int(t) if t.isdigit() else t.lower() for t in re.split(r"(\d+)", s)]


class BaseImageDataset:
    def __init__(self, root: str, split: str = "", transform: Callable | None = None):
        self.root = root
        self.split = split
        self.transform = transform
        self.images_filepaths: list[str] = []

    def __len__(self) -> int:
        return len(self.images_filepaths)

    def load_image(self, idx: int) -> np.ndarray:
        import cv2

        img = cv2.imread(str(self.images_filepaths[idx]))
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def __getitem__(self, idx: int):
        img = self.load_image(idx)
        if self.transform is not None:
            img = self.transform(img)
        return img

    def plot_examples(self, idxs: list[int], nrows: int = 1, **kwargs) -> np.ndarray:
        from ..utils.image import make_grid

        return make_grid([np.asarray(self.plot(i, **kwargs)) for i in idxs], nrows=nrows)

    def plot(self, idx: int, **kwargs) -> np.ndarray:
        return self.load_image(idx)


class DirectoryDataset(BaseImageDataset):
    """All jpg/JPEG/png files under a directory, naturally sorted
    (reference base.py:180-197)."""

    EXTS = (".jpg", ".jpeg", ".png", ".JPG", ".JPEG", ".PNG")

    def __init__(self, dirpath: str, transform: Callable | None = None):
        super().__init__(dirpath, "", transform)
        files = [
            str(p) for p in Path(dirpath).iterdir() if p.suffix in self.EXTS
        ]
        self.images_filepaths = sorted(files, key=natural_sort_key)


class ExplorerDataset(BaseImageDataset):
    """Interactive cv2 browsing (reference base.py:51-79); requires a display."""

    def explore(self, start_idx: int = 0) -> None:
        if not os.environ.get("DISPLAY"):
            log.warning("no display — explore() unavailable in headless mode")
            return
        import cv2

        idx = start_idx
        while True:
            img = np.asarray(self.plot(idx))
            cv2.imshow("explorer", cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
            key = cv2.waitKey(0) & 0xFF
            if key in (ord("q"), 27):
                break
            if key in (ord("d"), 83):
                idx = min(idx + 1, len(self) - 1)
            if key in (ord("a"), 81):
                idx = max(idx - 1, 0)
        cv2.destroyAllWindows()


class InferenceDataset(DirectoryDataset):
    """Runs a model over a directory; interactive when a display exists,
    otherwise saves plots (reference base.py:103-153)."""

    def perform_inference(
        self, model: Callable, out_dir: str | None = "inference_results", idxs=None
    ) -> None:
        import cv2

        display = bool(os.environ.get("DISPLAY"))
        indices = idxs if idxs is not None else range(len(self))
        for idx in indices:
            image = self.load_image(idx)
            result = model(image, None)
            plots = result.plot()
            stem = Path(self.images_filepaths[idx]).stem
            if out_dir:
                Path(out_dir).mkdir(parents=True, exist_ok=True)
                for name, img in plots.items():
                    cv2.imwrite(
                        str(Path(out_dir) / f"{stem}_{name}.jpg"),
                        cv2.cvtColor(img, cv2.COLOR_RGB2BGR),
                    )
            if display:
                for name, img in plots.items():
                    cv2.imshow(name, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
                key = cv2.waitKey(0) & 0xFF
                if key in (ord("q"), 27):
                    break
        if display:
            cv2.destroyAllWindows()
