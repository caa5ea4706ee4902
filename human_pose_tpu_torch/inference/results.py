"""Result objects: decoded predictions + plotting + OKS (port of the
keypoints results of human_pose_tpu/inference/results.py; host NumPy arrays
in, channel-last maps; cv2 imported where it is used).

Counterpart of reference src/keypoints/results.py (KeypointsResult for
val-time plotting, InferenceKeypointsResult with inverse-affine coordinate
mapping and OKS) and of reference src/classification/results.py
(ClassificationResult: the top-5 probabilities over the input).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..data.affine import transform_coords_inverse
from ..data.coco import COCO_LIMBS
from ..data.transforms import inverse_normalize
from ..metrics.oks import image_OKS, match_preds_to_targets
from ..utils.image import make_grid, match_size_to_src, stack_horizontally
from .visualization import plot_connections, plot_grouped_ae_tags, plot_heatmaps, plot_top_probs


@dataclass
class KeypointsResult:
    """Val-time result for one sample (decode already done on device)."""

    model_input_image: np.ndarray  # normalized float HWC
    kpts_heatmaps: np.ndarray  # [H, W, K] averaged, input size
    tags_heatmaps: np.ndarray  # [H, W, K] first embedding
    kpts_coords: np.ndarray  # [P, K, 2]
    kpts_scores: np.ndarray  # [P, K]
    kpts_tags: np.ndarray  # [P, K, E]
    obj_scores: np.ndarray  # [P]
    limbs: list = field(default_factory=lambda: COCO_LIMBS)
    det_thr: float = 0.05

    def plot(self) -> dict[str, np.ndarray]:
        import cv2

        img = inverse_normalize(self.model_input_image)
        connections = plot_connections(
            img.copy(), self.kpts_coords, self.kpts_scores, self.limbs,
            thr=self.det_thr, alpha=0.8,
        )
        hms = plot_heatmaps(img, self.kpts_heatmaps, clip_0_1=True)
        hms_grid = make_grid(hms, nrows=3, pad=5)
        hms_grid = cv2.resize(hms_grid, dsize=(0, 0), fx=0.4, fy=0.4)
        return {"connections": connections, "heatmaps": hms_grid}


@dataclass
class InferenceKeypointsResult:
    """Inference result mapped back to raw-image coordinates
    (reference results.py:174-339)."""

    raw_image: np.ndarray
    annot: list[dict] | None
    model_input_image: np.ndarray  # uint8 (de-normalized)
    kpts_heatmaps: np.ndarray
    tags_heatmaps: np.ndarray
    kpts_coords: np.ndarray  # [P, K, 2] raw-image space
    kpts_scores: np.ndarray
    kpts_tags: np.ndarray
    obj_scores: np.ndarray
    limbs: list
    det_thr: float
    tag_thr: float

    @classmethod
    def from_decoded(
        cls,
        raw_image,
        annot,
        model_input_image,
        avg_heatmaps,  # [H, W, K] at input size
        tags_heatmaps,  # [H, W, K, E]
        joints,  # [P, K, 3+E] decoded at input size
        obj_scores,  # [P]
        valid,  # [P]
        center,
        scale,
        det_thr: float = 0.05,
        tag_thr: float = 0.5,
        limbs=COCO_LIMBS,
    ) -> "InferenceKeypointsResult":
        joints = np.asarray(joints)[np.asarray(valid)]
        obj_scores = np.asarray(obj_scores)[np.asarray(valid)]
        kpts_coords = joints[..., :2]
        kpts_scores = joints[..., 2]
        kpts_tags = joints[..., 3:]
        h, w = model_input_image.shape[:2]
        if len(kpts_coords):
            kpts_coords = transform_coords_inverse(kpts_coords, center, scale, (w, h))
        return cls(
            raw_image=raw_image,
            annot=annot,
            model_input_image=model_input_image,
            kpts_heatmaps=np.asarray(avg_heatmaps),
            tags_heatmaps=np.asarray(tags_heatmaps)[..., 0],
            kpts_coords=kpts_coords,
            kpts_scores=kpts_scores,
            kpts_tags=kpts_tags,
            obj_scores=obj_scores,
            limbs=limbs,
            det_thr=det_thr,
            tag_thr=tag_thr,
        )

    def calculate_OKS(self) -> float:
        assert self.annot is not None
        joints, polys = [], []
        for obj in self.annot:
            kpts = np.asarray(obj["keypoints"], np.float64).reshape(-1, 3)
            if (kpts[:, 2] > 0).any():
                joints.append(kpts)
                polys.append(obj.get("segmentation", []))
        if not joints or not len(self.kpts_coords):
            return -1.0
        joints = np.stack(joints)
        target_xy, target_vis = joints[..., :2], joints[..., 2]
        idx = match_preds_to_targets(self.kpts_coords, self.obj_scores, target_xy, target_vis)
        if -1 not in idx:
            self.kpts_coords = self.kpts_coords[idx]
            self.kpts_scores = self.kpts_scores[idx]
            self.obj_scores = self.obj_scores[idx]
        return image_OKS(self.kpts_coords, target_xy, target_vis, polys)

    def to_coco_detections(self, image_id: int) -> list[dict]:
        """COCO-format result dicts (reference eval.py:32-48)."""
        out = []
        for p in range(len(self.kpts_coords)):
            kpts = []
            for k in range(self.kpts_coords.shape[1]):
                kpts += [
                    float(self.kpts_coords[p, k, 0]),
                    float(self.kpts_coords[p, k, 1]),
                    1,
                ]
            out.append(
                {
                    "image_id": int(image_id),
                    "category_id": 1,
                    "keypoints": kpts,
                    "score": float(self.obj_scores[p]),
                }
            )
        return out

    def plot(self) -> dict[str, np.ndarray]:
        import cv2

        oks = self.calculate_OKS() if self.annot is not None else -1.0
        connections = plot_connections(
            self.raw_image.copy(), self.kpts_coords, self.kpts_scores, self.limbs,
            thr=self.det_thr, alpha=0.8,
        )
        kpts_plots = plot_heatmaps(self.model_input_image, self.kpts_heatmaps, minmax=True)
        tags_plots = plot_heatmaps(self.model_input_image, self.tags_heatmaps, minmax=True)
        hms = np.concatenate(
            [make_grid(kpts_plots, nrows=2, pad=5), make_grid(tags_plots, nrows=2, pad=5)],
            axis=0,
        )
        hms = cv2.resize(hms, dsize=(0, 0), fx=0.6, fy=0.6)
        ae = plot_grouped_ae_tags(self.kpts_tags) if len(self.kpts_tags) else np.full((100, 100, 3), 255, np.uint8)
        conn = match_size_to_src(ae, [connections], mode="height")[0]
        ae_plot = stack_horizontally([conn, ae])
        if oks >= 0:
            from ..utils.image import put_txt

            put_txt(connections, [f"OKS: {oks:.2f}"])
        return {
            "heatmaps": hms,
            "connections": connections,
            "associative_embedding": ae_plot,
        }



@dataclass
class ClassificationResult:
    image: np.ndarray  # model input, HWC: normalized float32, or uint8 (compact)
    probs: np.ndarray  # [num_classes]
    labels: list[str]
    target: int | None = None

    def plot(self) -> dict[str, np.ndarray]:
        return {"top_probs": plot_top_probs(inverse_normalize(self.image), self.probs, self.labels)}
