"""Host-side affine transform math (NumPy; cv2 imported where it is used).

Port of human_pose_tpu/data/affine.py: the 3-point-correspondence affine
(center/scale/rot -> 2x3 matrix), the 64-multiple multi-scale size alignment
used for inference resizing, and the point-mapping helpers, with the same
formulas so decoded keypoints map back to the same raw-image coordinates.
The training affine (``get_aug_affine_matrix``) comes with training.
"""

from __future__ import annotations

import numpy as np


def affine_transform_point(point, matrix: np.ndarray) -> np.ndarray:
    """Map one (x, y) point through a 2x3 affine matrix
    (reference transforms/utils.py:5-8)."""
    p = np.array([point[0], point[1], 1.0])
    return (matrix @ p)[:2]


def _third_point(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    d = a - b
    return b + np.array([-d[1], d[0]], dtype=np.float32)


def get_affine_transform(
    center, scale, rot: float, output_size, shift=(0, 0), inverse: bool = False
) -> np.ndarray:
    """center/scale/rot -> 2x3 affine via 3-point correspondence
    (reference transforms/utils.py:25-57). ``scale`` is (w, h) in pixels."""
    center = np.asarray(center, np.float32)
    scale = np.asarray(scale, np.float32)
    shift = np.asarray(shift, np.float32)

    src_w = scale[0]
    dst_w, dst_h = output_size[0], output_size[1]

    rot_rad = np.pi * rot / 180.0
    sn, cs = np.sin(rot_rad), np.cos(rot_rad)
    src_point = np.array([0.0, -src_w / 2.0])
    src_dir = np.array(
        [src_point[0] * cs - src_point[1] * sn, src_point[0] * sn + src_point[1] * cs],
        np.float32,
    )
    dst_dir = np.array([0.0, -dst_w / 2.0], np.float32)

    src = np.zeros((3, 2), np.float32)
    dst = np.zeros((3, 2), np.float32)
    src[0] = center + scale * shift
    src[1] = center + src_dir + scale * shift
    dst[0] = [dst_w * 0.5, dst_h * 0.5]
    dst[1] = np.array([dst_w * 0.5, dst_h * 0.5], np.float32) + dst_dir
    src[2] = _third_point(src[0], src[1])
    dst[2] = _third_point(dst[0], dst[1])

    if inverse:
        src, dst = dst, src
    import cv2

    return cv2.getAffineTransform(src, dst)


def get_multi_scale_size(image: np.ndarray, input_size: int, current_scale: float, min_scale: float):
    """64-multiple size alignment for arbitrary aspect ratios
    (reference transforms/utils.py:60-86). Returns ((w, h), center, scale)."""
    h, w = image.shape[:2]
    center = (int(w / 2.0 + 0.5), int(h / 2.0 + 0.5))
    min_input_size = int((min_scale * input_size + 63) // 64 * 64)
    if w < h:
        w_resized = int(min_input_size * current_scale / min_scale)
        h_resized = int(int((min_input_size / w * h + 63) // 64 * 64) * current_scale / min_scale)
        scale_w = w
        scale_h = h_resized / w_resized * w
    else:
        h_resized = int(min_input_size * current_scale / min_scale)
        w_resized = int(int((min_input_size / h * w + 63) // 64 * 64) * current_scale / min_scale)
        scale_h = h
        scale_w = w_resized / h_resized * h
    return (w_resized, h_resized), center, (scale_w, scale_h)


def resize_align_multi_scale(image: np.ndarray, input_size: int, current_scale: float, min_scale: float):
    """Affine-resize an image to the 64-aligned multi-scale size
    (reference transforms/utils.py:89-97). Returns (image, center, scale)."""
    import cv2

    size_resized, center, scale = get_multi_scale_size(image, input_size, current_scale, min_scale)
    trans = get_affine_transform(center, scale, 0, size_resized)
    image_resized = cv2.warpAffine(image, trans, size_resized)
    return image_resized, center, scale


def transform_coords_inverse(kpts_xy: np.ndarray, center, scale, output_size) -> np.ndarray:
    """Map decoded keypoint coords back to raw-image space
    (reference src/keypoints/results.py:158-171)."""
    matrix = get_affine_transform(center, scale, 0, output_size, inverse=True)
    out = kpts_xy.copy().astype(np.float64)
    flat = out.reshape(-1, 2)
    ones = np.ones((flat.shape[0], 1))
    mapped = np.concatenate([flat, ones], axis=1) @ matrix.T
    return mapped.reshape(kpts_xy.shape)

