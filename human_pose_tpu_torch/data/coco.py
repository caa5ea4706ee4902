"""COCO keypoint names and the skeleton's limbs (port of the constants of
human_pose_tpu/data/coco.py; the dataset comes with batched eval)."""

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
