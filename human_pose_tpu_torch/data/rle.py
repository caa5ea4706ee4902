"""COCO mask utilities without pycocotools (port of
human_pose_tpu/data/rle.py; cv2 imported where it is used; the RLE decode
in the port's host library, ``data/native.py``).

Implements the COCO RLE formats from the public spec:
* compressed RLE strings (6-bit varint chunks, delta-coded after the first
  two counts — the pycocotools ``frString`` scheme)
* uncompressed RLE dicts ({"counts": [ints], "size": [h, w]}), column-major
* polygon lists, rasterized with cv2.fillPoly

Used for the crowd-mask pre-bake (reference coco.py:167-177) and segmentation
area computation for OKS.
"""

from __future__ import annotations

import numpy as np


def decode_rle_counts_string(s: str | bytes) -> list[int]:
    """Decode a compressed COCO RLE counts string to run lengths."""
    if isinstance(s, bytes):
        s = s.decode("ascii")
    counts: list[int] = []
    i = 0
    n = len(s)
    while i < n:
        x = 0
        k = 0
        more = True
        while more:
            c = ord(s[i]) - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def rle_to_mask(counts: list[int], h: int, w: int) -> np.ndarray:
    """Run lengths (column-major, starting with zeros) -> [h, w] uint8 mask,
    by the native decode (``csrc/rle_decode.cpp``), as the JAX package's."""
    from .native import rle_decode_native

    return rle_decode_native(counts, h, w)


def rle_to_mask_plain(counts: list[int], h: int, w: int) -> np.ndarray:
    """The NumPy loop of ``rle_to_mask`` (its plain version; it differs
    only on a negative count, which the native decode takes as empty)."""
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        flat[pos : pos + c] = val
        pos += c
        val = 1 - val
    return flat.reshape(w, h).T  # column-major


def polygons_to_mask(polygons: list, h: int, w: int) -> np.ndarray:
    """List of flat [x1,y1,...] polygons -> [h, w] uint8 mask."""
    import cv2

    mask = np.zeros((h, w), np.uint8)
    pts = [
        np.asarray(p, np.float64).reshape(-1, 2).round().astype(np.int32)
        for p in polygons
        if len(p) >= 6
    ]
    if pts:
        cv2.fillPoly(mask, pts, 1)
    return mask


def segmentation_to_mask(segm, h: int, w: int) -> np.ndarray:
    """Any COCO segmentation (polygons / RLE dict) -> [h, w] uint8 mask."""
    if isinstance(segm, dict):
        counts = segm["counts"]
        sh, sw = segm["size"]
        if isinstance(counts, (str, bytes)):
            counts = decode_rle_counts_string(counts)
        return rle_to_mask(list(counts), sh, sw)
    return polygons_to_mask(segm, h, w)


def segmentation_masks(segm, h: int, w: int) -> list[np.ndarray]:
    """Per-part masks, mirroring pycocotools.frPyObjects returning one RLE per
    polygon (used by get_crowd_mask's summation, reference coco.py:173-176)."""
    if isinstance(segm, dict):
        return [segmentation_to_mask(segm, h, w)]
    return [polygons_to_mask([p], h, w) for p in segm if len(p) >= 6]


def get_crowd_mask(annots: list[dict], img_h: int, img_w: int) -> np.ndarray:
    """Loss-weighting mask: True where NOT covered by crowd regions or
    zero-keypoint objects (reference coco.py:167-177; coverage threshold 0.5)."""
    m = np.zeros((img_h, img_w), np.float64)
    for obj in annots:
        if obj.get("iscrowd"):
            m += segmentation_to_mask(obj["segmentation"], img_h, img_w)
        elif obj.get("num_keypoints", 0) == 0:
            for part in segmentation_masks(obj["segmentation"], img_h, img_w):
                m += part
    return m < 0.5
