"""COCO keypoint AP/AR evaluation in pure NumPy (pycocotools-free); port
of human_pose_tpu/metrics/cocoeval.py.

pycocotools is not available in this image (SURVEY.md §2.9 anticipated a
"pure-NumPy COCOeval reimplementation"); this implements the keypoints flavor
of the public COCOeval protocol:

* OKS IoU matrix per image: gaussian similarity with the 17 COCO sigmas, gt
  area + eps normalization, visible-keypoint restriction, bbox-distance
  fallback for gts without labeled keypoints
* greedy per-threshold matching in detection-score order with ignore/crowd
  semantics
* accumulation over 10 OKS thresholds (.50:.05:.95), 101 recall thresholds,
  area ranges (all / medium / large), maxDets=20
* the standard 10-line AP/AR summary

Inputs mirror the reference eval flow (src/keypoints/bin/eval.py:52-65):
ground truth from person_keypoints_val2017.json, detections as COCO-format
result dicts {image_id, category_id, keypoints, score}.
"""

from __future__ import annotations

import numpy as np

SIGMAS = np.array(
    [26, 25, 25, 35, 35, 79, 79, 72, 72, 62, 62, 107, 107, 87, 87, 89, 89],
    np.float64,
) / 1000.0

OKS_THRS = np.round(np.arange(0.5, 0.95 + 1e-9, 0.05), 2)
REC_THRS = np.round(np.arange(0.0, 1.0 + 1e-9, 0.01), 2)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "medium": (32**2, 96**2),
    "large": (96**2, 1e10),
}
MAX_DETS = 20


def compute_oks_matrix(dts: list[dict], gts: list[dict]) -> np.ndarray:
    """[num_dt, num_gt] OKS similarity (pycocotools computeOks semantics)."""
    ious = np.zeros((len(dts), len(gts)))
    vars_ = (SIGMAS * 2) ** 2
    k = len(SIGMAS)
    for j, gt in enumerate(gts):
        g = np.asarray(gt["keypoints"], np.float64)
        xg, yg, vg = g[0::3], g[1::3], g[2::3]
        k1 = int((vg > 0).sum())
        bb = gt.get("bbox", [0, 0, 0, 0])
        x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
        y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
        for i, dt in enumerate(dts):
            d = np.asarray(dt["keypoints"], np.float64)
            xd, yd = d[0::3], d[1::3]
            if k1 > 0:
                dx, dy = xd - xg, yd - yg
            else:
                z = np.zeros(k)
                dx = np.maximum(z, x0 - xd) + np.maximum(z, xd - x1)
                dy = np.maximum(z, y0 - yd) + np.maximum(z, yd - y1)
            e = (dx**2 + dy**2) / vars_ / (gt.get("area", 0.0) + np.spacing(1)) / 2.0
            if k1 > 0:
                e = e[vg > 0]
            ious[i, j] = np.exp(-e).sum() / e.shape[0]
    return ious


def _dt_area(dt: dict) -> float:
    """Keypoint-extent area for detections (pycocotools loadRes keypoints)."""
    if "area" in dt:
        return float(dt["area"])
    kp = np.asarray(dt["keypoints"], np.float64)
    x, y = kp[0::3], kp[1::3]
    return float((x.max() - x.min()) * (y.max() - y.min()))


def evaluate_image(dts, gts, ious, area_rng):
    """Greedy matching per OKS threshold for one image/area-range."""
    T = len(OKS_THRS)
    gt_ignore0 = np.array(
        [
            bool(g.get("ignore", 0))
            or g["area"] < area_rng[0]
            or g["area"] > area_rng[1]
            for g in gts
        ],
        dtype=bool,  # empty lists otherwise default to float64 and break ~
    )
    # sort gts: non-ignored first (pycocotools order)
    g_order = np.argsort(gt_ignore0, kind="mergesort")
    gts = [gts[i] for i in g_order]
    gt_ig = gt_ignore0[g_order]
    d_order = np.argsort([-d["score"] for d in dts], kind="mergesort")[:MAX_DETS]
    dts = [dts[i] for i in d_order]
    if ious.size:
        ious = ious[d_order][:, g_order]

    G, D = len(gts), len(dts)
    gtm = np.zeros((T, G), np.int64) - 1
    dtm = np.zeros((T, D), np.int64) - 1
    dt_ig = np.zeros((T, D), bool)
    for tind, t in enumerate(OKS_THRS):
        for dind in range(D):
            iou = min(t, 1 - 1e-10)
            m = -1
            for gind in range(G):
                if gtm[tind, gind] >= 0 and not gts[gind].get("iscrowd", 0):
                    continue
                if m > -1 and not gt_ig[m] and gt_ig[gind]:
                    break
                if ious[dind, gind] < iou:
                    continue
                iou = ious[dind, gind]
                m = gind
            if m == -1:
                continue
            dt_ig[tind, dind] = gt_ig[m]
            dtm[tind, dind] = m
            gtm[tind, m] = dind
    # unmatched dts outside the area range are ignored
    a = np.array(
        [_dt_area(d) < area_rng[0] or _dt_area(d) > area_rng[1] for d in dts],
        dtype=bool,
    )
    dt_ig = np.logical_or(dt_ig, np.logical_and(dtm < 0, np.tile(a, (T, 1))))
    return {
        "dt_scores": np.array([d["score"] for d in dts]),
        "dtm": dtm,
        "dt_ig": dt_ig,
        "gt_ig": gt_ig,
        "num_gt": int((~gt_ig).sum()),
    }


class COCOKeypointsEval:
    """End-to-end OKS AP evaluation.

    Args:
      gt_annotations: COCO json dict (or just its 'annotations' list +
        'images' list) for the person category
      detections: list of {image_id, category_id, keypoints, score}
    """

    def __init__(self, gt_annotations, detections: list[dict]):
        if isinstance(gt_annotations, dict):
            anns = gt_annotations["annotations"]
            self.img_ids = sorted({im["id"] for im in gt_annotations["images"]})
        else:
            anns = gt_annotations
            # a bare annotation list carries no dataset image index, so
            # evaluate the union of GT and DT image ids — detections on a
            # GT-empty image must still count as false positives (pycocotools
            # evaluates every image in the dataset)
            self.img_ids = sorted(
                {a["image_id"] for a in anns} | {d["image_id"] for d in detections}
            )
        self.gts: dict[int, list] = {}
        for a in anns:
            if a.get("category_id", 1) != 1:
                continue
            a = dict(a)
            # pycocotools _prepare (keypoints flavor): crowd regions AND
            # gts without labeled keypoints are ignore — they can absorb
            # detections but never count as misses
            a["ignore"] = (
                a.get("ignore", 0)
                or a.get("iscrowd", 0)
                or a.get("num_keypoints", 0) == 0
            )
            self.gts.setdefault(a["image_id"], []).append(a)
        self.dts: dict[int, list] = {}
        for d in detections:
            self.dts.setdefault(d["image_id"], []).append(d)
        self.stats: np.ndarray | None = None

    def evaluate(self) -> np.ndarray:
        T, R = len(OKS_THRS), len(REC_THRS)
        A = len(AREA_RANGES)
        precision = -np.ones((T, R, A))
        recall = -np.ones((T, A))

        # per-image OKS matrices are shared across area ranges
        ious = {}
        for img_id in self.img_ids:
            dts = self.dts.get(img_id, [])
            gts = self.gts.get(img_id, [])
            ious[img_id] = compute_oks_matrix(dts, gts) if dts and gts else np.zeros((len(dts), len(gts)))

        for aind, (aname, arng) in enumerate(AREA_RANGES.items()):
            results = []
            for img_id in self.img_ids:
                dts = self.dts.get(img_id, [])
                gts = self.gts.get(img_id, [])
                if not dts and not gts:
                    continue
                results.append(evaluate_image(dts, gts, ious[img_id], arng))
            if not results:
                continue
            dt_scores = np.concatenate([r["dt_scores"] for r in results])
            order = np.argsort(-dt_scores, kind="mergesort")
            dtm = np.concatenate([r["dtm"] for r in results], axis=1)[:, order]
            dt_ig = np.concatenate([r["dt_ig"] for r in results], axis=1)[:, order]
            npig = sum(r["num_gt"] for r in results)
            if npig == 0:
                continue
            tps = np.logical_and(dtm >= 0, ~dt_ig)
            fps = np.logical_and(dtm < 0, ~dt_ig)
            tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
            fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
            for tind in range(T):
                tp, fp = tp_sum[tind], fp_sum[tind]
                rc = tp / npig
                pr = tp / (tp + fp + np.spacing(1))
                recall[tind, aind] = rc[-1] if len(rc) else 0.0
                # precision envelope
                q = np.zeros(R)
                pr = pr.tolist()
                for i in range(len(pr) - 1, 0, -1):
                    if pr[i] > pr[i - 1]:
                        pr[i - 1] = pr[i]
                inds = np.searchsorted(rc, REC_THRS, side="left")
                for ri, pi in enumerate(inds):
                    if pi < len(pr):
                        q[ri] = pr[pi]
                precision[tind, :, aind] = q

        def _ap(tind=None, aind=0):
            p = precision[:, :, aind] if tind is None else precision[tind : tind + 1, :, aind]
            p = p[p > -1]
            return float(p.mean()) if p.size else -1.0

        def _ar(tind=None, aind=0):
            r = recall[:, aind] if tind is None else recall[tind : tind + 1, aind]
            r = r[r > -1]
            return float(r.mean()) if r.size else -1.0

        t50 = int(np.argmin(np.abs(OKS_THRS - 0.5)))
        t75 = int(np.argmin(np.abs(OKS_THRS - 0.75)))
        self.stats = np.array(
            [
                _ap(),                 # AP @ .50:.95 all
                _ap(t50),              # AP @ .50
                _ap(t75),              # AP @ .75
                _ap(aind=1),           # AP medium
                _ap(aind=2),           # AP large
                _ar(),                 # AR @ .50:.95 all
                _ar(t50),              # AR @ .50
                _ar(t75),              # AR @ .75
                _ar(aind=1),           # AR medium
                _ar(aind=2),           # AR large
            ]
        )
        return self.stats

    def summarize(self) -> str:
        if self.stats is None:
            self.evaluate()
        names = [
            ("Average Precision  (AP)", "0.50:0.95", "   all"),
            ("Average Precision  (AP)", "0.50     ", "   all"),
            ("Average Precision  (AP)", "0.75     ", "   all"),
            ("Average Precision  (AP)", "0.50:0.95", "medium"),
            ("Average Precision  (AP)", "0.50:0.95", " large"),
            ("Average Recall     (AR)", "0.50:0.95", "   all"),
            ("Average Recall     (AR)", "0.50     ", "   all"),
            ("Average Recall     (AR)", "0.75     ", "   all"),
            ("Average Recall     (AR)", "0.50:0.95", "medium"),
            ("Average Recall     (AR)", "0.50:0.95", " large"),
        ]
        lines = [
            f" {n} @[ IoU={t} | area={a} | maxDets={MAX_DETS:3d} ] = {v:0.3f}"
            for (n, t, a), v in zip(names, self.stats)
        ]
        return "\n".join(lines)
