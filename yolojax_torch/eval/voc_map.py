"""PASCAL VOC mAP (host-side numpy; the device produced the detections).

Copy of ``yolojax/eval/voc_map.py`` (numpy only, so it is copied rather
than imported; tests/test_torch_eval.py holds every metric key equal).
The standard VOC protocol: per-class AP with greedy IoU
matching (each GT matched at most once, detections sorted by score),
both the VOC2007 11-point interpolation and the later continuous
(every-point) interpolation.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np


def voc_ap(recall: np.ndarray, precision: np.ndarray,
           *, eleven_point: bool = True) -> float:
    if eleven_point:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            mask = recall >= t
            p = float(precision[mask].max()) if mask.any() else 0.0
            ap += p / 11.0
        return ap
    # continuous: precision envelope integral
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _iou_one_to_many(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """IoU of one corner box ``a`` (4,) against M boxes ``b`` (M, 4)."""
    lo = np.maximum(a[:2], b[:, :2])
    hi = np.minimum(a[2:], b[:, 2:])
    inter = np.prod(np.maximum(hi - lo, 0), axis=1)
    area_a = max(a[2] - a[0], 0) * max(a[3] - a[1], 0)
    area_b = np.maximum(b[:, 2] - b[:, 0], 0) * np.maximum(
        b[:, 3] - b[:, 1], 0)
    return inter / np.maximum(area_a + area_b - inter, 1e-10)


def compute_map(
    detections: Sequence[Tuple[int, int, float, np.ndarray]],
    ground_truth: Sequence[Tuple[int, int, np.ndarray]],
    num_classes: int,
    *,
    iou_thresh: float = 0.5,
    eleven_point: bool = True,
    gt_difficult: Sequence[bool] = None,
) -> Dict[str, float]:
    """Compute per-class AP and mAP.

    detections:   (image_id, class_id, score, box[ymin,xmin,ymax,xmax])
    ground_truth: (image_id, class_id, box)
    Boxes in any consistent coordinate system.

    ``gt_difficult`` (aligned with ``ground_truth``) marks VOC *difficult*
    objects, handled exactly as in the devkit's VOCevaldet: excluded from
    the recall denominator, and a detection whose best-overlap GT is
    difficult (at >= ``iou_thresh``) is neither a TP nor an FP — difficult
    GT is never consumed, so any number of detections can sit on it freely.

    Classes with no (non-difficult) ground truth in the set are EXCLUDED
    from the mean (no ``ap_c`` emitted), the VOC-devkit/COCO convention —
    detections of such classes carry no penalty, exactly as in
    pycocotools. On real VOC val/test splits every class has GT, so this
    only matters for small synthetic sets.
    """

    iou = _iou_one_to_many
    if gt_difficult is None:
        gt_difficult = np.zeros(len(ground_truth), bool)

    aps = {}
    for c in range(num_classes):
        gt_by_img: Dict[int, List[np.ndarray]] = {}
        diff_by_img: Dict[int, List[bool]] = {}
        for gi, (img, cls, box) in enumerate(ground_truth):
            if cls == c:
                gt_by_img.setdefault(img, []).append(np.asarray(box, np.float64))
                diff_by_img.setdefault(img, []).append(bool(gt_difficult[gi]))
        npos = sum(len(v) - sum(d)
                   for v, d in zip(gt_by_img.values(), diff_by_img.values()))
        if npos == 0:
            continue  # absent class: excluded from the mean (see docstring)
        dets = [(img, score, np.asarray(box, np.float64))
                for img, cls, score, box in detections if cls == c]
        dets.sort(key=lambda d: -d[1])
        matched: Dict[int, np.ndarray] = {
            img: np.zeros(len(v), bool) for img, v in gt_by_img.items()
        }
        tp = np.zeros(len(dets))
        fp = np.zeros(len(dets))
        for i, (img, score, box) in enumerate(dets):
            gts = gt_by_img.get(img)
            if not gts:
                fp[i] = 1
                continue
            overlaps = iou(box, np.stack(gts))
            j = int(np.argmax(overlaps))
            if overlaps[j] < iou_thresh:
                fp[i] = 1
            elif diff_by_img[img][j]:
                pass  # ignored: sits on a difficult object
            elif not matched[img][j]:
                tp[i] = 1
                matched[img][j] = True
            else:
                fp[i] = 1
        ctp = np.cumsum(tp)
        cfp = np.cumsum(fp)
        recall = ctp / npos
        precision = ctp / np.maximum(ctp + cfp, 1e-10)
        aps[c] = voc_ap(recall, precision, eleven_point=eleven_point)
    out = {f"ap_{c}": v for c, v in aps.items()}
    out["map"] = float(np.mean(list(aps.values()))) if aps else 0.0
    return out


# COCO size bins in pixel^2 (areas computed after ``box_scale``)
COCO_AREA_RANGES = {
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, float("inf")),
}


class _ClassIndex:
    """Per-class, per-image grouping of detections/GT with cached IoU
    matrices — built ONCE per :func:`compute_coco_map` call so the AR and
    size-bin sweeps (6 surfaces x 10 IoU thresholds) re-run only the cheap
    greedy matching, not full-list scans and IoU recomputation
    (the naive form was O(surfaces x classes x thresholds x (D+G)))."""

    def __init__(self, detections, ground_truth, num_classes: int):
        self.num_classes = num_classes
        # class -> img -> [gi...] / [(score, di)... sorted desc]
        self.gt_rows: List[Dict[int, List[int]]] = [
            {} for _ in range(num_classes)]
        det_rows: List[Dict[int, List[Tuple[float, int]]]] = [
            {} for _ in range(num_classes)]
        for gi, (img, cls, _) in enumerate(ground_truth):
            if 0 <= cls < num_classes:
                self.gt_rows[cls].setdefault(img, []).append(gi)
        for di, (img, cls, score, _) in enumerate(detections):
            if 0 <= cls < num_classes:
                det_rows[cls].setdefault(img, []).append((float(score), di))
        gt_boxes = [np.asarray(g[2], np.float64) for g in ground_truth]
        det_boxes = [np.asarray(d[3], np.float64) for d in detections]
        # per class/img: det rows sorted by score desc, cached IoU (D, G)
        self.dets: List[Dict[int, List[Tuple[float, int]]]] = det_rows
        self.ious: List[Dict[int, np.ndarray]] = [
            {} for _ in range(num_classes)]
        for c in range(num_classes):
            for img, rows in det_rows[c].items():
                rows.sort(key=lambda r: -r[0])
                gis = self.gt_rows[c].get(img)
                if gis:
                    gmat = np.stack([gt_boxes[gi] for gi in gis])
                    self.ious[c][img] = np.stack(
                        [_iou_one_to_many(det_boxes[di], gmat)
                         for _, di in rows])

    def gt_flags(self, c: int, img: int, gt_in_bin) -> np.ndarray:
        gis = self.gt_rows[c][img]
        if gt_in_bin is None:
            return np.ones(len(gis), bool)
        return np.asarray([bool(gt_in_bin[gi]) for gi in gis])


def _binned_aps(
    index: _ClassIndex,
    iou_thresholds,
    *,
    gt_in_bin,
    det_in_bin,
) -> List[float]:
    """Size-bin AP per IoU threshold with COCO ignore semantics.

    Matching runs against ALL ground truth; out-of-bin GT is *ignored*
    rather than removed: a detection matched to an ignored GT is neither a
    TP nor an FP, and an unmatched detection whose own area is out-of-bin
    is ignored rather than an FP. Classes with no in-bin GT are excluded
    from the bin mean (COCO's -1 cells). ``gt_in_bin`` / ``det_in_bin``
    are index-aligned bool arrays over the original input sequences.
    """
    per_t: List[List[float]] = [[] for _ in iou_thresholds]
    for c in range(index.num_classes):
        npos = sum(
            bool(gt_in_bin[gi])
            for gis in index.gt_rows[c].values() for gi in gis)
        if npos == 0:
            continue  # no in-bin GT for this class: excluded, not AP 0
        flags = {img: index.gt_flags(c, img, gt_in_bin)
                 for img in index.gt_rows[c]}
        # global score order across images for the PR sweep
        order = sorted(
            ((score, img, row, di)
             for img, rows in index.dets[c].items()
             for row, (score, di) in enumerate(rows)),
            key=lambda r: -r[0])
        for ti, t in enumerate(iou_thresholds):
            matched = {img: np.zeros(len(gis), bool)
                       for img, gis in index.gt_rows[c].items()}
            tp, fp = [], []
            for score, img, row, di in order:
                in_bin = bool(det_in_bin[di])
                overlaps = index.ious[c].get(img)
                if overlaps is None:  # image has no GT of this class
                    if in_bin:
                        tp.append(0.0)
                        fp.append(1.0)
                    continue
                ov = overlaps[row]
                cand = np.where((ov >= t) & ~matched[img])[0]
                live = cand[flags[img][cand]]
                if live.size:  # prefer the best non-ignored GT
                    j = live[np.argmax(ov[live])]
                    matched[img][j] = True
                    tp.append(1.0)
                    fp.append(0.0)
                elif cand.size:  # matched an out-of-bin GT: ignored, no FP
                    matched[img][cand[np.argmax(ov[cand])]] = True
                elif in_bin:  # unmatched in-bin detection: FP
                    tp.append(0.0)
                    fp.append(1.0)
                # unmatched out-of-bin detection: ignored
            if not tp:
                per_t[ti].append(0.0)
                continue
            ctp = np.cumsum(tp)
            cfp = np.cumsum(fp)
            recall = ctp / npos
            precision = ctp / np.maximum(ctp + cfp, 1e-10)
            per_t[ti].append(voc_ap(recall, precision, eleven_point=False))
    return [float(np.mean(v)) if v else float("nan") for v in per_t]


def _class_recalls(
    index: _ClassIndex,
    cls: int,
    iou_thresholds,
    *,
    max_dets: int,
    gt_in_bin=None,
) -> List[float]:
    """Recall per IoU threshold for one class with at most ``max_dets``
    detections per image (COCO AR building block).

    Matching follows pycocotools: detections (top ``max_dets`` per image by
    score) greedily match unmatched GT in score order, preferring
    non-ignored GT; ``gt_in_bin`` marks out-of-bin GT as *ignored* —
    matches to them don't count, and they're excluded from the
    denominator. Returns NaNs when the class has no countable GT.
    """
    npos = sum(
        (True if gt_in_bin is None else bool(gt_in_bin[gi]))
        for gis in index.gt_rows[cls].values() for gi in gis)
    if npos == 0:
        return [float("nan")] * len(iou_thresholds)
    per_img = []  # (capped IoU matrix, countable flags)
    for img in index.gt_rows[cls]:
        overlaps = index.ious[cls].get(img)
        if overlaps is None or not overlaps.size:
            continue  # no detections of this class in the image
        per_img.append((overlaps[:max_dets],
                        index.gt_flags(cls, img, gt_in_bin)))
    out = []
    for t in iou_thresholds:
        hit = 0
        for overlaps, flags in per_img:
            matched = np.zeros(overlaps.shape[1], bool)
            for ov in overlaps:  # rows already in score order
                cand = np.where((ov >= t) & ~matched)[0]
                if not cand.size:
                    continue
                live = cand[flags[cand]]
                if live.size:
                    matched[live[np.argmax(ov[live])]] = True
                    hit += 1
                else:  # best available is an ignored GT: consume, no credit
                    matched[cand[np.argmax(ov[cand])]] = True
        out.append(hit / npos)
    return out


def compute_coco_map(
    detections: Sequence[Tuple[int, int, float, np.ndarray]],
    ground_truth: Sequence[Tuple[int, int, np.ndarray]],
    num_classes: int,
    *,
    box_scale: float = 1.0,
    iou_thresholds: Sequence[float] = tuple(
        round(0.5 + 0.05 * i, 2) for i in range(10)),
    gt_ignore: Sequence[bool] = None,
) -> Dict[str, float]:
    """COCO-style metrics on the same (image_id, class, score, box) streams
    as :func:`compute_map` (boxes ymin,xmin,ymax,xmax; GT matched at most
    once per class, continuous interpolation).

    Returns ``coco_map`` = mean AP over IoU .50:.05:.95, plus ``ap50`` /
    ``ap75``, average recall ``ar_1`` / ``ar_10`` / ``ar_100`` (mean max
    recall over the same IoU sweep with at most 1/10/100 detections per
    image, pycocotools semantics via :func:`_class_recalls`), size-binned
    ``ar_small``/``ar_medium``/``ar_large`` (AR@100 over in-bin GT only,
    out-of-bin GT ignored), and size-binned ``ap_small`` / ``ap_medium`` /
    ``ap_large``
    (GT binned by area after ``box_scale``: pass the canvas pixel dim when
    boxes are canvas-normalized). Size bins use COCO ignore semantics
    (:func:`_binned_aps`): matching runs against all GT, detections matched
    to out-of-bin GT are ignored (not false positives), unmatched
    out-of-bin detections are ignored, and classes with no in-bin GT are
    excluded from the bin mean.

    ``gt_ignore`` (aligned with ``ground_truth``) marks GT to ignore in
    every surface — VOC *difficult* objects scored COCO-style ride this,
    with the same mechanics pycocotools applies to crowd/ignore regions:
    excluded from every denominator, matches to them are neither TP nor
    FP (each ignored GT is consumed at most once per threshold sweep).

    This extends the VOC protocol for COCO-trained configs.
    """

    def _area(box) -> float:
        b = np.asarray(box, np.float64) * box_scale
        return max(b[2] - b[0], 0.0) * max(b[3] - b[1], 0.0)

    out: Dict[str, float] = {}
    index = _ClassIndex(detections, ground_truth, num_classes)
    # The unbinned sweep is the bin sweep with everything in-bin. Matching
    # is pycocotools-exact: a detection takes the best *unmatched* GT above
    # the threshold (VOC's compute_map takes the best-overall GT and fails
    # if it is already matched — for the VOC surface that stays as is).
    countable = (np.ones(len(ground_truth), bool) if gt_ignore is None
                 else ~np.asarray(gt_ignore, bool))
    all_det = np.ones(len(detections), bool)
    per_t = _binned_aps(index, iou_thresholds,
                        gt_in_bin=countable, det_in_bin=all_det)
    per_t = [0.0 if np.isnan(v) else v for v in per_t]
    out["coco_map"] = float(np.mean(per_t)) if per_t else 0.0
    for t, v in zip(iou_thresholds, per_t):
        if abs(t - 0.5) < 1e-9:
            out["ap50"] = v
        if abs(t - 0.75) < 1e-9:
            out["ap75"] = v

    def _mean_recall(max_dets: int, gt_in_bin=None) -> float:
        per_cls = []
        for c in range(num_classes):
            vals = [v for v in _class_recalls(
                        index, c, iou_thresholds, max_dets=max_dets,
                        gt_in_bin=gt_in_bin)
                    if not np.isnan(v)]
            if vals:  # class with countable GT
                per_cls.append(float(np.mean(vals)))
        return float(np.mean(per_cls)) if per_cls else float("nan")

    for k in (1, 10, 100):
        out[f"ar_{k}"] = _mean_recall(k, gt_in_bin=None if gt_ignore is None
                                      else countable)

    gt_areas = np.asarray([_area(g[2]) for g in ground_truth])
    det_areas = np.asarray([_area(d[3]) for d in detections])
    for name, (lo, hi) in COCO_AREA_RANGES.items():
        gt_in = (gt_areas >= lo) & (gt_areas < hi) if len(gt_areas) else gt_areas.astype(bool)
        gt_in &= countable
        det_in = (det_areas >= lo) & (det_areas < hi) if len(det_areas) else det_areas.astype(bool)
        if not gt_in.any():
            out[f"ap_{name}"] = float("nan")
            out[f"ar_{name}"] = float("nan")
            continue
        vals = [v for v in _binned_aps(index, iou_thresholds,
                                       gt_in_bin=gt_in, det_in_bin=det_in)
                if not np.isnan(v)]
        out[f"ap_{name}"] = float(np.mean(vals)) if vals else float("nan")
        out[f"ar_{name}"] = _mean_recall(100, gt_in_bin=gt_in)
    return out
